"""Table configuration model: the subset the segment builder, the realtime
converter, the server's load path and the upsert/dedup managers read.

Subset of the reference's TableConfig
(pinot-spi/.../spi/config/table/TableConfig.java:38): table type, every
index declaration of the JAX package's IndexingConfig, the time column and
the upsert and dedup configs, and the ingestion config (the stream, the
transforms and the filter a realtime table consumes with). The
`tableIndexConfig` JSON is the JAX package's, key for key, so a config
written by either reads back here with nothing dropped.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class TableType(enum.Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclass
class IndexingConfig:
    """Per-table index declarations (reference IndexingConfig.java):

    - 'noDictionaryColumns': columns stored raw, fixed-width values or a
      var-byte stream with u64 offsets (STRING, BYTES, JSON);
    - 'compressionConfigs': column -> codec of its forward buffers
      (PASS_THROUGH, LZ4, SNAPPY, GZIP, ZSTANDARD; segment/compression.py),
      or CLP for a raw STRING column (segment/clp.py);
    - 'bloomFilterColumns' and 'segmentPartitionConfig' (column ->
      {"functionName": "murmur|modulo|hashcode", "numPartitions": N}): the
      builder writes the bloom filters and partition stamps the pruner
      reads (engine/pruner.py), and a server builds a missing bloom filter
      at load (segment/loader.py backfill_indexes);
    - 'sortedColumn': the column a committed realtime segment is sorted on
      (realtime/converter.py);
    - star-tree configs, pre-aggregated tables (segment/startree.py); the
      JSON, text and vector index columns (segment/indexes.py); custom
      index types by column (segment/index_spi.py: {"colA": {"type":
      "map", ...}}), which, as in the full model, do not ride the JSON form;
    - 'invertedIndexColumns', 'rangeIndexColumns' and 'geoIndexConfigs':
      the inverted, range and geo indexes (segment/indexes.py), built by
      segment/builder.py and at load by backfill_indexes; the host engine
      (engine/host_executor.py) reads them."""

    inverted_index_columns: list[str] = field(default_factory=list)
    range_index_columns: list[str] = field(default_factory=list)
    bloom_filter_columns: list[str] = field(default_factory=list)
    no_dictionary_columns: list[str] = field(default_factory=list)
    sorted_column: Optional[str] = None
    star_tree_index_configs: list[dict] = field(default_factory=list)
    json_index_columns: list[str] = field(default_factory=list)
    text_index_columns: list[str] = field(default_factory=list)
    vector_index_columns: list[str] = field(default_factory=list)
    # {"latColumn": ..., "lngColumn": ..., "resolutionDeg": 0.5}
    geo_index_configs: list[dict] = field(default_factory=list)
    compression_configs: dict[str, str] = field(default_factory=dict)
    custom_index_configs: dict[str, dict] = field(default_factory=dict)
    segment_partition_config: dict[str, dict] = field(default_factory=dict)


@dataclass
class SegmentsValidationConfig:
    time_column_name: Optional[str] = None


@dataclass
class UpsertConfig:
    mode: str = "NONE"  # NONE | FULL | PARTIAL
    partial_upsert_strategies: dict[str, str] = field(default_factory=dict)
    comparison_columns: list[str] = field(default_factory=list)
    # reference UpsertConfig.metadataTTL: pk entries whose comparison value
    # falls behind the high-watermark by more than this stop being tracked
    metadata_ttl: float = 0.0  # 0 -> disabled; units of the comparison column
    # reference UpsertConfig.deleteRecordColumn: a truthy value tombstones
    # the key; deleted_keys_ttl bounds how long the tombstone is remembered
    delete_record_column: str = ""
    deleted_keys_ttl: float = 0.0
    # reference UpsertConfig.ConsistencyMode: NONE | SYNC. SYNC makes the
    # invalidate-old/validate-new pair atomic against query mask snapshots
    consistency_mode: str = "NONE"


@dataclass
class DedupConfig:
    enabled: bool = False


@dataclass
class IngestionConfig:
    """Stream + transform config (reference IngestionConfig.java)."""

    stream_configs: dict[str, Any] = field(default_factory=dict)
    transform_configs: list[dict] = field(default_factory=list)  # {columnName, transformFunction}
    filter_function: Optional[str] = None


@dataclass
class TableConfig:
    table_name: str
    table_type: TableType = TableType.OFFLINE
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    validation: SegmentsValidationConfig = field(
        default_factory=SegmentsValidationConfig)
    upsert: UpsertConfig = field(default_factory=UpsertConfig)
    dedup: DedupConfig = field(default_factory=DedupConfig)
    ingestion: IngestionConfig = field(default_factory=IngestionConfig)

    def __post_init__(self):
        if isinstance(self.table_type, str):
            self.table_type = TableType(self.table_type)

    def to_json(self) -> dict:
        return {
            "tableName": self.table_name,
            "tableType": self.table_type.value,
            "tableIndexConfig": {
                "invertedIndexColumns": self.indexing.inverted_index_columns,
                "rangeIndexColumns": self.indexing.range_index_columns,
                "bloomFilterColumns": self.indexing.bloom_filter_columns,
                "noDictionaryColumns": self.indexing.no_dictionary_columns,
                "sortedColumn": self.indexing.sorted_column,
                "starTreeIndexConfigs": self.indexing.star_tree_index_configs,
                "compressionConfigs": self.indexing.compression_configs,
                "jsonIndexColumns": self.indexing.json_index_columns,
                "textIndexColumns": self.indexing.text_index_columns,
                "vectorIndexColumns": self.indexing.vector_index_columns,
                "geoIndexConfigs": self.indexing.geo_index_configs,
                "segmentPartitionConfig": {
                    "columnPartitionMap":
                        self.indexing.segment_partition_config},
            },
            "segmentsConfig": {
                "timeColumnName": self.validation.time_column_name,
            },
            "upsertConfig": {
                "mode": self.upsert.mode,
                "partialUpsertStrategies": self.upsert.partial_upsert_strategies,
                "comparisonColumns": self.upsert.comparison_columns,
                "metadataTTL": self.upsert.metadata_ttl,
                "deleteRecordColumn": self.upsert.delete_record_column,
                "deletedKeysTTL": self.upsert.deleted_keys_ttl,
                "consistencyMode": self.upsert.consistency_mode,
            },
            "ingestionConfig": {
                "streamConfigs": self.ingestion.stream_configs,
                "transformConfigs": self.ingestion.transform_configs,
                "filterFunction": self.ingestion.filter_function,
            },
        }

    @classmethod
    def from_json(cls, d: dict) -> "TableConfig":
        idx = d.get("tableIndexConfig", {})
        seg = d.get("segmentsConfig", {})
        up = d.get("upsertConfig") or {}
        ing = d.get("ingestionConfig", {})
        return cls(
            table_name=d["tableName"],
            table_type=TableType(d.get("tableType", "OFFLINE")),
            indexing=IndexingConfig(
                inverted_index_columns=idx.get("invertedIndexColumns") or [],
                range_index_columns=idx.get("rangeIndexColumns") or [],
                bloom_filter_columns=idx.get("bloomFilterColumns") or [],
                no_dictionary_columns=idx.get("noDictionaryColumns") or [],
                sorted_column=idx.get("sortedColumn"),
                star_tree_index_configs=idx.get("starTreeIndexConfigs") or [],
                compression_configs=idx.get("compressionConfigs") or {},
                json_index_columns=idx.get("jsonIndexColumns") or [],
                text_index_columns=idx.get("textIndexColumns") or [],
                vector_index_columns=idx.get("vectorIndexColumns") or [],
                geo_index_configs=idx.get("geoIndexConfigs") or [],
                segment_partition_config=(idx.get("segmentPartitionConfig")
                                          or {}).get("columnPartitionMap")
                or {}),
            validation=SegmentsValidationConfig(
                time_column_name=seg.get("timeColumnName")),
            upsert=UpsertConfig(
                mode=up.get("mode", "NONE"),
                partial_upsert_strategies=up.get(
                    "partialUpsertStrategies") or {},
                comparison_columns=up.get("comparisonColumns") or [],
                metadata_ttl=float(up.get("metadataTTL", 0.0)),
                delete_record_column=up.get("deleteRecordColumn", ""),
                deleted_keys_ttl=float(up.get("deletedKeysTTL", 0.0)),
                consistency_mode=up.get("consistencyMode", "NONE")),
            ingestion=IngestionConfig(
                stream_configs=ing.get("streamConfigs") or {},
                transform_configs=ing.get("transformConfigs") or [],
                filter_function=ing.get("filterFunction")),
        )
