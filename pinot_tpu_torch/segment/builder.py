"""Immutable segment builder.

Reference: pinot-segment-local/.../segment/creator/impl/
SegmentIndexCreationDriverImpl.java (init:116, build:231) — a two-pass build
(stats collection, then per-column index creation). Here ingestion is columnar,
so stats + dictionary + encode happen in one vectorized pass per column.

Single-value columns, dictionary-encoded, raw fixed-width or raw var-byte
(noDictionaryColumns; STRING, BYTES and JSON as a value stream and u64
offsets), or CLP (segment/clp.py, `compressionConfigs: {col: "CLP"}` on a
raw STRING column); dictionary-encoded multi-value columns; forward
buffers in a PTCC container where `compressionConfigs` names a codec
(segment/compression.py); partition stamps (`segmentPartitionConfig`,
spi/partition.py); the inverted (single- and multi-value), raw range,
bloom, JSON, text, geo and vector indexes, custom indexes
(segment/index_spi.py: the map index) and star-trees (segment/startree.py)
the table config asks for. A dictionary column's range index is its
inverted index (a dictId range is one slice of it); a sorted column's
sorted index is derived at load and not stored. The on-disk format and
its CRCs are the JAX package's, byte for byte, LZ4 and Snappy buffers
included (both packages encode them in their native host libraries; under
PINOT_TPU_DISABLE_NATIVE the port writes literal-only streams, which
decode to the same bytes).
"""

from __future__ import annotations

import itertools
import operator
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from ..spi.data_types import DataType, Schema
from ..spi.partition import get_partition_function
from ..spi.table_config import TableConfig
from . import bitpack
from .clp import encode_column, serialize_clp
from .dictionary import (build_dictionary, deserialize_dictionary,
                         serialize_dictionary)
from .format import ColumnMetadata, SegmentMetadata, SegmentWriter
from .index_spi import build_custom_indexes
from .indexes import (BloomFilter, GeoGridIndex, InvertedIndex, JsonIndex,
                      RawRangeIndex, TextIndex, VectorIndex, serialize_bloom,
                      serialize_geo_index, serialize_inverted,
                      serialize_json_index, serialize_raw_range,
                      serialize_text_index, serialize_vector_index)
from .startree import StarTreeConfig, build_star_tree


@dataclass
class MultiValues:
    """A multi-value column in flat form: document i holds
    values[offsets[i]:offsets[i + 1]] with offsets the running sum of
    `lengths`. The builder takes it, or one list (or array) of values per
    document; both build the same bytes."""

    values: np.ndarray
    lengths: np.ndarray

    def __len__(self) -> int:
        return len(self.lengths)


def rows_to_columns(rows: Sequence[Mapping], schema: Schema) -> dict[str, list]:
    cols: dict[str, list] = {name: [] for name in schema.column_names()}
    for row in rows:
        for name in cols:
            cols[name].append(row.get(name))
    return cols


class SegmentBuilder:
    """Builds one immutable segment directory from columnar data."""

    def __init__(
        self,
        schema: Schema,
        table_config: Optional[TableConfig] = None,
        segment_name: str = "segment_0",
    ):
        self.schema = schema
        self.table_config = table_config or TableConfig(table_name=schema.schema_name)
        self.segment_name = segment_name

    def build_from_rows(self, rows: Sequence[Mapping], out_dir: str | Path) -> Path:
        return self.build(rows_to_columns(rows, self.schema), out_dir)

    def build(self, columns: Mapping[str, Iterable], out_dir: str | Path) -> Path:
        """columns: column name -> values (may contain None for nulls)."""
        out_dir = Path(out_dir)
        writer = SegmentWriter(out_dir)
        num_docs = None
        col_metas: dict[str, ColumnMetadata] = {}
        no_dict = set(self.table_config.indexing.no_dictionary_columns)

        for name in self.schema.column_names():
            spec = self.schema.field_spec(name)
            if name not in columns:
                raise KeyError(f"schema column {name!r} missing from input columns {sorted(columns)}")
            values = columns[name]
            if not isinstance(values, (np.ndarray, MultiValues)):
                values = list(values)
            if num_docs is None:
                num_docs = len(values)
            elif len(values) != num_docs:
                raise ValueError(f"column {name}: {len(values)} values, expected {num_docs}")
            if spec.single_value:
                col_metas[name] = self._build_sv_column(
                    writer, name, spec, values, num_docs, raw=name in no_dict)
                pconf = self.table_config.indexing \
                    .segment_partition_config.get(name)
                if pconf:
                    _stamp_partition(col_metas[name], pconf, values)
            else:
                col_metas[name] = self._build_mv_column(
                    writer, name, spec, values, num_docs)

        self._build_indexes(writer, columns, col_metas)
        star_tree_metas = self._build_star_trees(writer, col_metas)

        num_docs = num_docs or 0
        time_col = self.table_config.validation.time_column_name
        start_t = end_t = None
        if time_col and time_col in col_metas:
            m = col_metas[time_col]
            if m.min_value is not None and DataType(m.data_type).is_integral:
                start_t, end_t = int(m.min_value), int(m.max_value)

        meta = SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self.table_config.table_name,
            num_docs=num_docs,
            columns=col_metas,
            time_column=time_col,
            start_time=start_t,
            end_time=end_t,
            creation_time_ms=int(time.time() * 1000),
            star_trees=star_tree_metas,
            sort_order=self._compute_sort_order(writer, col_metas),
        )
        writer.write(meta)
        return out_dir

    def _compute_sort_order(self, writer, col_metas) -> list:
        """Ingestion-order metadata: the longest greedy chain of dict-
        encoded SV columns whose dict ids are LEXICOGRAPHICALLY
        nondecreasing over the rows — the leading column is globally
        sorted, each later column is nondecreasing within every run of
        equal chain-prefix values (read by the sparse group-by planner)."""
        names = [n for n, m in col_metas.items()
                 if m.encoding == "DICT" and m.single_value]
        ids_cache: dict[str, np.ndarray] = {}

        def diff_of(n):
            if n not in ids_cache:
                m = col_metas[n]
                ids = bitpack.unpack(
                    writer.peek_buffer(f"{n}.fwd"), m.bits_per_value,
                    m.total_number_of_entries)
                ids_cache[n] = np.diff(ids.astype(np.int64))
            return ids_cache[n]

        chain: list[str] = []
        new_run = None  # True where the chain prefix changes between rows
        progress = True
        while progress:
            progress = False
            for n in names:
                if n in chain:
                    continue
                d = diff_of(n)
                ok = bool(np.all(d >= 0)) if new_run is None \
                    else bool(np.all((d >= 0) | new_run))
                if ok:
                    chain.append(n)
                    new_run = (d != 0) if new_run is None \
                        else (new_run | (d != 0))
                    progress = True
        return chain

    def _build_indexes(self, writer, columns, col_metas) -> None:
        """The inverted, range, bloom, JSON, text, vector, geo and custom
        indexes the table config asks for, in the JAX builder's order and
        bytes (reference: per-column IndexCreators invoked by
        SegmentColumnarIndexCreator)."""
        idx = self.table_config.indexing

        def add(col: str, bufs: list):
            for suffix, arr in bufs:
                writer.add_buffer(f"{col}.{suffix}", np.ascontiguousarray(arr))

        def dict_ids(col: str, m: ColumnMetadata) -> np.ndarray:
            return bitpack.unpack(writer.peek_buffer(f"{col}.fwd"),
                                  m.bits_per_value, m.total_number_of_entries)

        for col in idx.inverted_index_columns:
            m = col_metas.get(col)
            if m is None or m.encoding != "DICT":
                continue
            inv = InvertedIndex.build(dict_ids(col, m), m.cardinality)
            if not m.single_value:
                # the flat entry stream's postings map back to documents:
                # a doc is posted under every value it holds (reference MV
                # inverted index)
                off = writer.peek_buffer(f"{col}.mvoff").view(np.uint32)
                doc_of_entry = np.repeat(
                    np.arange(len(off) - 1, dtype=np.int64),
                    np.diff(off.astype(np.int64)))
                inv = InvertedIndex(inv.offsets,
                                    doc_of_entry[inv.docs].astype(np.uint32))
            add(col, serialize_inverted(inv))
        for col in idx.range_index_columns:
            m = col_metas.get(col)
            if m is None or not m.single_value:
                continue
            if m.encoding == "DICT":
                # a dictionary range rides the inverted index (one slice):
                # build one unless it was asked for already
                if f"{col}.inv.off" not in writer.buffer_names():
                    add(col, serialize_inverted(InvertedIndex.build(
                        dict_ids(col, m), m.cardinality)))
            else:
                raw = writer.peek_buffer(f"{col}.fwd").view(
                    DataType(m.data_type).numpy_dtype)
                add(col, serialize_raw_range(RawRangeIndex.build(raw)))
        for col in idx.bloom_filter_columns:
            if col in columns:
                add(col, serialize_bloom(BloomFilter.build(
                    _bloom_values(columns[col]))))
        for col in idx.json_index_columns:
            if col in columns:
                add(col, serialize_json_index(JsonIndex.build(columns[col])))
        for col in idx.text_index_columns:
            if col in columns:
                add(col, serialize_text_index(TextIndex.build(columns[col])))
        for col in idx.vector_index_columns:
            if col in columns:
                add(col, serialize_vector_index(VectorIndex.build(
                    _vector_matrix(columns[col]))))
        for cfg in idx.geo_index_configs:
            lat_col, lng_col = cfg["latColumn"], cfg["lngColumn"]
            if lat_col in columns and lng_col in columns:
                add(f"{lat_col}__{lng_col}", serialize_geo_index(
                    GeoGridIndex.build(
                        np.asarray(columns[lat_col], dtype=np.float64),
                        np.asarray(columns[lng_col], dtype=np.float64),
                        float(cfg.get("resolutionDeg", 0.5)))))
        for name, arr in build_custom_indexes(columns,
                                              idx.custom_index_configs):
            writer.add_buffer(name, np.ascontiguousarray(arr))

    def _build_star_trees(self, writer, col_metas) -> list:
        """Pre-aggregated dense tables per star_tree_index_configs
        (segment/startree.py); their metadata rides SegmentMetadata."""
        metas = []
        for tree_id, cfg_json in enumerate(
                self.table_config.indexing.star_tree_index_configs):
            cfg = (StarTreeConfig.from_json(cfg_json)
                   if isinstance(cfg_json, dict) else cfg_json)
            if not cfg.split_order:
                raise ValueError(
                    "star-tree requires a non-empty dimensionsSplitOrder")
            for d in cfg.split_order:
                m = col_metas.get(d)
                if m is None or m.encoding != "DICT" or not m.single_value:
                    raise ValueError(f"star-tree split dim {d!r} must be a "
                                     "dict-encoded SV column")
            for fn, col in cfg.pairs():
                if (col == "*") != (fn == "count"):
                    raise ValueError(
                        f"star-tree pair {fn}__{col}: '*' is COUNT-only")
                if col != "*" and col not in col_metas:
                    raise ValueError(
                        f"star-tree pair references unknown column {col!r}")

            def decode_ids(col):
                m = col_metas[col]
                return bitpack.unpack(writer.peek_buffer(f"{col}.fwd"),
                                      m.bits_per_value,
                                      m.total_number_of_entries)

            dict_ids = {d: decode_ids(d) for d in cfg.split_order}
            raw_values = {}
            for fn, col in cfg.pairs():
                if col == "*" or col in raw_values:
                    continue
                m = col_metas[col]
                if m.encoding == "RAW":
                    raw_values[col] = writer.peek_buffer(f"{col}.fwd").view(
                        DataType(m.data_type).numpy_dtype)
                else:
                    d = deserialize_dictionary(
                        bytes(writer.peek_buffer(f"{col}.dict")),
                        DataType(m.data_type), m.cardinality)
                    ids = dict_ids.get(col)
                    raw_values[col] = d.take(
                        ids if ids is not None else decode_ids(col))
            buffers, meta = build_star_tree(tree_id, cfg, dict_ids,
                                            raw_values)
            for name, arr in buffers:
                writer.add_buffer(name, np.ascontiguousarray(arr))
            metas.append(meta)
        return metas

    def _replace_nulls(self, values, spec) -> tuple[list, np.ndarray]:
        if isinstance(values, np.ndarray) and values.dtype != object:
            # numpy fast path: fixed-width arrays cannot hold None
            return values, np.zeros(len(values), dtype=bool)
        nulls = np.array([v is None for v in values], dtype=bool)
        if nulls.any():
            dv = spec.default_null_value
            values = [dv if v is None else v for v in values]
        return values, nulls

    def _build_sv_column(self, writer, name, spec, values, num_docs, raw: bool) -> ColumnMetadata:
        values, nulls = self._replace_nulls(values, spec)
        dt = spec.data_type
        codec = self.table_config.indexing.compression_configs.get(name)
        if codec == "CLP" and not (raw and dt.value == "STRING"):
            raise ValueError(
                f"column {name!r}: CLP encoding requires a STRING column "
                "listed in noDictionaryColumns")
        if raw and dt.is_fixed_width:
            arr = np.ascontiguousarray(values, dtype=dt.numpy_dtype)
            writer.add_buffer(f"{name}.fwd", arr, codec=codec)
            meta = ColumnMetadata(
                name=name, data_type=dt.value, field_type=spec.field_type.value,
                encoding="RAW", cardinality=0, bits_per_value=arr.dtype.itemsize * 8,
                min_value=arr.min() if num_docs else None,
                max_value=arr.max() if num_docs else None,
                is_sorted=bool(num_docs == 0 or np.all(np.diff(arr) >= 0)),
                total_number_of_entries=num_docs,
            )
        elif raw and codec == "CLP":
            # log-structured: template dictionary + variable streams
            # (reference CLPForwardIndexCreatorV1)
            writer.add_buffer(f"{name}.fwd",
                              serialize_clp(encode_column(values)))
            meta = ColumnMetadata(
                name=name, data_type=dt.value, field_type=spec.field_type.value,
                encoding="CLP", cardinality=0, bits_per_value=0,
                min_value=None, max_value=None, is_sorted=False,
                total_number_of_entries=num_docs)
        elif raw:
            meta = _build_var_byte_column(writer, name, spec, values,
                                          num_docs, codec)
        else:
            dictionary, dict_ids = build_dictionary(values, dt)
            bits = bitpack.num_bits_for_cardinality(dictionary.cardinality)
            writer.add_buffer(f"{name}.fwd", bitpack.pack(dict_ids, bits),
                              codec=codec)
            writer.add_buffer(f"{name}.dict", serialize_dictionary(dictionary))
            meta = ColumnMetadata(
                name=name, data_type=dt.value, field_type=spec.field_type.value,
                encoding="DICT", cardinality=dictionary.cardinality, bits_per_value=bits,
                min_value=dictionary.min_value, max_value=dictionary.max_value,
                is_sorted=bool(num_docs == 0 or np.all(np.diff(dict_ids) >= 0)),
                total_number_of_entries=num_docs,
            )
        if nulls.any():
            writer.add_buffer(f"{name}.nulls", bitpack.pack_bitmap(nulls))
            meta.has_nulls = True
        return meta

    def _build_mv_column(self, writer, name, spec, values,
                         num_docs) -> ColumnMetadata:
        """MV column: the flattened values dict-encoded into one id stream,
        with u32 row offsets; a null document holds one default value and
        its null bit. The JAX builder's layout and metadata, built by
        whole-column numpy ops instead of a loop over documents. The device
        view is made at load time: a (docs, max_mv) id matrix padded with
        the cardinality (segment/loader.py get_mv_dict_id_matrix)."""
        if isinstance(values, MultiValues):
            flat = np.asarray(values.values)
            lens = np.asarray(values.lengths, dtype=np.int64)
            nulls = np.zeros(num_docs, dtype=bool)
        else:
            nulls = np.fromiter((v is None for v in values), dtype=bool,
                                count=num_docs)
            dv = spec.default_null_value
            docs = [[dv] if v is None
                    else v if isinstance(v, (list, tuple, np.ndarray))
                    else [v] for v in values]
            lens = np.fromiter(map(len, docs), dtype=np.int64,
                               count=num_docs)
            flat = list(itertools.chain.from_iterable(docs))
        offsets = np.zeros(num_docs + 1, dtype=np.uint32)
        np.cumsum(lens, out=offsets[1:], dtype=np.uint32)
        dictionary, dict_ids = build_dictionary(flat, spec.data_type)
        bits = bitpack.num_bits_for_cardinality(dictionary.cardinality)
        writer.add_buffer(f"{name}.fwd", bitpack.pack(dict_ids, bits))
        writer.add_buffer(f"{name}.dict", serialize_dictionary(dictionary))
        writer.add_buffer(f"{name}.mvoff", offsets)
        meta = ColumnMetadata(
            name=name, data_type=spec.data_type.value,
            field_type=spec.field_type.value, encoding="DICT",
            single_value=False, cardinality=dictionary.cardinality,
            bits_per_value=bits, min_value=dictionary.min_value,
            max_value=dictionary.max_value,
            total_number_of_entries=len(flat),
            max_number_of_multi_values=int(lens.max()) if num_docs else 0,
        )
        if nulls.any():
            writer.add_buffer(f"{name}.nulls", bitpack.pack_bitmap(nulls))
            meta.has_nulls = True
        return meta


def _build_var_byte_column(writer, name, spec, values, num_docs,
                           codec) -> ColumnMetadata:
    """A raw STRING / JSON / BYTES column: the values' bytes back to back
    and u64 offsets (reference VarByteChunkForwardIndexWriterV4), with the
    JAX builder's bytes and min / max / sorted metadata over the str (or
    bytes) values, built by whole-column passes instead of its loop."""
    dt = spec.data_type
    if dt.value == "BYTES":
        keys = [bytes(v) for v in values]
        encoded = keys
    else:
        keys = [str(v) for v in values]
        encoded = [v.encode("utf-8") for v in keys]
    offsets = np.zeros(num_docs + 1, dtype=np.uint64)
    np.cumsum(np.fromiter(map(len, encoded), dtype=np.uint64,
                          count=num_docs), out=offsets[1:])
    writer.add_buffer(f"{name}.fwd", b"".join(encoded), codec=codec)
    writer.add_buffer(f"{name}.voff", offsets, codec=codec)
    return ColumnMetadata(
        name=name, data_type=dt.value, field_type=spec.field_type.value,
        encoding="RAW", cardinality=0, bits_per_value=0,
        min_value=min(keys) if keys else None,
        max_value=max(keys) if keys else None,
        is_sorted=all(map(operator.le, keys, itertools.islice(keys, 1, None))),
        total_number_of_entries=num_docs,
    )


def _stamp_partition(meta: ColumnMetadata, pconf: dict, values) -> None:
    """Record the partitions this segment's values fall in (the JAX
    builder's _stamp_partition; reference SegmentColumnarIndexCreator
    stamps ColumnPartitionMetadata from the column's partition config),
    computed over the distinct non-null values."""
    fn = get_partition_function(
        pconf["functionName"], int(pconf["numPartitions"]))
    if isinstance(values, np.ndarray) and values.dtype != object:
        uniq = np.unique(values)
    else:
        uniq = sorted({v for v in values if v is not None}, key=repr)
    parts = sorted({int(p) for p in fn.partitions_of(uniq)}) \
        if len(uniq) else []
    meta.partition_function = fn.name
    meta.num_partitions = fn.num_partitions
    meta.partitions = parts
    meta.partition_id = parts[0] if len(parts) == 1 else None


def _bloom_values(values):
    """A column's values for its bloom filter, as the JAX builder
    gathers them: every non-null value, a multi-value document's each."""
    if isinstance(values, MultiValues):
        return np.asarray(values.values)
    if isinstance(values, np.ndarray) and values.dtype != object:
        return values
    flat = []
    for v in values:
        if isinstance(v, (list, tuple, np.ndarray)):
            flat.extend(v)
        elif v is not None:
            flat.append(v)
    return flat


def _vector_matrix(values) -> np.ndarray:
    """A vector column's (docs, dim) float32 matrix: from MultiValues of
    equal lengths, or one list (or array) per document, as the JAX builder
    stacks them."""
    if isinstance(values, MultiValues):
        lens = np.asarray(values.lengths)
        dim = int(lens[0]) if len(lens) else 0
        if np.any(lens != dim):
            raise ValueError("vector index: documents of unequal lengths")
        return np.asarray(values.values, dtype=np.float32).reshape(
            len(lens), dim)
    return np.stack([np.asarray(v, dtype=np.float32) for v in values])
