"""On-disk segment format.

Layout mirrors the reference's v3 single-file segment directory
(pinot-segment-local/.../segment/store/SingleFileIndexDirectory.java,
SegmentVersion.java:21-24): one `data.bin` holding every column buffer
back-to-back plus a `metadata.json` carrying the buffer index map and
column metadata. Unlike the reference's row-group-free but chunked layout,
buffers here are whole-column (the unit of device transfer is the column plane,
not a 10K-doc block — see SURVEY.md §7 design stance).

Buffer kinds per column:
  fwd    packed dict ids (fixed-bit LSB-first) for DICT encoding, raw
         fixed-width values or a var-byte value stream for RAW encoding,
         the serialized CLP column (segment/clp.py) for CLP encoding
  voff   u64 offsets into a var-byte value stream (RAW STRING/BYTES/JSON)
  dict   serialized sorted dictionary (DICT only)
  nulls  packed null bitmap (present iff column had nulls)
  mvoff  u32 row-offsets into the MV value stream (MV columns only)

A buffer written with a codec (table config `compressionConfigs`) is a
PTCC container (segment/compression.py), and its entry in the buffer map
is [offset, size, codec] instead of [offset, size].
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

FORMAT_VERSION = 1
DATA_FILE = "data.bin"
METADATA_FILE = "metadata.json"


@dataclass
class ColumnMetadata:
    name: str
    data_type: str              # DataType.value
    field_type: str             # FieldType.value
    encoding: str               # "DICT" | "RAW" | "CLP"
    single_value: bool = True
    cardinality: int = 0
    bits_per_value: int = 0
    min_value: Optional[object] = None
    max_value: Optional[object] = None
    is_sorted: bool = False
    has_nulls: bool = False
    total_number_of_entries: int = 0   # == num_docs for SV; total MV values for MV
    max_number_of_multi_values: int = 0
    # partition stamping (reference ColumnPartitionMetadata: function name,
    # numPartitions, and the SET of partition ids observed in this segment)
    partition_function: Optional[str] = None
    partition_id: Optional[int] = None  # singleton convenience when len(partitions)==1
    num_partitions: Optional[int] = None
    partitions: Optional[list] = None

    def to_json(self) -> dict:
        d = dict(self.__dict__)
        for k in ("min_value", "max_value"):
            v = d[k]
            if isinstance(v, (np.integer,)):
                d[k] = int(v)
            elif isinstance(v, (np.floating,)):
                d[k] = float(v)
            elif isinstance(v, bytes):
                d[k] = v.hex()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ColumnMetadata":
        m = cls(**d)
        if m.data_type == "BYTES":
            for k in ("min_value", "max_value"):
                v = getattr(m, k)
                if isinstance(v, str):
                    setattr(m, k, bytes.fromhex(v))
        return m


def partition_push_metadata(segment_dir) -> dict:
    """{"partitions": {col: [ids]}} for partition-stamped columns of a
    built segment directory, or {}: a realtime commit's DONE record carries
    it (realtime/manager.py), so the MSE dispatcher can place
    partition-aligned (colocated) workers next to their segments
    (reference: SegmentZKMetadata's partitionMetadata feeding the broker's
    TablePartitionInfo)."""
    meta_path = Path(segment_dir) / METADATA_FILE
    if not meta_path.exists():
        return {}
    meta = SegmentMetadata.from_json(json.loads(meta_path.read_text()))
    out = {}
    for col, m in meta.columns.items():
        if m.partition_function and m.partitions is not None \
                and m.num_partitions:
            # function + count travel with the ids so consumers can reject
            # stamps that predate a segmentPartitionConfig change
            out[col] = {"functionName": m.partition_function,
                        "numPartitions": int(m.num_partitions),
                        "partitions": [int(p) for p in m.partitions]}
    return {"partitions": out} if out else {}


@dataclass
class SegmentMetadata:
    segment_name: str
    table_name: str
    num_docs: int
    columns: dict[str, ColumnMetadata] = field(default_factory=dict)
    # name -> [offset, size], or [offset, size, codec] for a PTCC container
    buffers: dict[str, list] = field(default_factory=dict)
    time_column: Optional[str] = None
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    format_version: int = FORMAT_VERSION
    crc: Optional[str] = None
    # integrity fingerprints finer than the whole-segment crc: per-buffer
    # crc32 of the bytes as written (compressed form for PTCC buffers) and
    # per-column crc32 chained over that column's buffers in write order —
    # the loader verifies on load and names the damaged column(s)
    buffer_crcs: dict = field(default_factory=dict)   # buffer name -> crc hex
    column_crcs: dict = field(default_factory=dict)   # column name -> crc hex
    creation_time_ms: int = 0
    star_trees: list = field(default_factory=list)  # build_star_tree meta dicts
    # ingestion-order metadata (builder._compute_sort_order): longest
    # column chain whose dict ids are LEXICOGRAPHICALLY nondecreasing over
    # the rows — any prefix of it qualifies as presorted composite group
    # keys (engine/plan.py keys_presorted)
    sort_order: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "segmentName": self.segment_name,
            "tableName": self.table_name,
            "numDocs": self.num_docs,
            "formatVersion": self.format_version,
            "timeColumn": self.time_column,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "crc": self.crc,
            "bufferCrcs": self.buffer_crcs,
            "columnCrcs": self.column_crcs,
            "creationTimeMs": self.creation_time_ms,
            "columns": {k: v.to_json() for k, v in self.columns.items()},
            "buffers": self.buffers,
            "starTrees": self.star_trees,
            "sortOrder": self.sort_order,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentMetadata":
        return cls(
            segment_name=d["segmentName"],
            table_name=d["tableName"],
            num_docs=d["numDocs"],
            format_version=d.get("formatVersion", FORMAT_VERSION),
            time_column=d.get("timeColumn"),
            start_time=d.get("startTime"),
            end_time=d.get("endTime"),
            crc=d.get("crc"),
            buffer_crcs=d.get("bufferCrcs", {}),
            column_crcs=d.get("columnCrcs", {}),
            creation_time_ms=d.get("creationTimeMs", 0),
            columns={k: ColumnMetadata.from_json(v) for k, v in d.get("columns", {}).items()},
            buffers=d.get("buffers", {}),
            star_trees=d.get("starTrees", []),
            sort_order=d.get("sortOrder", []),
        )


class SegmentWriter:
    """Accumulates named buffers and writes data.bin + metadata.json."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self._buffers: list[tuple[str, bytes]] = []
        # buffer name -> codec, applied at write() so peek_buffer and the
        # index builders always read uncompressed bytes
        self.compress_on_write: dict[str, str] = {}

    def add_buffer(self, name: str, data: bytes | np.ndarray,
                   codec: Optional[str] = None) -> None:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self._buffers.append((name, data))
        if codec and codec.upper() != "PASS_THROUGH":
            self.compress_on_write[name] = codec.upper()

    def buffer_names(self) -> set[str]:
        return {name for name, _ in self._buffers}

    def peek_buffer(self, name: str) -> np.ndarray:
        """Re-read an already-added buffer (the sort-order scan derives from
        the forward index without keeping a second copy of the column)."""
        for n, data in self._buffers:
            if n == name:
                return np.frombuffer(data, dtype=np.uint8)
        raise KeyError(name)

    def write(self, metadata: SegmentMetadata) -> None:
        import zlib

        from .compression import compress_buffer

        self.directory.mkdir(parents=True, exist_ok=True)
        offset = 0
        crc = 0
        col_crcs: dict[str, int] = {}
        columns = sorted(metadata.columns, key=len, reverse=True)
        with open(self.directory / DATA_FILE, "wb") as f:
            for name, data in self._buffers:
                codec = self.compress_on_write.get(name)
                if codec:
                    data = compress_buffer(data, codec)
                    metadata.buffers[name] = [offset, len(data), codec]
                else:
                    metadata.buffers[name] = [offset, len(data)]
                f.write(data)
                metadata.buffer_crcs[name] = format(zlib.crc32(data), "08x")
                # chain this buffer into its owning column's checksum
                # (buffer names are "<column>.<kind>"; longest match wins
                # for column names that themselves contain dots)
                owner = next((c for c in columns
                              if name == c or name.startswith(c + ".")), None)
                if owner is not None:
                    col_crcs[owner] = zlib.crc32(data, col_crcs.get(owner, 0))
                crc = zlib.crc32(data, crc)
                offset += len(data)
        metadata.crc = format(crc, "08x")
        metadata.column_crcs = {c: format(v, "08x")
                                for c, v in col_crcs.items()}
        with open(self.directory / METADATA_FILE, "w") as f:
            json.dump(metadata.to_json(), f, indent=1, default=str)


def read_metadata(directory: str | Path) -> SegmentMetadata:
    with open(Path(directory) / METADATA_FILE) as f:
        return SegmentMetadata.from_json(json.load(f))
