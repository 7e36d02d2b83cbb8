"""Streaming segment-writer sink, the Flink connector analogue (the port of
pinot_tpu/connectors/sink.py).

Reference: pinot-connectors/pinot-flink-connector — FlinkSegmentWriter
buffers rows per parallel sink instance, cuts a segment every
``segmentFlushMaxNumRecords`` rows (or on checkpoint/close), names it with
the sink's partition id + a monotonically increasing sequence, and pushes
it via the segment uploader. The TPU-native rebuild keeps that contract —
row-at-a-time ``collect()``, threshold/explicit ``flush()``, push-on-close
— over this repo's transform pipeline + two-pass SegmentBuilder, so any
record-stream framework (a Flink DataStream sink, a Beam DoFn, a plain
loop over a queue) can land rows as query-ready segments.
"""

from __future__ import annotations

from typing import Mapping, Optional

from ..ingestion.batch import upload_segment_from_rows
from ..ingestion.transform import build_transform_pipeline
from ..spi.data_types import Schema
from ..spi.table_config import TableConfig


class StreamingSegmentWriter:
    """Buffer rows → segment directories → (optional) controller push.

    One writer per parallel sink instance; ``partition_id`` disambiguates
    segment names across instances exactly like the Flink writer's
    indexOfSubtask (reference: FlinkSegmentWriter.init(...,
    indexOfSubtask)). Not thread-safe — one owner per instance, matching
    the reference's per-subtask writer.
    """

    def __init__(self, schema: Schema, out_dir_uri: str,
                 table_config: Optional[TableConfig] = None,
                 controller=None, table_name_with_type: Optional[str] = None,
                 partition_id: int = 0,
                 flush_max_rows: int = 500_000,
                 time_column: Optional[str] = None,
                 start_seq: Optional[int] = None):
        self.schema = schema
        self.table_config = table_config or TableConfig(
            table_name=schema.schema_name)
        self.out_dir_uri = out_dir_uri.rstrip("/")
        self.controller = controller
        self.table = table_name_with_type or f"{schema.schema_name}_OFFLINE"
        self.partition_id = partition_id
        self.flush_max_rows = flush_max_rows
        self.time_column = time_column
        self._pipeline = build_transform_pipeline(self.schema,
                                                  self.table_config)
        self._rows: list[dict] = []
        # a restarted pipeline must not reuse segment names (add_segment
        # overwrites metadata — the first run's rows would silently
        # vanish). The Flink writer recovers its sequence from checkpoint
        # state; here it re-seeds past the table's registered segments for
        # this partition, or from an explicit start_seq.
        if start_seq is not None:
            self._seq = start_seq
        else:
            self._seq = 0
            if controller is not None:
                prefix = f"{schema.schema_name}_{partition_id}_"
                for seg in controller.store.children(
                        f"/SEGMENTS/{self.table}"):
                    if seg.startswith(prefix):
                        try:
                            self._seq = max(self._seq,
                                            int(seg[len(prefix):]) + 1)
                        except ValueError:
                            pass
        self._closed = False
        self.segments: list[str] = []  # pushed/built segment URIs
        self.rows_filtered = 0

    def collect(self, row: Mapping) -> None:
        """Add one record; cuts a segment when the buffer hits the
        threshold (reference: FlinkSegmentWriter.collect)."""
        if self._closed:
            raise RuntimeError("writer is closed")
        out = self._pipeline.transform(dict(row))
        if out is None:
            self.rows_filtered += 1
            return
        self._rows.append(out)
        if len(self._rows) >= self.flush_max_rows:
            self.flush()

    def flush(self) -> Optional[str]:
        """Build + push the buffered rows as one segment; returns its URI
        (None if the buffer was empty). Reference: flush() on
        checkpoint/threshold."""
        if not self._rows:
            return None
        name = (f"{self.schema.schema_name}_{self.partition_id}"
                f"_{self._seq}")
        self._seq += 1
        out_uri, partitions = upload_segment_from_rows(
            self.schema, self.table_config, name, self._rows,
            self.out_dir_uri)
        if self.controller is not None:
            meta = {"location": out_uri, "numDocs": len(self._rows)}
            if partitions:
                meta["partitions"] = partitions
            if self.time_column:
                tv = [r[self.time_column] for r in self._rows
                      if r.get(self.time_column) is not None]
                if tv:
                    meta["startTimeMs"] = int(min(tv))
                    meta["endTimeMs"] = int(max(tv))
            self.controller.add_segment(self.table, name, meta)
        self.segments.append(out_uri)
        self._rows = []
        return out_uri

    def close(self) -> list[str]:
        """Flush the tail and seal the writer; returns every segment URI
        this instance produced."""
        if not self._closed:
            self.flush()
            self._closed = True
        return self.segments

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        return False
