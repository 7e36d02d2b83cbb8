"""Mutable -> immutable segment conversion on commit.

The port of pinot_tpu/realtime/converter.py. Reference:
RealtimeSegmentConverter (pinot-segment-local/.../realtime/converter/):
snapshot the consuming segment's rows, sort on the configured sorted
column, and run the standard immutable build (SegmentBuilder), after which
the segment has sorted dictionaries and fixed-bit planes.
"""

from __future__ import annotations

from pathlib import Path

from ..segment.builder import SegmentBuilder
from ..segment.mutable import MutableSegment


class RealtimeSegmentConverter:
    def __init__(self, schema, table_config=None, preserve_doc_order=False):
        self.schema = schema
        self.table_config = table_config
        # upsert/dedup tables keep ingestion doc order so validity planes
        # and record locations transfer 1:1 (reference: upsert tables
        # cannot use a sorted column either)
        self.preserve_doc_order = preserve_doc_order

    def convert(self, segment: MutableSegment, out_dir: str | Path) -> Path:
        columns = segment.to_columns()
        sort_col = None
        if self.table_config is not None and not self.preserve_doc_order:
            sort_col = self.table_config.indexing.sorted_column
        if sort_col and sort_col in columns and segment.num_docs > 0:
            keys = columns[sort_col]
            order = sorted(range(len(keys)),
                           key=lambda i: (keys[i] is None, keys[i]))
            columns = {c: [v[i] for i in order] for c, v in columns.items()}
        builder = SegmentBuilder(self.schema, self.table_config,
                                 segment.segment_name)
        return builder.build(columns, out_dir)
