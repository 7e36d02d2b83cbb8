"""pandas / pyarrow connector: bulk read + bulk write (the port of
pinot_tpu/connectors/dataframe.py).

Reference analogue: pinot-connectors/pinot-spark-3-connector — the read
side runs queries against the cluster and hands back a dataframe; the
write side is the batch segment writer (Spark's PinotDataWriter building
segments from partitions and pushing them to the controller). pandas and
pyarrow are the dataframe currency of the Python data stack, so the
connector speaks both.

    import pinot_tpu_torch.connectors as pc
    tbl = pc.read_sql("SELECT * FROM stats LIMIT 100000", broker_url=url)
    df  = pc.read_sql_pandas("SELECT ...", connection=conn)
    pc.write_dataframe(df, table_name="stats", controller=ctl,
                       out_dir="/deep/store", rows_per_segment=1_000_000)
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..spi.data_types import Schema

_ARROW_TYPES = {
    "INT": "int32", "LONG": "int64", "FLOAT": "float32", "DOUBLE": "float64",
    "BOOLEAN": "bool_", "TIMESTAMP": "int64", "STRING": "string",
    "JSON": "string", "BYTES": "binary",
}


# -- read side -----------------------------------------------------------------


def read_sql(sql: str, broker_url: Optional[str] = None, connection=None,
             auth=None, token: Optional[str] = None):
    """Run a query and return a ``pyarrow.Table`` (the Spark connector's
    read path: query → dataframe)."""
    import pyarrow as pa

    rs = _result_set(sql, broker_url, connection, auth, token)
    if rs.rows:
        cols = dict(zip(rs.column_names, map(list, zip(*rs.rows))))
    else:
        cols = {name: [] for name in rs.column_names}
    arrays, names = [], []
    for name, ctype in zip(rs.column_names, rs.column_types):
        pa_type = getattr(pa, _ARROW_TYPES.get(ctype, "string"), pa.string)()
        try:
            arrays.append(pa.array(cols[name], type=pa_type))
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            arrays.append(pa.array(cols[name]))  # let arrow infer
        names.append(name)
    return pa.table(dict(zip(names, arrays)))


def read_sql_pandas(sql: str, broker_url: Optional[str] = None,
                    connection=None, auth=None, token: Optional[str] = None):
    return read_sql(sql, broker_url, connection, auth, token).to_pandas()


def scan_table(broker, table: str, columns: list[str],
               num_readers: int = 4, where: Optional[str] = None):
    """Segment-parallel scan: yields one ``pyarrow.RecordBatch`` per
    segment, fetched concurrently from the hosting servers.

    Reference analogue: the Spark connector's partitioned read plan —
    one Spark InputPartition per Pinot segment, each reading via the
    server's streaming endpoint (pinot-spark-3-connector
    PinotScan/PinotInputPartition). Here the embedded ``Broker`` supplies
    the routing table and per-segment selections run through the normal
    scatter plane, ``num_readers`` at a time; downstream engines consume
    the batches independently (the dataframe stack's executor pool plays
    the role of Spark's)."""
    import concurrent.futures as cf

    import pyarrow as pa

    routing = broker.routing_table(table)
    cols = ", ".join(columns)
    cond = f" WHERE {where}" if where else ""
    raw = table.rsplit("_", 1)[0]

    def fetch(seg):
        resp = broker.execute_sql(
            f"SELECT {cols} FROM {raw}{cond} LIMIT 1000000000",
            segments={table: [seg]})
        if resp.exceptions:
            raise RuntimeError(f"segment {seg}: {resp.exceptions}")
        rt = resp.result_table
        data = {name: [r[i] for r in rt.rows]
                for i, name in enumerate(rt.schema.column_names)}
        return pa.RecordBatch.from_pydict(data)

    with cf.ThreadPoolExecutor(max_workers=num_readers) as pool:
        futs = {pool.submit(fetch, seg): seg for seg in sorted(routing)}
        for fut in cf.as_completed(futs):
            yield futs[fut], fut.result()


def _result_set(sql, broker_url, connection, auth, token):
    if connection is None:
        if broker_url is None:
            raise ValueError("pass broker_url or connection")
        from ..client import connect

        # client connections are stateless (one HTTP request per execute,
        # nothing held open) so the throwaway connection costs one object;
        # pass `connection=` to reuse credentials across many reads
        connection = connect(broker_url, auth=auth, token=token)
    return connection.execute(sql)


# -- write side ----------------------------------------------------------------


def infer_schema(df, table_name: str,
                 time_column: Optional[str] = None) -> Schema:
    """pandas/pyarrow dtypes → Schema (the Spark writer's schema mapping).
    Integer/float columns become metrics, strings/booleans dimensions, the
    named time column a date-time field."""
    if hasattr(df, "to_pandas"):  # pyarrow.Table
        df = df.to_pandas()
    dims, metrics, date_times = [], [], []
    for name in df.columns:
        kind = df[name].dtype.kind
        if name == time_column or kind == "M":
            # datetime64 columns are date-times regardless of naming; values
            # convert to epoch MILLIS at write time
            date_times.append((name, "TIMESTAMP" if kind in "iuM" else "LONG"))
        elif kind in "iu":
            metrics.append((name, "LONG" if df[name].dtype.itemsize > 4
                            else "INT"))
        elif kind == "f":
            metrics.append((name, "DOUBLE" if df[name].dtype.itemsize > 4
                            else "FLOAT"))
        elif kind == "b":
            dims.append((name, "BOOLEAN"))
        else:
            dims.append((name, "STRING"))
    return Schema.build(table_name, dimensions=dims, metrics=metrics,
                        date_times=date_times)


def write_dataframe(df, table_name: str, out_dir: str | Path,
                    schema: Optional[Schema] = None,
                    table_config=None, controller=None,
                    time_column: Optional[str] = None,
                    rows_per_segment: int = 1_000_000,
                    segment_prefix: Optional[str] = None) -> list[str]:
    """Build segment directories from a dataframe and (optionally) register
    them with a controller (reference: the Spark connector's
    PinotDataWriter → segment build → controller push). Returns the built
    segment paths."""
    from ..segment.builder import SegmentBuilder

    if hasattr(df, "to_pandas"):
        df = df.to_pandas()
    if schema is None:
        schema = infer_schema(df, table_name, time_column)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = segment_prefix or f"{table_name}"
    paths: list[str] = []
    n = len(df)
    num_segments = max(1, (n + rows_per_segment - 1) // rows_per_segment)
    for i in range(num_segments):
        part = df.iloc[i * rows_per_segment:(i + 1) * rows_per_segment]
        cols = {}
        for name in df.columns:
            v = part[name].to_numpy()
            if v.dtype.kind == "M":
                # datetime64[*] → epoch millis (TIMESTAMP's documented unit)
                v = v.astype("datetime64[ms]").astype(np.int64)
            cols[name] = v.astype(object) if v.dtype.kind == "O" else v
        seg_name = f"{prefix}_{i}"
        dest = out_dir / seg_name
        SegmentBuilder(schema, table_config=table_config,
                       segment_name=seg_name).build(cols, dest)
        paths.append(str(dest))
        if controller is not None:
            from ..segment.format import partition_push_metadata

            meta = {"location": str(dest), "numDocs": len(part)}
            meta.update(partition_push_metadata(dest))
            if time_column is not None and len(part):
                tv = cols[time_column]  # already normalized to epoch millis
                meta["startTimeMs"] = int(np.min(tv))
                meta["endTimeMs"] = int(np.max(tv))
            controller.add_segment(f"{table_name}_OFFLINE", seg_name, meta)
    return paths
