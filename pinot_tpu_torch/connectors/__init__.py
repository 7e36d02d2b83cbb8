"""External-system connectors (the port of pinot_tpu/connectors/;
reference: pinot-connectors/).

The reference ships Spark/Flink connectors — bulk read (parallel scans of
the query engine) and bulk write (build + push segments from a dataframe).
In the Python ecosystem the equivalent surfaces are pandas/pyarrow:
connectors/dataframe.py provides both directions.
"""

from .arrow_reader import (  # noqa: F401
    ScanSplit,
    plan_scan,
    read_split,
    read_table,
)
from .dataframe import (  # noqa: F401
    infer_schema,
    read_sql,
    read_sql_pandas,
    write_dataframe,
)
from .sink import StreamingSegmentWriter  # noqa: F401
