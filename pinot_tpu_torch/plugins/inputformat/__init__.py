"""Input-format record readers (the port of pinot_tpu/plugins/inputformat/).

Reference analogue: pinot-plugins/pinot-input-format/ — RecordReader SPI
(pinot-spi/.../spi/data/readers/RecordReader.java) with avro, csv, json,
orc, parquet, protobuf, thrift, clp-log impls. Here: csv/json native,
parquet+orc via pyarrow, avro via a self-contained container-file decoder
(plugins/inputformat/avro.py), clp-log via the repo's CLP tokenizer
(plugins/inputformat/clplog.py)."""

from .readers import (
    RecordReader,
    create_record_reader,
    register_record_reader,
)

__all__ = ["RecordReader", "create_record_reader", "register_record_reader"]
