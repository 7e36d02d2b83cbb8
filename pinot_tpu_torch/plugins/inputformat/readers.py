"""RecordReader SPI + csv/json/parquet/orc readers (the port of
pinot_tpu/plugins/inputformat/readers.py).

Reference analogue: RecordReader (pinot-spi/.../spi/data/readers/
RecordReader.java — init/hasNext/next/rewind/close over GenericRow) and the
per-format plugins under pinot-plugins/pinot-input-format/. Rows surface as
plain dicts (the GenericRow analogue) for the ingestion transform pipeline.
"""

from __future__ import annotations

import csv
import gzip
import io
import json
from pathlib import Path
from typing import Callable, Iterator, Optional


class RecordReader:
    """Iterates a file as row dicts. Subclasses implement _iter()."""

    def __init__(self, path: str, config: Optional[dict] = None):
        self.path = path
        self.config = config or {}

    def __iter__(self) -> Iterator[dict]:
        return self._iter()

    def _iter(self) -> Iterator[dict]:
        raise NotImplementedError

    def _open_text(self):
        if str(self.path).endswith(".gz"):
            return io.TextIOWrapper(gzip.open(self.path, "rb"), encoding="utf-8")
        return open(self.path, "r", encoding="utf-8")

    def _open_binary(self):
        if str(self.path).endswith(".gz"):
            return gzip.open(self.path, "rb")
        return open(self.path, "rb")


class CsvRecordReader(RecordReader):
    """Reference: pinot-csv plugin (CSVRecordReader). config keys:
    delimiter, header (comma-separated names when the file has none),
    multiValueDelimiter (splits a cell into an MV list)."""

    def _iter(self) -> Iterator[dict]:
        delim = self.config.get("delimiter", ",")
        mv_delim = self.config.get("multiValueDelimiter")
        header = self.config.get("header")
        with self._open_text() as f:
            if header:
                names = [h.strip() for h in header.split(",")]
                reader = csv.reader(f, delimiter=delim)
            else:
                dict_reader = csv.DictReader(f, delimiter=delim)
                for row in dict_reader:
                    yield self._convert(row, mv_delim)
                return
            for vals in reader:
                yield self._convert(dict(zip(names, vals)), mv_delim)

    @staticmethod
    def _convert(row: dict, mv_delim) -> dict:
        out = {}
        for k, v in row.items():
            if v == "" or v is None:
                out[k] = None
            elif mv_delim and mv_delim in v:
                out[k] = [_auto(x) for x in v.split(mv_delim)]
            else:
                out[k] = _auto(v)
        return out


def _auto(v: str):
    """CSV cells are untyped; coerce numerics (the schema's data-type
    transformer does the authoritative coercion downstream)."""
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


class JsonRecordReader(RecordReader):
    """JSON-lines or a top-level JSON array (reference: pinot-json plugin)."""

    def _iter(self) -> Iterator[dict]:
        with self._open_text() as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                for row in json.load(f):
                    yield row
                return
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


class ParquetRecordReader(RecordReader):
    """Reference: pinot-parquet plugin; pyarrow supplies the columnar
    decode, rows surface batch-by-batch to bound memory."""

    def _iter(self) -> Iterator[dict]:
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(self.path)
        for batch in pf.iter_batches():
            for row in batch.to_pylist():
                yield row


class OrcRecordReader(RecordReader):
    """Reference: pinot-orc plugin."""

    def _iter(self) -> Iterator[dict]:
        from pyarrow import orc

        table = orc.ORCFile(self.path).read()
        for row in table.to_pylist():
            yield row


class AvroRecordReader(RecordReader):
    """Reference: pinot-avro plugin; decoding in plugins/inputformat/avro.py."""

    def _iter(self) -> Iterator[dict]:
        from .avro import read_avro_file

        with self._open_binary() as f:
            yield from read_avro_file(f)


_READERS: dict[str, Callable[..., RecordReader]] = {
    "csv": CsvRecordReader,
    "json": JsonRecordReader,
    "jsonl": JsonRecordReader,
    "parquet": ParquetRecordReader,
    "orc": OrcRecordReader,
    "avro": AvroRecordReader,
}


def register_record_reader(fmt: str, factory: Callable[..., RecordReader]) -> None:
    _READERS[fmt.lower()] = factory


def create_record_reader(path: str, fmt: Optional[str] = None,
                         config: Optional[dict] = None) -> RecordReader:
    """fmt defaults from the file extension (reference:
    RecordReaderFactory.getRecordReaderByClass / format inference)."""
    if fmt is None:
        name = Path(path).name
        for suffix in (".gz",):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        fmt = Path(name).suffix.lstrip(".").lower()
    fmt = fmt.lower()
    if fmt not in _READERS and fmt in ("proto", "protobuf", "thrift"):
        # registration-on-import, like stream plugins
        from . import protobuf, thrift  # noqa: F401
    if fmt not in _READERS and fmt in ("clplog", "clp"):
        from . import clplog  # noqa: F401
    factory = _READERS.get(fmt)
    if factory is None:
        raise ValueError(f"no record reader for format {fmt!r} "
                         f"(known: {sorted(_READERS)})")
    return factory(path, config)


from ...spi.plugins import register_kind as _register_kind  # noqa: E402

_register_kind("inputformat", lambda fmt: _READERS.get(fmt.lower()))
