"""The port's package boundary.

pinot_tpu_torch and chip_smoke.py import torch, numpy and the standard
library: never jax and never a module of the JAX package pinot_tpu, not
even a pure-numpy one. Its entry points run on the card unless the caller
asks for the CPU, and with no usable card they raise instead of running on
the CPU.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment.device_cache import SegmentDeviceView

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pinot_tpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_files():
    files = sorted((ROOT / "pinot_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_are_found():
    names = {p.name for p in _port_files()}
    assert {"chip_smoke.py", "kernels.py", "fused_groupby.py",
            "mxu_groupby.py", "query_executor.py", "transforms.py",
            "dim_tables.py", "coalesce.py", "explain.py",
            "trace.py", "broker.py", "server.py", "transport.py",
            "datatable.py", "scheduler.py", "doctor.py", "distributed.py",
            "plan_serde.py", "remote_store.py", "plugins.py",
            "filesystem.py", "s3.py", "gcs.py", "adls.py", "hdfs.py",
            "readers.py", "avro.py", "thrift.py", "protobuf.py",
            "clplog.py", "batch.py", "sink.py", "arrow_reader.py",
            "dataframe.py", "client.py"} <= names


# every kind and every name the port ships, resolved through the plugin
# loader, whose module paths are strings built at run time (a dict, an
# f-string), which the import scan above cannot see
RESOLVE_EVERY_PLUGIN = """
import sys
import chip_smoke  # noqa: F401
from pinot_tpu_torch.spi import filesystem, plugins
from pinot_tpu_torch.spi.stream import StreamConfig, get_stream_consumer_factory
for scheme in ("s3", "gs", "abfs", "hdfs"):
    try:
        plugins.resolve("filesystem",
                        filesystem._SCHEME_MODULES.get(scheme, scheme))
    except ValueError:  # adls registers its schemes, not its module name
        pass
    assert scheme in filesystem._FS_REGISTRY, scheme
from pinot_tpu_torch.plugins.inputformat import readers
for name in ("csv", "json", "jsonl", "parquet", "orc", "avro", "thrift",
             "protobuf", "proto", "clplog", "clp"):
    assert plugins.resolve("inputformat", name) is not None, name
assert sorted(readers._READERS) == sorted(
    ("csv", "json", "jsonl", "parquet", "orc", "avro", "thrift", "proto",
     "protobuf", "clplog", "clp"))
for name in ("inmemory", "kafka", "kinesis", "pulsar"):
    assert plugins.resolve("stream", name) is not None, name
for kind, name in (("stream", "zz9"), ("filesystem", "zz9"),
                   ("inputformat", "nope")):
    try:
        plugins.resolve(kind, name)
    except ValueError:
        pass
    else:
        raise AssertionError((kind, name))
try:
    get_stream_consumer_factory(StreamConfig(stream_type="zz9"))
except ValueError as e:
    assert "unknown streamType" in str(e)
else:
    raise AssertionError("zz9")
from pinot_tpu_torch.spi.stream import get_decoder
assert type(get_decoder(StreamConfig(decoder="confluentavro"))).__name__ \
    == "ConfluentAvroDecoder"
import pinot_tpu_torch.client, pinot_tpu_torch.connectors  # noqa: E401,F401
import pinot_tpu_torch.dbapi, pinot_tpu_torch.minion  # noqa: E401,F401
import pinot_tpu_torch.ingestion.batch  # noqa: F401
import pinot_tpu_torch.timeseries  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
print("FORBIDDEN", bad)
"""


def test_plugins_resolve_without_the_jax_package():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", RESOLVE_EVERY_PLUGIN],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    # whatever this machine has, a CUDA-less runtime must refuse the
    # default device rather than carry on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        QueryExecutor()
    with pytest.raises(RuntimeError):
        QueryExecutor(device="cuda")


def test_cuda_needs_compute_capability_9_0(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        QueryExecutor(device="cuda")


def test_cpu_is_asked_for_explicitly():
    assert QueryExecutor(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        QueryExecutor(device="meta")


def test_narrow_planes_default_by_device():
    class _Seg:
        num_docs = 10

    assert SegmentDeviceView(_Seg(), "cpu").packed is False
    assert SegmentDeviceView(_Seg(), "cuda").packed is True
    assert SegmentDeviceView(_Seg(), "cpu", packed=True).packed is True
