"""The port's plugin loader and PinotFS plugins against the JAX package's.

The cases of tests/test_plugins_fs.py (and the file-system cases of
tests/test_batch_ingestion.py), run through both packages: the same
sequence of operations on each package's LocalPinotFS, S3PinotFS (over one
fake boto3 client each), GcsPinotFS and AdlsPinotFS (over fake SDK clients
behind each package's own adapter) and HdfsPinotFS (over pyarrow's
LocalFileSystem) must give the same results and raise the same error
types; `resolve` / `load_class` must find the same plugins (each in its
own package) and fail with the same errors. A tarred segment in an
`s3://` deep store loads on a port server, which answers the JAX server's
rows.
"""

from __future__ import annotations

import importlib.util
import tarfile
from pathlib import Path

import numpy as np
import pytest

import pinot_tpu.plugins.filesystem.adls as jadls
import pinot_tpu.plugins.filesystem.gcs as jgcs
import pinot_tpu.plugins.filesystem.s3 as js3
import pinot_tpu.spi.filesystem as jfs
import pinot_tpu.spi.plugins as jplugins
import pinot_tpu_torch.plugins.filesystem.adls as padls
import pinot_tpu_torch.plugins.filesystem.gcs as pgcs
import pinot_tpu_torch.plugins.filesystem.s3 as ps3
import pinot_tpu_torch.spi.filesystem as pfs
import pinot_tpu_torch.spi.plugins as pplugins

ROOT = Path(__file__).resolve().parent.parent

BOTH = {"port": (pfs, ps3, pgcs, padls, pplugins),
        "jax": (jfs, js3, jgcs, jadls, jplugins)}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_s3", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the boto3 client surface S3PinotFS uses, over a dict: the smoke's own
FakeS3Client = _smoke().MemS3Client


class _Blob:
    def __init__(self, store, bucket, name):
        self.store, self.bucket, self.name = store, bucket, name

    @property
    def size(self):
        return len(self.store[(self.bucket, self.name)])

    # google-cloud-storage Blob
    def upload_from_string(self, data):
        self.store[(self.bucket, self.name)] = bytes(data)

    def download_as_bytes(self):
        return self.store[(self.bucket, self.name)]

    def delete(self):
        self.store.pop((self.bucket, self.name), None)

    # azure BlobClient
    @property
    def url(self):
        return f"mem://{self.bucket}/{self.name}"

    def upload_blob(self, data, overwrite=True):
        self.upload_from_string(data)

    def download_blob(self):
        data = self.download_as_bytes()
        return type("D", (), {"readall": lambda _self: data})()

    def get_blob_properties(self):
        if (self.bucket, self.name) not in self.store:
            raise KeyError(self.name)
        return self

    def delete_blob(self):
        self.delete()

    def start_copy_from_url(self, url):
        bucket, name = url[len("mem://"):].split("/", 1)
        self.store[(self.bucket, self.name)] = self.store[(bucket, name)]


class _Bucket:
    def __init__(self, store, name):
        self.store, self.name = store, name

    def blob(self, key):
        return _Blob(self.store, self.name, key)

    def get_blob(self, key):
        return self.blob(key) if (self.name, key) in self.store else None

    def copy_blob(self, blob, dst_bucket, key):
        self.store[(dst_bucket.name, key)] = self.store[(blob.bucket,
                                                         blob.name)]


class FakeGcsClient:
    """The google-cloud-storage Client surface the GCS adapter uses."""

    def __init__(self):
        self.store: dict[tuple[str, str], bytes] = {}

    def bucket(self, name):
        return _Bucket(self.store, name)

    def list_blobs(self, bucket, prefix="", page_token=None):
        return [_Blob(self.store, b, k) for b, k in sorted(self.store)
                if b == bucket and k.startswith(prefix)]


class FakeAzureService:
    """The azure-storage-blob BlobServiceClient surface the ADLS adapter
    uses."""

    def __init__(self):
        self.store: dict[tuple[str, str], bytes] = {}

    def get_blob_client(self, container, blob):
        return _Blob(self.store, container, blob)

    def get_container_client(self, container):
        store = self.store

        class _C:
            def list_blobs(self, name_starts_with=""):
                return [_Blob(store, b, k) for b, k in sorted(store)
                        if b == container and k.startswith(name_starts_with)]

        return _C()


def _run(fs, ops, base="", strip=""):
    """Apply `ops` to `fs` (a "~/" path argument is under `base`): each
    result, or the error's type name, with the local base path `strip`
    masked out of strings."""

    def norm(v):
        if isinstance(v, str):
            return v.replace(strip, "<base>") if strip else v
        if isinstance(v, list):
            return [norm(x) for x in v]
        if isinstance(v, bytes):
            return v
        return v

    out = []
    for op, *args in ops:
        args = [base + a[1:] if isinstance(a, str) and a.startswith("~/")
                else a for a in args]
        try:
            res = getattr(fs, op)(*args)
            if op == "open":
                res = res.read()
            out.append((op, norm(res)))
        except Exception as e:  # the error type is the compared value
            out.append((op, "raises " + type(e).__name__))
    return out


OBJECT_OPS = [
    ("exists", "~/store/t/seg.bin"), ("is_directory", "~/store/t"),
    ("mkdir", "~/store/empty"), ("is_directory", "~/store/empty"),
    ("list_files", "~/store"), ("list_files", "~/store", True),
    ("length", "~/store/t/seg.bin"), ("open", "~/store/t/seg.bin"),
    ("copy", "~/store/t/seg.bin", "~/store/t/seg2.bin"),
    ("move", "~/store/t/seg2.bin", "~/other/seg2.bin"),
    ("exists", "~/store/t/seg2.bin"), ("exists", "~/other/seg2.bin"),
    ("move", "~/other/seg2.bin", "~/store/t/seg.bin", False),
    ("copy", "~/store/t", "~/backup"), ("open", "~/backup/seg.bin"),
    ("list_files", "~/backup", True), ("delete", "~/store/t"),
    ("delete", "~/store/t", True), ("exists", "~/store/t/seg.bin"),
    ("delete", "~/nothing"), ("length", "~/nothing"), ("open", "~/nothing"),
    ("is_directory", "~/store/x"), ("list_files", "~/nothing"),
]


def _object_store_ops(pkg, scheme, fs_cls, client, tmp_path):
    fs = fs_cls(client=client)
    local = tmp_path / f"{pkg}_{scheme}.bin"
    local.write_bytes(b"columnar bytes")
    fs.copy_from_local(str(local), f"{scheme}://deep/store/t/seg.bin")
    got = _run(fs, OBJECT_OPS, base=f"{scheme}://deep")
    back = tmp_path / f"{pkg}_{scheme}_back.bin"
    fs.copy_to_local(f"{scheme}://deep/backup/seg.bin", str(back))
    got.append(("copy_to_local", back.read_bytes()))
    return got


@pytest.mark.parametrize("scheme", ["s3", "gs", "adl2"])
def test_object_store_ops_equal_jax(scheme, tmp_path):
    runs = {}
    for pkg, (_fs, s3, gcs, adls, _pl) in BOTH.items():
        if scheme == "s3":
            fs_cls, client = s3.S3PinotFS, FakeS3Client()
        elif scheme == "gs":
            fs_cls, client = gcs.GcsPinotFS, gcs._GcsClientAdapter(
                FakeGcsClient())
        else:
            fs_cls, client = adls.AdlsPinotFS, adls._AdlsClientAdapter(
                FakeAzureService())
        runs[pkg] = _object_store_ops(pkg, scheme, fs_cls, client, tmp_path)
    assert runs["port"] == runs["jax"]
    # the store's own answers, as tests/test_plugins_fs.py pins them
    got = dict(runs["port"][:8])
    assert got["length"] == 14 and got["open"] == b"columnar bytes"
    assert ("delete", "raises OSError") in runs["port"]
    assert runs["port"][-1] == ("copy_to_local", b"columnar bytes")


LOCAL_OPS = [
    ("mkdir", "~/x"), ("exists", "~/x/f.txt"), ("length", "~/x/f.txt"),
    ("list_files", "~/x"), ("copy", "~/x/f.txt", "~/x/g.txt"),
    ("move", "~/x/g.txt", "~/h.txt"), ("exists", "~/h.txt"),
    ("exists", "~/x/g.txt"), ("move", "~/h.txt", "~/x/f.txt", False),
    ("copy", "~/x", "~/y"), ("list_files", "~/y", True), ("open", "~/y/f.txt"),
    ("is_directory", "~/y"), ("is_directory", "~/y/f.txt"),
    ("delete", "~/x"), ("delete", "~/x", True), ("exists", "~/x"),
    ("delete", "~/x"), ("length", "~/nothing"), ("open", "~/nothing"),
    ("list_files", "~/nothing"),
]


def test_local_fs_ops_equal_jax(tmp_path):
    runs = {}
    for pkg, (fsmod, *_rest) in BOTH.items():
        base = tmp_path / pkg
        base.mkdir()
        fs = fsmod.get_fs(str(base))
        assert isinstance(fs, fsmod.LocalPinotFS)
        ops = LOCAL_OPS[:1] + [("copy_from_local", str(tmp_path / "f.txt"),
                                str(base / "x" / "f.txt"))] + LOCAL_OPS[1:]
        (tmp_path / "f.txt").write_text("hi")
        runs[pkg] = _run(fs, ops, base=str(base), strip=str(base))
        # a file:// URI reaches the same file system
        assert fsmod.get_fs(f"file://{base}").exists(f"file://{base}/y")
    assert runs["port"] == runs["jax"]
    assert ("length", 2) in runs["port"]
    assert ("delete", "raises OSError") in runs["port"]


def test_hdfs_ops_equal_jax(tmp_path):
    from pyarrow import fs as pafs

    from pinot_tpu.plugins.filesystem.hdfs import HdfsPinotFS as JHdfs
    from pinot_tpu_torch.plugins.filesystem.hdfs import HdfsPinotFS as PHdfs

    ops = [("mkdir", "~/dir"), ("is_directory", "~/dir"),
           ("exists", "~/dir/f.txt"), ("length", "~/dir/f.txt"),
           ("open", "~/dir/f.txt"), ("copy", "~/dir", "~/dir2"),
           ("open", "~/dir2/f.txt"), ("move", "~/dir2/f.txt", "~/dir2/g.txt"),
           ("exists", "~/dir2/f.txt"), ("list_files", "~/dir2"),
           ("move", "~/dir2/g.txt", "~/dir/f.txt", False),
           ("delete", "~/dir2"), ("delete", "~/dir2", True),
           ("exists", "~/dir2"), ("delete", "~/dir2")]
    (tmp_path / "f.txt").write_bytes(b"hello")
    runs = {}
    for pkg, cls in (("port", PHdfs), ("jax", JHdfs)):
        base = str(tmp_path / f"hdfs_{pkg}")
        h = cls(filesystem=pafs.LocalFileSystem())
        h.mkdir(base + "/dir")
        h.copy_from_local(str(tmp_path / "f.txt"), base + "/dir/f.txt")
        runs[pkg] = _run(h, ops, base=base, strip=base)
    assert runs["port"] == runs["jax"]
    assert ("open", b"hello") in runs["port"]
    assert ("delete", "raises OSError") in runs["port"]


@pytest.mark.parametrize("pkg", list(BOTH))
def test_unknown_scheme_and_missing_sdk_raise_as_jax(pkg, monkeypatch):
    fsmod, s3, gcs, adls, _ = BOTH[pkg]
    with pytest.raises(ValueError, match="no PinotFS"):
        fsmod.get_fs("zz9://bucket/key")
    # boto3 and azure are absent here and on the card's machine: each
    # default client factory raises its ImportError (the GCS default builds
    # a real client where its SDK is installed, so it is not called here)
    for scheme, lib in (("s3", "boto3"), ("abfs", "azure")):
        with pytest.raises(ImportError, match=lib):
            fsmod.get_fs(f"{scheme}://bucket/key")
    # a replaced factory is what get_fs builds
    client = FakeS3Client()
    monkeypatch.setattr(s3.S3PinotFS, "client_factory",
                        staticmethod(lambda: client))
    fs = fsmod.get_fs("s3://bucket/x")
    assert isinstance(fs, s3.S3PinotFS) and fs._client is client


def test_hdfs_without_a_cluster_raises_as_jax():
    from pinot_tpu.plugins.filesystem.hdfs import HdfsPinotFS as JHdfs
    from pinot_tpu_torch.plugins.filesystem.hdfs import HdfsPinotFS as PHdfs

    errors = []
    for cls in (PHdfs, JHdfs):
        try:
            cls()
        except Exception as e:  # the error type is the compared value
            errors.append(type(e).__name__)
    assert len(errors) == 2 and errors[0] == errors[1]


def _resolutions(plugins):
    out = []
    for kind, name in (("filesystem", "s3"), ("filesystem", "gcs"),
                       ("filesystem", "hdfs"), ("filesystem", "adls"),
                       ("filesystem", "zz9"), ("inputformat", "csv"),
                       ("inputformat", "avro"), ("inputformat", "thrift"),
                       ("inputformat", "protobuf"), ("inputformat", "clp"),
                       ("inputformat", "nope"), ("nope", "x"),
                       ("stream", "inmemory"),
                       ("stream", "definitely_missing")):
        try:
            found = plugins.resolve(kind, name)
            out.append((kind, name, found.__module__.split(".", 1)[1],
                        found.__qualname__))
        except Exception as e:  # the error type is the compared value
            out.append((kind, name, type(e).__name__))
    return out


def test_resolve_and_load_class_equal_jax():
    got, want = _resolutions(pplugins), _resolutions(jplugins)
    assert got == want
    assert ("nope", "x", "ValueError") in got
    assert ("stream", "definitely_missing", "ValueError") in got
    # each package resolves into itself
    assert pplugins.resolve("filesystem", "s3") is ps3.S3PinotFS
    assert jplugins.resolve("filesystem", "s3") is js3.S3PinotFS
    with pytest.raises(ValueError, match="unknown plugin kind"):
        pplugins.resolve("nope", "x")
    with pytest.raises(ValueError, match="no stream plugin"):
        pplugins.resolve("stream", "definitely_missing")
    for path in ("pinot_tpu_torch.plugins.filesystem.s3:S3PinotFS",
                 "pinot_tpu_torch.plugins.filesystem.s3.S3PinotFS"):
        assert pplugins.load_class(path) is ps3.S3PinotFS
    errors = []
    for plugins, pkg in ((pplugins, "pinot_tpu_torch"), (jplugins, "pinot_tpu")):
        row = []
        for path in (f"{pkg}.plugins.filesystem.s3:Missing", "NoDots",
                     f"{pkg}.plugins.filesystem.nosuch:X"):
            try:
                plugins.load_class(path)
            except Exception as e:  # the error type is the compared value
                row.append(type(e).__name__)
        errors.append(row)
    assert errors[0] == errors[1] == ["ValueError", "ValueError",
                                      "ModuleNotFoundError"]
    inst = pplugins.create_instance(
        "pinot_tpu_torch.plugins.filesystem.s3:S3PinotFS", FakeS3Client())
    assert isinstance(inst, ps3.S3PinotFS)


# -- an s3:// deep store feeding a port server ---------------------------------


def test_s3_tarred_segment_loads_on_a_port_server(tmp_path, monkeypatch):
    """A tarred segment in an `s3://` deep store: the port server fetches
    it through `get_fs` (the tier's untar), loads it and answers the JAX
    server's rows over the same tarball."""
    from pinot_tpu.cluster import Broker as JBroker
    from pinot_tpu.cluster import ClusterController as JController
    from pinot_tpu.cluster import PropertyStore as JStore
    from pinot_tpu.cluster import ServerInstance as JServer
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema

    rng = np.random.default_rng(7)
    schema = Schema.build("t", dimensions=[("d", "STRING")],
                          metrics=[("m", "INT")])
    cols = {"d": np.asarray(["a", "b", "c"], dtype=object)[
                rng.integers(0, 3, 300)],
            "m": rng.integers(0, 1000, 300).astype(np.int32)}
    SegmentBuilder(schema, segment_name="seg0").build(cols, tmp_path / "seg0")
    tarred = tmp_path / "seg0.tar.gz"
    with tarfile.open(tarred, "w:gz") as tf:
        tf.add(tmp_path / "seg0", arcname="seg0")
    uri = "s3://deep/t/seg0.tar.gz"
    for s3 in (ps3, js3):
        client = FakeS3Client()
        monkeypatch.setattr(s3.S3PinotFS, "client_factory",
                            staticmethod(lambda c=client: c))
        s3.S3PinotFS().copy_from_local(str(tarred), uri)
    sql = "SELECT d, SUM(m), COUNT(*) FROM t GROUP BY d ORDER BY d"
    rows = {}
    for pkg, (store_cls, ctl_cls, srv, brk) in {
            "port": (PropertyStore, ClusterController,
                     lambda st: ServerInstance(st, "Server_0", device="cpu"),
                     Broker),
            "jax": (JStore, JController,
                    lambda st: JServer(st, "Server_0", backend="host"),
                    JBroker)}.items():
        store = store_cls()
        ctl = ctl_cls(store)
        server = srv(store)
        server.start()
        broker = brk(store)
        try:
            ctl.add_schema(schema.to_json())
            table = ctl.create_table({"tableName": "t", "replication": 1})
            ctl.add_segment(table, "seg0", {"location": uri, "numDocs": 300})
            resp = broker.execute_sql(sql)
            assert not resp.exceptions, (pkg, resp.exceptions)
            rows[pkg] = [list(r) for r in resp.result_table.rows]
        finally:
            server.stop()
            if hasattr(broker, "close"):
                broker.close()
    assert rows["port"] == rows["jax"]
    assert sum(r[2] for r in rows["port"]) == 300
