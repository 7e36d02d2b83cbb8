"""S3 PinotFS, the port of pinot_tpu/plugins/filesystem/s3.py (reference: pinot-plugins/pinot-file-system/pinot-s3/
S3PinotFS.java).

Deep-store layout semantics match the reference: S3 has no real
directories, so ``mkdir`` writes a zero-byte ``<prefix>/`` marker,
``is_directory`` is "any key under the prefix", and copy/move of a
directory prefix copies every object below it.

boto3 is an OPTIONAL dependency: the default ``client_factory`` imports it
lazily; tests inject a fake with the same client surface
(put_object/get_object/delete_object/list_objects_v2/head_object/
copy_object).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Callable
from urllib.parse import urlparse

from ...spi.filesystem import PinotFS, register_fs


def _default_client_factory():
    try:
        import boto3  # type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "scheme 's3' needs the boto3 package (or inject "
            "S3PinotFS.client_factory)") from e
    return boto3.client("s3")


class S3PinotFS(PinotFS):
    client_factory: Callable = staticmethod(_default_client_factory)
    schemes: tuple = ("s3",)

    def __init__(self, client=None):
        self._client = client if client is not None else \
            type(self).client_factory()

    def _split(self, uri: str) -> tuple[str, str]:
        p = urlparse(uri)
        if p.scheme not in self.schemes:
            raise ValueError(f"not a {self.schemes[0]} uri: {uri}")
        return p.netloc, p.path.lstrip("/")

    # -- helpers -----------------------------------------------------------
    def _keys_under(self, bucket: str, prefix: str) -> list[str]:
        out: list[str] = []
        token = None
        while True:
            kwargs = {"Bucket": bucket, "Prefix": prefix}
            if token:
                kwargs["ContinuationToken"] = token
            resp = self._client.list_objects_v2(**kwargs)
            out.extend(o["Key"] for o in resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                return out
            token = resp.get("NextContinuationToken")

    def _exists_key(self, bucket: str, key: str) -> bool:
        try:
            self._client.head_object(Bucket=bucket, Key=key)
            return True
        except Exception:
            return False

    # -- PinotFS surface ---------------------------------------------------
    def mkdir(self, uri: str) -> None:
        bucket, key = self._split(uri)
        self._client.put_object(Bucket=bucket,
                                Key=key.rstrip("/") + "/", Body=b"")

    def exists(self, uri: str) -> bool:
        bucket, key = self._split(uri)
        return self._exists_key(bucket, key) or self.is_directory(uri)

    def is_directory(self, uri: str) -> bool:
        bucket, key = self._split(uri)
        prefix = key.rstrip("/") + "/"
        return bool(self._keys_under(bucket, prefix))

    def length(self, uri: str) -> int:
        bucket, key = self._split(uri)
        return self._client.head_object(Bucket=bucket, Key=key)["ContentLength"]

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        bucket, key = self._split(uri)
        prefix = key.rstrip("/") + "/" if key else ""
        keys = self._keys_under(bucket, prefix)
        out = set()
        for k in keys:
            rest = k[len(prefix):]
            if not rest:
                continue
            if not recursive and "/" in rest.rstrip("/"):
                rest = rest.split("/", 1)[0] + "/"
            out.add(f"{self.schemes[0]}://{bucket}/{prefix}{rest}")
        return sorted(out)

    def delete(self, uri: str, force: bool = False) -> bool:
        bucket, key = self._split(uri)
        if self._exists_key(bucket, key):
            self._client.delete_object(Bucket=bucket, Key=key)
            return True
        prefix = key.rstrip("/") + "/"
        keys = self._keys_under(bucket, prefix)
        if not keys:
            return False
        if len([k for k in keys if k != prefix]) and not force:
            raise OSError(f"{uri} is a non-empty directory (use force)")
        for k in keys:
            self._client.delete_object(Bucket=bucket, Key=k)
        return True

    def copy(self, src: str, dst: str) -> bool:
        sb, sk = self._split(src)
        db, dk = self._split(dst)
        if self._exists_key(sb, sk):
            self._client.copy_object(Bucket=db, Key=dk,
                                     CopySource={"Bucket": sb, "Key": sk})
            return True
        prefix = sk.rstrip("/") + "/"
        keys = self._keys_under(sb, prefix)
        if not keys:
            return False
        for k in keys:
            self._client.copy_object(
                Bucket=db, Key=dk.rstrip("/") + "/" + k[len(prefix):],
                CopySource={"Bucket": sb, "Key": k})
        return True

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        if not overwrite and self.exists(dst):
            return False
        if not self.copy(src, dst):
            return False
        self.delete(src, force=True)
        return True

    def open(self, uri: str) -> BinaryIO:
        bucket, key = self._split(uri)
        body = self._client.get_object(Bucket=bucket, Key=key)["Body"]
        data = body.read()
        return io.BytesIO(data)

    def copy_to_local(self, src_uri: str, local_path: str) -> None:
        with open(local_path, "wb") as f:
            f.write(self.open(src_uri).read())

    def copy_from_local(self, local_path: str, dst_uri: str) -> None:
        bucket, key = self._split(dst_uri)
        with open(local_path, "rb") as f:
            self._client.put_object(Bucket=bucket, Key=key, Body=f.read())


register_fs("s3", S3PinotFS)
