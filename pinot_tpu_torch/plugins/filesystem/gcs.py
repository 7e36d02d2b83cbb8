"""GCS PinotFS, the port of pinot_tpu/plugins/filesystem/gcs.py (reference: pinot-plugins/pinot-file-system/pinot-gcs/
GcsPinotFS.java).

GCS's flat namespace has the same directory-marker semantics as S3, and
``google-cloud-storage``'s client surface maps almost 1:1 onto the S3
operations this tree already implements — so this plugin adapts the GCS
client to the S3 client surface and reuses S3PinotFS wholesale rather than
re-deriving the prefix logic. The SDK is optional and lazily imported.
"""

from __future__ import annotations

from typing import Callable

from ...spi.filesystem import register_fs
from .s3 import S3PinotFS


class _GcsClientAdapter:
    """google-cloud-storage Client → the boto3-style surface S3PinotFS uses."""

    def __init__(self, client):
        self.client = client

    def put_object(self, Bucket, Key, Body=b""):
        self.client.bucket(Bucket).blob(Key).upload_from_string(Body)

    def get_object(self, Bucket, Key):
        import io

        data = self.client.bucket(Bucket).blob(Key).download_as_bytes()
        return {"Body": io.BytesIO(data)}

    def head_object(self, Bucket, Key):
        blob = self.client.bucket(Bucket).get_blob(Key)
        if blob is None:
            raise FileNotFoundError(f"gs://{Bucket}/{Key}")
        return {"ContentLength": blob.size}

    def delete_object(self, Bucket, Key):
        self.client.bucket(Bucket).blob(Key).delete()

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        blobs = self.client.list_blobs(Bucket, prefix=Prefix,
                                       page_token=ContinuationToken)
        contents = [{"Key": b.name} for b in blobs]
        token = getattr(blobs, "next_page_token", None)
        return {"Contents": contents, "IsTruncated": bool(token),
                "NextContinuationToken": token}

    def copy_object(self, Bucket, Key, CopySource):
        src_bucket = self.client.bucket(CopySource["Bucket"])
        src_blob = src_bucket.blob(CopySource["Key"])
        src_bucket.copy_blob(src_blob, self.client.bucket(Bucket), Key)


def _default_client_factory():
    try:
        from google.cloud import storage  # type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "scheme 'gs' needs the google-cloud-storage package (or inject "
            "GcsPinotFS.client_factory)") from e
    return _GcsClientAdapter(storage.Client())


class GcsPinotFS(S3PinotFS):
    client_factory: Callable = staticmethod(_default_client_factory)
    schemes: tuple = ("gs", "gcs")


register_fs("gs", GcsPinotFS)
register_fs("gcs", GcsPinotFS)
