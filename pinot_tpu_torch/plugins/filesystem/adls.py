"""ADLS Gen2 PinotFS, the port of pinot_tpu/plugins/filesystem/adls.py
(reference: pinot-plugins/pinot-file-system/
pinot-adls/AzurePinotFS.java).

Azure Data Lake's blob namespace is flat like S3's, so this plugin adapts
the ``azure-storage-blob`` container client onto the S3 client surface and
reuses S3PinotFS's prefix-directory logic. URI form:
``adl2://<account>/<container-and-path>`` — the "bucket" is the container,
resolved through the account-level service client. The SDK is optional and
lazily imported.
"""

from __future__ import annotations

import io
from typing import Callable

from ...spi.filesystem import register_fs
from .s3 import S3PinotFS


class _AdlsClientAdapter:
    def __init__(self, service_client):
        self.service = service_client

    def _blob(self, container, key):
        return self.service.get_blob_client(container=container, blob=key)

    def put_object(self, Bucket, Key, Body=b""):
        self._blob(Bucket, Key).upload_blob(Body, overwrite=True)

    def get_object(self, Bucket, Key):
        data = self._blob(Bucket, Key).download_blob().readall()
        return {"Body": io.BytesIO(data)}

    def head_object(self, Bucket, Key):
        props = self._blob(Bucket, Key).get_blob_properties()
        return {"ContentLength": props.size}

    def delete_object(self, Bucket, Key):
        self._blob(Bucket, Key).delete_blob()

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        cc = self.service.get_container_client(Bucket)
        names = [{"Key": b.name} for b in
                 cc.list_blobs(name_starts_with=Prefix)]
        return {"Contents": names, "IsTruncated": False}

    def copy_object(self, Bucket, Key, CopySource):
        src_url = self._blob(CopySource["Bucket"], CopySource["Key"]).url
        self._blob(Bucket, Key).start_copy_from_url(src_url)


def _default_client_factory():
    try:
        from azure.storage.blob import (  # type: ignore[import-not-found]
            BlobServiceClient,
        )
        from azure.identity import (  # type: ignore[import-not-found]
            DefaultAzureCredential,
        )
    except ImportError as e:
        raise ImportError(
            "scheme 'adl2' needs the azure-storage-blob + azure-identity "
            "packages (or inject AdlsPinotFS.client_factory)") from e
    import os

    account = os.environ.get("AZURE_STORAGE_ACCOUNT_URL")
    return _AdlsClientAdapter(
        BlobServiceClient(account, credential=DefaultAzureCredential()))


class AdlsPinotFS(S3PinotFS):
    client_factory: Callable = staticmethod(_default_client_factory)
    schemes: tuple = ("adl2", "abfs", "abfss")


register_fs("adl2", AdlsPinotFS)
register_fs("abfs", AdlsPinotFS)
register_fs("abfss", AdlsPinotFS)
