"""Blob storage backends for the dataset distribution pipeline.

The port's copy of ``bqueryd_tpu/blob.py``: it imports neither torch nor
pandas, and the cloud SDKs only when such a backend is constructed.

The reference downloads shard zips from S3 (boto3 + smart_open streaming,
reference bqueryd/worker.py:442-498) or Azure blob storage (reference
bqueryd/worker.py:519-556).  Neither SDK is guaranteed present here, so
backends are gated on import and a filesystem-backed backend exists for
tests and air-gapped clusters — the same seam the reference's tests use by
subclassing the downloader (reference tests/test_download.py:25-45).

URL scheme picks the backend: ``s3://bucket/key``, ``azure://container/blob``,
``localfs://bucket/key`` (rooted at BQUERYD_TPU_BLOB_DIR).
"""

import os
import shutil

CHUNK_SIZE = 16 * 1024 * 1024  # streaming chunk (reference bqueryd/worker.py:31)


class BlobBackend:
    scheme = None

    def fetch(self, bucket, key, dest_path, progress_cb=None):
        """Download bucket/key to dest_path, calling progress_cb(bytes_done)
        after each chunk."""
        raise NotImplementedError

    def put(self, bucket, key, src_path):
        raise NotImplementedError


class LocalFSBackend(BlobBackend):
    """``localfs://`` — a directory tree standing in for object storage."""

    scheme = "localfs"

    def __init__(self, root=None):
        self.root = root or os.environ.get(
            "BQUERYD_TPU_BLOB_DIR", "/tmp/bqueryd_tpu_blobs"
        )

    def _path(self, bucket, key):
        return os.path.join(self.root, bucket, key)

    def fetch(self, bucket, key, dest_path, progress_cb=None):
        src = self._path(bucket, key)
        if not os.path.exists(src):
            raise FileNotFoundError(f"localfs://{bucket}/{key}")
        done = 0
        with open(src, "rb") as fin, open(dest_path, "wb") as fout:
            while True:
                chunk = fin.read(CHUNK_SIZE)
                if not chunk:
                    break
                fout.write(chunk)
                done += len(chunk)
                if progress_cb:
                    progress_cb(done)

    def put(self, bucket, key, src_path):
        dest = self._path(bucket, key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(src_path, dest)


class S3Backend(BlobBackend):
    """``s3://`` via boto3; streamed in CHUNK_SIZE chunks with retry handled
    by the caller.  Endpoint/credentials come from the standard AWS env or
    the constructor (the localstack seam)."""

    scheme = "s3"

    def __init__(
        self, endpoint_url=None, access_key=None, secret_key=None, client=None
    ):
        if client is not None:
            # injection seam: tests (and exotic deployments) hand in a
            # ready-made client; boto3 never has to be importable
            self.client = client
            return
        import boto3  # gated import: optional dependency

        kwargs = {}
        if endpoint_url or os.environ.get("BQUERYD_TPU_S3_ENDPOINT"):
            kwargs["endpoint_url"] = endpoint_url or os.environ[
                "BQUERYD_TPU_S3_ENDPOINT"
            ]
        if access_key:
            kwargs["aws_access_key_id"] = access_key
            kwargs["aws_secret_access_key"] = secret_key
        self.client = boto3.client("s3", **kwargs)

    def fetch(self, bucket, key, dest_path, progress_cb=None):
        response = self.client.get_object(Bucket=bucket, Key=key)
        body = response["Body"]
        done = 0
        with open(dest_path, "wb") as fout:
            while True:
                chunk = body.read(CHUNK_SIZE)
                if not chunk:
                    break
                fout.write(chunk)
                done += len(chunk)
                if progress_cb:
                    progress_cb(done)

    def put(self, bucket, key, src_path):
        self.client.upload_file(src_path, bucket, key)


class AzureBackend(BlobBackend):
    """``azure://`` via azure-storage-blob; connection string from
    /etc config or env (reference bqueryd/node.py:9-11)."""

    scheme = "azure"

    def __init__(self, conn_string=None, service=None):
        if service is not None:
            self.service = service  # injection seam, as S3Backend.client
            return
        from azure.storage.blob import BlobServiceClient  # gated import

        conn = conn_string or os.environ.get("AZURE_STORAGE_CONNECTION_STRING")
        self.service = BlobServiceClient.from_connection_string(conn)

    def fetch(self, bucket, key, dest_path, progress_cb=None):
        blob = self.service.get_blob_client(container=bucket, blob=key)
        stream = blob.download_blob()
        done = 0
        with open(dest_path, "wb") as fout:
            for chunk in stream.chunks():
                fout.write(chunk)
                done += len(chunk)
                if progress_cb:
                    progress_cb(done)

    def put(self, bucket, key, src_path):
        blob = self.service.get_blob_client(container=bucket, blob=key)
        with open(src_path, "rb") as f:
            blob.upload_blob(f, overwrite=True)


_BACKENDS = {
    "localfs": LocalFSBackend,
    "s3": S3Backend,
    "azure": AzureBackend,
}


def parse_url(url):
    """'scheme://bucket/key' -> (scheme, bucket, key)."""
    scheme, _, rest = url.partition("://")
    bucket, _, key = rest.partition("/")
    if not scheme or not bucket or not key:
        raise ValueError(f"bad blob url {url!r}")
    return scheme, bucket, key


def backend_for(scheme, **kwargs):
    cls = _BACKENDS.get(scheme)
    if cls is None:
        raise ValueError(f"unknown blob scheme {scheme!r}")
    return cls(**kwargs)
