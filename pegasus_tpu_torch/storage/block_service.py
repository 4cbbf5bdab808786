"""Block service: remote blob storage for backup artifacts.

Parity: src/block_service/block_service.h:273,337 — the abstract remote
file system (create_file / write / read / list_dir / remove_path /
upload / download) used by cold backup, restore, and bulk load.
Backends: LocalFS (parity: block_service/local/local_service.h:47) and
RemoteBlockService, a network blob store speaking the blob daemon's
HTTP protocol (storage/blob_server.py — the HDFS-backend role,
block_service/hdfs/hdfs_service.h:47).

Every subsystem resolves its configured root through
`block_service_for(root)`: a plain path is local, `remote://host:port[/
bucket]` is the network backend — so pointing a backup policy / bulk
load / duplication bootstrap at a remote store is a config change, not
a code change.
"""

from __future__ import annotations

import hashlib
import json
import os

from pegasus_tpu_torch.storage.efile import open_data_file
import shutil
from typing import List, Optional


class BlockService:
    """Interface."""

    def write_file(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list_dir(self, path: str) -> List[str]:
        raise NotImplementedError

    def remove_path(self, path: str) -> None:
        raise NotImplementedError

    def upload(self, local_path: str, remote_path: str) -> None:
        with open_data_file(local_path, "rb") as f:
            self.write_file(remote_path, f.read())

    def download(self, remote_path: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        with open_data_file(local_path, "wb") as f:
            f.write(self.read_file(remote_path))


class RemoteBlockService(BlockService):
    """Network blob store over the blob daemon's HTTP protocol
    (storage/blob_server.py). Content md5 is verified on read against
    the server's X-Content-MD5 header — the same end-to-end integrity
    LocalBlockService gets from its sidecar files."""

    def __init__(self, url: str) -> None:
        # url: "remote://host:port[/bucket]"
        rest = url[len("remote://"):]
        hostport, _, bucket = rest.partition("/")
        host, _, port = hostport.partition(":")
        self.host = host
        self.port = int(port or 8950)
        self.bucket = bucket.strip("/")
        self._base = f"http://{self.host}:{self.port}"

    def _url(self, kind: str, path: str) -> str:
        p = "/".join(x for x in (self.bucket, path.lstrip("/")) if x)
        return f"{self._base}/{kind}/{p}"

    def _request(self, method: str, url: str, data: bytes = None):
        import urllib.request

        req = urllib.request.Request(url, data=data, method=method)
        return urllib.request.urlopen(req, timeout=60)

    def write_file(self, path: str, data: bytes) -> None:
        with self._request("PUT", self._url("blob", path), data) as r:
            if r.status != 200:
                raise IOError(f"blob PUT {path}: {r.status}")
            want = hashlib.md5(data).hexdigest()
            got = r.headers.get("X-Content-MD5", "")
            if got and got != want:
                # the server stored bytes that do not match what we
                # sent: surface NOW, not at some future restore
                raise IOError(f"blob PUT {path}: stored md5 {got} != "
                              f"sent {want}")

    def read_file(self, path: str) -> bytes:
        import urllib.error

        try:
            with self._request("GET", self._url("blob", path)) as r:
                data = r.read()
                want = r.headers.get("X-Content-MD5", "")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(
                    f"blob GET {path}: not found") from e
            # 5xx / integrity failures are SERVER errors, not absence —
            # a corrupt backup must not read as "never taken"
            raise IOError(f"blob GET {path}: HTTP {e.code}") from e
        if want and hashlib.md5(data).hexdigest() != want:
            raise IOError(f"blob md5 mismatch for {path}")
        return data

    def exists(self, path: str) -> bool:
        import urllib.error

        try:
            with self._request("HEAD", self._url("blob", path)) as r:
                return r.status == 200
        except urllib.error.HTTPError:
            return False

    def list_dir(self, path: str) -> List[str]:
        import urllib.error

        try:
            with self._request("GET", self._url("list", path)) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return []
            # a server fault must not read as "no backups exist"
            raise IOError(f"blob LIST {path}: HTTP {e.code}") from e

    def remove_path(self, path: str) -> None:
        import urllib.error

        try:
            self._request("DELETE", self._url("blob", path)).close()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return  # already absent: removal is idempotent
            # a failed delete silently "succeeding" leaks artifacts
            raise IOError(f"blob DELETE {path}: HTTP {e.code}") from e


def block_service_for(root: str) -> BlockService:
    """Resolve a configured backup/bulk-load/bootstrap root to its
    backend (the block_service_manager role,
    block_service/block_service_manager.h)."""
    if root.startswith("remote://"):
        return RemoteBlockService(root)
    return LocalBlockService(root)


class LocalBlockService(BlockService):
    """Filesystem-backed blob store with content md5s in a sidecar index
    (parity: local_service writes .md5 metadata alongside files)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path.lstrip("/")))
        root = os.path.normpath(self.root)
        if os.path.commonpath([p, root]) != root:
            raise ValueError(f"path escapes block service root: {path}")
        return p

    def write_file(self, path: str, data: bytes) -> None:
        abs_path = self._abs(path)
        os.makedirs(os.path.dirname(abs_path), exist_ok=True)
        tmp = abs_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # data first, checksum after: a crash in between leaves old data
        # with the OLD md5 (readable), never new-md5-over-old-data
        os.replace(tmp, abs_path)
        with open(abs_path + ".md5", "w") as f:
            f.write(hashlib.md5(data).hexdigest())

    def read_file(self, path: str) -> bytes:
        return self.read_file_with_md5(path)[0]

    def read_file_with_md5(self, path: str):
        """(data, md5hex) with the digest computed exactly once —
        verified against the sidecar when present (the blob daemon
        serves the digest in X-Content-MD5 without re-hashing)."""
        abs_path = self._abs(path)
        with open(abs_path, "rb") as f:
            data = f.read()
        digest = hashlib.md5(data).hexdigest()
        md5_path = abs_path + ".md5"
        if os.path.exists(md5_path):
            with open(md5_path) as f:
                want = f.read().strip()
            if digest != want:
                raise IOError(f"block service md5 mismatch for {path}")
        return data, digest

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list_dir(self, path: str) -> List[str]:
        abs_path = self._abs(path)
        if not os.path.isdir(abs_path):
            return []
        return sorted(n for n in os.listdir(abs_path)
                      if not n.endswith((".md5", ".tmp")))

    def remove_path(self, path: str) -> None:
        abs_path = self._abs(path)
        if os.path.isdir(abs_path):
            shutil.rmtree(abs_path)
        elif os.path.exists(abs_path):
            os.remove(abs_path)
            md5 = abs_path + ".md5"
            if os.path.exists(md5):
                os.remove(md5)
