"""Remote file transfer: chunked directory copy between nodes.

Parity: src/nfs/ (nfs_node.h:84 copy_remote_files — rDSN-RPC-based bulk
file copy used by LT_APP learning and disk migration; NOT posix NFS).
Message protocol (server side lives on the replica stub):

    "list_dir"         {rid, path}            -> "list_dir_reply"
                       {rid, err, files: [{name, size}]}
    "fetch_chunk"      {rid, path, offset, length}
                       -> "fetch_chunk_reply" {rid, err, data, eof}

Paths are validated against the serving stub's data dirs — a transfer
peer can only read replica state, never arbitrary files.

The client side is an ASYNC session (FileFetchSession): message
handlers cannot block on request/reply (single-threaded dispatch), so
the session advances one outstanding chunk at a time and fires a
completion callback — the same shape as the duplication sessions.
"""

from __future__ import annotations

import itertools
import os

from pegasus_tpu_torch.storage.vfs import logical_size, open_data_file
from typing import Callable, List, Optional, Tuple

CHUNK_SIZE = 1 << 20

_RIDS = itertools.count(5_000_000)


def path_allowed(path: str, roots: List[str]) -> bool:
    real = os.path.realpath(path)
    for root in roots:
        if real == os.path.realpath(root) or real.startswith(
                os.path.realpath(root) + os.sep):
            return True
    return False


class TransferServer:
    """Stub-side handlers (registered by ReplicaStub)."""

    def __init__(self, net, name: str, roots: List[str]) -> None:
        self.net = net
        self.name = name
        self.roots = list(roots)

    def on_list_dir(self, src: str, payload: dict) -> None:
        rid = payload.get("rid")
        path = payload["path"]
        if not path_allowed(path, self.roots) or not os.path.isdir(path):
            self.net.send(self.name, src, "list_dir_reply", {
                "rid": rid, "err": 1, "files": []})
            return
        files = []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            if os.path.isfile(full):
                files.append({"name": name,
                              "size": logical_size(full)})
        self.net.send(self.name, src, "list_dir_reply", {
            "rid": rid, "err": 0, "files": files})

    def on_fetch_chunk(self, src: str, payload: dict) -> None:
        rid = payload.get("rid")
        path = payload["path"]
        if not path_allowed(path, self.roots) or not os.path.isfile(path):
            self.net.send(self.name, src, "fetch_chunk_reply", {
                "rid": rid, "err": 1, "data": b"", "eof": True})
            return
        with open_data_file(path, "rb") as f:
            f.seek(payload["offset"])
            data = f.read(payload["length"])
            eof = f.tell() >= logical_size(path)
        self.net.send(self.name, src, "fetch_chunk_reply", {
            "rid": rid, "err": 0, "data": data, "eof": eof})


class FileFetchSession:
    """Pulls one remote directory into a local one, chunk by chunk.

    Owner routes "list_dir_reply"/"fetch_chunk_reply" into on_reply();
    `on_done(ok)` fires exactly once at completion or failure.
    """

    def __init__(self, net, name: str, remote_node: str, remote_dir: str,
                 local_dir: str,
                 on_done: Callable[[bool], None]) -> None:
        self.net = net
        self.name = name
        self.remote_node = remote_node
        self.remote_dir = remote_dir
        self.local_dir = local_dir
        self.on_done = on_done
        self._files: List[dict] = []
        self._file_idx = 0
        self._offset = 0
        self._fh = None
        self._rid: Optional[int] = None
        self._finished = False
        os.makedirs(local_dir, exist_ok=True)
        self._send_list()

    # ---- protocol ------------------------------------------------------

    def _send_list(self, reuse_rid: bool = False) -> None:
        if not reuse_rid or self._rid is None:
            self._rid = next(_RIDS)
        self.net.send(self.name, self.remote_node, "list_dir", {
            "rid": self._rid, "path": self.remote_dir})

    def _send_chunk_req(self, reuse_rid: bool = False) -> None:
        if not reuse_rid or self._rid is None:
            self._rid = next(_RIDS)
        f = self._files[self._file_idx]
        self.net.send(self.name, self.remote_node, "fetch_chunk", {
            "rid": self._rid,
            "path": os.path.join(self.remote_dir, f["name"]),
            "offset": self._offset, "length": CHUNK_SIZE})

    def resend(self) -> None:
        """Timer hook: the last request may have been lost. The SAME rid
        is re-sent — minting a new one would invalidate an in-flight
        reply, and a round-trip slower than the tick would then livelock
        (every reply always stale)."""
        if self._finished:
            return
        if self._fh is None and not self._files:
            self._send_list(reuse_rid=True)
        elif self._file_idx < len(self._files):
            self._send_chunk_req(reuse_rid=True)

    def on_reply(self, msg_type: str, payload: dict) -> bool:
        if self._finished or payload.get("rid") != self._rid:
            return False
        if msg_type == "list_dir_reply":
            if payload["err"] != 0:
                self._finish(False)
                return True
            self._files = payload["files"]
            self._file_idx = 0
            self._next_file()
            return True
        if msg_type == "fetch_chunk_reply":
            if payload["err"] != 0:
                self._finish(False)
                return True
            self._fh.write(payload["data"])
            self._offset += len(payload["data"])
            if payload["eof"]:
                self._fh.close()
                self._fh = None
                self._file_idx += 1
                self._next_file()
            else:
                self._send_chunk_req()
            return True
        return False

    def _next_file(self) -> None:
        while self._file_idx < len(self._files):
            f = self._files[self._file_idx]
            if f["size"] == 0:
                open_data_file(os.path.join(self.local_dir, f["name"]), "wb").close()
                self._file_idx += 1
                continue
            self._fh = open_data_file(os.path.join(self.local_dir, f["name"]), "wb")
            self._offset = 0
            self._send_chunk_req()
            return
        self._finish(True)

    def _finish(self, ok: bool) -> None:
        self._finished = True
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self.on_done(ok)
