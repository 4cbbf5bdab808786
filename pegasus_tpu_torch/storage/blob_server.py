"""Standalone remote blob-store daemon.

Parity role: the remote end of the reference's HDFS block service
(src/block_service/hdfs/hdfs_service.h:47) — a NETWORK blob store that
backup, restore, bulk load, and duplication bootstrap write to and read
from across machines. The image has no HDFS, so the daemon is our own:
a threaded HTTP server over a LocalBlockService root (content md5
verified on both ends), speaking a four-verb protocol any backend
could implement:

    PUT    /blob/<path>    body -> stored (md5 sidecar)
    GET    /blob/<path>    -> body (verified), X-Content-MD5 header
    HEAD   /blob/<path>    -> 200/404
    GET    /list/<path>    -> JSON name list
    DELETE /blob/<path>    -> recursive remove

CLI: python -m pegasus_tpu_torch.storage.blob_server --root R --port P
"""

from __future__ import annotations

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pegasus_tpu_torch.storage.block_service import LocalBlockService


class _Handler(BaseHTTPRequestHandler):
    store: LocalBlockService = None  # type: ignore[assignment]

    def log_message(self, *args) -> None:  # quiet
        pass

    def _reply(self, code: int, body: bytes = b"",
               content_md5: str = "") -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        if content_md5:
            self.send_header("X-Content-MD5", content_md5)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _path(self, prefix: str) -> str:
        return self.path[len(prefix):].lstrip("/")

    def do_PUT(self) -> None:
        if not self.path.startswith("/blob/"):
            return self._reply(404)
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        try:
            self.store.write_file(self._path("/blob/"), data)
        except ValueError:
            return self._reply(400)
        self._reply(200, content_md5=hashlib.md5(data).hexdigest())

    def do_GET(self) -> None:
        # a path-traversal attempt (LocalBlockService._abs raises
        # ValueError) is a BAD REQUEST on every verb, never an
        # uncaught traceback that kills the connection
        if self.path.startswith("/blob/"):
            p = self._path("/blob/")
            try:
                if not self.store.exists(p):
                    return self._reply(404)
                data, digest = self.store.read_file_with_md5(p)
            except ValueError:
                return self._reply(400)
            except OSError:
                # includes the sidecar md5 mismatch: an INTEGRITY
                # failure, which must not masquerade as absence
                return self._reply(500)
            return self._reply(200, data, content_md5=digest)
        if self.path.startswith("/list/"):
            try:
                names = self.store.list_dir(self._path("/list/"))
            except ValueError:
                return self._reply(400)
            return self._reply(200, json.dumps(names).encode())
        self._reply(404)

    def do_HEAD(self) -> None:
        if not self.path.startswith("/blob/"):
            return self._reply(404)
        try:
            found = self.store.exists(self._path("/blob/"))
        except ValueError:
            return self._reply(400)
        self._reply(200 if found else 404)

    def do_DELETE(self) -> None:
        if not self.path.startswith("/blob/"):
            return self._reply(404)
        try:
            self.store.remove_path(self._path("/blob/"))
        except ValueError:
            return self._reply(400)
        self._reply(200)


class BlobServer:
    """In-process daemon handle (tests / onebox); the CLI below runs it
    as a standalone process."""

    def __init__(self, root: str, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        handler = type("BoundHandler", (_Handler,),
                       {"store": LocalBlockService(root)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="blob-server", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"remote://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    # loopback by default: the daemon is unauthenticated, so exposing
    # backup/bulk-load data on all interfaces must be an explicit
    # operator choice (--host 0.0.0.0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8950)
    args = ap.parse_args()
    srv = BlobServer(args.root, args.host, args.port)
    print(f"blob server on {srv.host}:{srv.port} root={args.root}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
