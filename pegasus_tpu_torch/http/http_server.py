"""Built-in HTTP endpoints: /metrics, /version, /config, /command.

Parity: src/http/http_server.h:91 (registry-based endpoints) with the
builtin calls (src/http/builtin_http_calls.cpp:80-103 /version /config;
:280-288 /metrics via metrics_http_service, JSON with entity/metric
filters — the surface the Go collector scrapes) plus remote-command
verbs over HTTP (/command?verb=...&args=a,b — command_manager.h:52).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import pegasus_tpu_torch
from pegasus_tpu_torch.utils.flags import FLAGS
from pegasus_tpu_torch.utils.metrics import METRICS


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, payload) -> None:
        body = json.dumps(payload, indent=1).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str,
                    content_type: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        query = parse_qs(url.query)
        routes = getattr(self.server, "routes", None) or {}
        if url.path in routes:
            try:
                self._reply(200, routes[url.path](
                    {k: v[0] for k, v in query.items()}))
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e)})
            return
        if url.path == "/version":
            self._reply(200, {"version": pegasus_tpu_torch.__version__,
                              "framework": "pegasus_tpu_torch"})
        elif url.path == "/config":
            self._reply(200, FLAGS.snapshot())
        elif url.path == "/command":
            mgr = getattr(self.server, "commands", None)
            if mgr is None:
                self._reply(404, {"error": "no command manager attached"})
                return
            verb = query.get("verb", ["help"])[0]
            args = [a for a in query.get("args", [""])[0].split(",") if a]
            try:
                self._reply(200, {"verb": verb,
                                  "result": mgr.call(verb, args)})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
        elif url.path == "/pprof/heap":
            # parity: pprof_http_service heap endpoint — Python-native:
            # tracemalloc top allocations when tracing, else rss only
            import resource
            import tracemalloc

            out = {"max_rss_kb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss,
                "tracing": tracemalloc.is_tracing()}
            if tracemalloc.is_tracing():
                snap = tracemalloc.take_snapshot()
                out["top"] = [
                    {"site": str(stat.traceback[0]),
                     "size_kb": stat.size // 1024,
                     "count": stat.count}
                    for stat in snap.statistics("lineno")[:25]]
            self._reply(200, out)
        elif url.path == "/pprof/profile":
            # parity: pprof cpu profile — sampled Python stacks over a
            # short window; collapsed-stack counts, biggest first
            import collections
            import sys
            import time as _time

            try:
                seconds = min(10.0, float(
                    query.get("seconds", ["1"])[0]))
            except ValueError:
                self._reply(400, {"error": "seconds must be a number"})
                return
            hz = 50
            me = threading.get_ident()
            counts: collections.Counter = collections.Counter()
            end = _time.monotonic() + seconds
            while _time.monotonic() < end:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    f = frame
                    while f is not None and len(stack) < 24:
                        stack.append(
                            f"{f.f_code.co_filename.rsplit('/', 1)[-1]}"
                            f":{f.f_code.co_name}")
                        f = f.f_back
                    counts[";".join(reversed(stack))] += 1
                _time.sleep(1.0 / hz)
            self._reply(200, {
                "seconds": seconds, "hz": hz,
                "samples": sum(counts.values()),
                "stacks": [{"stack": k, "count": v}
                           for k, v in counts.most_common(40)]})
        elif url.path == "/metrics":
            entity_type = query.get("with_metric_entity_type",
                                    query.get("entity_type", [None]))[0]
            names = query.get("with_metrics", query.get("metrics", [None]))[0]
            metric_names = names.split(",") if names else None
            snap = METRICS.snapshot(entity_type, metric_names)
            if query.get("format", [None])[0] == "prom":
                # Prometheus text exposition (standard scrapers; the
                # collector->Prometheus sink path). JSON stays default.
                from pegasus_tpu_torch.utils.metrics import to_prometheus

                self._reply_text(
                    200, to_prometheus(snap),
                    "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(200, snap)
        else:
            self._reply(404, {"error": f"unknown path {url.path}"})


class MetricsHttpServer:
    """Threaded HTTP server; bind port 0 for an ephemeral port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 commands=None, routes=None) -> None:
        self._server = ThreadingHTTPServer((host, port), _Handler)
        # the /command endpoint serves this registry (None = 404)
        self._server.commands = commands
        # extra GET routes: path -> callable(query_dict) -> payload
        # (the meta REST surface rides here, meta_http_service parity)
        self._server.routes = routes
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsHttpServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
