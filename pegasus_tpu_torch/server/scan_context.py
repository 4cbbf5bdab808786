"""Server-held scan contexts with expiry.

Parity: src/server/pegasus_scan_context.h:91 — a paged scan saves its
state server-side under a context id; the client continues with
on_scan(context_id) and the server drops contexts unused for 5 minutes
(pegasus_server_impl.cpp:1362-1388). The context stores the resume key
instead of a live iterator, so no snapshot stays pinned.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from pegasus_tpu_torch.server.types import GetScannerRequest

CONTEXT_EXPIRE_SECONDS = 300.0


@dataclass
class ScanContext:
    request: GetScannerRequest
    resume_key: bytes            # next full key to seek (exclusive of served)
    stop_key: bytes              # effective exclusive upper bound
    # aggregate-mode pushdown: the partial (ops/pushdown.AggState) that
    # continues across pages and ships only on the final one
    agg_state: Optional[object] = None
    last_used: float = field(default_factory=time.monotonic)


class ScanContextCache:
    def __init__(self) -> None:
        self._contexts: Dict[int, ScanContext] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def put(self, ctx: ScanContext) -> int:
        with self._lock:
            now = time.monotonic()
            for cid in [c for c, x in self._contexts.items()
                        if now - x.last_used > CONTEXT_EXPIRE_SECONDS]:
                del self._contexts[cid]
            cid = next(self._ids)
            self._contexts[cid] = ctx
            return cid

    def take(self, context_id: int) -> Optional[ScanContext]:
        """Remove and return; callers re-insert (fresh id) when unfinished —
        the reference's single-use fetch/store contract."""
        with self._lock:
            ctx = self._contexts.pop(context_id, None)
            if ctx is None or time.monotonic() - ctx.last_used > CONTEXT_EXPIRE_SECONDS:
                return None
            ctx.last_used = time.monotonic()
            return ctx

    def remove(self, context_id: int) -> None:
        with self._lock:
            self._contexts.pop(context_id, None)

    def __len__(self) -> int:
        return len(self._contexts)
