"""The closed loop: one client sends each call, waits for its reply,
then sends the next, as a YCSB client thread does. Every request and
every answer goes into the log the reference judges afterwards.
"""

from __future__ import annotations

import contextlib
import time

from benchmark.reference.kv import (
    encode_key,
    hashkey,
    record_value,
    sortkey,
)


class Loop:
    """Issues the calls of a `gen.Requests` against a ClusterClient and
    records, per call kind, the wall of each call and how many requests
    it carried."""

    def __init__(self, client, requests, data) -> None:
        from pegasus_tpu_torch.server.types import GetScannerRequest

        self.client = client
        self.requests = requests
        self.data = data
        self.calls = requests.calls()
        self._scan_request = GetScannerRequest
        self.log: list = []
        self.pending: list = []    # raw answers, turned into log rows later
        self.reset_window()

    def reset_window(self) -> None:
        self.walls: dict = {}       # kind -> [(wall_s, requests)]
        self.ends: list = []        # (end, kind, requests) a call
        self.done: dict = {}        # kind -> requests answered
        self.failed = 0
        self.attempted = 0

    # ---- one call -----------------------------------------------------

    def step(self, span=contextlib.nullcontext) -> None:
        kind, arg = next(self.calls)
        with span(f"bench.{kind}"):
            t0 = time.perf_counter()
            n = getattr(self, f"_{kind}")(arg)
            t1 = time.perf_counter()
        self.walls.setdefault(kind, []).append((t1 - t0, n))
        self.ends.append((t1, kind, n))
        self.attempted += n

    def _scan(self, items: list) -> int:
        """One scan_multi call of one-page scans; a page that comes back
        short is read on from its last key in a further call, as a
        scanner pages on, until it holds its rows or a page is empty.
        (The server stops a page where its range-read budget, the
        records it examined, runs out.)"""
        data, req = self.data, self._scan_request
        pages = [[] for _ in items]      # the responses of each scan
        got = [0] * len(items)
        bad = [False] * len(items)
        todo = list(range(len(items)))
        while todo:
            groups: dict = {}
            placed = []
            for i in todo:
                h, limit = items[i]
                p = data.partition_of(h)
                lst = groups.setdefault(p, [])
                placed.append((p, len(lst), i))
                if pages[i]:
                    start, first = _last_key(pages[i][-1].kvs), False
                else:
                    start, first = encode_key(hashkey(h)), True
                lst.append(req(start_key=start, start_inclusive=first,
                               batch_size=limit - got[i],
                               validate_partition_hash=True, one_page=True))
            try:
                result = self.client.scan_multi(groups)
            except Exception:  # noqa: BLE001 - a failed call fails its scans
                result = {}
            todo = []
            for p, j, i in placed:
                resps = result.get(p)
                resp = resps[j] if resps is not None and len(resps) > j \
                    else None
                if resp is None or resp.error != 0:
                    bad[i] = True
                    continue
                n = len(resp.kvs)
                if n:
                    pages[i].append(resp)
                    got[i] += n
                    if got[i] < items[i][1]:
                        todo.append(i)
        ok = 0
        for i, (h, limit) in enumerate(items):
            if bad[i]:
                self.failed += 1
            else:
                ok += 1
            self.pending.append(("scan", data.partition_of(h),
                                 encode_key(hashkey(h)), limit,
                                 None if bad[i] else pages[i]))
        self.done["scan"] = self.done.get("scan", 0) + ok
        return len(items)

    def _insert(self, h: int) -> int:
        fields = self.data.fields
        kvs = {sortkey(f): record_value(h * fields + f, self.data.value_bytes)
               for f in range(fields)}
        try:
            err = self.client.multi_set(hashkey(h), kvs)
        except Exception:  # noqa: BLE001 - counted as not acknowledged
            err = -1
        acked = err == 0
        if acked:
            self.requests.acknowledge(h)
            self.done["insert"] = self.done.get("insert", 0) + 1
        else:
            self.failed += 1
        self.pending.append(("insert", h, acked))
        return 1

    # ---- after the window ---------------------------------------------

    def finish_log(self) -> list:
        """The log in the reference's terms: scan responses as rows."""
        for ev in self.pending:
            if ev[0] == "scan":
                resps = ev[4]
                rows = None if resps is None else [
                    (kv.key, kv.value) for resp in resps for kv in resp.kvs]
                ev = ev[:4] + (rows,)
            self.log.append(ev)
        self.pending = []
        return self.log


def _last_key(kvs) -> bytes:
    """The last key of a page: a list of KeyValue, or the native
    packer's ScanPage."""
    if hasattr(kvs, "key_at"):
        return kvs.key_at(len(kvs) - 1)
    return kvs[-1].key
