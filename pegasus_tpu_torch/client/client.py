"""PegasusClient: the user-facing API.

Parity: src/include/pegasus/client.h:42 — set/get/del/exist/ttl,
multi_set/multi_get/multi_get_sortkeys/multi_del, incr, check_and_set,
check_and_mutate, batch_get, sortkey_count, get_scanner (hashkey-scoped)
and get_unordered_scanners (full-table scan fan-out, :1164-1180).

Errors surface as integer status codes matching the server (0 = OK,
1 = NotFound, ...), like the reference's PERR_* mapping.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from pegasus_tpu_torch.base.key_schema import (
    generate_key,
    generate_next_bytes,
    restore_key,
)
from pegasus_tpu_torch.base.value_schema import epoch_now
from pegasus_tpu_torch.client.table import Table
from pegasus_tpu_torch.ops import pushdown as pushdown_ops
from pegasus_tpu_torch.ops.predicates import FT_NO_FILTER, host_match_filter
from pegasus_tpu_torch.ops.pushdown import PushdownSpec
from pegasus_tpu_torch.server.partition_server import PartitionServer
from pegasus_tpu_torch.server.read_coordinator import point_read_multi
from pegasus_tpu_torch.server.scan_coordinator import scan_multi
from pegasus_tpu_torch.server.types import (
    BatchGetRequest,
    CheckAndMutateRequest,
    CheckAndMutateResponse,
    CheckAndSetRequest,
    CheckAndSetResponse,
    FullKey,
    GetScannerRequest,
    IncrRequest,
    KeyValue,
    MultiGetRequest,
    MultiPutRequest,
    MultiRemoveRequest,
    Mutate,
    SCAN_CONTEXT_ID_COMPLETED,
    SCAN_CONTEXT_ID_NOT_EXIST,
)
from pegasus_tpu_torch.utils.errors import ErrorCode, StorageStatus

_MISROUTED = int(ErrorCode.ERR_PARENT_PARTITION_MISUSED)


def _err_of(resp) -> int:
    if isinstance(resp, int):
        return resp
    if isinstance(resp, tuple):
        return resp[0]
    return resp.error


def paginate_sortkeys(fetch) -> "Tuple[int, List[bytes]]":
    """Drive `fetch(cursor, inclusive) -> MultiGetResponse` (a no_value
    range multi_get) to exhaustion, paging past the server's one-shot
    read budget. Resumes from the response's resume_sort_key, so even a
    page whose every record was filtered (a long expired run) makes
    progress; if a server provides neither kvs nor a resume point, the
    truncation is reported as INCOMPLETE — never silently as OK. Shared
    by both clients' multi_get_sortkeys."""
    out: List[bytes] = []
    cursor, inclusive = b"", True
    while True:
        resp = fetch(cursor, inclusive)
        out.extend(kv.key for kv in resp.kvs)
        if resp.error != int(StorageStatus.INCOMPLETE):
            return resp.error, sorted(out)
        if resp.resume_sort_key is not None:
            nxt = (resp.resume_sort_key, True)
        elif resp.kvs:
            nxt = (max(kv.key for kv in resp.kvs), False)
        else:
            return int(StorageStatus.INCOMPLETE), sorted(out)
        if nxt == (cursor, inclusive):
            # a server that stops making progress must not spin us
            return int(StorageStatus.INCOMPLETE), sorted(out)
        cursor, inclusive = nxt


def make_hashkey_scan_request(hash_key: bytes, batch_size: int = 1000,
                              validate_partition_hash: bool = True,
                              start_sortkey: bytes = b"",
                              stop_sortkey: bytes = b""):
    """The one place the hashkey-range scan request shape lives (both
    clients' get_scanner and the geo batched path build from here).
    Optional sortkey bounds narrow to [start_sortkey, stop_sortkey)
    within the hashkey (empty stop = to the hashkey's end)."""

    stop_key = (generate_key(hash_key, stop_sortkey) if stop_sortkey
                else generate_next_bytes(hash_key))
    return GetScannerRequest(
        start_key=generate_key(hash_key, start_sortkey),
        stop_key=stop_key,
        stop_inclusive=False, batch_size=batch_size,
        validate_partition_hash=validate_partition_hash)


@dataclass
class ScanOptions:
    """Parity: pegasus_client::scan_options (client.h)."""

    batch_size: int = 100
    start_inclusive: bool = True
    stop_inclusive: bool = False
    hash_key_filter_type: int = FT_NO_FILTER
    hash_key_filter_pattern: bytes = b""
    sort_key_filter_type: int = FT_NO_FILTER
    sort_key_filter_pattern: bytes = b""
    no_value: bool = False
    return_expire_ts: bool = False
    only_return_count: bool = False
    # server-side pushdown: match against the record's USER value bytes
    # (same FT_* match types as the key filters). Old servers ignore the
    # spec; the scanner detects pushdown_applied=False and filters
    # locally, so the option is safe against any server
    value_filter_type: int = FT_NO_FILTER
    value_filter_pattern: bytes = b""


class PegasusScanner:
    """Pages through one or more partitions' scan contexts.

    Parity: pegasus_scanner (client.h:1122) — next() yields
    (hash_key, sort_key, value) until exhausted.
    """

    def __init__(self, partitions: List[PartitionServer],
                 request: GetScannerRequest) -> None:
        self._partitions = list(partitions)
        self._request = request
        self._part_idx = 0
        self._context_id: Optional[int] = None
        self._buffer: List[KeyValue] = []
        self._buf_pos = 0
        self._last_key: Optional[bytes] = None  # for context-loss restart
        self.kv_count = 0  # accumulated when only_return_count
        self.shipped_bytes = 0  # wire-size of every response consumed

    def __iter__(self) -> Iterator[Tuple[bytes, bytes, bytes]]:
        return self

    def __next__(self) -> Tuple[bytes, bytes, bytes]:
        kv = self._next_kv()
        hk, sk = restore_key(kv.key)
        return hk, sk, kv.value

    def next_record(self) -> Tuple[bytes, bytes, bytes, int]:
        """Like next(), plus the record's expire_ts (0 = no TTL).
        Meaningful only when the scan was opened with
        ScanOptions.return_expire_ts."""
        kv = self._next_kv()
        hk, sk = restore_key(kv.key)
        return hk, sk, kv.value, kv.expire_ts_seconds or 0

    def _next_kv(self):
        while True:
            if self._buf_pos < len(self._buffer):
                kv = self._buffer[self._buf_pos]
                self._buf_pos += 1
                self._last_key = kv.key
                return kv
            if not self._fetch_next_batch():
                raise StopIteration

    def _fetch_next_batch(self) -> bool:

        while self._part_idx < len(self._partitions):
            server = self._partitions[self._part_idx]
            if self._context_id is None:
                resp = server.on_get_scanner(self._request)
            else:
                resp = server.on_scan(self._context_id)
                if resp.context_id == SCAN_CONTEXT_ID_NOT_EXIST:
                    # server GC'd the context (5-min expiry): restart past
                    # the last served key (parity: pegasus_scanner_impl
                    # reissues get_scanner on context loss)
                    self._context_id = None
                    restart = self._request
                    if self._last_key is not None:
                        restart = replace(self._request,
                                          start_key=self._last_key + b"\x00",
                                          start_inclusive=True)
                    resp = server.on_get_scanner(restart)
            if resp.error != int(StorageStatus.OK):
                raise RuntimeError(f"scan failed: error {resp.error}")
            self.shipped_bytes += resp.wire_bytes()
            if resp.kv_count >= 0:
                self.kv_count += resp.kv_count
            buf = resp.kvs
            spec = self._request.pushdown
            vf = spec.value_filter if spec is not None else None
            if vf is not None and not resp.pushdown_applied:
                # pre-pushdown server (or pushdown disabled): the spec
                # was ignored and full pages streamed — same result,
                # evaluated locally
                buf = [kv for kv in buf
                       if host_match_filter(kv.value, vf[0], vf[1])]
            self._buffer = buf
            self._buf_pos = 0
            if resp.context_id == SCAN_CONTEXT_ID_COMPLETED:
                self._part_idx += 1
                self._context_id = None
            else:
                self._context_id = resp.context_id
            if self._buffer:
                return True
        return False

    # ---- aggregate pushdown -------------------------------------------

    def count(self) -> int:
        """Matching-row count over this scanner's range, evaluated
        server-side where possible (one tiny partial per partition on
        the wire; pre-pushdown servers stream rows and the count happens
        here). Respects the scanner's value filter."""
        return self.aggregate("count")

    def aggregate(self, kind: str, k: int = 0, seed: int = 0):
        """Run this scanner's range as ONE aggregate — `count`,
        `sum` (values as u64), `top_k` (by sort key, k required) or
        `sample` (reservoir, k required) — merged across partitions.
        Consumes the range independently of iteration (does not touch
        the paging cursor)."""

        base = self._request.pushdown or PushdownSpec()
        spec = replace(base, aggregate=kind, k=int(k), seed=int(seed))
        spec.check()
        req = replace(self._request, pushdown=spec,
                      one_page=False, only_return_count=False)
        parts = [self._aggregate_partition(server, req, spec)
                 for server in self._partitions]
        return pushdown_ops.finalize(
            spec, pushdown_ops.merge_partials(spec, parts))

    def _aggregate_partition(self, server, req, spec):
        resp = server.on_get_scanner(req)
        rows: List[Tuple[bytes, bytes]] = []  # fallback accumulation
        last_key: Optional[bytes] = None
        while True:
            if resp.context_id == SCAN_CONTEXT_ID_NOT_EXIST:
                # server GC'd the context. In aggregate mode the partial
                # lives SERVER-side, so losing the context lost every
                # page it folded — restart from the original start with
                # nothing accumulated: no double count by construction.
                # The local-fallback path (rows collected here) resumes
                # past the last collected key like a plain scan.

                if rows and last_key is not None:
                    resp = server.on_get_scanner(replace(
                        req, start_key=last_key + b"\x00",
                        start_inclusive=True))
                else:
                    rows.clear()
                    resp = server.on_get_scanner(req)
                continue
            if resp.error != int(StorageStatus.OK):
                raise RuntimeError(f"scan failed: error {resp.error}")
            self.shipped_bytes += resp.wire_bytes()
            for kv in resp.kvs:
                rows.append((kv.key, kv.value))
                last_key = kv.key
            if resp.context_id == SCAN_CONTEXT_ID_COMPLETED:
                break
            resp = server.on_scan(resp.context_id)
        if resp.agg is not None:
            return resp.agg
        # pre-pushdown server streamed rows: evaluate the whole spec here
        vf = spec.value_filter
        st = pushdown_ops.AggState(spec)
        for key, value in rows:
            if vf is not None and not host_match_filter(value, vf[0], vf[1]):
                continue
            st.fold_row(key, value)
        return st.to_wire()

    def close(self) -> None:
        if self._context_id is not None and self._part_idx < len(self._partitions):
            self._partitions[self._part_idx].on_clear_scanner(self._context_id)
            self._context_id = None


class PegasusClient:
    def __init__(self, table: Table) -> None:
        self._table = table

    @property
    def device(self):
        """The device the table's partitions serve on."""
        return self._table.device

    def _dispatch(self, hash_key: bytes, sort_key: bytes, op):
        """Route, dispatch, and re-resolve on a stale-route rejection.

        The server rejects requests whose partition_hash no longer maps to
        it after a split (ERR_PARENT_PARTITION_MISUSED); re-resolving picks
        up the new partition count — parity with partition_resolver's
        config-refresh-on-error loop (partition_resolver_simple.h:56).
        """
        resp = None
        for _ in range(3):
            server, ph = self._table.route(hash_key, sort_key)
            resp = op(server, ph)
            if _err_of(resp) != _MISROUTED:
                return resp
        return resp

    # ---- single-record ops --------------------------------------------

    def set(self, hash_key: bytes, sort_key: bytes, value: bytes,
            ttl_seconds: int = 0) -> int:
        key = generate_key(hash_key, sort_key)
        return self._dispatch(hash_key, sort_key, lambda s, ph: s.on_put(
            key, value, ttl_seconds, partition_hash=ph))

    def get(self, hash_key: bytes, sort_key: bytes) -> Tuple[int, bytes]:
        key = generate_key(hash_key, sort_key)
        return self._dispatch(hash_key, sort_key,
                              lambda s, ph: s.on_get(key, partition_hash=ph))

    def delete(self, hash_key: bytes, sort_key: bytes) -> int:
        key = generate_key(hash_key, sort_key)
        return self._dispatch(hash_key, sort_key, lambda s, ph: s.on_remove(
            key, partition_hash=ph))

    def exist(self, hash_key: bytes, sort_key: bytes) -> bool:
        return self.get(hash_key, sort_key)[0] == int(StorageStatus.OK)

    def ttl(self, hash_key: bytes, sort_key: bytes) -> Tuple[int, int]:
        key = generate_key(hash_key, sort_key)
        return self._dispatch(hash_key, sort_key,
                              lambda s, ph: s.on_ttl(key, partition_hash=ph))

    def incr(self, hash_key: bytes, sort_key: bytes, increment: int,
             ttl_seconds: int = 0):
        req = IncrRequest(generate_key(hash_key, sort_key), increment,
                          ttl_seconds)
        return self._dispatch(hash_key, sort_key, lambda s, ph: s.on_incr(
            req, partition_hash=ph))

    # ---- multi ops ----------------------------------------------------

    def multi_set(self, hash_key: bytes,
                  kvs: Dict[bytes, bytes] | Sequence[Tuple[bytes, bytes]],
                  ttl_seconds: int = 0) -> int:
        if not hash_key:
            # parity: PERR_INVALID_HASH_KEY (pegasus_client_impl.cpp:177) —
            # multi-key records validate by crc64(hash_key); an empty one
            # would be routed and validated inconsistently
            return int(StorageStatus.INVALID_ARGUMENT)
        items = kvs.items() if isinstance(kvs, dict) else kvs
        req = MultiPutRequest(hash_key,
                              [KeyValue(k, v) for k, v in items],
                              ttl_seconds)
        return self._dispatch(hash_key, b"", lambda s, ph: s.on_multi_put(
            req, partition_hash=ph))

    def multi_get(self, hash_key: bytes,
                  sort_keys: Optional[Sequence[bytes]] = None,
                  start_sortkey: bytes = b"", stop_sortkey: bytes = b"",
                  max_kv_count: int = -1, max_kv_size: int = -1,
                  start_inclusive: bool = True, stop_inclusive: bool = False,
                  sort_key_filter_type: int = FT_NO_FILTER,
                  sort_key_filter_pattern: bytes = b"",
                  no_value: bool = False, reverse: bool = False
                  ) -> Tuple[int, Dict[bytes, bytes]]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), {}
        req = MultiGetRequest(
            hash_key, sort_keys=list(sort_keys or []),
            max_kv_count=max_kv_count, max_kv_size=max_kv_size,
            no_value=no_value, start_sortkey=start_sortkey,
            stop_sortkey=stop_sortkey, start_inclusive=start_inclusive,
            stop_inclusive=stop_inclusive,
            sort_key_filter_type=sort_key_filter_type,
            sort_key_filter_pattern=sort_key_filter_pattern, reverse=reverse)
        resp = self._table.resolve(hash_key).on_multi_get(req)
        return resp.error, {kv.key: kv.value for kv in resp.kvs}

    def multi_get_sortkeys(self, hash_key: bytes
                           ) -> Tuple[int, List[bytes]]:
        """All sort keys under a hash key, paginating past the server's
        one-shot read budget (INCOMPLETE pages resume from the server's
        resume_sort_key — without this, large hash keys silently
        truncate)."""

        def fetch(cursor: bytes, inclusive: bool):
            req = MultiGetRequest(hash_key, no_value=True,
                                  start_sortkey=cursor,
                                  start_inclusive=inclusive)
            return self._table.resolve(hash_key).on_multi_get(req)

        return paginate_sortkeys(fetch)

    def multi_del(self, hash_key: bytes, sort_keys: Sequence[bytes]
                  ) -> Tuple[int, int]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), 0
        req = MultiRemoveRequest(hash_key, list(sort_keys))
        return self._dispatch(hash_key, b"", lambda s, ph: s.on_multi_remove(
            req, partition_hash=ph))

    def batch_get(self, keys: Sequence[Tuple[bytes, bytes]]
                  ) -> Tuple[int, List[Tuple[bytes, bytes, bytes]]]:
        """Point-gets across partitions; groups by partition server."""
        by_server: Dict[int, List[FullKey]] = {}
        for hk, sk in keys:
            pidx = self._table.resolve(hk, sk).pidx
            by_server.setdefault(pidx, []).append(FullKey(hk, sk))
        out: List[Tuple[bytes, bytes, bytes]] = []
        for pidx, fks in by_server.items():
            resp = self._table.partitions[pidx].on_batch_get(
                BatchGetRequest(fks))
            if resp.error != int(StorageStatus.OK):
                return resp.error, []
            out.extend((d.hash_key, d.sort_key, d.value) for d in resp.data)
        return int(StorageStatus.OK), out

    def sortkey_count(self, hash_key: bytes) -> Tuple[int, int]:
        if not hash_key:
            return int(StorageStatus.INVALID_ARGUMENT), 0
        return self._table.resolve(hash_key).on_sortkey_count(hash_key)

    def check_and_set(self, hash_key: bytes, check_sort_key: bytes,
                      check_type: int, check_operand: bytes,
                      set_sort_key: bytes, set_value: bytes,
                      ttl_seconds: int = 0,
                      return_check_value: bool = False
                      ) -> CheckAndSetResponse:
        if not hash_key:
            # deviation from the reference (which only rejects oversized
            # hash keys here): with partition-hash validation always on for
            # pow-2 tables, an empty-hashkey cas record could never satisfy
            # the stale-key predicate on its routed partition
            resp = CheckAndSetResponse()
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp
        req = CheckAndSetRequest(
            hash_key, check_sort_key, check_type, check_operand,
            set_diff_sort_key=(set_sort_key != check_sort_key),
            set_sort_key=set_sort_key, set_value=set_value,
            set_expire_ts_seconds=ttl_seconds,
            return_check_value=return_check_value)
        return self._dispatch(hash_key, b"", lambda s, ph: s.on_check_and_set(
            req, partition_hash=ph))

    def check_and_mutate(self, hash_key: bytes, check_sort_key: bytes,
                         check_type: int, check_operand: bytes,
                         mutates: Sequence[Mutate],
                         return_check_value: bool = False
                         ) -> CheckAndMutateResponse:
        if not hash_key:
            resp = CheckAndMutateResponse()
            resp.error = int(StorageStatus.INVALID_ARGUMENT)
            return resp
        req = CheckAndMutateRequest(
            hash_key, check_sort_key, check_type, check_operand,
            mutate_list=list(mutates),
            return_check_value=return_check_value)
        return self._dispatch(hash_key, b"",
                              lambda s, ph: s.on_check_and_mutate(
                                  req, partition_hash=ph))

    @property
    def partition_count(self) -> int:
        return self._table.partition_count

    def scan_page(self, pidx: int, context_id: int):
        """Continue a server-held scan context (batched-path paging)."""
        return self._table.partitions[pidx].on_scan(context_id)

    def scan_abort(self, pidx: int, context_id: int) -> None:
        self._table.partitions[pidx].on_clear_scanner(context_id)

    def scan_multi(self, groups):
        """Batched scans for many partitions (in-process form): the
        node-level coordinator stacks every partition's blocks into one
        device evaluation — same API shape as the cluster client's."""

        pairs = [(self._table.partitions[pidx], reqs)
                 for pidx, reqs in groups.items()]
        results = scan_multi(pairs, epoch_now())
        return {pidx: resps for (pidx, _reqs), resps
                in zip(groups.items(), results)}

    def point_read_multi(self, groups):
        """Batched point reads for many partitions (in-process form):
        one coordinator flush serves every partition's get / ttl /
        multi_get(sort keys) / batch_get ops — same API shape as the
        cluster client's. `groups`: {pidx: [(op, args,
        partition_hash)]} -> {pidx: [result]}."""

        pairs = [(self._table.partitions[pidx], ops)
                 for pidx, ops in groups.items()]
        results = point_read_multi(pairs)
        return {pidx: res for (pidx, _ops), res
                in zip(groups.items(), results)}

    # ---- scanners -----------------------------------------------------

    def get_scanner(self, hash_key: bytes, start_sortkey: bytes = b"",
                    stop_sortkey: bytes = b"",
                    options: Optional[ScanOptions] = None) -> PegasusScanner:
        """Ordered scan within one hashkey (single partition)."""

        if not hash_key:
            # parity: PERR_INVALID_HASH_KEY — "hash key cannot be empty
            # when scan" (pegasus_client_impl.cpp:1147)
            raise ValueError("hash key cannot be empty when scan")
        opts = options or ScanOptions()
        start_key = generate_key(hash_key, start_sortkey)
        if stop_sortkey:
            stop_key = generate_key(hash_key, stop_sortkey)
        else:
            stop_key = generate_next_bytes(hash_key)
            # stop bound is exclusive of the whole hashkey range; force
            # stop_inclusive off so _after() isn't applied to it
            opts = replace(opts, stop_inclusive=False)
        req = self._make_scan_request(start_key, stop_key, opts)
        return PegasusScanner([self._table.resolve(hash_key)], req)

    def get_unordered_scanners(self, max_split_count: int,
                               options: Optional[ScanOptions] = None
                               ) -> List[PegasusScanner]:
        """Full-table scan fan-out (parity: client.h:1164): partitions are
        divided among up to max_split_count scanners the caller can drive
        in parallel."""
        if max_split_count < 1:
            raise ValueError("max_split_count must be >= 1")
        opts = options or ScanOptions()
        partitions = self._table.all_partitions()
        split = min(max_split_count, len(partitions))
        groups: List[List[PartitionServer]] = [[] for _ in range(split)]
        for i, p in enumerate(partitions):
            groups[i % split].append(p)
        req = self._make_scan_request(b"", b"", opts, full_scan=True)
        return [PegasusScanner(g, req) for g in groups if g]

    @staticmethod
    def _make_scan_request(start_key: bytes, stop_key: bytes,
                           opts: ScanOptions,
                           full_scan: bool = False) -> GetScannerRequest:
        pushdown = None
        if opts.value_filter_type != FT_NO_FILTER:
            pushdown = PushdownSpec(
                value_filter_type=opts.value_filter_type,
                value_filter_pattern=opts.value_filter_pattern)
            pushdown.check()
        return GetScannerRequest(
            start_key=start_key, stop_key=stop_key,
            start_inclusive=opts.start_inclusive,
            stop_inclusive=opts.stop_inclusive,
            batch_size=opts.batch_size, no_value=opts.no_value,
            hash_key_filter_type=opts.hash_key_filter_type,
            hash_key_filter_pattern=opts.hash_key_filter_pattern,
            sort_key_filter_type=opts.sort_key_filter_type,
            sort_key_filter_pattern=opts.sort_key_filter_pattern,
            validate_partition_hash=True,
            return_expire_ts=opts.return_expire_ts,
            full_scan=full_scan,
            only_return_count=opts.only_return_count,
            pushdown=pushdown)
