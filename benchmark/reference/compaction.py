"""The plain reference of the TTL-compaction configuration: the records
of a table of `user%08d` hashkeys x `s00..` sortkeys, drawn from the
seed, and what a manual compaction under the TTL filter must leave of
them, written from the semantics alone.

It imports nothing of the program. The routing hash is kv.py's frozen
crc64 of the hashkey; the key layout is its own (a big-endian u16
hashkey length, the hashkey, the sortkey, zero-padded to the key
width). The benchmark stages these same records into the program's
store, and the reference judges what a compaction pass left there.

The semantics held (key_ttl_compaction_filter.h:55-121, no default TTL
and no rules):
- a record whose expire time is set and not after the pass's `now` is
  not in the output;
- every other record is in the output once, with its key, its value and
  its expire time unchanged;
- a partition's rows, read in the order of its runs and their blocks,
  are in strictly increasing key order (a sorted run).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .kv import route

_M64 = (1 << 64) - 1

# the judged numbers, each with the limit 0
CHECKS = ("expired_kept", "live_lost", "rows_unexpected", "rows_misordered",
          "passes_failed")


@dataclass
class Records:
    """One partition's records in key order."""

    number: np.ndarray      # int64[n] record numbers
    keys: np.ndarray        # uint8[n, key_width]
    key_len: np.ndarray     # int32[n]
    values: np.ndarray      # uint8[n, value_bytes]
    expired: np.ndarray     # bool[n]: written with a TTL in the past


def key_rows(number: np.ndarray, sortkeys: int, width: int):
    """(uint8[n, width] key rows, int32[n] lengths) of records `number`:
    hashkey user%08d of number // sortkeys, sortkey s%02d of the rest."""
    n = number.size
    h, s = number // sortkeys, number % sortkeys
    keys = np.zeros((n, width), dtype=np.uint8)
    keys[:, 1] = 12
    keys[:, 2:6] = np.frombuffer(b"user", dtype=np.uint8)
    keys[:, 6:14] = h[:, None] // 10 ** np.arange(7, -1, -1) % 10 + 48
    keys[:, 14] = ord("s")
    keys[:, 15:17] = s[:, None] // np.array([10, 1]) % 10 + 48
    return keys, np.full(n, 17, dtype=np.int32)


class TtlTable:
    """The configuration's records, drawn from the seed one partition at
    a time: the same seed gives the same records, and every seed the
    same number of records and of expired records a partition."""

    def __init__(self, config: dict, seed: int) -> None:
        self.partitions = int(config["partitions"])
        self.sortkeys = int(config["sortkeys"])
        self.key_width = int(config["key_width"])
        self.value_bytes = int(config["value_bytes"])
        self.expired_share = float(config["expired_share"])
        records = int(float(config["store_gb"]) * 1e9
                      / float(config["record_bytes"]))
        self.hashkeys = records // self.sortkeys
        if not 0 < self.hashkeys < 10 ** 8 or self.sortkeys > 100:
            raise ValueError("the key layout holds 1 to 10^8 hashkeys "
                             "of at most 100 sortkeys")
        self.records = self.hashkeys * self.sortkeys
        self.seed = seed & _M64
        self.part_of = route(0, self.hashkeys, self.partitions)

    def partition(self, p: int) -> Records:
        h = np.flatnonzero(self.part_of == p)
        number = (h[:, None] * self.sortkeys
                  + np.arange(self.sortkeys)).ravel()
        keys, key_len = key_rows(number, self.sortkeys, self.key_width)
        rng = np.random.default_rng([self.seed, p])
        n = number.size
        # 64 printable characters, '0' to 'o', each equally likely
        values = np.frombuffer(rng.bytes(n * self.value_bytes),
                               dtype=np.uint8).reshape(n, self.value_bytes)
        values = (values & np.uint8(63)) + np.uint8(48)
        expired = np.zeros(n, dtype=bool)
        expired[rng.choice(n, round(n * self.expired_share),
                           replace=False)] = True
        return Records(number, keys, key_len, values, expired)


@dataclass
class Output:
    """The rows a compaction left in one partition, in the order its
    runs and blocks hold them."""

    keys: np.ndarray        # uint8[n, width]
    key_len: np.ndarray     # int32[n]
    expire_ts: np.ndarray   # uint32[n]
    value_offs: np.ndarray  # int64[n + 1], into value_heap
    value_heap: np.ndarray  # uint8[...]


def survivors(rec: Records, dead_ts: int, now: int, late_s: int = 0
              ) -> Output:
    """The plain compaction of one partition: the records whose expire
    time is unset or after `now - late_s`. `late_s` > 0 judges TTLs that
    many seconds late, the control's broken guarantee."""
    ets = np.where(rec.expired, np.uint32(dead_ts), np.uint32(0))
    keep = (ets == 0) | (ets.astype(np.int64) + late_s > now)
    n = int(keep.sum())
    vb = rec.values.shape[1]
    return Output(rec.keys[keep], rec.key_len[keep], ets[keep],
                  np.arange(n + 1, dtype=np.int64) * vb,
                  rec.values[keep].ravel())


def _rows(keys, key_len, expire_ts, value_offs, value_heap,
          value_width: int) -> np.ndarray:
    """uint8[n, w]: each row's key length, key, expire time, value length
    and value (zero-padded to value_width) side by side."""
    n = keys.shape[0]
    offs = np.asarray(value_offs, dtype=np.int64)
    lens = offs[1:] - offs[:-1]
    heap = np.asarray(value_heap, dtype=np.uint8)
    vals = np.zeros((n, value_width), dtype=np.uint8)
    if n and (lens == value_width).all() and \
            offs[-1] - offs[0] == n * value_width:
        vals[:] = heap[offs[0]:offs[-1]].reshape(n, value_width)
    else:
        for i in range(n):
            v = heap[offs[i]:offs[i + 1]][:value_width]
            vals[i, :v.size] = v
    return np.concatenate([
        _key_cols(keys, key_len),
        np.asarray(expire_ts, dtype="<u4").reshape(n, 1).view(np.uint8),
        lens.astype("<u4").reshape(n, 1).view(np.uint8), vals], axis=1)


def _key_cols(keys, key_len) -> np.ndarray:
    """uint8[n, 4 + width]: each row's key length and key row."""
    n = keys.shape[0]
    return np.concatenate([
        np.asarray(key_len, dtype="<i4").reshape(n, 1).view(np.uint8),
        np.asarray(keys, dtype=np.uint8)], axis=1)


def _widen(keys: np.ndarray, width: int) -> np.ndarray:
    """Key rows zero-padded to `width` bytes."""
    if keys.shape[1] == width:
        return keys
    out = np.zeros((keys.shape[0], width), dtype=np.uint8)
    out[:, :keys.shape[1]] = keys
    return out


def _void(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows)
    return rows.view(np.dtype((np.void, rows.shape[1]))).ravel()


class Judge:
    """Judges what a compaction pass left in each partition against its
    records, every pass's `now` at or after the expired records' expire
    time: expired records kept, live records missing or altered, rows
    that are no live record or repeat one, and rows out of key order.
    The rows a partition must hold are laid out once, at its first
    judgement."""

    def __init__(self, records: list) -> None:
        self.records = records
        self._want: list = [None] * len(records)

    def partition(self, p: int, out: Output) -> dict:
        rec = self.records[p]
        width = rec.values.shape[1]
        if out.value_offs.size > 1:
            width = max(width, int(np.diff(out.value_offs).max()))
        kw = max(rec.keys.shape[1], out.keys.shape[1])
        live = ~rec.expired
        want = self._want[p]
        if want is None or want.shape[1] != 12 + kw + width:
            n_live = int(live.sum())
            want = self._want[p] = _rows(
                _widen(rec.keys[live], kw), rec.key_len[live],
                np.zeros(n_live, dtype=np.uint32),
                np.arange(n_live + 1, dtype=np.int64) * rec.values.shape[1],
                rec.values[live].ravel(), width)
        got = _rows(_widen(out.keys, kw), out.key_len, out.expire_ts,
                    out.value_offs, out.value_heap, width)
        if got.shape == want.shape and np.array_equal(got, want):
            return {"expired_kept": 0, "live_lost": 0, "rows_unexpected": 0,
                    "rows_misordered": 0}
        kept = np.isin(_void(got[:, :4 + kw]), _void(_key_cols(
            _widen(rec.keys[rec.expired], kw), rec.key_len[rec.expired])))
        got_rows, want_rows = _void(got), _void(want)
        is_live = np.isin(got_rows, want_rows)
        live_got = got_rows[is_live]
        return {"expired_kept": int(kept.sum()),
                "live_lost": int(want.shape[0]
                                 - np.isin(want_rows, got_rows).sum()),
                "rows_unexpected": int((~is_live & ~kept).sum()
                                       + live_got.size
                                       - np.unique(live_got).size),
                "rows_misordered": misordered(out.keys, out.key_len)}


def misordered(keys: np.ndarray, key_len) -> int:
    """Rows whose key is not strictly after the key of the row before
    them, in the order the output holds them. Keys compare as their bytes
    do (memcmp, a key before every longer key it begins): the zero-padded
    rows by their first differing byte, equal rows by their length."""
    keys = np.asarray(keys, dtype=np.uint8)
    key_len = np.asarray(key_len, dtype=np.int64)
    if keys.shape[0] < 2:
        return 0
    a, b = keys[:-1], keys[1:]
    differ = a != b
    first = differ.argmax(axis=1)
    i = np.arange(a.shape[0])
    after = np.where(differ[i, first], b[i, first] > a[i, first],
                     key_len[1:] > key_len[:-1])
    return int((~after).sum())
