"""The plain reference of the key-value configurations: what a Pegasus
table of `user%08d` hashkeys x `s00..s09` sortkeys serves, written from
the semantics alone.

It holds its own frozen copies of the two encodings a client and a
server must agree on: the routing hash crc64(hashkey) (rDSN's reflected
crc64, the polynomial of src/utils/crc.cpp:289-295) and the key
layout (a big-endian u16 hashkey length, the hashkey, the sortkey). It
imports nothing of the program, and takes only the records the
benchmark generated (record numbers and which of them were written
already expired) and the requests it sent.

The semantics held:
- a record written with an expire time in the past is never served;
- an acknowledged write is visible to every later read of its key;
- a one-page scan of `limit` rows from a start key answers the first
  `limit` live rows of that partition at or after the key, in key order.
"""

from __future__ import annotations

import bisect

import numpy as np

_CRC64_BITS = (63, 61, 59, 58, 56, 55, 52, 49, 48, 47, 46, 44, 41, 37, 36,
               34, 32, 31, 28, 26, 23, 22, 19, 16, 13, 12, 10, 9, 6, 4, 3, 0)
_M64 = (1 << 64) - 1


def _crc64_table() -> np.ndarray:
    poly = 0
    for n in _CRC64_BITS:
        poly |= 1 << (63 - n)
    table = []
    for i in range(256):
        k = i
        for _ in range(8):
            k = (k >> 1) ^ poly if k & 1 else k >> 1
        table.append(k)
    return np.array(table, dtype=np.uint64)


CRC64_TABLE = _crc64_table()


def crc64(data: bytes) -> int:
    crc = _M64
    for b in data:
        crc = int(CRC64_TABLE[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return ~crc & _M64


def crc64_rows(rows: np.ndarray) -> np.ndarray:
    """crc64 of each row of a uint8[n, w] array (every byte counts)."""
    crc = np.full(rows.shape[0], _M64, dtype=np.uint64)
    eight = np.uint64(8)
    for j in range(rows.shape[1]):
        idx = (crc ^ rows[:, j].astype(np.uint64)) & np.uint64(0xFF)
        crc = CRC64_TABLE[idx] ^ (crc >> eight)
    return ~crc


def hashkey(h: int) -> bytes:
    return b"user%08d" % h


def sortkey(f: int) -> bytes:
    return b"s%02d" % f


def encode_key(hash_key: bytes, sort_key: bytes = b"") -> bytes:
    return len(hash_key).to_bytes(2, "big") + hash_key + sort_key


def record_value(n: int, width: int) -> bytes:
    """Record n's value: `field<f>=` and n in decimal, zero-padded to
    `width` bytes (f = n % 10, the record's field)."""
    head = b"field%d=" % (n % 10)
    return head + b"%0*d" % (width - len(head), n)


def hashkey_crc(lo: int, hi: int) -> np.ndarray:
    """crc64 of each hashkey user%08d for h in [lo, hi)."""
    rows = np.frombuffer(b"".join(hashkey(h) for h in range(lo, hi)),
                         dtype=np.uint8).reshape(-1, 12)
    return crc64_rows(rows)


def route(lo: int, hi: int, partitions: int) -> np.ndarray:
    """Partition of each hashkey user%08d for h in [lo, hi): its crc64
    modulo the partition count."""
    return (hashkey_crc(lo, hi) % np.uint64(partitions)).astype(np.int64)


class Table:
    """The live records of one table, a sorted key list a partition.

    `expired`: bool[n_hashkeys, fields], the records written already
    expired. Records are numbered h * fields + f."""

    def __init__(self, n_hashkeys: int, fields: int, expired: np.ndarray,
                 partitions: int, value_bytes: int) -> None:
        self.fields = fields
        self.partitions = partitions
        self.value_bytes = value_bytes
        self.n_hashkeys = n_hashkeys
        self.expired = np.asarray(expired, dtype=bool)
        self.part_of = list(route(0, n_hashkeys, partitions).tolist())
        self.keys = [[] for _ in range(partitions)]
        self.number = {}                  # key -> record number (live)
        sks = [sortkey(f) for f in range(fields)]
        for h in range(n_hashkeys):
            p = self.part_of[h]
            hk = hashkey(h)
            for f in range(fields):
                if not self.expired[h, f]:
                    key = encode_key(hk, sks[f])
                    self.keys[p].append(key)
                    self.number[key] = h * fields + f
        for lst in self.keys:
            lst.sort()

    def partition_of(self, h: int) -> int:
        while h >= len(self.part_of):
            lo = len(self.part_of)
            self.part_of.extend(route(lo, lo + 1024, self.partitions)
                                .tolist())
        return self.part_of[h]

    def insert(self, h: int) -> None:
        """Every field of a new record h, written without a TTL."""
        p = self.partition_of(h)
        hk = hashkey(h)
        for f in range(self.fields):
            key = encode_key(hk, sortkey(f))
            if key not in self.number:
                bisect.insort(self.keys[p], key)
            self.number[key] = h * self.fields + f

    def value(self, key: bytes) -> bytes:
        return record_value(self.number[key], self.value_bytes)

    def page(self, pidx: int, start: bytes, limit: int) -> list:
        keys = self.keys[pidx]
        i = bisect.bisect_left(keys, start)
        return [(k, self.value(k)) for k in keys[i:i + limit]]

    def is_expired_key(self, key: bytes) -> bool:
        """Whether `key` names a generated record written expired."""
        hlen = int.from_bytes(key[:2], "big")
        hk, sk = key[2:2 + hlen], key[2 + hlen:]
        if not (hk.startswith(b"user") and sk.startswith(b"s")):
            return False
        try:
            h, f = int(hk[4:]), int(sk[1:])
        except ValueError:
            return False
        return (h < self.n_hashkeys and f < self.fields
                and bool(self.expired[h, f]))
