"""The one traffic generator: records and requests drawn from `--seed`,
shaped by a configuration file and a traffic file.

Records follow bench.py's layout (bench.py:199-236): hashkeys
`user%08d`, one sortkey `s%02d` per YCSB field, values of the
configuration's field length, a share written already expired. Record
numbers are h * fields + f.

Requests follow YCSB's core workload E (workloads/workloade): keys chosen by YCSB's scrambled zipfian
(ScrambledZipfianGenerator: a zipfian rank over 10^10 items with the
constant 0.99, hashed by FNV-1a 64 and taken modulo the item count),
scan lengths uniform in records, inserts of new records in sequence;
every seed draws the same requests in another order (`Requests`). The
traffic file names the mix; this module has no cell of its own.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.kv import crc64, hashkey, hashkey_crc

# YCSB ScrambledZipfianGenerator: ITEM_COUNT, ZETAN and the constant
ZIPF_ITEMS = 10_000_000_000
ZIPF_ZETAN = 26.46902820178302
ZIPF_THETA = 0.99
FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211

# requests a block: every seed draws the same blocks, each in its own
# order; and the fixed seed of the blocks
BLOCK = 64
POOL_SEED = 0x59435342


def fnvhash64(vals: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64 of each int64: FNV-1a over its 8 bytes,
    low byte first, then Math.abs of the signed result."""
    v = vals.astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_64, dtype=np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= prime
    return np.abs(h.view(np.int64))


def zipfian_ranks(rng, size: int, items: int = ZIPF_ITEMS,
                  theta: float = ZIPF_THETA,
                  zetan: float = ZIPF_ZETAN) -> np.ndarray:
    """YCSB's ZipfianGenerator.nextLong(items): Gray et al.'s method."""
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(size)
    uz = u * zetan
    ranks = (items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ranks[uz < 1.0 + 0.5 ** theta] = 1
    ranks[uz < 1.0] = 0
    return ranks


def scrambled_zipfian(rng, size: int, itemcount: int,
                      theta: float = ZIPF_THETA) -> np.ndarray:
    if theta != ZIPF_THETA:
        raise ValueError("the scrambled zipfian's zetan is YCSB's, for "
                         "the constant 0.99 only")
    return fnvhash64(zipfian_ranks(rng, size)) % itemcount


class Dataset:
    """The table's records, drawn from the seed."""

    def __init__(self, config: dict, seed: int) -> None:
        self.hashkeys = int(config["hashkeys"])
        self.fields = int(config["fields"])
        self.value_bytes = int(config["field_bytes"])
        self.partitions = int(config["partitions"])
        rng = np.random.default_rng([seed, 0])
        self.expired = (rng.random((self.hashkeys, self.fields))
                        < float(config["expired_share"]))
        self.crc = hashkey_crc(0, self.hashkeys)
        self.route = (self.crc % np.uint64(self.partitions)).astype(np.int64)
        self._new: dict = {}

    def partition_of(self, h: int) -> int:
        if h < self.hashkeys:
            return int(self.route[h])
        p = self._new.get(h)
        if p is None:
            p = self._new[h] = crc64(hashkey(h)) % self.partitions
        return p

    @property
    def records(self) -> int:
        return self.hashkeys * self.fields


class Requests:
    """The cell's calls in order: each call one of ("scan", [(h, rows)])
    or ("insert", h).

    Every seed gets the same requests in another order: the requests are
    drawn in blocks of BLOCK from a generator of fixed seed, and `--seed`
    only permutes each block. So the work of a window does not hang on
    the seed, while its order, and the records written expired, do.

    As YCSB's CoreWorkload: a scan's length is drawn in records and
    reads each record's every field (readallfields), so it asks for
    records x fields rows; the scrambled zipfian spans the loaded
    records and operationcount x insertproportion x 2 more (its
    `expectednewkeys`); a start key past the acknowledged records is
    drawn again (`nextKeynum`), from a second generator of fixed seed."""

    def __init__(self, traffic: dict, data: Dataset, seed: int) -> None:
        self.t = traffic
        self.data = data
        self.pool = np.random.default_rng(POOL_SEED)
        self.redraws = np.random.default_rng(POOL_SEED + 1)
        self.order = np.random.default_rng([seed, 1])
        mix = traffic["mix"]
        self.kinds = sorted(mix)
        self.cum = np.cumsum([float(mix[k]) for k in self.kinds])
        if abs(self.cum[-1] - 1.0) > 1e-9:
            raise ValueError(f"the mix's shares add up to {self.cum[-1]}")
        self.batch = int(traffic.get("batch", 1))
        lo, hi = traffic.get("scan_records", (1, 1))
        self.scan_lo, self.scan_hi = int(lo), int(hi)
        expected_new = int(int(traffic.get("operationcount", 0))
                           * float(mix.get("insert", 0.0)) * 2.0)
        self.itemcount = data.hashkeys + expected_new
        self.next_insert = data.hashkeys   # YCSB's insert key sequence
        self.acked = data.hashkeys         # records a request may name

    def _block(self) -> list:
        """BLOCK requests (kind, key, records) from the fixed pool, in
        the seed's order."""
        pool = self.pool
        kinds = np.minimum(np.searchsorted(self.cum, pool.random(BLOCK),
                                           side="right"),
                           len(self.kinds) - 1)
        keys = scrambled_zipfian(pool, BLOCK, self.itemcount)
        lengths = pool.integers(self.scan_lo, self.scan_hi + 1, BLOCK)
        rows = list(zip([self.kinds[k] for k in kinds], keys.tolist(),
                        lengths.tolist()))
        return [rows[i] for i in self.order.permutation(BLOCK)]

    def acknowledge(self, h: int) -> None:
        """Record h was written: later requests may name it."""
        self.acked = max(self.acked, h + 1)

    def _named(self, key: int) -> int:
        while key >= self.acked:
            key = int(scrambled_zipfian(self.redraws, 1, self.itemcount)[0])
        return key

    def calls(self):
        """Calls forever. Scans are coalesced: they wait until `batch`
        were drawn, and go out as one call; an insert goes out when it
        is drawn."""
        pending: list = []
        fields = self.data.fields
        while True:
            for kind, key, records in self._block():
                if kind == "insert":
                    h = self.next_insert
                    self.next_insert += 1
                    yield "insert", h
                elif kind == "scan":
                    pending.append((self._named(key), records * fields))
                    if len(pending) >= self.batch:
                        yield "scan", pending
                        pending = []
                else:
                    raise ValueError(f"unknown request kind {kind!r}")
