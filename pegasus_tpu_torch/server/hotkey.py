"""Hotkey detection: find hot hashkeys from the request stream.

Parity: src/server/hotkey_collector.h:93 — two-phase detection started
on demand (on_detect_hotkey RPC, pegasus_server_impl.h:470):
1. COARSE: hashkeys bucket by hash into a small array of counters; a
   bucket whose count is a variance outlier (z-score over buckets,
   hotkey_collector.cpp find_outlier_index) flags phase 2.
2. FINE: only keys landing in the hot bucket are counted individually;
   the dominant key is reported.

Counting is vectorized (numpy) over batches of captured hashkeys — the
server feeds whole request batches, not one key at a time.

The port's copy of the JAX package's server/hotkey.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import enum
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from pegasus_tpu_torch.base.crc import crc64_batch

BUCKET_COUNT = 37  # prime, parity with the reference's small bucket array
COARSE_ZSCORE_THRESHOLD = 3.0
FINE_DOMINANCE = 0.5  # a key owning half the hot bucket's traffic wins


class HotkeyState(enum.Enum):
    STOPPED = "stopped"
    COARSE = "coarse"
    FINE = "fine"
    FINISHED = "finished"


class HotkeyCollector:
    def __init__(self) -> None:
        self.state = HotkeyState.STOPPED
        self._coarse = np.zeros(BUCKET_COUNT, dtype=np.int64)
        self._hot_bucket: Optional[int] = None
        self._fine: Counter = Counter()
        self.result: Optional[bytes] = None

    def start(self) -> None:
        self.state = HotkeyState.COARSE
        self._coarse[:] = 0
        self._hot_bucket = None
        self._fine.clear()
        self.result = None

    def stop(self) -> None:
        self.state = HotkeyState.STOPPED

    def hot_hash_key(self) -> Optional[bytes]:
        """The detected-hot hashkey once a detection FINISHES, else
        None — the node row cache's fast-admit signal: a hashkey the
        two-phase detector already flagged earns caching on first
        touch instead of waiting out the repeat-hit gate."""
        return self.result if self.state is HotkeyState.FINISHED else None

    def hot_share(self) -> float:
        """Share (0..1) of fine-phase traffic owned by the detected-hot
        hashkey; 0 before a detection FINISHES. Owned here (not read
        through the private counter from outside) because a concurrent
        `start()` clears the counter mid-iteration — callers on other
        threads (the config-sync workload digest) get 0 for that racy
        instant instead of a RuntimeError."""
        hot = self.hot_hash_key()
        if hot is None:
            return 0.0
        try:
            total = sum(self._fine.values())
            top = self._fine.get(hot, 0)
        except RuntimeError:  # restart cleared the counter mid-sum
            return 0.0
        return top / total if total else 0.0

    def capture(self, hash_keys: Sequence[bytes]) -> None:
        """Feed a batch of request hashkeys (called from read/write
        dispatch paths while a detection is running)."""
        if self.state not in (HotkeyState.COARSE, HotkeyState.FINE):
            return
        if not hash_keys:
            return
        # vectorized bucketing: one crc64_batch over the padded batch
        # instead of a per-key Python loop on the dispatch path
        width = max(len(hk) for hk in hash_keys)
        arr = np.zeros((len(hash_keys), max(1, width)), dtype=np.uint8)
        lens = np.zeros(len(hash_keys), dtype=np.int64)
        for i, hk in enumerate(hash_keys):
            arr[i, :len(hk)] = np.frombuffer(hk, dtype=np.uint8)
            lens[i] = len(hk)
        buckets = (crc64_batch(arr, lens)
                   % np.uint64(BUCKET_COUNT)).astype(np.int64)
        if self.state == HotkeyState.COARSE:
            np.add.at(self._coarse, buckets, 1)
            self._maybe_promote()
        if self.state == HotkeyState.FINE:
            for hk, b in zip(hash_keys, buckets):
                if b == self._hot_bucket:
                    self._fine[hk] += 1
            self._maybe_finish()

    def _maybe_promote(self) -> None:
        """Coarse -> fine when one bucket is a z-score outlier (parity:
        find_outlier_index)."""
        total = int(self._coarse.sum())
        if total < 100:
            return
        mean = self._coarse.mean()
        std = self._coarse.std()
        if std == 0:
            return
        z = (self._coarse - mean) / std
        hot = int(z.argmax())
        if z[hot] >= COARSE_ZSCORE_THRESHOLD:
            self._hot_bucket = hot
            self.state = HotkeyState.FINE

    def _maybe_finish(self) -> None:
        total = sum(self._fine.values())
        if total < 100:
            return
        key, count = self._fine.most_common(1)[0]
        if count >= total * FINE_DOMINANCE:
            self.result = key
            self.state = HotkeyState.FINISHED


def hotspot_partition_indices(partition_qps: Sequence[float],
                              threshold: float = 3.0) -> List[int]:
    """Cluster-side hotspot detection: z-score over per-partition QPS
    (parity: src/server/hotspot_partition_calculator.h:46 — the collector
    flags partitions whose load is a variance outlier)."""
    qps = np.asarray(partition_qps, dtype=float)
    if len(qps) < 2:
        return []
    std = qps.std()
    if std == 0:
        return []
    z = (qps - qps.mean()) / std
    return [int(i) for i in np.flatnonzero(z >= threshold)]
