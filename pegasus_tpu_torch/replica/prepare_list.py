"""PrepareList: the sliding commit window of in-flight mutations.

Parity: src/replica/prepare_list.h:56,82 — a decree-indexed window
[last_committed+1, last_committed+capacity]; prepare() admits mutations
in decree order (same-decree re-prepare with a higher ballot replaces),
commit() advances last_committed and hands mutations to the apply
callback. Commit modes mirror the reference (prepare_list.cpp:100,132):

- COMMIT_TO_DECREE_HARD: commit everything <= d; gaps are fatal (used on
  secondaries following the primary's piggy-backed commit point).
- COMMIT_ALL_READY: commit the maximal contiguous prefix (used on the
  primary as acks arrive).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from pegasus_tpu_torch.replica.mutation import Mutation

COMMIT_TO_DECREE_HARD = 0
COMMIT_ALL_READY = 1
COMMIT_TO_DECREE_SOFT = 2


class PrepareList:
    def __init__(self, last_committed: int, capacity: int,
                 committer: Callable[[Mutation], None]) -> None:
        self._mutations: Dict[int, Mutation] = {}
        self._last_committed = last_committed
        self._capacity = capacity
        self._committer = committer
        self._ready: set[int] = set()  # decrees acked/ready to commit

    @property
    def last_committed_decree(self) -> int:
        return self._last_committed

    def max_decree(self) -> int:
        return max(self._mutations, default=self._last_committed)

    def count(self) -> int:
        return len(self._mutations)

    def get_mutation_by_decree(self, decree: int) -> Optional[Mutation]:
        return self._mutations.get(decree)

    def prepare(self, mu: Mutation) -> None:
        if mu.decree <= self._last_committed:
            return  # already committed; stale re-send
        if mu.decree > self._last_committed + self._capacity:
            raise ValueError(
                f"decree {mu.decree} beyond window "
                f"(last_committed={self._last_committed}, "
                f"capacity={self._capacity})")
        existing = self._mutations.get(mu.decree)
        if existing is not None and existing.ballot > mu.ballot:
            return  # keep the higher-ballot mutation
        self._mutations[mu.decree] = mu

    def mark_ready(self, decree: int) -> None:
        """Primary side: all replicas acked this decree."""
        if decree > self._last_committed:
            self._ready.add(decree)

    def commit(self, decree: int, mode: int) -> int:
        """Returns the number of mutations committed."""
        n = 0
        if mode in (COMMIT_TO_DECREE_HARD, COMMIT_TO_DECREE_SOFT):
            while self._last_committed < decree:
                d = self._last_committed + 1
                mu = self._mutations.pop(d, None)
                if mu is None:
                    if mode == COMMIT_TO_DECREE_SOFT:
                        return n  # stop at the first gap (mid-learn state)
                    raise RuntimeError(
                        f"commit gap at decree {d} (target {decree})")
                self._last_committed = d
                self._ready.discard(d)
                self._committer(mu)
                n += 1
            return n
        if mode == COMMIT_ALL_READY:
            while (self._last_committed + 1) in self._ready:
                d = self._last_committed + 1
                mu = self._mutations.pop(d)
                self._last_committed = d
                self._ready.discard(d)
                self._committer(mu)
                n += 1
            return n
        raise ValueError(f"unknown commit mode {mode}")

    def reset(self, last_committed: int) -> None:
        """Drop everything and restart the window (post-learn, parity:
        reset_prepare_list_after_replay)."""
        self._mutations.clear()
        self._ready.clear()
        self._last_committed = last_committed
