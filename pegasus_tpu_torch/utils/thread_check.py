"""Replica access-discipline checkers (race detection, SURVEY §5.2).

Parity: utils/thread_access_checker.h — the reference asserts each
replica is only ever touched from its pinned worker thread
(replica_2pc.cpp:115). Our runtime serializes replica access under the
node lock (TCP dispatcher + timer threads) or a single sim thread, so
the translated invariant is NO CONCURRENT ENTRY: two threads inside a
replica's mutating sections at once means a missing lock, and the
checker turns that silent race into a loud failure at the exact site.

Overhead is two attribute writes and an integer compare per guarded
section — cheap enough to stay on in production, like the reference's
checker in debug builds but without needing a special build.
"""

from __future__ import annotations

import threading


class SerialAccessChecker:
    """Asserts mutating sections never run concurrently.

    Usage:
        self._access = SerialAccessChecker("replica 1.3")
        ...
        with self._access:
            <mutating section>

    Re-entrant from the owning thread (a guarded method may call another
    guarded method); any second THREAD entering while one is inside
    raises RuntimeError naming both threads.
    """

    __slots__ = ("name", "_owner", "_depth")

    def __init__(self, name: str) -> None:
        self.name = name
        self._owner: int | None = None
        self._depth = 0

    def __enter__(self) -> "SerialAccessChecker":
        me = threading.get_ident()
        owner = self._owner
        if owner is not None and owner != me:
            raise RuntimeError(
                f"concurrent access to {self.name}: thread {me} entered "
                f"while thread {owner} is inside — a lock is missing "
                f"(single-writer discipline, replica_2pc.cpp:115)")
        self._owner = me
        self._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None


class ThreadAccessChecker:
    """Strict pinned-thread form (parity: thread_access_checker.h
    verbatim): every check() must come from the SAME thread for the
    object's lifetime. For objects genuinely owned by one thread (sim
    loop internals, per-connection parser state)."""

    __slots__ = ("name", "_ident")

    def __init__(self, name: str) -> None:
        self.name = name
        self._ident: int | None = None

    def check(self) -> None:
        me = threading.get_ident()
        if self._ident is None:
            self._ident = me
        elif self._ident != me:
            raise RuntimeError(
                f"{self.name} accessed from thread {me} but owned by "
                f"thread {self._ident}")
