"""Faults planted under a run, and the control, to show that the
comparison which decides `correct` fails them.

Each `plant_<fault>(system, loop)` breaks the timed path underneath the
harness before the window, at the client's boundary with the cluster:
- drop_insert: an insert is acknowledged and never written (a step that
  returns its state unchanged);
- half_batch: the second half of each batched call is left out (empty
  pages);
- alter_answer: one answer of each call is altered where it is produced
  (a value byte of a served row);
- fail_calls: every tenth call never answers (it raises);
- flush_in_window: the fullest memtable is flushed into an L0 run a few
  calls into the window (background work the window must not hold).

The control (`ControlSystem`) puts the plain reference in the program's
place with one of the configuration's guarantees broken: records
written already expired are served as live.
"""

from __future__ import annotations

import copy

import numpy as np

from benchmark.reference.kv import Table


def _flip(value: bytes) -> bytes:
    return value[:-1] + bytes([value[-1] ^ 0x01])


def plant_drop_insert(system, loop) -> None:
    loop.client.multi_set = lambda hash_key, kvs, ttl_seconds=0: 0


def plant_half_batch(system, loop) -> None:
    client = loop.client
    scan_multi = client.scan_multi

    def half_scans(groups, consistency=None):
        out = scan_multi(groups, consistency)
        for resps in out.values():
            for i in range(len(resps) // 2, len(resps)):
                resps[i] = copy.copy(resps[i])
                resps[i].kvs = []
        return out

    client.scan_multi = half_scans


def plant_alter_answer(system, loop) -> None:
    client = loop.client
    scan_multi = client.scan_multi

    def altered_scans(groups, consistency=None):
        out = scan_multi(groups, consistency)
        for resps in out.values():
            for i, resp in enumerate(resps):
                if resp.kvs:
                    kv = copy.copy(resp.kvs[0])
                    kv.value = _flip(kv.value)
                    resps[i] = copy.copy(resp)
                    resps[i].kvs = [kv] + resp.kvs[1:]
                    return out
        return out

    client.scan_multi = altered_scans


def plant_fail_calls(system, loop) -> None:
    client = loop.client
    calls = {"n": 0}

    def failing(fn):
        def call(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] % 10 == 0:
                raise RuntimeError("planted: the call never answers")
            return fn(*args, **kwargs)
        return call

    client.scan_multi = failing(client.scan_multi)
    client.multi_set = failing(client.multi_set)


def plant_flush_in_window(system, loop, after: int = 5) -> None:
    """`after` calls into the window (the warm-up's calls come first)."""
    at = int(loop.requests.t.get("warmup_calls", 0)) + after
    calls = {"n": 0}
    step = loop.step

    def flushing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == at:
            fullest = max(system.servers(),
                          key=lambda s: len(s.engine.lsm.memtable))
            fullest.flush()
        return step(*args, **kwargs)

    loop.step = flushing


FAULTS = {"drop_insert": plant_drop_insert,
          "half_batch": plant_half_batch,
          "alter_answer": plant_alter_answer,
          "fail_calls": plant_fail_calls,
          "flush_in_window": plant_flush_in_window}


# ---- the control --------------------------------------------------------


class _Row:
    __slots__ = ("key", "value")

    def __init__(self, key: bytes, value: bytes) -> None:
        self.key, self.value = key, value


class _Page:
    def __init__(self, rows) -> None:
        self.error = 0
        self.kvs = [_Row(k, v) for k, v in rows]


class ControlClient:
    """The client surface `core/loop.Loop` uses, answered by the plain
    reference over a table in which no record expired."""

    def __init__(self, table: Table) -> None:
        self.table = table

    def scan_multi(self, groups, consistency=None):
        return {p: [_Page(self.table.page(p, r.start_key, r.batch_size))
                    for r in reqs] for p, reqs in groups.items()}

    def multi_set(self, hash_key: bytes, kvs, ttl_seconds: int = 0) -> int:
        self.table.insert(int(hash_key[4:]))
        return 0


class ControlSystem:
    """The `System` surface over the control: the records go into a
    reference table that serves the expired ones as live."""

    def __init__(self, config: dict, device, data_dir: str,
                 seed: int) -> None:
        self.data_dir = data_dir
        self.data = None

    def load_writes(self, puts: dict) -> int:
        return sum(map(len, puts.values()))

    def compact(self) -> None:
        pass

    def bulk_load(self, records, root: str) -> int:
        return len(records)

    def open_client(self):
        d = self.data
        table = Table(d.hashkeys, d.fields,
                      np.zeros_like(d.expired), d.partitions, d.value_bytes)
        return ControlClient(table)

    def lsm_state(self) -> dict:
        return {"l0_runs": 0, "l1_runs": 0, "memtable_rows": 0}

    def close(self) -> None:
        pass
