"""Capacity-unit metering.

Parity: src/server/capacity_unit_calculator.h:50 — every request bills
read/write capacity units: 1 CU per started 4KB of key+value bytes
(min 1 per request), accumulated into per-partition counters.

The port's copy of the JAX package's server/capacity_units.py.
"""

from __future__ import annotations

from pegasus_tpu_torch.utils.metrics import MetricEntity

CU_SIZE = 4096


def units(size: int) -> int:
    """CU for ONE request of `size` bytes (min 1 — the per-request
    floor the reference bills, capacity_unit_calculator.h:50)."""
    return max(1, (size + CU_SIZE - 1) // CU_SIZE)


def client_write_units(raw_ops) -> int:
    """CU for one client write's wire ops [(op_code, request)], the
    SAME per-op math replica._apply_mutation bills at apply time. Used
    by the stub's write handlers to debit the requesting tenant ONCE
    at the primary (apply runs in later dispatches on every member,
    where no client tenant is ambient — and billing each member's
    apply would charge a tenant its own replication factor)."""
    from pegasus_tpu_torch.rpc.codec import (
        OP_INCR,
        OP_MULTI_PUT,
        OP_MULTI_REMOVE,
        OP_PUT,
        OP_REMOVE,
    )

    cu = 0
    for op, req in raw_ops:
        if op == OP_PUT:
            cu += units(len(req[0]) + len(req[1]))
        elif op == OP_REMOVE:
            cu += units(len(req[0]))
        elif op == OP_MULTI_PUT:
            cu += units(len(req.hash_key) + sum(
                len(kv.key) + len(kv.value) for kv in req.kvs))
        elif op == OP_MULTI_REMOVE:
            cu += units(len(req.hash_key) + sum(
                len(sk) for sk in req.sort_keys))
        elif op == OP_INCR:
            cu += units(len(req.key))
        # CAS/CAM/ingest: unbilled at apply too — parity preserved
    return cu


class CapacityUnitCalculator:
    """Per-partition CU counters + the per-tenant budget feed: every
    billed unit ALSO debits the thread's ambient tenant (server/
    tenancy.py post-debit buckets), so the multi-tenant governor rides
    the exact accounting the reference already does — one funnel, two
    ledgers."""

    def __init__(self, entity: MetricEntity) -> None:
        self._read_cu = entity.counter("recent_read_cu")
        self._write_cu = entity.counter("recent_write_cu")
        from pegasus_tpu_torch.server.tenancy import TENANTS

        self._tenants = TENANTS

    def add_read(self, size: int) -> None:
        cu = units(size)
        self._read_cu.increment(cu)
        self._tenants.charge_ambient(cu)

    def add_read_units(self, cu: int) -> None:
        """Batch accounting: the caller pre-summed units(size) per
        request (hot scan path — one counter touch per batch)."""
        if cu:
            self._read_cu.increment(cu)
            self._tenants.charge_ambient(cu)

    def add_write(self, size: int) -> None:
        cu = units(size)
        self._write_cu.increment(cu)
        self._tenants.charge_ambient(cu)

    def add_write_units(self, cu: int) -> None:
        """Batch accounting: the caller pre-summed units(size) per
        request (mutation apply — one counter touch per mutation)."""
        if cu:
            self._write_cu.increment(cu)
            self._tenants.charge_ambient(cu)

    @property
    def read_cu(self) -> int:
        return self._read_cu.value()

    @property
    def write_cu(self) -> int:
        return self._write_cu.value()
