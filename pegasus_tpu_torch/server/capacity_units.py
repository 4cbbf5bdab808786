"""Capacity-unit metering.

Parity: src/server/capacity_unit_calculator.h:50 — every request bills
read/write capacity units: 1 CU per started 4KB of key+value bytes
(min 1 per request), accumulated into per-partition counters.

The port's copy of the JAX package's server/capacity_units.py. Its
`client_write_units` (one client write's wire ops, billed at the
primary) needs `rpc.codec` and arrives with the replication slice.
"""

from __future__ import annotations

from pegasus_tpu_torch.utils.metrics import MetricEntity

CU_SIZE = 4096


def units(size: int) -> int:
    """CU for ONE request of `size` bytes (min 1 — the per-request
    floor the reference bills, capacity_unit_calculator.h:50)."""
    return max(1, (size + CU_SIZE - 1) // CU_SIZE)


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
