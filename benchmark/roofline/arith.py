"""The bytes and operations of the port's kernels, and the card's peaks:
the yardstick of every `<kernel>_roofline` metric, frozen here so that a
change to the program cannot move it.

Copied from chip_smoke.py (kernel_bound, table_bytes): every input byte
a launch needs read once and every output byte written once. The scan
kernel is the one kernel a cell's window launches.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12    # non-tensor peak (float32 rate)


def table_bytes(n: int, k: int, *, hash_filter: bool, sort_filter: bool,
                now: bool, validate: bool, pidx_column: bool,
                mask_rows: int = 1) -> int:
    """The bytes one scan-table launch over `n` records of key width `k`
    moves. Per record: valid 1 B; hash_lo 4 B (and the pidx column 4 B)
    with validation; expire_ts 4 B with `now`; the key row k B and
    hashkey_len 4 B with any filter, key_len 4 B with a sortkey filter.
    Output: a status byte with `now`, a packed keep bit without, in each
    of `mask_rows` rows (the flavour axis writes one row a flavour)."""
    per = 1
    if validate:
        per += 4 + (4 if pidx_column else 0)
    if now:
        per += 4
    if hash_filter or sort_filter:
        per += k + 4
    if sort_filter:
        per += 4
    return n * per + (n if now else mask_rows * -(-n // 8))


def kernel_bound(n: int, k: int, *, hash_filter: bool, sort_filter: bool,
                 now: bool, validate: bool, pidx_column: bool,
                 ops: float, mask_rows: int = 1):
    """(bound_ms, bound_by) of one scan-table launch: table_bytes over
    HBM, `ops` integer operations over the non-tensor peak, the larger."""
    nbytes = table_bytes(n, k, hash_filter=hash_filter,
                         sort_filter=sort_filter, now=now, validate=validate,
                         pidx_column=pidx_column, mask_rows=mask_rows)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")
