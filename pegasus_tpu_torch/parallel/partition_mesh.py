"""Partition-stacked predicate evaluation on the card.

The port's counterpart of pegasus_tpu/parallel/partition_mesh.py. The
JAX package sharded a table's stacked [P, B, K] image over a 2D device
mesh: partitions on the "dp" axis, the record batch on "sp", one jitted
program per step with the global counts psum-reduced over the mesh. The
port runs on one card, so a mesh here is the list of devices and its
(dp, sp) shape: on one H100 dp = sp = 1, and multi-card sharding is not
in scope (a mesh over several distinct devices raises at
`sharded_scan_step`). `make_mesh` keeps the JAX rules: a single device
degrades any requested dp to (1, 1) with a warning, and a device count
that dp does not divide raises ValueError.

`sharded_scan_step` is the Pallas contract of the scan kernel with
`now` (ops/fused_scan.scan_table's status bytes) over the stack
flattened to one block of P * B rows with a per-row pidx column; the
stack has no hash_lo, so a validating step hashes the keys (the scan
kernel's key-hash instance on the card). The host-computed `allowed`
gate (the reject-all ownership state per partition) and the three
counts follow as torch ops: XLA computed them outside any Pallas kernel,
and this function is off the serving path.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from pegasus_tpu_torch.ops.predicates import FilterSpec
from pegasus_tpu_torch.ops.record_block import RecordBlock

_M32 = 0xFFFFFFFF


class PartitionMesh(NamedTuple):
    devices: tuple  # torch.device, dp * sp of them, row-major
    dp: int         # partition-parallel axis size
    sp: int         # record-batch-parallel axis size

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> PartitionMesh:
    """A (dp, sp) mesh over `devices`, by default the cards of this host
    (the first `n_devices` of them); dp defaults to all. A single device
    degrades any requested dp to (1, 1) with a warning; a count that dp
    does not divide raises ValueError. Without `devices` and without
    CUDA it raises: the CPU is used only when the caller names it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices="
                               "[torch.device('cpu')] to build a mesh on "
                               "the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices:
            devices = devices[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if dp is None:
        dp = n
    if n == 1 and dp != 1:
        warnings.warn(f"single-device host: degrading mesh dp={dp} to a "
                      f"(1, 1) mesh", RuntimeWarning, stacklevel=2)
        dp = 1
    if n % dp:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    return PartitionMesh(devices, dp, n // dp)


class StackedBlocks(NamedTuple):
    """P partitions x B records, padded columnar, on one device."""

    keys: torch.Tensor         # uint8[P, B, K]
    key_len: torch.Tensor      # int32[P, B]
    hashkey_len: torch.Tensor  # int32[P, B]
    expire_ts: torch.Tensor    # int32[P, B], uint32 bits
    valid: torch.Tensor        # bool[P, B]
    pidx: torch.Tensor         # int32[P], uint32 bits: partition per slot


def stack_blocks(blocks: Sequence[RecordBlock],
                 pidx: Optional[Sequence[int]] = None) -> StackedBlocks:
    """Stack per-partition RecordBlocks (equal capacity and key width, one
    device) to [P, ...]."""
    if not blocks:
        raise ValueError("no blocks")
    caps = {(b.capacity, b.key_width) for b in blocks}
    if len(caps) > 1:
        raise ValueError(f"blocks must share shape, got {caps}")
    if pidx is None:
        pidx = list(range(len(blocks)))
    dev = blocks[0].device
    pidx_bits = (np.asarray(pidx, dtype=np.int64) & _M32).astype(
        np.uint32).view(np.int32)
    return StackedBlocks(
        keys=torch.stack([b.keys for b in blocks]),
        key_len=torch.stack([b.key_len for b in blocks]),
        hashkey_len=torch.stack([b.hashkey_len for b in blocks]),
        expire_ts=torch.stack([b.expire_ts for b in blocks]),
        valid=torch.stack([b.valid for b in blocks]),
        pidx=torch.from_numpy(pidx_bits.copy()).to(dev),
    )


def partition_allowed(pidx: np.ndarray, validate_hash: bool,
                      partition_version: int) -> np.ndarray:
    """bool[P]: the slots the ownership check may keep rows of — none
    when validating with partition_version < 0, pidx <= pv when
    validating, all otherwise (scan_block_predicate's reject-all gate)."""
    pidx = np.asarray(pidx, dtype=np.int64) & _M32
    if validate_hash and partition_version < 0:
        return np.zeros(len(pidx), dtype=bool)
    if validate_hash:
        return pidx <= partition_version
    return np.ones(len(pidx), dtype=bool)


def sharded_scan_step(pmesh: PartitionMesh, stacked: StackedBlocks, now: int,
                      sort_filter: Optional[FilterSpec] = None,
                      partition_version: int = -1,
                      validate_hash: bool = False):
    """One scan step over the stacked blocks on the mesh's device.

    Returns (keep bool[P, B], total kept, total expired, kept per
    partition int64[P]), tensors on the mesh's device."""
    from pegasus_tpu_torch.ops.fused_scan import (
        STATUS_EXPIRED,
        STATUS_KEEP,
        scan_table,
    )

    if len(set(pmesh.devices)) != 1:
        raise NotImplementedError("sharding over several devices is not "
                                  "ported: the mesh holds one device")
    dev = pmesh.device
    p, b, k = stacked.keys.shape
    flat = RecordBlock(
        stacked.keys.reshape(p * b, k).to(dev).contiguous(),
        stacked.key_len.reshape(p * b).to(dev).contiguous(),
        stacked.hashkey_len.reshape(p * b).to(dev).contiguous(),
        stacked.expire_ts.reshape(p * b).to(dev).contiguous(),
        stacked.valid.reshape(p * b).to(dev).contiguous(),
        None)
    pidx = stacked.pidx.to(dev)
    sort_filter = (FilterSpec.none(dev) if sort_filter is None
                   else FilterSpec.make(sort_filter.filter_type,
                                        sort_filter.raw, dev))
    status = scan_table([flat], [pidx.repeat_interleave(b)],
                        FilterSpec.none(dev), sort_filter, validate_hash,
                        max(partition_version, 0) & _M32, now=now)
    allowed = torch.from_numpy(partition_allowed(
        stacked.pidx.cpu().numpy(), validate_hash, partition_version)).to(dev)
    keep = (status == STATUS_KEEP).view(p, b) & allowed[:, None]
    expired = (status == STATUS_EXPIRED).view(p, b)
    return keep, keep.sum(), expired.sum(), keep.sum(dim=1)
