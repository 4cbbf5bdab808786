"""Fault-injectable VFS: the storage layers' single door to the disk.

Every durable-data file open (SSTables, the storage WAL, the private
mutation log, learning file transfers) routes through
`open_data_file()` here, which layers disk-fault injection over the
at-rest-encryption layer (storage/efile.py). With no fail points armed
this module is a pass-through — the hot path pays one boolean check at
OPEN time, nothing per read/write.

Fault model (parity: the reference's disk-fault fail points around
aio/log writes — fail_point.h sites in replication_app_base.cpp and
mutation_log.cpp, exercised by the .act 200-series): four named
injection sites interpreted by this layer, armed through the global
FAIL_POINTS registry with the standard mini-language (so '<N>%' rate
prefixes and seeded replay come for free):

    vfs::open    return(eio)                    open fails
    vfs::read    return(bit_flip | eio)         flip one seeded bit /
                                                fail the read
    vfs::write   return(torn_write | eio |      persist a seeded prefix
                        enospc | bit_flip)      then fail / fail / fail
                                                with ENOSPC / corrupt
                                                one seeded bit in flight
    vfs::fsync   return(eio)                    fsync fails

All randomness (WHICH bit flips, HOW MUCH of a torn write survives)
draws from FAIL_POINTS' seeded RNG, so a chaos run replays exactly from
`FAIL_POINTS.seed(n)`. A torn write persists a strict prefix and then
raises EIO — the on-disk state a crash mid-write leaves behind, which
the framed-log torn-tail recovery must absorb.

Cluster arming: `disk_fault_plan` in cluster.json (the disk twin of the
network `fault_plan`), e.g.

    {"seed": 7, "points": {"vfs::write": "2%return(torn_write)",
                           "vfs::fsync": "1%return(eio)"}}

installed at node boot by `install_disk_faults()`.

NOTE: plaintext SSTables are mmapped by their reader, so `vfs::read`
does not intercept block reads there (it does intercept the framed
logs and encrypted stores). On-disk SST corruption is injected by
flipping file bytes directly (kill_test --mode corrupt) — the mmap
serves the flipped bytes and the per-block crc32 catches them.

The port's copy of the JAX package's storage/vfs.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import errno
import os

from pegasus_tpu_torch.storage import efile
from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

FP_OPEN = "vfs::open"
FP_READ = "vfs::read"
FP_WRITE = "vfs::write"
FP_FSYNC = "vfs::fsync"


def install_disk_faults(plan: dict) -> None:
    """Arm the vfs fail points from a cluster.json `disk_fault_plan`."""
    FAIL_POINTS.setup()
    if "seed" in plan:
        FAIL_POINTS.seed(int(plan["seed"]))
    for name, action in (plan.get("points") or {}).items():
        FAIL_POINTS.cfg(name, action)


def _flip_one_bit(data: bytes) -> bytes:
    """Corrupt one seeded bit — the single-event-upset shape."""
    if not data:
        return data
    pos = int(FAIL_POINTS.rand() * len(data)) % len(data)
    bit = int(FAIL_POINTS.rand() * 8) % 8
    out = bytearray(data)
    out[pos] ^= 1 << bit
    return bytes(out)


def _err(code: int, site: str) -> OSError:
    return OSError(code, f"injected fault ({site})")


class FaultyFile:
    """Wraps a data file with the vfs fault sites. Exposes exactly the
    surface the storage layers use (read/write/seek/tell/truncate/
    flush/fileno/close + context management); fsync is intercepted via
    `fsync_file()` below, which all storage callers route through."""

    def __init__(self, f) -> None:
        self._f = f

    # -- data ------------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        act = FAIL_POINTS.inject(FP_READ)
        data = self._f.read(n) if act != "eio" else None
        if act == "eio":
            raise _err(errno.EIO, FP_READ)
        if act == "bit_flip":
            return _flip_one_bit(data)
        return data

    def write(self, data) -> int:
        act = FAIL_POINTS.inject(FP_WRITE)
        if act == "eio":
            raise _err(errno.EIO, FP_WRITE)
        if act == "enospc":
            raise _err(errno.ENOSPC, FP_WRITE)
        if act == "torn_write" and len(data) > 0:
            # a strict prefix lands, then the write "crashes": the
            # durable state recovery has to truncate past. Flush so the
            # torn bytes really reach the OS before the error unwinds
            # whatever buffering sits above.
            keep = int(FAIL_POINTS.rand() * len(data)) % len(data)
            self._f.write(bytes(data[:keep]))
            self._f.flush()
            raise _err(errno.EIO, FP_WRITE)
        if act == "bit_flip" and len(data) > 0:
            self._f.write(_flip_one_bit(bytes(data)))
            return len(data)
        self._f.write(data)
        return len(data)

    # -- passthrough ------------------------------------------------------
    def seek(self, off: int, whence: int = os.SEEK_SET) -> int:
        return self._f.seek(off, whence)

    def tell(self) -> int:
        return self._f.tell()

    def truncate(self, size=None):
        return (self._f.truncate() if size is None
                else self._f.truncate(size))

    def flush(self) -> None:
        self._f.flush()

    def fileno(self) -> int:
        return self._f.fileno()

    def close(self) -> None:
        self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def __enter__(self) -> "FaultyFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _disk_faults_armed() -> bool:
    """True when any vfs::* point is configured. FAIL_POINTS is shared
    with the NETWORK FaultPlan (rpc/fault.py calls setup() too), so
    gating the wrap on the registry's global enabled bit would tax
    every disk IO of a network-only chaos run with a Python proxy."""
    if not FAIL_POINTS.enabled:
        return False
    return any(FAIL_POINTS.configured(site)
               for site in (FP_OPEN, FP_READ, FP_WRITE, FP_FSYNC))


def open_data_file(path: str, mode: str = "rb"):
    """The storage layers' open(): encryption-aware (efile) and, when
    a vfs fault site is armed, fault-wrapped. The no-disk-chaos path
    returns efile's file object untouched — zero per-IO overhead."""
    if not _disk_faults_armed():
        return efile.open_data_file(path, mode)
    if FAIL_POINTS.inject(FP_OPEN) == "eio":
        raise _err(errno.EIO, FP_OPEN)
    return FaultyFile(efile.open_data_file(path, mode))


def fsync_file(f) -> None:
    """fsync through the fault layer: storage durability points
    (SST finish, log gc, frame sync) call this instead of raw
    os.fsync so an injected fsync failure surfaces as the OSError a
    dying disk would produce."""
    if FAIL_POINTS.enabled and FAIL_POINTS.inject(FP_FSYNC) == "eio":
        raise _err(errno.EIO, FP_FSYNC)
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Directory-entry durability (post-rename), same fault site."""
    if FAIL_POINTS.enabled and FAIL_POINTS.inject(FP_FSYNC) == "eio":
        raise _err(errno.EIO, FP_FSYNC)
    dir_fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


# the FaultyFile wrap is decided at OPEN time: a file opened before its
# site was armed keeps the raw handle (chaos plans arm at boot, before
# any store opens — the contract disk_fault_plan relies on)


# efile helpers re-exported so storage modules keep ONE import door
repair_truncate = efile.repair_truncate
logical_size = efile.logical_size
is_encrypted = efile.is_encrypted
copy_data_tree = efile.copy_data_tree
