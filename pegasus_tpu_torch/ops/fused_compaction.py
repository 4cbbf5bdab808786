"""The compaction-filter kernel: counterpart of the JAX package's fused
compaction program (pegasus_tpu/ops/compaction.py:110 `eval_block`, with
ops/compaction_rules.py:134 `apply_rules_ops` inside it).

`compaction_filter` evaluates, for one chunk of padded rows in one
launch: the default-TTL rewrite, every operation and rule of a parsed
ruleset in order, expiry, and the stale-split term, and writes the drop
mask (one byte a row, or bit-packed as `jnp.packbits` packs it) and the
rewritten TTLs. The bulk compactor (ops/compaction.make_compaction_eval),
the merge path's filter (ops/compaction.compaction_filter_block) and the
merge path's rules hook (ops/compaction_rules.compile_rules) all reach it
on a CUDA device, so one kernel carries every compaction filter on the
card. It takes CUDA tensors only and raises on anything else; the plain
torch version the CPU runs, and chip_smoke.py holds the kernel against,
is ops/compaction.eval_block_plain.

Validation reads a chunk's stored `hash_lo` column or, where the chunk
has none, hashes the keys inside the kernel (the JAX package's
`key_hash_device`, ops/device_crc.py:65) with the crc64 slicing tables
of ops/fused_scan.crc_tables (from base/crc.py), copied to the card once
a device.

`slot_gate_filter` launches the same source's second kernel, the
resident image's TTL pass (ops/compaction.mesh_compact_step with no
ruleset, validating against the resident hash_lo, the slot gate on):
8 rows a thread, its packed drop mask and rewritten TTLs written into a
caller's result buffer.

The kernels are csrc/compaction_filter.cu, built with nvcc for sm_90a at
first use into `_build/` and bound through ctypes; the build and the
load happen once, under a lock (the bulk compactions of several
partitions launch from their own filter-stage threads).
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pegasus_tpu_torch.base.value_schema import PEGASUS_EPOCH_BEGIN
from pegasus_tpu_torch.ops.fused_scan import BUILD_DIR, _nvcc, crc_tables

_M32 = 0xFFFFFFFF

# the ruleset table's bounds (kMaxOps / kMaxRules in the source); a
# larger ruleset raises
MAX_OPS = 16
MAX_RULES = 64

# kernel launches: "compaction" of compaction_filter_kernel, "slot_gate"
# of the launches with the resident image's slot gate (either kernel:
# ops/compaction.mesh_compact_step), "slot_gate_columns" of
# slot_gate_kernel; a launch made by a wrapper adds here, nothing else
# does
LAUNCHES = {"compaction": 0, "slot_gate": 0, "slot_gate_columns": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "compaction_filter.cu")
# the matcher and the key hash, shared with scan_predicate.cu
_HEADERS = (os.path.join(_PKG_DIR, "csrc", "match.cuh"),
            os.path.join(_PKG_DIR, "csrc", "key_hash.cuh"))
_LIB_PATH = os.path.join(BUILD_DIR, "libcompaction_filter.so")

_lib = None
_lib_lock = threading.Lock()
# the filter-stage threads of concurrent compactions count here together
_count_lock = threading.Lock()

# RuleDesc and OpDesc in csrc/compaction_filter.cu
_RULE = struct.Struct("<iiiiII")
_OP = struct.Struct("<iiIii")
assert _RULE.size == 24 and _OP.size == 20

# rule kinds, operation codes and update types of the descriptors
_KIND_HASHKEY, _KIND_SORTKEY, _KIND_TTL, _KIND_NEVER = 0, 1, 2, 3
_OP_DELETE, _OP_UPDATE = 0, 1
_UTOT = {"from_now": 0, "from_current": 1, "timestamp": 2}

# flag bits of the entry point
_F_VALIDATE, _F_EXPIRE, _F_WANT_ETS, _F_PACK, _F_NEED_KEYS = 1, 2, 4, 8, 16
_F_HASH_KEYS, _F_SLOT_GATE = 32, 64


def build(force: bool = False) -> Tuple[float, str]:
    """Compile csrc/compaction_filter.cu into _build/ when the library is
    missing, older than its sources, or `force` is set. Returns the
    seconds spent and nvcc's output (ptxas' register and shared-memory
    report); raises when nvcc fails."""
    t0 = time.perf_counter()
    newest = max(os.path.getmtime(f) for f in (_SOURCE,) + _HEADERS)
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= newest):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_LIB_PATH)
            fn = lib.pegasus_compaction_filter
            p, u32_, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, p, u32_, ctypes.c_int64, i32,
                           ctypes.c_char_p, i32, ctypes.c_char_p, i32, p,
                           u32_, u32_, u32_, i32, p, p, p, p, p, i32]
            fn.restype = ctypes.c_int
            gate = lib.pegasus_slot_gate_filter
            gate.argtypes = [p, p, p, p, p, ctypes.c_int64, i32, u32_, u32_,
                             u32_, p, p, p]
            gate.restype = ctypes.c_int
            _lib = lib
        return _lib


def ops_key(operations) -> tuple:
    """Content identity of a parsed ruleset: the same JSON compiled twice
    (config-sync re-delivers app-envs periodically) maps to the same
    cached table and evaluation program."""
    if not operations:
        return ()
    out = []
    for op in operations:
        rules = []
        for r in op.rules:
            if r.kind == "ttl_range":
                rules.append((r.kind, r.start_ttl, r.stop_ttl))
            else:
                rules.append((r.kind, r.filter.filter_type, r.filter.raw))
        out.append((op.op, getattr(op, "utot", None),
                    getattr(op, "value", None), tuple(rules)))
    return tuple(out)


def _descriptors(key: tuple):
    """(OpDesc bytes, RuleDesc bytes, pattern buffer bytes, need_keys)
    of a ruleset given by its `ops_key`. Raises for a ruleset past the
    table's bounds."""
    n_rules = sum(len(rules) for *_h, rules in key)
    if len(key) > MAX_OPS or n_rules > MAX_RULES:
        raise ValueError(
            f"ruleset of {len(key)} operations and {n_rules} rules exceeds "
            f"the compaction kernel's table ({MAX_OPS} operations, "
            f"{MAX_RULES} rules)")
    ops, rules, pats = [], [], bytearray()
    need_keys = False
    for op, utot, value, op_rules in key:
        ops.append(_OP.pack(
            _OP_DELETE if op == "delete_key" else _OP_UPDATE,
            _UTOT.get(utot, 0),
            (0 if op == "delete_key"
             else max(0, value - PEGASUS_EPOCH_BEGIN) & _M32
             if utot == "timestamp" else value & _M32),
            len(rules), len(op_rules)))
        for kind, a, b in op_rules:
            if kind == "ttl_range":
                # the match field carries start == stop == 0, judged on
                # the rule's own integers
                rules.append(_RULE.pack(_KIND_TTL, int(a == 0 and b == 0),
                                        0, 0, a & _M32, b & _M32))
            elif not b:
                # an empty pattern matches nothing
                rules.append(_RULE.pack(_KIND_NEVER, 0, 0, 0, 0, 0))
            else:
                rules.append(_RULE.pack(
                    _KIND_HASHKEY if kind == "hashkey_pattern"
                    else _KIND_SORTKEY, int(a), len(pats), len(b), 0, 0))
                pats += b + b"\x00" * (-len(b) % 4)
                need_keys = True
    return (b"".join(ops), b"".join(rules), bytes(pats or b"\x00" * 4),
            need_keys)


@functools.lru_cache(maxsize=64)
def _table(key: tuple, device: torch.device):
    """The ruleset's descriptors and its patterns in one device buffer
    (4-byte aligned, each pattern padded to 4 bytes): one host-to-device
    copy per ruleset and device."""
    ops, rules, pats, need_keys = _descriptors(key)
    buf = torch.from_numpy(np.frombuffer(pats, dtype=np.uint8).copy())
    return (ops, rules, buf.to(device), need_keys, len(key),
            len(rules) // _RULE.size)


def _check(t: Optional[torch.Tensor], name: str, dtype, shape,
           dev: torch.device) -> None:
    if (t is None or t.dtype != dtype or t.device != dev
            or tuple(t.shape) != shape or not t.is_contiguous()):
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"compaction kernel needs {name} as contiguous "
                         f"{dtype}{list(shape)} on {dev}, got {got}")


def _check_aligned(t: torch.Tensor, name: str, align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"compaction kernel needs {name} {align}-byte "
                         f"aligned")


def slot_gate_filter(expire_ts: torch.Tensor, valid: torch.Tensor,
                     hash_lo: torch.Tensor, pidx: torch.Tensor,
                     slot_allowed: torch.Tensor, now: int, default_ttl: int,
                     partition_version: int, drop: torch.Tensor,
                     ets: Optional[torch.Tensor]) -> None:
    """The resident image's TTL pass in one launch of slot_gate_kernel on
    the current stream: B = P * S rows (S a power of two >= 8) of
    expire_ts and hash_lo int32[B] (uint32 bits, 16-byte aligned), valid
    bool[B] (8-byte aligned), pidx int32[P] and slot_allowed uint8[P] a
    slot. Writes the packed drop mask into `drop` (uint8[B / 8]) and,
    when `ets` is given (int32[B], 16-byte aligned), the rewritten TTLs:
    eval_block's default-TTL rewrite, expiry and the slot-gated
    stale-split drop, with no ruleset. CUDA tensors only."""
    dev = expire_ts.device
    if dev.type != "cuda":
        raise ValueError(f"the compaction kernel runs on CUDA tensors, "
                         f"got {dev}")
    b = expire_ts.shape[0]
    n_slots = slot_allowed.shape[0] if slot_allowed.dim() == 1 else 0
    slot_rows = b // n_slots if n_slots else 0
    if (not n_slots or slot_rows * n_slots != b or slot_rows < 8
            or slot_rows & (slot_rows - 1)):
        raise ValueError("the slot gate needs B = P * S rows, S a power of "
                         "two >= 8")
    _check(expire_ts, "expire_ts", torch.int32, (b,), dev)
    _check(hash_lo, "hash_lo", torch.int32, (b,), dev)
    _check(valid, "valid", torch.bool, (b,), dev)
    _check(pidx, "pidx", torch.int32, (n_slots,), dev)
    _check(slot_allowed, "slot_allowed", torch.uint8, (n_slots,), dev)
    _check(drop, "drop", torch.uint8, (b // 8,), dev)
    for t, name, align in ((expire_ts, "expire_ts", 16),
                           (hash_lo, "hash_lo", 16), (valid, "valid", 8)):
        _check_aligned(t, name, align)
    if ets is not None:
        _check(ets, "ets", torch.int32, (b,), dev)
        _check_aligned(ets, "ets", 16)
    err = _library().pegasus_slot_gate_filter(
        expire_ts.data_ptr(), valid.data_ptr(), hash_lo.data_ptr(),
        pidx.data_ptr(), slot_allowed.data_ptr(), b,
        slot_rows.bit_length() - 1, int(now) & _M32,
        int(default_ttl) & _M32, int(partition_version) & _M32,
        drop.data_ptr(), 0 if ets is None else ets.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slot_gate_filter launch failed: cuda error "
                           f"{err}")
    with _count_lock:
        LAUNCHES["slot_gate"] += 1
        LAUNCHES["slot_gate_columns"] += 1


def compaction_filter(keys: Optional[torch.Tensor],
                      key_len: Optional[torch.Tensor],
                      expire_ts: torch.Tensor, valid: torch.Tensor,
                      hash_lo: Optional[torch.Tensor],
                      pidx, operations: Sequence, now: int,
                      default_ttl: int, partition_version: int, *,
                      validate_hash: bool, expire: bool = True,
                      want_ets: bool = True, pack: bool = False,
                      slot_allowed: Optional[torch.Tensor] = None,
                      out: Optional[Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch over B rows on the current stream: (drop, ets2).

    keys uint8[B, K] (K a power of two >= 32, rows 16-byte aligned),
    key_len / expire_ts / hash_lo int32[B] (the uint32 columns as bit
    patterns), valid bool[B]; `pidx` an int or an int32[B] column;
    `hash_lo` is read only with `validate_hash`, and with `validate_hash`
    and no `hash_lo` the kernel hashes the keys instead. The two key
    columns may be None for a ruleset without pattern rules that does
    not hash keys. The kernel reads a row's hashkey length from its
    big-endian u16 prefix (0 where key_len is 0), as every block's
    hashkey_len column holds it.
    `expire=False` leaves out expiry (the merge path's rules hook).
    `slot_allowed` uint8[P] (with `validate_hash`, B = P * S rows, S a
    power of two) is the resident image's slot gate: row r's stale-split
    term also needs slot_allowed[r // S], and a `pidx` tensor is then
    int32[P], one owner a slot (read as pidx[r // S]).
    drop is bool[B], or uint8[ceil(B / 8)] in packbits order with
    `pack`; ets2 is int32[B] (uint32 bits), or None without `want_ets`.
    `out` = (drop, ets2) are tensors of those shapes to write into (views
    of a caller's result buffer) instead of new ones."""
    dev = expire_ts.device
    if dev.type != "cuda":
        raise ValueError(f"the compaction kernel runs on CUDA tensors, "
                         f"got {dev}")
    b = expire_ts.shape[0]
    _check(expire_ts, "expire_ts", torch.int32, (b,), dev)
    ops, rules, pats, need_keys, n_ops, n_rules = _table(
        ops_key(operations), dev)
    hash_keys = validate_hash and hash_lo is None
    if keys is None:
        # no rule reads a key byte: the key columns may be left out
        if need_keys:
            raise ValueError("a ruleset with pattern rules needs the keys")
        if hash_keys:
            raise ValueError("validation without a hash_lo column hashes "
                             "the keys: pass them")
        k = 32
    else:
        if keys.dim() != 2:
            raise ValueError("keys must be uint8[B, K]")
        k = keys.shape[1]
        if k < 32 or k & (k - 1):
            raise ValueError(f"key width {k} is not a power of two >= 32")
        _check(keys, "keys", torch.uint8, (b, k), dev)
        if b and keys.data_ptr() % 16:
            raise ValueError("key rows must start 16-byte aligned")
        _check(key_len, "key_len", torch.int32, (b,), dev)
    _check(valid, "valid", torch.bool, (b,), dev)
    if validate_hash and not hash_keys:
        _check(hash_lo, "hash_lo", torch.int32, (b,), dev)
    slot_shift, n_owners = 0, b
    if slot_allowed is not None:
        n_slots = slot_allowed.shape[0] if slot_allowed.dim() == 1 else 0
        slot_rows = b // n_slots if n_slots else 0
        if (not validate_hash or not n_slots or slot_rows * n_slots != b
                or slot_rows & (slot_rows - 1)):
            raise ValueError("the slot gate needs validation and B = P * S "
                             "rows, S a power of two")
        _check(slot_allowed, "slot_allowed", torch.uint8, (n_slots,), dev)
        slot_shift = slot_rows.bit_length() - 1
        n_owners = n_slots
    if isinstance(pidx, torch.Tensor):
        _check(pidx, "pidx", torch.int32, (n_owners,), dev)
        pidx_col, pidx_scalar = pidx.data_ptr(), 0
    else:
        pidx_col, pidx_scalar = 0, int(pidx) & _M32
    if out is None:
        drop = torch.empty(-(-b // 8) if pack else b,
                           dtype=torch.uint8, device=dev)
        ets = torch.empty(b if want_ets else 0, dtype=torch.int32,
                          device=dev)
    else:
        drop, ets = out
        _check(drop, "drop", torch.uint8, (-(-b // 8) if pack else b,), dev)
        if want_ets:
            _check(ets, "ets", torch.int32, (b,), dev)
    if b == 0:
        # nothing to launch, so nothing to count
        return (drop if pack else drop.bool()), (ets if want_ets else None)
    flags = ((_F_VALIDATE if validate_hash else 0)
             | (_F_EXPIRE if expire else 0)
             | (_F_WANT_ETS if want_ets else 0) | (_F_PACK if pack else 0)
             | (_F_NEED_KEYS if need_keys or hash_keys else 0)
             | (_F_HASH_KEYS if hash_keys else 0)
             | (_F_SLOT_GATE if slot_allowed is not None else 0))
    err = _library().pegasus_compaction_filter(
        *((0, 0) if keys is None else (keys.data_ptr(), key_len.data_ptr())),
        expire_ts.data_ptr(), valid.data_ptr(),
        hash_lo.data_ptr() if validate_hash and not hash_keys else 0,
        pidx_col, pidx_scalar, b, k, ops, n_ops, rules, n_rules,
        pats.data_ptr(), int(now) & _M32, int(default_ttl) & _M32,
        int(partition_version) & _M32, flags, drop.data_ptr(),
        ets.data_ptr() if want_ets else 0,
        torch.cuda.current_stream(dev).cuda_stream,
        crc_tables(dev).data_ptr() if hash_keys else 0,
        slot_allowed.data_ptr() if slot_allowed is not None else 0,
        slot_shift)
    if err != 0:
        raise RuntimeError(f"compaction_filter launch failed: cuda error "
                           f"{err}")
    with _count_lock:
        LAUNCHES["compaction"] += 1
        if slot_allowed is not None:
            LAUNCHES["slot_gate"] += 1
    return (drop if pack else drop.view(torch.bool)), \
        (ets if want_ets else None)
