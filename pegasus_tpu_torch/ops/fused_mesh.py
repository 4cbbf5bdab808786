"""The resident image's epilogue kernel: counterpart of the JAX package's
`_mesh_step` (pegasus_tpu/parallel/mesh_resident.py:119).

`_mesh_step` is one XLA program over a table's [P, B, K] resident image:
the static keep mask over the flattened image, gated per slot by
`allowed`, then TTL liveness, the value-filter mask `extra`, the packed
gated mask, per-slot counts and the value lanes' sums. In the port its
first half is one launch of the scan kernel's static contract over the
image as one block with a per-row pidx column
(parallel/mesh_resident.py); `mesh_step` here is the rest, one launch of
csrc/mesh_step.cu. In torch ops this epilogue is about a dozen launches
on every resident dispatch.

The results come as one uint8 buffer (`mesh_step_buffer`, laid out by
`result_layout`): the gated packed mask, the counts and the lane sums,
each part 16-byte aligned (at B >= 128 exactly P * B / 8 + 28 * P
bytes). Over a sharded image the launch runs a shard at a time on the
shard's [P, B] tile, and a round copies every shard's buffer home once,
after the last launch (ops/result_buffer.home_all); `mesh_step` returns
its three views. `extra=None` is the all-ones value
filter, a kernel instance that reads no mask.

On CUDA tensors the kernel is launched (or the wrapper raises); on CPU
tensors `mesh_step_plain` runs, the plain torch version the CPU tests
and chip_smoke.py hold the kernel against. The kernel is built with nvcc
for sm_90a at first use into `_build/` and bound through ctypes, once,
under a lock.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
import weakref
from collections import Counter
from typing import Optional, Tuple

import torch

from pegasus_tpu_torch.ops import result_buffer
from pegasus_tpu_torch.ops.fused_scan import BUILD_DIR, _nvcc, _stream
from pegasus_tpu_torch.ops.predicates import ttl_expired
from pegasus_tpu_torch.ops.record_block import u32

# kernel launches; a launch made by the wrapper adds one, nothing else does
LAUNCHES = {"mesh_step": 0}
# the same launches by (kernel, card index)
DEVICE_LAUNCHES: Counter = Counter()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "mesh_step.cu")
_LIB_PATH = os.path.join(BUILD_DIR, "libmesh_step.so")

_lib = None
_lib_lock = threading.Lock()

_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def build(force: bool = False) -> Tuple[float, str]:
    """Compile csrc/mesh_step.cu into _build/ when the library is missing,
    older than its source, or `force` is set. Returns the seconds spent
    and nvcc's output (ptxas' register report); raises when nvcc
    fails."""
    t0 = time.perf_counter()
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
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
            fn = lib.pegasus_mesh_step
            p = ctypes.c_void_p
            fn.argtypes = [p, p, p, p, p, p, ctypes.c_uint32, ctypes.c_int,
                           ctypes.c_int64, ctypes.c_int, p, p, p, p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def mesh_step_plain(packed: torch.Tensor, allowed: torch.Tensor,
                    expire_ts: torch.Tensor, present: torch.Tensor,
                    extra: Optional[torch.Tensor],
                    lanes: Optional[torch.Tensor], now: int, with_sum: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of `mesh_step`, on any device: (gated packed
    uint8[P, B/8], counts int32[P, 3], lane_sums int32[P, 4] of uint32
    bits). `extra=None` keeps every considered row."""
    p, nbytes = packed.shape
    b = nbytes * 8
    gate = allowed.to(torch.bool)
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    static = (((packed[:, :, None] >> shifts) & 1).reshape(p, b).bool()
              & gate[:, None])
    alive = ~ttl_expired(expire_ts, now)
    considered = static & alive
    live = considered if extra is None else considered & extra
    gated = torch.where(gate[:, None], packed, torch.zeros_like(packed))
    counts = torch.stack([live.sum(dim=1), considered.sum(dim=1),
                          (present & ~alive).sum(dim=1)],
                         dim=1).to(torch.int32)
    if with_sum:
        sums = (u32(lanes) * live[:, :, None]).sum(dim=1) & 0xFFFFFFFF
        lane_sums = torch.where(sums >= 1 << 31, sums - (1 << 32),
                                sums).to(torch.int32)
    else:
        lane_sums = torch.zeros((p, 4), dtype=torch.int32,
                                device=packed.device)
    return gated, counts, lane_sums


# the image's operands, the same tensors every round of a stack, checked
# at their first launch: a hit needs the very same tensors (weak refs)
_checked: dict = {}


def result_layout(p: int, b: int) -> tuple:
    """The parts of a round's result buffer over a [p, b] image: the
    gated packed mask uint8[p, b / 8], counts int32[p, 3], lane sums
    uint32[p, 4]."""
    return (("u8", (p, b // 8)), ("i32", (p, 3)), ("u32", (p, 4)))


def _check(t: Optional[torch.Tensor], name: str, dtype, shape,
           dev: torch.device, align: int) -> None:
    if (t is None or t.dtype != dtype or t.device != dev
            or tuple(t.shape) != shape or not t.is_contiguous()
            or t.data_ptr() % align):
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"mesh_step kernel needs {name} as contiguous "
                         f"{dtype}{list(shape)} on {dev}, {align}-byte "
                         f"aligned, got {got}")


def mesh_step_buffer(packed: torch.Tensor, allowed: torch.Tensor,
                     expire_ts: torch.Tensor, present: torch.Tensor,
                     extra: Optional[torch.Tensor],
                     lanes: Optional[torch.Tensor], now: int,
                     with_sum: bool) -> torch.Tensor:
    """The epilogue over a [P, B] image into one result buffer (parts
    `result_layout(P, B)`): packed uint8[P, B/8] static mask, allowed
    uint8[P], expire_ts int32[P, B] (uint32 bits), present bool[P, B],
    extra bool[P, B] or None (all ones), lanes int32[P, B, 4] (uint32
    bits; read only with `with_sum`; the sums are zero without it). One
    launch on the current stream on CUDA, the plain version on the
    CPU."""
    dev = packed.device
    p, nbytes = packed.shape
    b = nbytes * 8
    layout = result_layout(p, b)
    if dev.type == "cpu":
        buf = result_buffer.empty(layout, dev)
        for view, part in zip(result_buffer.views(buf, layout),
                              mesh_step_plain(packed, allowed, expire_ts,
                                              present, extra, lanes, now,
                                              with_sum)):
            view.copy_(part)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"no mesh_step for device {dev}")
    _check(packed, "packed", torch.uint8, (p, nbytes), dev, 1)
    image = (allowed, expire_ts, present, extra, lanes if with_sum else None)
    key = tuple(map(id, image)) + (p, b)
    refs = _checked.get(key)
    if refs is None or any(r is not None and r() is not t
                           for r, t in zip(refs, image)):
        _check(allowed, "allowed", torch.uint8, (p,), dev, 1)
        _check(expire_ts, "expire_ts", torch.int32, (p, b), dev, 16)
        _check(present, "present", torch.bool, (p, b), dev, 8)
        if extra is not None:
            _check(extra, "extra", torch.bool, (p, b), dev, 8)
        if with_sum:
            _check(lanes, "lanes", torch.int32, (p, b, 4), dev, 16)
        if len(_checked) >= 64:
            _checked.clear()
        _checked[key] = tuple(None if t is None else weakref.ref(t)
                              for t in image)
    offs, size = result_buffer.offsets(layout)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    if p == 0:
        # nothing to launch, so nothing to count
        return buf
    base = buf.data_ptr()
    lib = _library()
    # cudaLaunchKernelEx launches on the calling thread's current device
    with torch.cuda.device(dev):
        err = lib.pegasus_mesh_step(
            packed.data_ptr(), allowed.data_ptr(), expire_ts.data_ptr(),
            present.data_ptr(), 0 if extra is None else extra.data_ptr(),
            lanes.data_ptr() if with_sum else 0, int(now) & 0xFFFFFFFF, p,
            b, int(with_sum), base, base + offs[1], base + offs[2],
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"mesh_step launch failed: cuda error {err}")
    LAUNCHES["mesh_step"] += 1
    DEVICE_LAUNCHES["mesh_step", dev.index] += 1
    return buf


def mesh_step(packed: torch.Tensor, allowed: torch.Tensor,
              expire_ts: torch.Tensor, present: torch.Tensor,
              extra: Optional[torch.Tensor], lanes: Optional[torch.Tensor],
              now: int, with_sum: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`mesh_step_buffer`'s three views: (gated packed mask uint8[P,
    B/8], counts int32[P, 3] = live, considered, present-and-expired,
    lane_sums int32[P, 4] of uint32 bits)."""
    p, nbytes = packed.shape
    return result_buffer.views(
        mesh_step_buffer(packed, allowed, expire_ts, present, extra, lanes,
                         now, with_sum),
        result_layout(p, nbytes * 8))
