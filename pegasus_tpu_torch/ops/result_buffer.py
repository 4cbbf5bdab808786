"""One result buffer a device round, and its one copy home.

A resident round (parallel/mesh_resident.py) writes all of its results
into one uint8 buffer on the device: the epilogue kernel's packed mask,
counts and lane sums (ops/fused_mesh.py), or the compaction round's
packed drop mask and rewritten TTLs (ops/compaction.mesh_compact_buffer)
— one buffer a shard of the image. A layout names the parts in order,
each starting 16-byte aligned; `views` cuts a torch or numpy buffer into
them, and `home_all` brings a round's buffers to the host, one copy each
into one page-locked buffer, and one wait a device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

ALIGN = 16

# a part's element type: (bytes, torch dtype, numpy dtype); 4-byte
# unsigned parts are int32 bit patterns on the torch side
_TYPES = {"u8": (1, torch.uint8, np.uint8),
          "i32": (4, torch.int32, np.int32),
          "u32": (4, torch.int32, np.uint32)}

Part = Tuple[str, Tuple[int, ...]]


@functools.lru_cache(maxsize=256)
def offsets(parts: Tuple[Part, ...]) -> Tuple[Tuple[int, ...], int]:
    """(each part's byte offset, the buffer's size) for `parts`."""
    offs, end = [], 0
    for kind, shape in parts:
        end = -(-end // ALIGN) * ALIGN
        offs.append(end)
        end += _TYPES[kind][0] * math.prod(shape)
    return tuple(offs), end


def nbytes(parts: Tuple[Part, ...]) -> int:
    """The buffer's size for `parts`."""
    return offsets(parts)[1]


def empty(parts: Tuple[Part, ...], device) -> torch.Tensor:
    """An uninitialised uint8 buffer for `parts` on `device`."""
    return torch.empty(nbytes(parts), dtype=torch.uint8, device=device)


def views(buf, parts: Tuple[Part, ...]) -> tuple:
    """`buf` (a uint8 torch tensor or numpy array) cut into `parts`."""
    offs, end = offsets(parts)
    if buf.shape[0] < end:
        raise ValueError(f"result buffer of {buf.shape[0]} B, the layout "
                         f"needs {end} B")
    host = isinstance(buf, np.ndarray)
    out = []
    for off, (kind, shape) in zip(offs, parts):
        size, tdt, ndt = _TYPES[kind]
        n = size * math.prod(shape)
        seg = buf[off:off + n]
        out.append(seg.view(ndt).reshape(shape) if host
                   else seg.view(tdt).view(shape))
    return tuple(out)


def home(buf: torch.Tensor) -> np.ndarray:
    """`buf` as a numpy array on the host (`home_all` of one buffer)."""
    return home_all([buf])[0]


def home_all(bufs) -> list:
    """Each of `bufs` (uint8, one a shard of a round) as a numpy array on
    the host. From cards: every buffer is copied into its own 16-byte
    aligned region of one page-locked host buffer allocated for this
    call (cached views of an earlier round's buffer keep their own),
    each copy queued on the current stream of its buffer's device behind
    that shard's kernels, then each of those streams waited on once.
    Call it after the round's last launch: a copy queued before a later
    shard's launch would hold that launch behind the wait."""
    if all(b.device.type == "cpu" for b in bufs):
        return [b.numpy() for b in bufs]
    if any(b.device.type != "cuda" for b in bufs):
        raise ValueError("a round's buffers lie on cards, or all on the "
                         "CPU")
    offs, end = [], 0
    for b in bufs:
        end = -(-end // ALIGN) * ALIGN
        offs.append(end)
        end += b.shape[0]
    host = torch.empty(end, dtype=torch.uint8, pin_memory=True)
    for b, off in zip(bufs, offs):
        # queued on the current stream of b's device
        host[off:off + b.shape[0]].copy_(b, non_blocking=True)
    for dev in dict.fromkeys(b.device for b in bufs):
        torch.cuda.current_stream(dev).synchronize()
    arr = host.numpy()
    return [arr[off:off + b.shape[0]] for b, off in zip(bufs, offs)]
