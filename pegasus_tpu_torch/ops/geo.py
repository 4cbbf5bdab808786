"""Geo predicates on the device: batched haversine distance filtering.

The radius-search hot loop (geo_client.h:295-335 filters every candidate
record by exact distance after the cell cover narrows the set) runs as
one batch of elementwise torch ops over the candidates on the device it
is given: the card, or the host when the caller names the CPU.

The function is the JAX package's float32 one: radians, earth radius
6,371,000 m, `a = sin²(Δφ/2) + cos φ1 cos φ2 sin²(Δλ/2)`,
`dist = 2R·asin(min(1, √a))`, keep = `valid & (dist <= radius_m)`.
Nothing is padded: torch keeps no per-shape compiled program, and the
first n results do not depend on padding.
"""

from __future__ import annotations

import numpy as np
import torch

from pegasus_tpu_torch.utils.device import resolve_device

EARTH_RADIUS_M = 6_371_000.0

# calls that ran on a CUDA device (each one batch of torch ops), and the
# candidates they filtered
LAUNCHES = {"radius_filter": 0}
ROWS = {"radius_filter": 0}


def _haversine_mask(lats, lngs, valid, center_lat, center_lng, radius_m):
    """(keep, dist) over float32 tensors; the centre and radius are
    float32 0-d tensors on the same device."""
    lat1 = torch.deg2rad(center_lat)
    lat2 = torch.deg2rad(lats)
    dp = lat2 - lat1
    dl = torch.deg2rad(lngs) - torch.deg2rad(center_lng)
    a = (torch.sin(dp / 2.0) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dl / 2.0) ** 2)
    dist = 2.0 * EARTH_RADIUS_M * torch.asin(
        torch.clamp(torch.sqrt(a), max=1.0))
    return valid & (dist <= radius_m), dist


def radius_filter(lats: np.ndarray, lngs: np.ndarray,
                  center_lat: float, center_lng: float,
                  radius_m: float, valid=None, device=None):
    """(keep bool[n], distances float32[n], metres) for a candidate batch,
    computed on `device` (the card by default; raises without CUDA unless
    `device="cpu"`)."""
    dev = resolve_device(device)
    n = len(lats)
    if n == 0:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.float64)
    f32 = torch.float32
    la = torch.as_tensor(np.asarray(lats, dtype=np.float32)).to(dev)
    lo = torch.as_tensor(np.asarray(lngs, dtype=np.float32)).to(dev)
    va = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
        else torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev)
    keep, dist = _haversine_mask(
        la, lo, va, torch.tensor(center_lat, dtype=f32, device=dev),
        torch.tensor(center_lng, dtype=f32, device=dev),
        torch.tensor(radius_m, dtype=f32, device=dev))
    if dev.type == "cuda":
        LAUNCHES["radius_filter"] += 1
        ROWS["radius_filter"] += n
    return keep.cpu().numpy(), dist.cpu().numpy()


def f32_error_band_m(lat: float, lng: float, radius_m: float) -> float:
    """A bound, in metres, on how far the float32 distance of a candidate
    near (lat, lng) within about `radius_m` of the centre can lie from its
    float64 haversine distance.

    Each of the four coordinates is rounded twice: to float32 degrees
    (half an ulp) and again after the multiplication by pi/180 (half an
    ulp of the radians). A latitude error moves the distance by at most R
    per radian, a longitude error by at most R·cos(lat). The subtraction
    of two nearby float32 values is exact (Sterbenz); the rest of the
    formula (sin, cos, sqrt, asin, the products) adds a relative error of
    at most 16 float32 ulps of the distance, with the radius as its
    upper end. Spacings are taken a degree above the centre's magnitude,
    which bounds every candidate within that degree."""
    def coord_err_rad(deg: float) -> float:
        d = np.float32(abs(deg) + 1.0)
        r = np.float32(np.deg2rad(d))
        return (float(np.spacing(d)) / 2 * np.pi / 180
                + float(np.spacing(r)) / 2)

    lat_err = 2 * coord_err_rad(lat)
    lng_err = 2 * coord_err_rad(lng) * abs(np.cos(np.deg2rad(lat)))
    formula = 16 * float(np.finfo(np.float32).eps) * radius_m
    return EARTH_RADIUS_M * (lat_err + lng_err) + formula
