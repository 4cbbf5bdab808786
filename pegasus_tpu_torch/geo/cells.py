"""Hierarchical geo cells: quadtree Morton codes over (lat, lng).

Parity role: the S2 cell ids the reference's geo client keys its index
table with (src/geo/lib/geo_client.h:96 — hashkey = cell id at
min_level, sortkey continues to max_level). S2's exact cell geometry is
library-specific; what the design needs from it is (a) a hierarchical
id whose string prefix identifies every ancestor cell and (b) a way to
cover a circle with cells at a fixed level. A base-4 Morton code over
the equirectangular grid provides both: digit k subdivides the parent
cell into quadrants, so a level-L cell is exactly a length-L prefix.

Cells are strings of digits '0'-'3' (level = len). Level L cell size:
180/2^L degrees of latitude by 360/2^L degrees of longitude.
"""

from __future__ import annotations

import math
from typing import List, Tuple

EARTH_RADIUS_M = 6_371_000.0


def cell_id(lat: float, lng: float, level: int) -> str:
    """The level-`level` cell containing (lat, lng)."""
    if not (-90.0 <= lat <= 90.0 and -180.0 <= lng <= 180.0):
        raise ValueError(f"bad coordinate ({lat}, {lng})")
    # normalize to [0, 1); clamp the closed upper edge into the last cell
    y = min((lat + 90.0) / 180.0, 1.0 - 1e-12)
    x = min((lng + 180.0) / 360.0, 1.0 - 1e-12)
    digits = []
    for _ in range(level):
        y *= 2
        x *= 2
        yb = int(y)
        xb = int(x)
        digits.append(str((yb << 1) | xb))
        y -= yb
        x -= xb
    return "".join(digits)


def cell_bounds(cell: str) -> Tuple[float, float, float, float]:
    """(lat_min, lat_max, lng_min, lng_max) of a cell."""
    y0, y1 = 0.0, 1.0
    x0, x1 = 0.0, 1.0
    for d in cell:
        v = int(d)
        ym = (y0 + y1) / 2
        xm = (x0 + x1) / 2
        if v & 2:
            y0 = ym
        else:
            y1 = ym
        if v & 1:
            x0 = xm
        else:
            x1 = xm
    return (y0 * 180.0 - 90.0, y1 * 180.0 - 90.0,
            x0 * 360.0 - 180.0, x1 * 360.0 - 180.0)


def covering_cells(lat: float, lng: float, radius_m: float,
                   level: int, max_cells: int = 256) -> List[str]:
    """Cells at `level` intersecting the circle's bounding box (parity:
    S2RegionCoverer over the search cap, geo_client.h:295-335)."""
    dlat = math.degrees(radius_m / EARTH_RADIUS_M)
    cos_lat = max(math.cos(math.radians(lat)), 1e-6)
    dlng = math.degrees(radius_m / (EARTH_RADIUS_M * cos_lat))
    lat_lo = max(lat - dlat, -90.0)
    lat_hi = min(lat + dlat, 90.0)
    lng_lo = max(lng - dlng, -180.0)
    lng_hi = min(lng + dlng, 180.0)
    step_lat = 180.0 / (1 << level)
    step_lng = 360.0 / (1 << level)
    cells = []
    seen = set()
    la = lat_lo
    while True:
        ln = lng_lo
        while True:
            c = cell_id(min(la, 90.0), min(ln, 180.0), level)
            if c not in seen:
                seen.add(c)
                cells.append(c)
                if len(cells) > max_cells:
                    raise ValueError(
                        f"radius {radius_m}m needs >{max_cells} cells at "
                        f"level {level}; use a coarser index level")
            if ln >= lng_hi:
                break
            ln += step_lng
        if la >= lat_hi:
            break
        la += step_lat
    return cells


def haversine_m(lat1: float, lng1: float, lat2: float, lng2: float) -> float:
    """Great-circle distance in meters (host-side scalar; the batched
    candidate filter runs on device — ops/geo.py)."""
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lng2 - lng1)
    a = (math.sin(dp / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
    return 2 * EARTH_RADIUS_M * math.asin(min(1.0, math.sqrt(a)))
