"""GeoClient: location-aware KV over the dual-table design.

Parity: src/geo/lib/geo_client.h:96 — two tables:
- the RAW table: the user's (hashkey, sortkey) -> value, unchanged;
- the GEO index table: hashkey = cell id at `index_level` (the S2
  min_level analogue), sortkey = remaining cell digits + the raw keys,
  value = the raw value. Radius search covers the circle with index
  cells (geo_client.h:295-335), scans each cell in parallel-ready
  fashion, and filters candidates by exact distance — here as ONE
  batched predicate (ops/geo.py) on the device of the index client's
  servers, instead of a scalar loop.

Values carry their coordinates; the codec extracts (lat, lng) from a
'|'-separated value by field index (parity: latlng_codec with
configurable latitude_index/longitude_index). The RAW table stores the
user's value untouched; INDEX rows prefix it with a versioned packed
coordinate header (see _MAGIC/_COORD) so radius searches lift
candidate coordinates vectorized; headerless index rows written by
older builds still decode through the text codec.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from pegasus_tpu_torch.base.key_schema import key_hash_parts, restore_key
from pegasus_tpu_torch.client.client import make_hashkey_scan_request
from pegasus_tpu_torch.geo.cells import cell_id, covering_cells, haversine_m
from pegasus_tpu_torch.ops.geo import radius_filter
from pegasus_tpu_torch.utils.device import resolve_device
from pegasus_tpu_torch.utils.errors import StorageStatus

SORT_SEP = b"|"

# Index-table value layout: 2-byte version magic, 16-byte packed
# (lat, lng) doubles, then the raw value verbatim. The RAW table keeps
# the user's value untouched (text codec, latlng_codec parity); the
# INDEX table is internal to GeoClient, and the fixed binary header is
# what lets a radius search lift every candidate's coordinates out of
# a columnar scan page with ONE vectorized gather instead of a
# per-record text parse. The magic distinguishes headered rows from
# index rows written by builds that stored the raw value directly —
# those fall back to the per-record text codec.
_MAGIC = b"G\x01"
_COORD = struct.Struct("<dd")
_HDR = len(_MAGIC) + _COORD.size


def _coord_in_range(lat: float, lng: float) -> bool:
    """Sanity gate on header-sniffed coordinates: the 2-byte magic is
    weak evidence, and a legacy headerless value that happens to start
    with it would otherwise inject garbage coordinates into the radius
    filter (and silently lose its first 18 bytes). Out-of-range or
    non-finite doubles mean "not really a packed header" — the row
    falls back to the text codec. NaN fails both comparisons."""
    return -90.0 <= lat <= 90.0 and -180.0 <= lng <= 180.0


@dataclass
class LatLngCodec:
    """Extract/encode coordinates from a record value (parity:
    base/latlng_codec)."""

    latitude_index: int = 0
    longitude_index: int = 1

    def decode(self, value: bytes) -> Optional[Tuple[float, float]]:
        parts = value.split(b"|")
        hi = max(self.latitude_index, self.longitude_index)
        if len(parts) <= hi:
            return None
        try:
            return (float(parts[self.latitude_index]),
                    float(parts[self.longitude_index]))
        except ValueError:
            return None


@dataclass
class GeoSearchResult:
    hash_key: bytes
    sort_key: bytes
    value: bytes
    distance_m: float


def _page_coords(kvs, codec, value_of, n_rows):
    """(coords float64[n, 2], row indices int64[n], packed bool[n]) of
    the decodable rows of one response page.

    Rows carrying the versioned packed header decode VECTORIZED on the
    columnar ScanPage shape (one gather over the value blob); rows
    without it — index entries written by a build predating the header
    — fall back to the per-record text codec (`packed`=False marks
    them so the caller keeps their value unstripped)."""
    m0, m1 = _MAGIC
    if not hasattr(kvs, "val_offs"):  # KeyValue list
        rows, coords, packed = [], [], []
        for i in range(n_rows):
            v = value_of(i)
            c = None
            if len(v) >= _HDR and v[0] == m0 and v[1] == m1:
                lat, lng = _COORD.unpack_from(v, len(_MAGIC))
                if _coord_in_range(lat, lng):
                    rows.append(i)
                    coords.append((lat, lng))
                    packed.append(True)
                    continue
            c = codec.decode(v)
            if c is not None:
                rows.append(i)
                coords.append(c)
                packed.append(False)
        if not rows:
            return None, (), ()
        return (np.asarray(coords, dtype=np.float64),
                np.asarray(rows, dtype=np.int64),
                np.asarray(packed, dtype=bool))
    vo = np.frombuffer(kvs.val_offs, dtype="<u4").astype(np.int64)
    if len(vo) <= 1:
        return None, (), ()
    starts = vo[:-1]
    blob = np.frombuffer(kvs.val_blob, dtype=np.uint8)
    fits = (vo[1:] - starts) >= _HDR
    has_magic = fits.copy()
    idx = np.flatnonzero(fits)
    if len(idx):
        has_magic[idx] &= (blob[starts[idx]] == m0) \
            & (blob[starts[idx] + 1] == m1)
    prows = np.flatnonzero(has_magic)
    pcoords = np.zeros((0, 2))
    if len(prows):
        win = (starts[prows][:, None] + len(_MAGIC)
               + np.arange(_COORD.size))
        pcoords = blob[win].reshape(-1).view("<f8").reshape(-1, 2)
        # range-validate the sniffed headers (vectorized): impossible
        # lat/lng means a legacy value that merely starts with the
        # magic — demote those rows to the text-codec path
        with np.errstate(invalid="ignore"):
            sane = (np.isfinite(pcoords).all(axis=1)
                    & (np.abs(pcoords[:, 0]) <= 90.0)
                    & (np.abs(pcoords[:, 1]) <= 180.0))
        if not sane.all():
            has_magic[prows[~sane]] = False
            prows = prows[sane]
            pcoords = pcoords[sane]
    # legacy headerless rows: per-record text decode
    lrows, lcoords = [], []
    for i in np.flatnonzero(~has_magic):
        c = codec.decode(value_of(int(i)))
        if c is not None:
            lrows.append(int(i))
            lcoords.append(c)
    if not len(prows) and not lrows:
        return None, (), ()
    coords = np.concatenate(
        [pcoords, np.asarray(lcoords, dtype=np.float64).reshape(-1, 2)])
    rows = np.concatenate(
        [prows.astype(np.int64),
         np.asarray(lrows, dtype=np.int64)])
    packed = np.concatenate(
        [np.ones(len(prows), dtype=bool),
         np.zeros(len(lrows), dtype=bool)])
    return coords, rows, packed


class GeoClient:
    """`raw` and `index` are any client exposing the PegasusClient API
    (in-process or cluster). The distance filter runs on `device`; None
    is the device of an in-process index table's servers
    (`index_client.device`) and, for a wire client, the card."""

    def __init__(self, raw_client, index_client,
                 codec: Optional[LatLngCodec] = None,
                 index_level: int = 12, max_level: int = 16,
                 device=None) -> None:
        self.raw = raw_client
        self.index = index_client
        if device is None:
            device = getattr(index_client, "device", None)
        self.device = resolve_device(device)
        self.codec = codec or LatLngCodec()
        self.index_level = index_level
        self.max_level = max_level

    # ---- index key layout ---------------------------------------------

    def _index_keys(self, hash_key: bytes, sort_key: bytes,
                    lat: float, lng: float) -> Tuple[bytes, bytes]:
        cell = cell_id(lat, lng, self.max_level)
        idx_hash = cell[:self.index_level].encode()
        idx_sort = (cell[self.index_level:].encode() + SORT_SEP
                    + hash_key + SORT_SEP + sort_key)
        return idx_hash, idx_sort

    @staticmethod
    def _restore_raw_keys(idx_sort: bytes) -> Tuple[bytes, bytes]:
        _cell_rest, hk, sk = idx_sort.split(SORT_SEP, 2)
        return hk, sk

    # ---- data ops (parity: geo_client set/get/del keep both tables) ---

    def set(self, hash_key: bytes, sort_key: bytes, value: bytes,
            ttl_seconds: int = 0) -> int:
        coord = self.codec.decode(value)
        if coord is None:
            return int(StorageStatus.INVALID_ARGUMENT)
        # stale index entries for a moved point are removed first (the
        # reference reads the old value and deletes its old cell entry)
        err, old = self.raw.get(hash_key, sort_key)
        if err == int(StorageStatus.OK):
            old_coord = self.codec.decode(old)
            if old_coord is not None and old_coord != coord:
                oh, os_ = self._index_keys(hash_key, sort_key, *old_coord)
                self.index.delete(oh, os_)
        err = self.raw.set(hash_key, sort_key, value, ttl_seconds)
        if err != int(StorageStatus.OK):
            return err
        ih, isk = self._index_keys(hash_key, sort_key, *coord)
        return self.index.set(
            ih, isk, _MAGIC + _COORD.pack(*coord) + value, ttl_seconds)

    def get(self, hash_key: bytes, sort_key: bytes) -> Tuple[int, bytes]:
        return self.raw.get(hash_key, sort_key)

    def delete(self, hash_key: bytes, sort_key: bytes) -> int:
        err, value = self.raw.get(hash_key, sort_key)
        if err == int(StorageStatus.OK):
            coord = self.codec.decode(value)
            if coord is not None:
                ih, isk = self._index_keys(hash_key, sort_key, *coord)
                self.index.delete(ih, isk)
        return self.raw.delete(hash_key, sort_key)

    # ---- radius search (parity: async_search_radial :295-335) ----------

    def _cover_level(self, radius_m: float) -> int:
        """Covering level whose cell edge is comparable to the radius
        (parity: S2RegionCoverer's adaptive cells between min and max
        level, geo_client.h:374). Covering a small circle with
        index_level cells scans the whole coarse cell — orders of
        magnitude more candidates than the circle needs; the index
        sortkey carries the cell digits down to max_level, so finer
        covering cells narrow each scan to a SORTKEY RANGE."""
        # cell edge at level L is ~(180 deg * 111km/deg) / 2^L
        edge0_m = 180.0 * 111_000.0
        level = int(math.log2(edge0_m / max(radius_m, 1.0)))
        return max(self.index_level, min(self.max_level, level))

    def search_radial(self, lat: float, lng: float, radius_m: float,
                      count: int = -1,
                      sort_by_distance: bool = True
                      ) -> List[GeoSearchResult]:
        # near the poles the longitude span scales by 1/cos(lat), so the
        # radius-based level can overflow the covering budget — coarsen
        # until it fits (index_level always fits or raises legitimately)
        level = self._cover_level(radius_m)
        while True:
            try:
                cells = covering_cells(lat, lng, radius_m, level)
                break
            except ValueError:
                if level <= self.index_level:
                    raise
                level -= 1
        # Candidate coordinates are lifted PAGE-at-a-time: columnar
        # scan pages give every packed (lat, lng) header in one numpy
        # gather; keys/values materialize per record only for the
        # SURVIVORS of the distance filter (typically a small fraction
        # of the candidate set). A page is a columnar ScanPage or, from
        # a scan the batched path served request by request, a KeyValue
        # list; both index to KeyValues.
        pages: list = []  # (page, row_indices, packed_flags)
        lat_parts: list = []
        lng_parts: list = []
        for page in self._scan_cell_pages(cells):
            value_of = getattr(page, "value_at", None) or (
                lambda i, page=page: page[i].value)
            coords, rows, packed = _page_coords(page, self.codec,
                                                value_of, len(page))
            if coords is None or not len(rows):
                continue
            pages.append((page, rows, packed))
            lat_parts.append(coords[:, 0])
            lng_parts.append(coords[:, 1])
        if not pages:
            return []
        cand_lat = np.concatenate(lat_parts)
        cand_lng = np.concatenate(lng_parts)
        # exact-distance filtering: ONE batch on the index's device
        keep, dist = radius_filter(cand_lat, cand_lng, lat, lng, radius_m,
                                   device=self.device)
        out: List[GeoSearchResult] = []
        base = 0
        for page, rows, packed in pages:
            n = len(rows)
            for j in np.flatnonzero(keep[base:base + n]):
                kv = page[int(rows[int(j)])]
                _ih, isk = restore_key(kv.key)
                value = kv.value
                hk, sk = self._restore_raw_keys(isk)
                if packed[int(j)]:
                    value = bytes(value[_HDR:])
                out.append(GeoSearchResult(
                    hk, sk, value, float(dist[base + int(j)])))
            base += n
        if sort_by_distance:
            out.sort(key=lambda r: r.distance_m)
        if count >= 0:
            out = out[:count]
        return out

    @staticmethod
    def _sub_stop(sub: bytes) -> bytes:
        """Exclusive sortkey stop bound for a cell-digit prefix (digits
        are '0'-'3', so bumping the last byte covers every deeper cell
        and the SORT_SEP continuation)."""
        return sub[:-1] + bytes([sub[-1] + 1]) if sub else b""

    def _scan_cell_pages(self, cells):
        """All covering cells' index rows, yielded as whole response
        PAGES (columnar ScanPage or KeyValue list) so the caller can
        lift coordinates vectorized. A covering cell FINER than
        index_level becomes a sortkey-range scan inside its coarse
        hashkey cell (the cell digits continue into the sortkey). Every
        cell's FIRST page rides one coalesced scan_multi wave — one
        stacked device evaluation per node — with per-cell paging only
        for overflowing cells."""
        specs = [(cell[:self.index_level].encode(),
                  cell[self.index_level:].encode()) for cell in cells]
        pcount = getattr(self.index, "partition_count", None)
        if not pcount:
            self.index.refresh_config()
            pcount = self.index.partition_count
        groups: dict = {}
        for hk, sub in specs:
            req = make_hashkey_scan_request(
                hk, batch_size=1000, start_sortkey=sub,
                stop_sortkey=self._sub_stop(sub))
            groups.setdefault(key_hash_parts(hk) % pcount,
                              []).append((hk, req))
        results = self.index.scan_multi({p: [r for _hk, r in reqs]
                                         for p, reqs in groups.items()})
        for pidx, reqs in groups.items():
            for (hk, _req), resp in zip(reqs, results[pidx]):
                if resp.error != int(StorageStatus.OK):
                    # a denied/throttled partition must not read as
                    # "no nearby points" — match the scanner path
                    raise RuntimeError(
                        f"geo cell scan failed: error {resp.error}")
                yield resp.kvs
                # overflowing cells RESUME the server-held context (no
                # re-scan of served rows, no positional skipping, no
                # leaked context)
                cid = resp.context_id
                while cid >= 0:
                    page = self.index.scan_page(pidx, cid)
                    if page.error != int(StorageStatus.OK):
                        raise RuntimeError(
                            f"geo cell scan failed: error {page.error}")
                    yield page.kvs
                    cid = page.context_id

    def search_radial_by_key(self, hash_key: bytes, sort_key: bytes,
                             radius_m: float, count: int = -1
                             ) -> List[GeoSearchResult]:
        """Radius search centered on an existing record (parity:
        the hashkey/sortkey overload of async_search_radial)."""
        err, value = self.raw.get(hash_key, sort_key)
        if err != int(StorageStatus.OK):
            return []
        coord = self.codec.decode(value)
        if coord is None:
            return []
        return self.search_radial(coord[0], coord[1], radius_m, count)

    def distance(self, hk1: bytes, sk1: bytes, hk2: bytes, sk2: bytes
                 ) -> Optional[float]:
        """Parity: geo_client::distance."""
        err1, v1 = self.raw.get(hk1, sk1)
        err2, v2 = self.raw.get(hk2, sk2)
        if err1 != int(StorageStatus.OK) or err2 != int(StorageStatus.OK):
            return None
        c1 = self.codec.decode(v1)
        c2 = self.codec.decode(v2)
        if c1 is None or c2 is None:
            return None
        return haversine_m(c1[0], c1[1], c2[0], c2[1])
