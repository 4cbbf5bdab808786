"""Geo radius search: the port's cells, radius_filter and GeoClient
against the JAX package's.

- `cells`: cell ids, bounds, coverings and float64 haversine distances
  exactly equal to pegasus_tpu/geo/cells.py on seeded inputs;
- `radius_filter` on the CPU against pegasus_tpu/ops/geo.radius_filter
  on seeded batches of 1 to 5000 candidates: distances within TOL_M (see
  `_tol_m`), masks equal except where the JAX distance lies within that
  tolerance of the radius (such candidates are counted); and every
  distance within `f32_error_band_m` of the float64 haversine;
- GeoClient set / update / delete / search_radial /
  search_radial_by_key / distance on a raw and an index Table in each
  package: the same hits; a pair of tables the JAX package wrote answers
  the same through the port's GeoClient;
- the cases of tests/test_geo.py that need no cluster, on the port,
  the legacy headerless index rows among them;
- GeoClient and radius_filter run on the card unless told otherwise.
"""

import math
import random

import numpy as np
import pytest

from pegasus_tpu.client import PegasusClient as JClient
from pegasus_tpu.client import Table as JTable
from pegasus_tpu.geo import GeoClient as JGeo
from pegasus_tpu.geo import cells as jcells
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.ops.geo import radius_filter as j_radius_filter
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu_torch.client import PegasusClient, Table
from pegasus_tpu_torch.geo import (
    GeoClient,
    cell_id,
    covering_cells,
    haversine_m,
)
from pegasus_tpu_torch.geo import cells as tcells
from pegasus_tpu_torch.ops.geo import f32_error_band_m, radius_filter
from pegasus_tpu_torch.utils.errors import StorageStatus

OK = int(StorageStatus.OK)
EPS32 = float(np.finfo(np.float32).eps)
R = 6_371_000.0


def _tol_m(dist_m):
    """How far the port's float32 distance may lie from the JAX
    package's for the same candidate.

    Both compute the same float32 formula from bit-identical radians.
    Torch's float32 sin, cos, sqrt and asin are each within a few ulps
    relative, so its distance is within 16 ulps (16·eps·d; 2.2e-7
    relative measured). XLA's CPU float32 sine of the small half-angles
    here is accurate to about one float32 epsilon absolute, not
    relative: sin(Δφ/2) enters the distance multiplied by 2R, so the
    reference may be off by 2R·eps = 1.52 m (0.29 m measured)."""
    return 2 * R * EPS32 + 16 * EPS32 * np.asarray(dist_m, np.float64)


def test_cells_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(300):
        lat = float(rng.uniform(-90, 90))
        lng = float(rng.uniform(-180, 180))
        level = int(rng.integers(1, 20))
        cid = tcells.cell_id(lat, lng, level)
        assert cid == jcells.cell_id(lat, lng, level)
        assert tcells.cell_bounds(cid) == jcells.cell_bounds(cid)
        lat2 = lat + float(rng.normal(0, 0.1))
        lng2 = lng + float(rng.normal(0, 0.1))
        assert tcells.haversine_m(lat, lng, lat2, lng2) == \
            jcells.haversine_m(lat, lng, lat2, lng2)
    for lat, lng, radius, level in ((40.0, -74.0, 500.0, 12),
                                    (40.0, -74.0, 2500.0, 14),
                                    (-33.9, 151.2, 120.0, 16),
                                    (89.9, 10.0, 500.0, 12),
                                    (0.0, 179.999, 800.0, 13)):
        assert tcells.covering_cells(lat, lng, radius, level) == \
            jcells.covering_cells(lat, lng, radius, level)
    with pytest.raises(ValueError):
        tcells.covering_cells(89.9, 10.0, 500.0, 16)
    with pytest.raises(ValueError):
        tcells.cell_id(91.0, 0.0, 3)


@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 1000, 5000])
def test_radius_filter_matches_jax(n):
    rng = np.random.default_rng(n)
    boundary = 0
    for trial in range(4):
        c_lat = 40.0 + float(rng.uniform(-1, 1))
        c_lng = -74.0 + float(rng.uniform(-1, 1))
        lats = c_lat + (rng.random(n) - 0.5) * 0.18
        lngs = c_lng + (rng.random(n) - 0.5) * 0.24
        radius = float(rng.choice([120.0, 500.0, 2500.0, 6000.0]))
        valid = rng.random(n) < 0.9 if trial % 2 else None
        jk, jd = j_radius_filter(lats, lngs, c_lat, c_lng, radius,
                                 valid=valid)
        tk, td = radius_filter(lats, lngs, c_lat, c_lng, radius,
                               valid=valid, device="cpu")
        assert tk.shape == jk.shape == (n,) and td.dtype == np.float32
        diff = np.abs(td.astype(np.float64) - jd.astype(np.float64))
        assert (diff <= _tol_m(jd)).all(), diff.max()
        near = np.abs(jd.astype(np.float64) - radius) <= _tol_m(jd)
        boundary += int(near.sum())
        assert (tk[~near] == jk[~near]).all()
        truth = np.array([haversine_m(c_lat, c_lng, la, lo)
                          for la, lo in zip(lats, lngs)])
        band = f32_error_band_m(c_lat, c_lng, radius)
        close = truth <= 2 * radius
        assert (np.abs(td - truth)[close] <= band).all()
    # the boundary share is tiny: the tolerance is metres, radii hundreds
    assert boundary <= max(2, n // 100)
    assert radius_filter(np.zeros(0), np.zeros(0), 0.0, 0.0, 1.0,
                         device="cpu")[0].shape == (0,)


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        radius_filter(np.ones(3), np.ones(3), 1.0, 1.0, 10.0)

    class CardClient:
        device = None

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeoClient(CardClient(), CardClient())


def make_geo(tmp_path, partitions=4, name=""):
    raw = Table(str(tmp_path / f"raw{name}"), app_id=1,
                partition_count=partitions, device="cpu")
    idx = Table(str(tmp_path / f"idx{name}"), app_id=2,
                partition_count=partitions, device="cpu")
    return GeoClient(PegasusClient(raw), PegasusClient(idx)), raw, idx


def make_jgeo(tmp_path, partitions=4, name="j"):
    raw = JTable(str(tmp_path / f"raw{name}"), app_id=1,
                 partition_count=partitions)
    idx = JTable(str(tmp_path / f"idx{name}"), app_id=2,
                 partition_count=partitions)
    return JGeo(JClient(raw), JClient(idx)), raw, idx


@pytest.fixture
def jax_state():
    yield
    jplacement.reset_probe()
    JDRIFT.reset()


def _hits(results):
    return [(r.hash_key, r.sort_key, r.value) for r in results]


def test_geo_client_matches_jax(tmp_path, jax_state):
    """The same seeded writes, moves and deletes through both clients;
    every search, by point and by key, and every distance the same."""
    geos = [make_geo(tmp_path), make_jgeo(tmp_path)]
    try:
        rng = np.random.default_rng(17)
        n = 1200
        lats = 40.0 + (rng.random(n) - 0.5) * 0.12
        lngs = -74.0 + (rng.random(n) - 0.5) * 0.16
        for geo, raw, idx in geos:
            for i in range(n):
                assert geo.set(b"poi%05d" % i, b"s",
                               b"%f|%f|p%d" % (lats[i], lngs[i], i)) == OK
            raw.flush_all()
            idx.manual_compact_all()
            for i in range(0, n, 37):  # moves, then deletes
                assert geo.set(b"poi%05d" % i, b"s", b"%f|%f|moved" % (
                    lats[i] + 0.003, lngs[i] - 0.002)) == OK
            for i in range(5, n, 41):
                assert geo.delete(b"poi%05d" % i, b"s") == OK
        for radius in (150.0, 600.0, 3000.0):
            for ci in (0, 100, 333, 777):
                got = [_hits(g.search_radial(float(lats[ci]),
                                             float(lngs[ci]), radius))
                       for g, _r, _i in geos]
                assert sorted(got[0]) == sorted(got[1]), (radius, ci)
                by_key = [_hits(g.search_radial_by_key(
                    b"poi%05d" % ci, b"s", radius, count=10))
                    for g, _r, _i in geos]
                assert [h[0] for h in by_key[0]] == \
                    [h[0] for h in by_key[1]]
        for i, j in ((1, 2), (3, 400), (37, 38), (5, 6)):
            d = [g.distance(b"poi%05d" % i, b"s", b"poi%05d" % j, b"s")
                 for g, _r, _i in geos]
            assert d[0] == d[1]
    finally:
        for _g, raw, idx in geos:
            raw.close()
            idx.close()


def test_jax_written_geo_tables_answer_the_same(tmp_path, jax_state):
    jgeo, jraw, jidx = make_jgeo(tmp_path, name="")
    rng = np.random.default_rng(23)
    pts = [(40.0 + float(rng.uniform(-0.02, 0.02)),
            -74.0 + float(rng.uniform(-0.02, 0.02))) for _ in range(300)]
    for i, (la, ln) in enumerate(pts):
        assert jgeo.set(b"pt%04d" % i, b"s", b"%f|%f|x" % (la, ln)) == OK
    jidx.split()
    want = [sorted(_hits(jgeo.search_radial(40.0, -74.0, r)))
            for r in (300.0, 1500.0)]
    count = jidx.partition_count
    jraw.close()
    jidx.close()
    raw = Table(str(tmp_path / "raw"), app_id=1, partition_count=4,
                device="cpu")
    idx = Table(str(tmp_path / "idx"), app_id=2, partition_count=count,
                device="cpu")
    try:
        geo = GeoClient(PegasusClient(raw), PegasusClient(idx))
        got = [sorted(_hits(geo.search_radial(40.0, -74.0, r)))
               for r in (300.0, 1500.0)]
        assert got == want and len(got[1]) > 20
    finally:
        raw.close()
        idx.close()


# ---- the cases of tests/test_geo.py that need no cluster ------------------

def test_cell_ids_hierarchical():
    deep = cell_id(40.0, -74.0, 16)
    assert cell_id(40.0, -74.0, 12) == deep[:12]
    assert len(deep) == 16
    assert cell_id(40.0, -74.0, 4) == cell_id(40.01, -74.01, 4)


def test_covering_cells_cover_the_circle():
    cells = covering_cells(40.0, -74.0, 500.0, 12)
    assert cell_id(40.0, -74.0, 12) in cells
    for brg in range(0, 360, 45):
        dlat = 0.004 * math.cos(math.radians(brg))
        dlng = 0.004 * math.sin(math.radians(brg))
        assert cell_id(40.0 + dlat, -74.0 + dlng, 12) in cells


def test_haversine_known_distance():
    d = haversine_m(40.6413, -73.7781, 40.7769, -73.8740)
    assert 16000 < d < 19000


def test_geo_set_get_search(tmp_path):
    geo, raw, idx = make_geo(tmp_path)
    try:
        points = {
            b"p_center": (40.0000, -74.0000),
            b"p_200m_n": (40.0018, -74.0000),
            b"p_400m_e": (40.0000, -73.9953),
            b"p_2km_s": (39.9820, -74.0000),
            b"p_far": (41.0, -75.0),
        }
        for name, (la, ln) in points.items():
            assert geo.set(name, b"s",
                           b"%f|%f|payload-%s" % (la, ln, name)) == OK
        assert geo.get(b"p_center", b"s")[0] == OK
        got = {r.hash_key for r in geo.search_radial(40.0, -74.0, 500)}
        assert got == {b"p_center", b"p_200m_n", b"p_400m_e"}
        top = geo.search_radial(40.0, -74.0, 5000, count=2)
        assert [r.hash_key for r in top] == [b"p_center", b"p_200m_n"]
        assert top[0].distance_m < 1.0
        got = {r.hash_key
               for r in geo.search_radial_by_key(b"p_center", b"s", 500)}
        assert b"p_400m_e" in got
        d = geo.distance(b"p_center", b"s", b"p_2km_s", b"s")
        assert 1800 < d < 2200
    finally:
        raw.close()
        idx.close()


def test_geo_update_moves_index_entry(tmp_path):
    geo, raw, idx = make_geo(tmp_path)
    try:
        assert geo.set(b"mover", b"s", b"40.0|-74.0|v1") == OK
        assert len(geo.search_radial(40.0, -74.0, 200)) == 1
        assert geo.set(b"mover", b"s", b"41.0|-75.0|v2") == OK
        assert geo.search_radial(40.0, -74.0, 200) == []
        hits = geo.search_radial(41.0, -75.0, 200)
        assert len(hits) == 1 and hits[0].value == b"41.0|-75.0|v2"
        assert geo.delete(b"mover", b"s") == OK
        assert geo.search_radial(41.0, -75.0, 200) == []
    finally:
        raw.close()
        idx.close()


def test_geo_rejects_uncodable_value(tmp_path):
    geo, raw, idx = make_geo(tmp_path)
    try:
        assert geo.set(b"bad", b"s", b"no-coords-here") == int(
            StorageStatus.INVALID_ARGUMENT)
    finally:
        raw.close()
        idx.close()


def test_geo_overflowing_cell_pages_through_context(tmp_path):
    """A covering cell with more points than one page surfaces all of
    them, resuming the server-held scan context."""
    geo, raw, idx = make_geo(tmp_path, partitions=2)
    try:
        rng = random.Random(3)
        for i in range(1500):
            la = 40.0 + rng.uniform(-0.00013, 0.00013)
            ln = -74.0 + rng.uniform(-0.00013, 0.00013)
            assert geo.set(b"blob%05d" % i, b"s",
                           b"%f|%f|x" % (la, ln)) == 0
        hits = geo.search_radial(40.0, -74.0, 100)
        assert len(hits) == 1500
        assert len({h.hash_key for h in hits}) == 1500
    finally:
        raw.close()
        idx.close()


def test_adaptive_covering_matches_brute_force(tmp_path):
    """Finer covering cells (sortkey-range scans inside coarse hashkey
    cells) return exactly the float64 haversine ground truth."""
    geo, raw, idx = make_geo(tmp_path, partitions=4)
    try:
        rng = np.random.default_rng(5)
        n = 3000
        lats = 40.0 + (rng.random(n) - 0.5) * 0.18
        lngs = -74.0 + (rng.random(n) - 0.5) * 0.24
        for i in range(n):
            assert geo.set(b"poi%05d" % i, b"s",
                           b"%f|%f|p" % (lats[i], lngs[i])) == 0
        raw.flush_all()
        idx.flush_all()
        for radius in (120, 500, 2500):
            for ci in (0, 11, 42):
                got = {r.hash_key for r in geo.search_radial(
                    float(lats[ci]), float(lngs[ci]), radius)}
                want = {b"poi%05d" % i for i in range(n)
                        if haversine_m(float(lats[ci]), float(lngs[ci]),
                                       float(lats[i]),
                                       float(lngs[i])) <= radius}
                assert got == want, (radius, ci)
        assert geo._cover_level(100) > geo._cover_level(50_000)
        assert geo._cover_level(1e9) == geo.index_level
        assert geo._cover_level(0.1) == geo.max_level
    finally:
        raw.close()
        idx.close()


def test_polar_search_coarsens_instead_of_crashing(tmp_path):
    geo, raw, idx = make_geo(tmp_path, partitions=2)
    try:
        assert geo.set(b"polar", b"s", b"89.900000|10.000000|x") == 0
        hits = geo.search_radial(89.9, 10.0, 500)
        assert [h.hash_key for h in hits] == [b"polar"]
    finally:
        raw.close()
        idx.close()


def test_legacy_headerless_index_rows_still_searchable(tmp_path):
    """Index rows that store the raw value directly (no packed coordinate
    header) appear in radius searches through the text codec, their
    values unstripped."""
    geo, raw, idx = make_geo(tmp_path)
    try:
        assert geo.set(b"new", b"s", b"40.0001|-74.0001|new-point") == OK
        ih, isk = geo._index_keys(b"old", b"s", 40.0002, -74.0002)
        legacy_value = b"40.0002|-74.0002|old-point"
        assert geo.index.set(ih, isk, legacy_value) == OK
        assert geo.raw.set(b"old", b"s", legacy_value) == OK
        by_hk = {g.hash_key: g for g in geo.search_radial(40.0, -74.0, 300)}
        assert set(by_hk) == {b"new", b"old"}
        assert by_hk[b"new"].value == b"40.0001|-74.0001|new-point"
        assert by_hk[b"old"].value == legacy_value
        assert abs(by_hk[b"old"].distance_m
                   - haversine_m(40.0, -74.0, 40.0002, -74.0002)) < 1.0
    finally:
        raw.close()
        idx.close()
