"""Storage parity: on-disk state crosses between the JAX package and the
port under the slice's flags (`block_codec = none`, no bloom filter, no
perfect-hash index).

- an SST written by either package reads back identically in the other,
  and both writers produce byte-identical data blocks;
- a JAX file that carries bloom / phash sidecars opens and serves in the
  port, and so does a compressed (dcz2) one; a file whose index names a
  codec neither package knows is refused with a clear error;
- WAL replay after an unclean close recovers the same records in both;
- LSM flush, merge compaction and `iterate` agree across packages, and a
  data directory written by one package serves in the other.
"""

import os

import numpy as np
import pytest

from pegasus_tpu.base.value_schema import epoch_now
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu.storage import lsm as jlsm
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.storage.wal import OP_DEL as J_OP_DEL
from pegasus_tpu.storage.wal import OP_PUT as J_OP_PUT
from pegasus_tpu.utils.errors import (
    StorageCorruptionError as JStorageCorruptionError,
)
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from pegasus_tpu_torch.base.crc import crc32
from pegasus_tpu_torch.storage import engine as teng
from pegasus_tpu_torch.storage import lsm as tlsm
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from pegasus_tpu_torch.utils.errors import StorageCorruptionError

SLICE_FLAGS = (("pegasus.storage", "block_codec", "none"),
               ("pegasus.server", "bloom_bits_per_key", 0),
               ("pegasus.server", "phash_index", False))


def _set_flags(values, registries=(JFLAGS, TFLAGS)):
    """Set flags in both packages' process-wide registries."""
    for section, name, value in values:
        for reg in registries:
            reg.set(section, name, value, force=True)


@pytest.fixture
def slice_flags():
    saved = [[(s, n, reg.get(s, n)) for s, n, _v in SLICE_FLAGS]
             for reg in (JFLAGS, TFLAGS)]
    _set_flags(SLICE_FLAGS)
    yield
    _set_flags(saved[0], (JFLAGS,))
    _set_flags(saved[1], (TFLAGS,))


def _records(seed, n=700):
    """Sorted (key, value, expire_ts, tombstone) rows: pegasus keys of
    mixed widths (some past 32 bytes), empty hashkeys, tombstones and
    expire_ts values past 2^31."""
    from pegasus_tpu_torch.base.key_schema import generate_key

    rng = np.random.default_rng(seed)
    keys = set()
    while len(keys) < n:
        hk = b"" if rng.random() < 0.05 else b"user%0*d" % (
            int(rng.integers(4, 30)), int(rng.integers(0, 10 ** 4)))
        keys.add(generate_key(hk, b"s%02d" % int(rng.integers(0, 100))))
    rows = []
    for key in sorted(keys):
        tomb = rng.random() < 0.1
        value = b"" if tomb else rng.bytes(int(rng.integers(0, 90)))
        ets = int(rng.choice([0, 100, 0x7FFFFFFF, 0x80000005]))
        rows.append((key, value, 0 if tomb else ets, tomb))
    return rows


def _write(writer_cls, path, rows, block_capacity=64):
    w = writer_cls(path, block_capacity=block_capacity,
                   meta={"last_flushed_decree": 9, "data_version": 1})
    for key, value, ets, tomb in rows:
        w.add(key, value, ets, tombstone=tomb)
    w.finish()


def _table_contents(table):
    out = []
    for i in range(len(table.blocks)):
        blk = table.read_block(i)
        out.append(tuple(np.asarray(c).tobytes() for c in (
            blk.keys, blk.key_len, blk.expire_ts, blk.hash_lo, blk.flags,
            blk.value_offs, blk.value_heap)))
    return out


def _block_bytes(path, table):
    with open(path, "rb") as f:
        data = f.read()
    return [data[b.offset:b.offset + b.size] for b in table.blocks]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sst_crosses_between_packages(tmp_path, slice_flags, writer):
    rows = _records(1)
    path = str(tmp_path / "l0-1.sst")
    _write(jsst.SSTableWriter if writer == "jax" else tsst.SSTableWriter,
           path, rows)
    jt, tt = jsst.SSTable(path), tsst.SSTable(path)
    assert jt.codec is None and jt.bloom is None and jt.phash is None
    assert [(b.offset, b.size, b.count, b.key_width, b.first_key,
             b.last_key, b.crc) for b in jt.blocks] == [
        (b.offset, b.size, b.count, b.key_width, b.first_key, b.last_key,
         b.crc) for b in tt.blocks]
    assert tt.meta == jt.meta and tt.total_count == jt.total_count == 700
    assert _table_contents(tt) == _table_contents(jt)
    assert list(tt.iterate()) == list(jt.iterate())
    lo, hi = rows[100][0], rows[400][0]
    assert list(tt.iterate(lo, hi)) == list(jt.iterate(lo, hi))
    assert (list(tt.iterate(lo, hi, reverse=True))
            == list(jt.iterate(lo, hi, reverse=True)))
    for key, _v, _e, _t in rows[::7]:
        assert tt.get(key) == jt.get(key)
        assert tt.get(key + b"\x00") == jt.get(key + b"\x00") is None
    jt.close()
    tt.close()


def test_writers_produce_identical_data_blocks(tmp_path, slice_flags):
    rows = _records(2)
    jpath, tpath = str(tmp_path / "j.sst"), str(tmp_path / "t.sst")
    _write(jsst.SSTableWriter, jpath, rows)
    _write(tsst.SSTableWriter, tpath, rows)
    jt, tt = jsst.SSTable(jpath), tsst.SSTable(tpath)
    assert len(jt.blocks) == len(tt.blocks) == 11
    assert _block_bytes(tpath, tt) == _block_bytes(jpath, jt)
    jt.close()
    tt.close()


def test_sidecar_file_serves_and_compressed_file_is_refused(tmp_path,
                                                            slice_flags):
    rows = _records(3)
    plain = str(tmp_path / "plain.sst")
    _write(jsst.SSTableWriter, plain, rows)
    _set_flags((("pegasus.server", "bloom_bits_per_key", 10),
                    ("pegasus.server", "phash_index", True)))
    sidecars = str(tmp_path / "sidecars.sst")
    _write(jsst.SSTableWriter, sidecars, rows)
    jt = jsst.SSTable(sidecars)
    assert jt.bloom is not None and jt.phash is not None
    tt, tp = tsst.SSTable(sidecars), tsst.SSTable(plain)
    assert _table_contents(tt) == _table_contents(tp)
    assert list(tt.iterate()) == list(jt.iterate())
    for key, _v, _e, _t in rows[::11]:
        assert tt.get(key) == jt.get(key)
    _set_flags((("pegasus.storage", "block_codec", "dcz2"),))
    packed = str(tmp_path / "dcz2.sst")
    _write(jsst.SSTableWriter, packed, rows)
    tc = tsst.SSTable(packed)
    assert tc.codec == "dcz2" and _table_contents(tc) == _table_contents(tp)
    # the same file with its index naming an unknown codec
    with open(packed, "rb") as f:
        data = f.read()
    index_offset, index_size, _crc, magic = tsst.FOOTER.unpack(
        data[-tsst.FOOTER.size:])
    blob = data[index_offset:index_offset + index_size].replace(
        b'"codec": "dcz2"', b'"codec": "dcz9"')
    unknown = str(tmp_path / "dcz9.sst")
    with open(unknown, "wb") as f:
        f.write(data[:index_offset] + blob + tsst.FOOTER.pack(
            index_offset, len(blob), crc32(blob), magic))
    for reader, error in ((jsst.SSTable, JStorageCorruptionError),
                          (tsst.SSTable, StorageCorruptionError)):
        with pytest.raises(error, match="dcz9"):
            reader(unknown)
    for t in (jt, tt, tp, tc):
        t.close()


def _batches(seed, n_batches=40):
    from pegasus_tpu_torch.base.key_schema import generate_key

    rng = np.random.default_rng(seed)
    now = epoch_now()
    out = []
    for _ in range(n_batches):
        items = []
        for _ in range(int(rng.integers(1, 6))):
            key = generate_key(b"hk%03d" % int(rng.integers(0, 60)),
                               b"s%d" % int(rng.integers(0, 5)))
            if rng.random() < 0.2:
                items.append((OP_DEL, key, b"", 0))
            else:
                ets = now + 10 ** 6 if rng.random() < 0.3 else 0
                items.append((OP_PUT, key, rng.bytes(12), ets))
        out.append(items)
    return out


def _apply(eng, mod, batches, first_decree=1, flush_at=()):
    j_ops = {OP_PUT: J_OP_PUT, OP_DEL: J_OP_DEL}
    is_jax = mod is jeng
    for i, items in enumerate(batches):
        eng.write_batch([mod.WriteBatchItem(
            j_ops[op] if is_jax else op, k, v, e) for op, k, v, e in items],
            first_decree + i)
        if i in flush_at:
            eng.flush()


def _open(kind, path):
    if kind == "jax":
        return jeng.StorageEngine(path, values_carry_expire_header=False)
    return teng.StorageEngine(path, device="cpu")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_wal_replay_after_unclean_close(tmp_path, slice_flags, writer,
                                        reader):
    """No close(): the WAL frames written so far are all the reader gets;
    a torn tail frame is dropped and the store reopens for writing."""
    batches = _batches(4)
    path = str(tmp_path / "data")
    eng = _open(writer, path)
    _apply(eng, jeng if writer == "jax" else teng, batches, flush_at=(14,))
    eng.wal._f.flush()
    want = list(eng.iterate())
    decree = eng.last_committed_decree
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00torn")  # a frame cut by the crash
    got = _open(reader, path)
    assert got.last_committed_decree == decree == 40
    assert got.last_flushed_decree == 15
    assert list(got.iterate()) == want
    _apply(got, jeng if reader == "jax" else teng, _batches(5, 3),
           first_decree=decree + 1)
    got.close()
    again = _open(reader, path)
    assert again.last_committed_decree == decree + 3
    again.close()


def test_lsm_flush_compact_iterate_agree(tmp_path, slice_flags):
    """The same writes, flushes and merge compactions in both LSM stores
    give the same merged view at every step."""
    rng = np.random.default_rng(6)
    stores = (jlsm.LSMStore(str(tmp_path / "j"), block_capacity=32),
              tlsm.LSMStore(str(tmp_path / "t"), block_capacity=32))
    assert tlsm.L1_RUN_CAPACITY == jlsm.L1_RUN_CAPACITY
    keys = [b"\x00\x03k%02d" % i + b"s%03d" % j
            for i in range(40) for j in range(12)]

    def views():
        out = []
        for s in stores:
            lo, hi = keys[50], keys[300]
            out.append((list(s.iterate()), list(s.iterate(lo, hi)),
                        list(s.iterate(lo, hi, reverse=True)),
                        [s.get(k) for k in keys[::13]],
                        s.sorted_runs() is None))
        assert out[0] == out[1]

    for step in range(6):
        for i in rng.choice(len(keys), 150, replace=False):
            delete = rng.random() < 0.15
            for s in stores:
                if delete:
                    s.delete(keys[i])
                else:
                    s.put(keys[i], b"v%d-%d" % (step, i), step * 10)
        views()
        for s in stores:
            s.flush(meta={"last_flushed_decree": step})
        views()
        if step % 2:
            for s in stores:
                s.compact()
            views()
            assert stores[1].sorted_runs() is not None
    for s in stores:
        s.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_engine_directory_serves_in_the_other_package(tmp_path, slice_flags,
                                                      writer):
    """A data directory with L1 runs, L0 files and a WAL tail, written by
    one package, opens in the other with the same view; a merge-path
    manual compaction then gives both the same result."""
    path = str(tmp_path / "data")
    batches = _batches(7, 60)
    eng = _open(writer, path)
    mod = jeng if writer == "jax" else teng
    _apply(eng, mod, batches[:30], flush_at=(9, 19))
    eng.manual_compact(now=epoch_now())
    _apply(eng, mod, batches[30:], first_decree=31, flush_at=(10,))
    eng.close()
    reader = "torch" if writer == "jax" else "jax"
    other = _open(reader, path)
    mine = _open(writer, path)
    want = list(mine.iterate())
    assert list(other.iterate()) == want
    assert other.last_committed_decree == mine.last_committed_decree == 60
    mine.close()
    other.manual_compact(now=epoch_now())
    other.close()
    for kind in ("jax", "torch"):
        e = _open(kind, path)
        assert e.lsm.sorted_runs() is not None
        assert list(e.iterate()) == want
        e.close()
