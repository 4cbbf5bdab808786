"""The port's block codec and SST files against the JAX package.

- `encode_block` bytes (dcz = v1, dcz2 = v2) for seeded blocks with every
  expire_ts shape (all zero, a u8 and a u16 FOR spread, a spread that
  falls back to raw u32), empty hashkeys, tombstones, malformed rows and
  both value-heap modes (zstd, and zlib with libzstd hidden from both
  packages through their own `_Zstd` state, restored after the test);
  `EncodedBlock` parsing and decoding, the native key rebuild against its
  numpy twin, and the native encoded subset;
- transcoding: a v2 block appended to a dcz writer, in both packages;
- SST files after the same writes, flushes and `manual_compact` under
  each codec, with the bloom and perfect-hash sidecars on and off: the
  same file names and bytes (an L1 index's compaction finish time, a
  wall-clock stamp, aside), and each package serves the other's store.
Flags are set in both packages' registries and restored after each test.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from pegasus_tpu.base.value_schema import epoch_now
from pegasus_tpu.native import cblock_subset_fn as jsubset_fn
from pegasus_tpu.storage import block_codec as jbc
from pegasus_tpu.storage import engine as jeng
from pegasus_tpu.storage import sstable as jsst
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.value_schema import generate_value
from pegasus_tpu_torch.native import cblock_subset_fn
from pegasus_tpu_torch.ops.record_block import hash_lo_column
from pegasus_tpu_torch.storage import block_codec as tbc
from pegasus_tpu_torch.storage import engine as teng
from pegasus_tpu_torch.storage import sstable as tsst
from pegasus_tpu_torch.storage.wal import OP_DEL, OP_PUT
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

FLAG_NAMES = (("pegasus.storage", "block_codec"),
              ("pegasus.server", "bloom_bits_per_key"),
              ("pegasus.server", "phash_index"))
STORE_FLAGS = [(codec, sidecars) for codec in ("none", "dcz", "dcz2")
               for sidecars in (False, True)]
ETS_SHAPES = ("zero", "u8", "u16", "raw")


def _set(codec, sidecars):
    for (section, name), value in zip(
            FLAG_NAMES, (codec, 10 if sidecars else 0, sidecars)):
        for reg in (JFLAGS, TFLAGS):
            reg.set(section, name, value, force=True)


@pytest.fixture
def restore_flags():
    saved = [[reg.get(s, n) for s, n in FLAG_NAMES]
             for reg in (JFLAGS, TFLAGS)]
    yield _set
    for reg, values in zip((JFLAGS, TFLAGS), saved):
        for (section, name), value in zip(FLAG_NAMES, values):
            reg.set(section, name, value, force=True)


@pytest.fixture(params=["zstd", "zlib"])
def heap_mode(request):
    """Both packages' heap compressor: libzstd, or zlib with libzstd
    hidden through each package's own `_Zstd` module state."""
    saved = [(z, z._lib, z._tried) for z in (jbc._Zstd, tbc._Zstd)]
    if request.param == "zlib":
        for z in (jbc._Zstd, tbc._Zstd):
            z._lib, z._tried = None, True
    else:
        assert tbc._Zstd.lib() is not None and jbc._Zstd.lib() is not None
    yield request.param
    for z, lib, tried in saved:
        z._lib, z._tried = lib, tried


def _block(seed, ets_shape, malformed, n=150, width=32):
    """Raw block columns (keys, key_len, ets, hash_lo, flags, offs, heap)
    in SST order: runs of equal hashkeys, an empty-hashkey row, rows
    with the tombstone flag, compressible values."""
    rng = np.random.default_rng(seed)
    keys_list = {generate_key(b"user%04d" % int(rng.integers(0, n // 5)),
                              b"s%02d" % int(rng.integers(0, 12)))
                 for _ in range(n)}
    keys_list.add(generate_key(b"", b"sortonly-%d" % seed))
    if malformed:
        keys_list |= {b"\x00", b"\x00\x09ab", b"\xff\xff"}
    keys_list = sorted(keys_list)
    n = len(keys_list)
    keys = np.zeros((n, width), dtype=np.uint8)
    key_len = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(keys_list):
        keys[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
        key_len[i] = len(k)
    base = 1_700_000_000
    spread = {"zero": 0, "u8": 200, "u16": 40_000, "raw": 1 << 30}[
        ets_shape]
    ets = np.where(rng.random(n) < 0.4, 0,
                   base + rng.integers(0, spread + 1, n)).astype(np.uint32)
    if ets_shape == "zero":
        ets[:] = 0
    flags = (rng.random(n) < 0.1).astype(np.uint8)
    vals = [b"\x00\x00\x00\x00field0=%064d" % int(rng.integers(0, 10 ** 6))
            for _ in range(n)]
    offs = np.zeros(n + 1, dtype=np.uint32)
    offs[1:] = np.cumsum([len(v) for v in vals])
    return (keys, key_len, ets, hash_lo_column(keys, key_len), flags, offs,
            b"".join(vals))


@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("ets_shape", ETS_SHAPES)
@pytest.mark.parametrize("version", [1, 2])
def test_encode_block_bytes_and_decode(heap_mode, version, ets_shape,
                                       malformed):
    cols = _block(7, ets_shape, malformed)
    raw = tbc.encode_block(*cols, version=version)
    assert raw == jbc.encode_block(*cols, version=version)
    assert tbc.block_version(raw) == version
    enc, jenc = tbc.EncodedBlock.parse(raw), jbc.EncodedBlock.parse(raw)
    assert enc.has_malformed == jenc.has_malformed == malformed
    assert enc.heap_mode == jenc.heap_mode == (
        2 if heap_mode == "zstd" else 1)
    for name in ("expire_ts", "hash_lo", "key_len", "flags", "value_offs",
                 "hk_idx", "dict_offs", "sk_offs"):
        assert np.array_equal(getattr(enc, name), getattr(jenc, name)), name
    assert np.array_equal(enc.key_matrix(), enc.key_matrix_plain())
    assert [enc.key_at(i) for i in range(enc.n)] == \
        [jenc.key_at(i) for i in range(enc.n)]
    assert enc.dict_entries() == jenc.dict_entries()
    blk = enc.decode()
    keys, key_len, ets, hash_lo, flags, offs, heap = cols
    for got, want in ((blk.keys, keys), (blk.key_len, key_len),
                      (blk.expire_ts, ets), (blk.hash_lo, hash_lo),
                      (blk.flags, flags), (blk.value_offs, offs)):
        assert np.array_equal(got, want)
    assert bytes(np.asarray(blk.value_heap)) == heap
    assert enc.mem_bytes() == jenc.mem_bytes()
    assert tbc.codec_accepts("dcz", version) == jbc.codec_accepts(
        "dcz", version)


@pytest.mark.parametrize("version", [1, 2])
def test_native_subset_matches_jax(heap_mode, version):
    """pegasus_cblock_subset: the same kept rows, re-stamped TTLs and
    value headers, the same bytes, hashes and fence keys."""
    cols = _block(8, "u16", False)
    raw = tbc.encode_block(*cols, version=version)
    enc = tbc.EncodedBlock.parse(raw)
    rng = np.random.default_rng(1)
    keep = rng.random(enc.n) < 0.6
    new_ets = np.where(rng.random(enc.n) < 0.5, 0,
                       1_800_000_000).astype(np.uint32)
    for ets, patch in ((None, False), (new_ets, True)):
        got = cblock_subset_fn()(raw, enc.raw_heap_len, enc.key_width,
                                 keep, ets, patch, True)
        want = jsubset_fn()(raw, enc.raw_heap_len, enc.key_width, keep,
                            ets, patch, True)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
        assert got[2:] == want[2:]


def test_dcz_writer_transcodes_a_v2_block(tmp_path, restore_flags):
    raw = tbc.encode_block(*_block(9, "u8", False), version=2)
    restore_flags("dcz", True)
    paths = []
    for sst, bc in ((jsst, jbc), (tsst, tbc)):
        path = str(tmp_path / f"{sst.__name__.split('.')[0]}.sst")
        w = sst.SSTableWriter(path)
        w.add_block_encoded(bc.EncodedBlock.parse(raw))
        w.finish()
        paths.append(path)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]
    t = tsst.SSTable(paths[1])
    assert t.codec == "dcz"
    assert tbc.block_version(t.read_block_encoded(0).raw) == 1
    restore_flags("dcz2", True)
    w = tsst.SSTableWriter(str(tmp_path / "v2.sst"))
    with pytest.raises(ValueError, match="none"):
        restore_flags("none", False)
        tsst.SSTableWriter(str(tmp_path / "none.sst")).add_block_encoded(
            tbc.EncodedBlock.parse(raw))
    w.abandon()


def _load(eng, mod, seed, now):
    """Writes, two flushes and a memtable, then a manual compaction."""
    rng = np.random.default_rng(seed)
    decree = 1
    item_cls = mod.WriteBatchItem
    ops = {OP_PUT: jeng.OP_PUT if mod is jeng else OP_PUT,
           OP_DEL: jeng.OP_DEL if mod is jeng else OP_DEL}
    for step in range(3):
        items = []
        for _ in range(400):
            key = generate_key(b"user%04d" % int(rng.integers(0, 200)),
                               b"s%02d" % int(rng.integers(0, 10)))
            if rng.random() < 0.1:
                items.append(item_cls(ops[OP_DEL], key, b"", 0))
            else:
                ets = int(rng.choice([0, 0, now + 100, now + 10 ** 6,
                                      now - 5]))
                items.append(item_cls(ops[OP_PUT], key, generate_value(
                    1, b"field0=%064d" % int(rng.integers(0, 10 ** 9)),
                    ets), ets))
        eng.write_batch(items, decree)
        decree += 1
        if step < 2:
            eng.flush()


def _digest(path):
    """sha256 of an SST file: its data blocks and sidecars byte for byte,
    and its index with the compaction's wall-clock finish stamp
    dropped (the two compactions run a moment apart)."""
    data = open(path, "rb").read()
    index_offset, index_size, _crc, magic = tsst.FOOTER.unpack(
        data[-tsst.FOOTER.size:])
    index = json.loads(data[index_offset:index_offset + index_size])
    index["meta"].pop("manual_compact_finish_time", None)
    h = hashlib.sha256(data[:index_offset])
    h.update(json.dumps(index, sort_keys=True).encode() + magic)
    return h.hexdigest()


def _digests(root):
    sst = os.path.join(root, "sst")
    return {name: _digest(os.path.join(sst, name))
            for name in sorted(os.listdir(sst)) if name.endswith(".sst")}


@pytest.mark.parametrize("codec,sidecars", STORE_FLAGS,
                         ids=[f"{c}-{'sidecars' if s else 'bare'}"
                              for c, s in STORE_FLAGS])
def test_sst_files_match_after_flush_and_compaction(tmp_path, restore_flags,
                                                    codec, sidecars):
    restore_flags(codec, sidecars)
    now = epoch_now()
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    j = jeng.StorageEngine(jroot, block_capacity=64,
                           values_carry_expire_header=True)
    t = teng.StorageEngine(troot, values_carry_expire_header=True,
                           device="cpu")
    t.lsm._block_capacity = 64
    _load(j, jeng, 5, now)
    _load(t, teng, 5, now)
    assert _digests(troot) == _digests(jroot)
    l0 = _digests(troot)
    assert len(l0) == 2
    j.manual_compact(default_ttl=0, now=now)
    t.manual_compact(default_ttl=0, now=now)
    assert _digests(troot) == _digests(jroot) != l0
    for table in t.lsm.l1_runs:
        assert table.codec == (None if codec == "none" else codec)
        assert (table.bloom is not None) == sidecars
        assert (table.phash is not None) == sidecars
    j.close()
    t.close()
    # each package serves the other's store
    for root in (jroot, troot):
        jr = jeng.StorageEngine(root, values_carry_expire_header=True)
        tr = teng.StorageEngine(root, values_carry_expire_header=True,
                                device="cpu")
        assert list(tr.iterate()) == list(jr.iterate())
        for i in range(0, 200, 3):
            for s in (0, 5, 11):
                key = generate_key(b"user%04d" % i, b"s%02d" % s)
                assert tr.get(key) == jr.get(key)
        jr.close()
        tr.close()
