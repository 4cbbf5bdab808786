"""pegasus_tpu_torch.base against pegasus_tpu.base: crc64/crc32, the key
schema and the value schema, exact."""

import numpy as np
import pytest

from pegasus_tpu.base import crc as jcrc
from pegasus_tpu.base import key_schema as jks
from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu_torch.base import crc as tcrc
from pegasus_tpu_torch.base import key_schema as tks
from pegasus_tpu_torch.base import value_schema as tvs
from tests.test_crc import GOLDEN


@pytest.mark.parametrize("data,want64,want32", GOLDEN)
def test_golden_vectors(data, want64, want32):
    assert tcrc.crc64(data) == want64
    assert tcrc.crc32(data) == tcrc.crc32_plain(data) == want32


@pytest.mark.parametrize("n", [0, 1, 511, 4095, 4096, 4097, 70_001])
def test_crc_matches_jax_package(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                              dtype=np.uint8).tobytes()
    assert tcrc.crc64(data) == jcrc.crc64(data)
    assert tcrc.crc32(data) == tcrc.crc32_plain(data) == jcrc.crc32(data)
    # init chaining equals concatenation on both packages
    half = n // 2
    assert (tcrc.crc32_plain(data[half:], tcrc.crc32_plain(data[:half]))
            == jcrc.crc32(data))
    assert (tcrc.crc32(data[half:], tcrc.crc32(data[:half]))
            == jcrc.crc32(data))
    assert (tcrc.crc64(data[half:], tcrc.crc64(data[:half]))
            == jcrc.crc64(data))


def test_crc64_batch_matches_jax_package():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(200, 48), dtype=np.uint8)
    lengths = rng.integers(-3, 49, size=200)
    starts = rng.integers(0, 10, size=200)
    np.testing.assert_array_equal(
        tcrc.crc64_batch(data, lengths, start=starts),
        jcrc.crc64_batch(data, lengths, start=starts))


def _key_cases():
    rng = np.random.default_rng(5)
    cases = [(b"", b""), (b"", b"sk"), (b"hk", b""), (b"\xff\xff", b""),
             (b"a\xff", b"\xff"), (b"user00000001", b"s03")]
    for _ in range(40):
        hk = rng.integers(0, 256, rng.integers(0, 6), dtype=np.uint8)
        sk = rng.integers(0, 256, rng.integers(0, 6), dtype=np.uint8)
        cases.append((hk.tobytes(), sk.tobytes()))
    return cases


@pytest.mark.parametrize("hk,sk", _key_cases())
def test_key_schema_matches_jax_package(hk, sk):
    key = tks.generate_key(hk, sk)
    assert key == jks.generate_key(hk, sk)
    assert tks.restore_key(key) == jks.restore_key(key)
    assert tks.generate_next_bytes(hk) == jks.generate_next_bytes(hk)
    assert (tks.generate_next_bytes(hk, sk)
            == jks.generate_next_bytes(hk, sk))
    assert tks.key_hash(key) == jks.key_hash(key)
    assert tks.key_hash_parts(hk, sk) == jks.key_hash_parts(hk, sk)
    for count in (1, 8, 64):
        assert (tks.partition_index(hk, count, sk)
                == jks.partition_index(hk, count, sk))
        assert (tks.check_key_hash(key, 3, count - 1)
                == jks.check_key_hash(key, 3, count - 1))


def test_key_schema_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        jks.generate_key(b"x" * 70000, b"")
    with pytest.raises(ValueError):
        tks.generate_key(b"x" * 70000, b"")


@pytest.mark.parametrize("version", [0, 1, 2])
@pytest.mark.parametrize("ets", [0, 1, 300_000_000, 0xFFFFFFFF])
def test_value_schema_matches_jax_package(version, ets):
    tag = tvs.generate_timetag(1_700_000_000_123_456, 5, True)
    assert tag == jvs.generate_timetag(1_700_000_000_123_456, 5, True)
    raw = tvs.generate_value(version, b"user-data", ets, tag)
    assert raw == jvs.generate_value(version, b"user-data", ets, tag)
    assert tvs.header_length(version) == jvs.header_length(version)
    assert (tvs.extract_expire_ts(version, raw)
            == jvs.extract_expire_ts(version, raw) == ets)
    assert (tvs.extract_user_data(version, raw)
            == jvs.extract_user_data(version, raw) == b"user-data")
    assert (tvs.update_expire_ts(version, raw, 77)
            == jvs.update_expire_ts(version, raw, 77))
    if version:
        assert (tvs.extract_timetag(version, raw)
                == jvs.extract_timetag(version, raw))
    for now in (0, ets, ets + 1, 300_000_000):
        assert (tvs.check_if_ts_expired(now, ets)
                == jvs.check_if_ts_expired(now, ets))
        assert (tvs.check_if_record_expired(version, now, raw)
                == jvs.check_if_record_expired(version, now, raw))


def test_ttl_and_epoch_match_jax_package():
    for unix in (0.0, 1451606400.0, 1_760_000_000.5):
        assert tvs.epoch_now(unix) == jvs.epoch_now(unix)
    for ttl in (-5, 0, 1, 86400):
        assert (tvs.expire_ts_from_ttl(ttl, now=1000)
                == jvs.expire_ts_from_ttl(ttl, now=1000))
