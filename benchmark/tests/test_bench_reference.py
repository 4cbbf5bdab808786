"""The plain reference and the frozen kernel arithmetic, on the CPU."""

import subprocess
import sys

import numpy as np
import pytest

from benchmark.reference import judge as judge_mod
from benchmark.reference import kv
from benchmark.roofline import arith

REPO = __file__.rsplit("/benchmark/", 1)[0]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.kv, "
            "benchmark.reference.judge; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pegasus_tpu', 'pegasus_tpu_torch', 'jax', 'jaxlib', 'torch'}); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_frozen_encodings_agree_with_the_port():
    from pegasus_tpu_torch.base.crc import crc64
    from pegasus_tpu_torch.base.key_schema import generate_key

    for h in (0, 1, 99_999, 123_456_789):
        hk = kv.hashkey(h)
        assert kv.crc64(hk) == crc64(hk)
        assert kv.encode_key(hk, b"s03") == generate_key(hk, b"s03")
    crcs = kv.hashkey_crc(500, 700)
    assert [int(c) for c in crcs] == [crc64(kv.hashkey(h))
                                      for h in range(500, 700)]


def small_table() -> kv.Table:
    n, fields = 300, 10
    expired = (np.arange(n * fields) % 7 == 0).reshape(n, fields)
    return kv.Table(n, fields, expired, 4, 100)


def test_values_are_the_field_length():
    v = kv.record_value(1_234_567, 100)
    assert len(v) == 100 and v.startswith(b"field7=") and v.endswith(
        b"1234567")


def test_a_dropped_insert_fails_the_comparison():
    table, served = small_table(), small_table()
    h = 5000
    p = table.partition_of(h)
    start = kv.encode_key(kv.hashkey(h))
    log = [("insert", h, True),
           ("scan", p, start, 20, served.page(p, start, 20))]
    out = judge_mod.judge(table, log)
    assert out["pages_wrong"] == 1 and out["inserts_unseen"] == 10


def test_a_served_expired_row_fails_the_comparison():
    table = small_table()
    live = kv.Table(300, 10, np.zeros((300, 10), dtype=bool), 4, 100)
    p = 0
    start = table.keys[p][0]
    log = [("scan", p, start, 30, live.page(p, start, 30))]
    out = judge_mod.judge(table, log)
    assert out["pages_wrong"] == 1 and out["expired_served"] >= 1


def test_sound_answers_pass_and_an_unanswered_scan_is_held():
    table = small_table()
    p = 2
    start = table.keys[p][3]
    log = [("scan", p, start, 7, table.page(p, start, 7)),
           ("insert", 400, True),
           ("scan", p, start, 7, None)]
    out = judge_mod.judge(table, log)
    assert out == {"pages_wrong": 0, "expired_served": 0,
                   "inserts_unseen": 0, "unanswered": 1}


def test_checks_follow_the_request_kinds():
    assert judge_mod.checks_for(["insert", "scan"]) == [
        "inserts_unseen", "pages_wrong", "expired_served", "unanswered"]


def test_scan_kernel_bound_pins_the_kernel_table():
    # PERF.md's kernel table: 2^20 records, K = 32, sortkey PREFIX 3 B,
    # static, validation: 14.124475 us at 3.35 TB/s
    ms, by = arith.kernel_bound(1 << 20, 32, hash_filter=False,
                                sort_filter=True, now=False, validate=True,
                                pidx_column=False, ops=0.0)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(14.124475, abs=5e-7)


def test_table_bytes_counts_the_now_contract():
    # the merge path's now launch over 1024 records, K = 32, validating:
    # valid 1 + hash_lo 4 + expire_ts 4 a record, one status byte out
    assert arith.table_bytes(1024, 32, hash_filter=False, sort_filter=False,
                             now=True, validate=True,
                             pidx_column=False) == 1024 * 10
