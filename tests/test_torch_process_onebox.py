"""The port's multi-process onebox over TCP (server/node_main.py,
tools/onebox_cluster.py, tools/kill_test.py), on the CPU.

The onebox cases of tests/test_transport.py run on the port through
`load_spec`: 1 meta and 3 replica processes of
`pegasus_tpu_torch.server.node_main` (every one started with
`device="cpu"`), DDL and data through the wire clients, a kill -9 and
the meta's cure; the kill test's random kill -9s under continuous
verification; acked writes racing an env-triggered compaction. Then a
bulk load into 64 partitions x 3 replicas of node processes, which the
JAX package's meta let stall (a re-ack storm; ROADMAP §3).
"""

import time

import pytest

from torch_mesh_helpers import load_spec, restore_process_state

SPEC = load_spec("test_transport.py", globals(), "transport_spec",
                 keep=lambda name: name in (
                     "test_multiprocess_onebox",
                     "test_kill_test_harness_short",
                     "test_no_write_loss_during_env_compaction"))


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


def test_every_spec_case_was_taken():
    assert len(SPEC) == 3, SPEC


def test_bulk_load_of_64_partitions_over_tcp(tmp_path):
    """A bulk load into 64 partitions x 3 replicas of node processes
    completes while the meta keeps answering. The meta re-sends
    trigger_ingest at every tick and every drive, and an ingested
    primary re-acks each; the JAX package's meta drove its window again
    on every re-ack, so on real timers the re-acks multiplied until its
    inbox stalled (ROADMAP §3). The port drops a duplicate ack."""
    import numpy as np

    from pegasus_tpu_torch.server.bulk_load import SSTGenerator
    from pegasus_tpu_torch.storage.block_service import LocalBlockService
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    d = str(tmp_path / "ob")
    ob.start(d, n_replica=3, device="cpu")
    try:
        admin = ob.OneboxAdmin(d)
        deadline = time.monotonic() + 90
        while len(admin.call("list_nodes", timeout=6)) != 3:
            assert time.monotonic() < deadline
            time.sleep(0.5)
        root = str(tmp_path / "stage")
        rng = np.random.default_rng(3)
        SSTGenerator(LocalBlockService(root), "bl", 64).generate(
            [(b"h%05d" % i, b"s", b"v%d" % int(rng.integers(1000)), 0)
             for i in range(2000)])
        admin.create_table("bl", partition_count=64, replica_count=3)
        admin.call("start_bulk_load", app_name="bl", root=root)
        deadline = time.monotonic() + 90
        while not admin.call("bulk_load_status", app_name="bl",
                             timeout=6)["complete"]:
            assert time.monotonic() < deadline, "bulk load stalled"
            time.sleep(0.5)
        c = ob.connect("bl", d)
        try:
            assert c.sortkey_count(b"h00007") == (0, 1)
        finally:
            c.net.close()
        admin.close()
    finally:
        ob.stop(d)
