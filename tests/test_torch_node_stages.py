"""A node process over TCP reports the scan handler's stages through
its `task-profiler` verb: enabled on a replica node, a scan_multi from
the wire client adds the pegasus.* stage rows to the node's dump beside
its message types."""

from __future__ import annotations

import time

from pegasus_tpu_torch.server.types import GetScannerRequest


def test_a_node_process_dumps_its_scan_stages(tmp_path):
    from pegasus_tpu_torch.tools import onebox_cluster as ob

    d = str(tmp_path / "ob")
    ob.start(d, n_replica=1, device="cpu")
    try:
        admin = ob.OneboxAdmin(d)
        deadline = time.monotonic() + 90
        while len(admin.call("list_nodes", timeout=6)) != 1:
            assert time.monotonic() < deadline
            time.sleep(0.5)
        admin.create_table("st", partition_count=4, replica_count=1)
        node = next(n for n, c in admin.cfg["nodes"].items()
                    if c["role"] == "replica")
        c = ob.connect("st", d)
        try:
            for i in range(40):
                assert c.set(b"h%03d" % i, b"s", b"v%d" % i) == 0
            assert admin.remote_command(node, "task-profiler",
                                        ["enable"]) == \
                "task profiler enabled"
            result = c.scan_multi({p: [GetScannerRequest(
                batch_size=100, one_page=True)] for p in range(4)})
            assert sum(len(r.kvs) for rs in result.values()
                       for r in rs) == 40
            rows = {row["code"]: row["count"] for row in
                    admin.remote_command(node, "task-profiler", ["dump"])}
            admin.remote_command(node, "task-profiler", ["disable"])
        finally:
            c.net.close()
        admin.close()
    finally:
        ob.stop(d)
    assert rows["client_scan_multi"] == 1
    # the memtable-only table serves through the merge path
    for code in ("pegasus.stub.gate", "pegasus.scan.plan",
                 "pegasus.merge.read", "pegasus.merge.validate",
                 "pegasus.merge.rows", "pegasus.stub.reply"):
        assert rows.get(code, 0) >= 1, (code, rows)
