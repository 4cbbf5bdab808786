"""Chaos against the port's process onebox, on the CPU.

Through `load_spec` (node processes started with `device="cpu"`):
- tests/test_chaos.py and tests/test_scale.py: the cases not marked
  slow run in tier 1 (the seeded TCP fault plan in every node process,
  the client's typed deadlines, the zipfian workload, the WAN twin on a
  SimCluster); the slow soaks come along with their mark;
- tests/test_cross_cluster_dup.py's wire case: two oneboxes over TCP,
  A duplicating to B;
- the onebox cases of tests/test_integrity.py (the kill test's corrupt
  mode) and tests/test_follower_reads.py (kill -9 chaos under
  MONOTONIC ledger reads), both marked slow by the reference.
"""

import pytest

from torch_mesh_helpers import load_spec, restore_process_state

SPEC = (load_spec("test_chaos.py", globals(), "chaos_spec")
        + load_spec("test_scale.py", globals(), "scale_spec")
        + load_spec("test_cross_cluster_dup.py", globals(), "xdup_spec",
                    keep=lambda name: "onebox" in name)
        + load_spec("test_integrity.py", globals(), "integrity_spec",
                    keep=lambda name: "onebox" in name)
        + load_spec("test_follower_reads.py", globals(), "follower_spec",
                    keep=lambda name: "onebox" in name))


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


def test_every_spec_case_was_taken():
    assert len(SPEC) == 13, SPEC
