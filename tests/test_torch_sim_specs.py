"""The JAX package's SimCluster test files run on the port, on the CPU.

- tests/test_model_fuzz.py, tests/test_follower_reads.py (its onebox
  case runs in test_torch_chaos.py), tests/test_meta_election.py,
  tests/test_elasticity.py, tests/test_geo.py and
  tests/test_redis_proxy.py, through `load_spec`: the JAX package's
  test text with its imports rewritten and every SimCluster, table and
  engine asking for the CPU.
"""

import pytest

from torch_mesh_helpers import load_spec, restore_process_state

SPEC = (load_spec("test_model_fuzz.py", globals(), "fuzz_spec")
        + load_spec("test_follower_reads.py", globals(), "follower_spec",
                    keep=lambda name: "onebox" not in name)
        + load_spec("test_meta_election.py", globals(), "election_spec")
        + load_spec("test_elasticity.py", globals(), "elasticity_spec")
        + load_spec("test_geo.py", globals(), "geo_spec")
        + load_spec("test_redis_proxy.py", globals(), "redis_spec"))


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


def test_every_spec_case_was_taken():
    assert len(SPEC) == 56, SPEC
