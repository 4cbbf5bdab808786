"""Host runtime: deterministic simulation + async scheduling.

Parity: the reference's rDSN tool layer — `nativerun` vs `simulator`
(src/runtime/simulator.h:63, env.sim.h:36): the same service code can run
under a deterministic single-process scheduler with a simulated network
(drop/delay injectable, src/rpc/network.sim.h:86). This package provides
that seam for the replication layer: the SAME replica state machines run
under the in-proc direct transport in production paths and under
`SimLoop`/`SimNetwork` for seeded, reproducible whole-cluster tests.
"""

from pegasus_tpu_torch.runtime.sim import SimLoop, SimNetwork
