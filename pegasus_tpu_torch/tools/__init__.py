"""Operational tools (reference: `pegasus_tpu/tools/`): the simulated
cluster (`cluster.SimCluster`) and the kill test's data verifier
(`kill_test.DataVerifier`). The onebox cluster and the shell are slice
6(c) of the port."""
