"""Partition parallelism for multi-partition batch work on the card."""

from pegasus_tpu_torch.parallel.partition_mesh import (
    PartitionMesh,
    make_mesh,
    sharded_scan_step,
)

# mesh_resident (the resident serving layer) is imported lazily by its
# call sites: importing this package stays cheap for callers that only
# want the mesh shapes.
