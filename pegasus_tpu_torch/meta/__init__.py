"""Meta server: cluster control plane (reference: src/meta/).

The port holds the meta store and the partition configuration so far;
the failure detector and the meta service come with the stub.
"""

from pegasus_tpu_torch.meta.meta_storage import MetaStorage
from pegasus_tpu_torch.meta.server_state import AppState, PartitionConfig, ServerState
