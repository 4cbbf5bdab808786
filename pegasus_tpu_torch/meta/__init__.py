"""Meta server: cluster control plane (reference: src/meta/)."""

from pegasus_tpu_torch.meta.meta_storage import MetaStorage
from pegasus_tpu_torch.meta.failure_detector import FailureDetector
from pegasus_tpu_torch.meta.server_state import AppState, PartitionConfig, ServerState
from pegasus_tpu_torch.meta.meta_service import MetaService
