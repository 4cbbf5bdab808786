"""Client API (reference: src/include/pegasus/client.h, src/client_lib/)."""

from pegasus_tpu_torch.client.table import Table
from pegasus_tpu_torch.client.client import (
    PegasusClient,
    PegasusScanner,
    ScanOptions,
)

__all__ = ["PegasusClient", "PegasusScanner", "ScanOptions", "Table"]
