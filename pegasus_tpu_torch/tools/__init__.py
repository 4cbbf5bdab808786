"""Operational tools: onebox cluster, interactive shell (reference:
src/shell/, run.sh onebox, admin-cli/)."""

from pegasus_tpu_torch.tools.onebox import Onebox
