"""Replication framework: PacificA consensus (reference: src/replica/)."""

from pegasus_tpu_torch.replica.mutation import Mutation, WriteOp
from pegasus_tpu_torch.replica.prepare_list import PrepareList
from pegasus_tpu_torch.replica.mutation_log import MutationLog
from pegasus_tpu_torch.replica.group_commit import WriteFlushWindow
from pegasus_tpu_torch.replica.replica import (
    PartitionStatus,
    Replica,
    ReplicaBusyError,
    ReplicaConfig,
)
