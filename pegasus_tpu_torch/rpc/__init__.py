"""Wire/wal codecs and (later) the DCN RPC stack (reference: src/rpc/)."""

from pegasus_tpu_torch.rpc.codec import (
    OP_CAM,
    OP_CAS,
    OP_INCR,
    OP_MULTI_PUT,
    OP_MULTI_REMOVE,
    OP_PUT,
    OP_REMOVE,
    decode_write,
    encode_write,
)
