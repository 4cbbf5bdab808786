"""Security: client auth, connection negotiation, and at-rest encryption's
KMS client and data-key provider."""
from pegasus_tpu_torch.security.auth import make_credentials, sign, verify

__all__ = ["make_credentials", "sign", "verify"]
