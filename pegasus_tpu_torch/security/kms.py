"""At-rest encryption: KMS client + per-server data-key provider.

TPU-native re-design of the reference's KMS-backed encryption
(src/security/kms_client.h, src/replica/kms_key_provider.h): a replica
server fetches/unwraps one data key at boot and every data file is
stream-encrypted with it. The reference delegates the cipher to an
encrypted rocksdb Env (AES-CTR); here the cipher is a seekable
SHAKE-256 counter-mode keystream XOR — pure stdlib (this image has no
crypto package), random-access capable (SST block reads seek), and
vectorized through numpy so file IO stays bulk work.

Integrity note: like the reference's CTR env, the file cipher itself
carries no MAC — the storage formats above it (SST index/frame crc32)
detect corruption. The *wrapped key* IS authenticated: a tampered or
wrong-root unwrap fails loudly rather than decrypting garbage.

The port's copy of the JAX package's security/kms.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
from typing import Optional

import numpy as np

# keystream is generated per fixed-size chunk so any byte offset can be
# served by regenerating only the covering chunks (random-access reads)
CHUNK = 4096
KEY_LEN = 32
NONCE_LEN = 16


def keystream(key: bytes, nonce: bytes, offset: int, length: int) -> bytes:
    """Seekable keystream bytes [offset, offset+length)."""
    if length <= 0:
        return b""
    first = offset // CHUNK
    last = (offset + length - 1) // CHUNK
    parts = []
    base = key + nonce
    for c in range(first, last + 1):
        parts.append(hashlib.shake_256(
            base + c.to_bytes(8, "big")).digest(CHUNK))
    blob = b"".join(parts)
    start = offset - first * CHUNK
    return blob[start:start + length]


def xor_crypt(key: bytes, nonce: bytes, offset: int, data: bytes) -> bytes:
    """Encrypt == decrypt: XOR with the keystream at `offset`."""
    if not data:
        return b""
    ks = keystream(key, nonce, offset, len(data))
    a = np.frombuffer(data, dtype=np.uint8)
    b = np.frombuffer(ks, dtype=np.uint8)
    return (a ^ b).tobytes()


class KmsError(Exception):
    pass


class LocalKmsClient:
    """Envelope KMS backed by a local root key.

    Stands in for the reference's remote KMS HTTP client
    (security/kms_client.h:GenerateEncryptionKey/DecryptEncryptionKey):
    the interface is identical — generate a (plaintext, wrapped) data
    key pair, and unwrap a stored wrapped key — so a real remote KMS can
    replace it without touching any caller.
    """

    def __init__(self, root_key: bytes) -> None:
        if len(root_key) < 16:
            raise KmsError("root key must be at least 16 bytes")
        self._root = hashlib.sha256(b"pegasus-kms-root|" + root_key).digest()

    def generate_data_key(self) -> tuple[bytes, bytes]:
        key = secrets.token_bytes(KEY_LEN)
        return key, self._wrap(key)

    def _wrap(self, key: bytes) -> bytes:
        nonce = secrets.token_bytes(NONCE_LEN)
        ct = xor_crypt(self._root, nonce, 0, key)
        tag = hmac.new(self._root, b"wrap|" + nonce + ct,
                       hashlib.sha256).digest()
        return nonce + ct + tag

    def unwrap(self, wrapped: bytes) -> bytes:
        if len(wrapped) != NONCE_LEN + KEY_LEN + 32:
            raise KmsError("malformed wrapped key")
        nonce = wrapped[:NONCE_LEN]
        ct = wrapped[NONCE_LEN:NONCE_LEN + KEY_LEN]
        tag = wrapped[NONCE_LEN + KEY_LEN:]
        want = hmac.new(self._root, b"wrap|" + nonce + ct,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise KmsError("wrapped key authentication failed "
                           "(tampered file or wrong root key)")
        return xor_crypt(self._root, nonce, 0, ct)


KEY_FILE = ".pegasus_data_key"


def _write_wrapped(path: str, wrapped: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(wrapped)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class KeyProvider:
    """Loads-or-creates the server data key under a data root.

    Parity: replica/kms_key_provider.h — the wrapped key lives next to
    the data it protects; the plaintext key exists only in memory.
    """

    def __init__(self, data_root: str, kms: LocalKmsClient) -> None:
        self.data_root = data_root
        os.makedirs(data_root, exist_ok=True)
        path = os.path.join(data_root, KEY_FILE)
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.data_key = kms.unwrap(f.read())
        else:
            self.data_key, wrapped = kms.generate_data_key()
            _write_wrapped(path, wrapped)

    @classmethod
    def for_dirs(cls, dirs: list, kms: LocalKmsClient) -> "KeyProvider":
        """One provider for a multi-disk server: find the wrapped key in
        ANY of the dirs (so losing or reordering disk 0 cannot orphan
        the other disks' data), then replicate it to every dir."""
        found = None
        for d in dirs:
            if os.path.exists(os.path.join(d, KEY_FILE)):
                found = d
                break
        prov = cls(found if found is not None else dirs[0], kms)
        with open(os.path.join(prov.data_root, KEY_FILE), "rb") as f:
            wrapped = f.read()
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            p = os.path.join(d, KEY_FILE)
            if not os.path.exists(p):
                _write_wrapped(p, wrapped)
        return prov


def root_key_from_env(fallback: Optional[bytes] = None) -> Optional[bytes]:
    """PEGASUS_KMS_ROOT_KEY (hex) > PEGASUS_KMS_ROOT_KEY_FILE > fallback."""
    hexkey = os.environ.get("PEGASUS_KMS_ROOT_KEY")
    if hexkey:
        return bytes.fromhex(hexkey)
    path = os.environ.get("PEGASUS_KMS_ROOT_KEY_FILE")
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return f.read().strip()
    return fallback
