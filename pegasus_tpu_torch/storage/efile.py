"""Transparent at-rest encryption for data files.

The storage layers (sstable, mutation_log, file_transfer) open every
data file through `open_data_file()`. When the file's path falls under
a registered encryption zone (enabled per data root at server boot —
the analogue of the reference swapping in an encrypted rocksdb Env
under FLAGS_encrypt_data_at_rest), writes go through a seekable
XOR-keystream cipher (security/kms.py) and reads sniff the header:

    [8B magic "PEGSENC1"][16B nonce][8B reserved]   = 32-byte header

Files without the magic are served as plaintext even inside a zone, so
a cluster can turn encryption on and still read its pre-existing data;
every file written after that is encrypted (parity with the reference's
mixed-env migration story, common/fs_utils encrypt-on-rewrite).

The port's copy of the JAX package's storage/efile.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from pegasus_tpu_torch.security.kms import KeyProvider, xor_crypt

MAGIC = b"PEGSENC1"
HEADER = 32

_zones: Dict[str, KeyProvider] = {}


def enable_encryption(data_root: str, provider: KeyProvider) -> None:
    _zones[os.path.abspath(data_root)] = provider


def disable_encryption(data_root: str) -> None:
    _zones.pop(os.path.abspath(data_root), None)


def zone_for(path: str) -> Optional[KeyProvider]:
    if not _zones:  # fast path: feature off, zero overhead
        return None
    p = os.path.abspath(path)
    for root, prov in _zones.items():
        if p.startswith(root + os.sep) or p == root:
            return prov
    return None


class CipherFile:
    """File-like XOR-stream view over an encrypted file.

    Logical offsets exclude the 32-byte header. Supports the exact
    surface the storage layer uses: read/write/seek/tell/truncate/
    flush/fileno/close and context management. Reads are random-access
    (the keystream is seekable). Writes must only ever extend the
    file: rewriting bytes at a previously-written offset would reuse
    that offset's keystream (two-time pad) — crash repair goes through
    repair_truncate(), which rewrites under a fresh nonce instead.
    """

    def __init__(self, f, key: bytes, nonce: bytes) -> None:
        self._f = f
        self._key = key
        self._nonce = nonce

    # -- positioning (logical <-> physical is a fixed +HEADER shift)
    def seek(self, off: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            return self._f.seek(off + HEADER) - HEADER
        if whence == os.SEEK_END:
            return self._f.seek(off, os.SEEK_END) - HEADER
        return self._f.seek(off, whence) - HEADER

    def tell(self) -> int:
        return self._f.tell() - HEADER

    # -- data
    def read(self, n: int = -1) -> bytes:
        pos = self.tell()
        raw = self._f.read(n)
        return xor_crypt(self._key, self._nonce, pos, raw)

    def write(self, data: bytes) -> int:
        pos = self.tell()
        self._f.write(xor_crypt(self._key, self._nonce, pos, data))
        return len(data)

    def truncate(self, size: Optional[int] = None) -> int:
        if size is None:
            return self._f.truncate() - HEADER
        return self._f.truncate(size + HEADER) - HEADER

    # -- passthrough
    def flush(self) -> None:
        self._f.flush()

    def fileno(self) -> int:
        return self._f.fileno()

    def close(self) -> None:
        self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def __enter__(self) -> "CipherFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_data_file(path: str, mode: str = "rb"):
    """Drop-in replacement for open() on data files.

    Outside any encryption zone this IS open(). Inside a zone:
    - new writes ("wb", "ab" on a missing/empty file) get a fresh
      nonce + header and encrypt;
    - existing files are sniffed — encrypted ones are wrapped,
      legacy plaintext ones pass through untouched.
    """
    prov = zone_for(path)
    if prov is None:
        return open(path, mode)
    key = prov.data_key
    if mode == "wb":
        f = open(path, "wb")
        nonce = os.urandom(16)
        f.write(MAGIC + nonce + b"\0" * (HEADER - len(MAGIC) - 16))
        return CipherFile(f, key, nonce)
    if mode == "ab":
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size == 0:
            f = open(path, "wb")
            nonce = os.urandom(16)
            f.write(MAGIC + nonce + b"\0" * (HEADER - len(MAGIC) - 16))
            return CipherFile(f, key, nonce)
        nonce = _sniff(path)
        if nonce is None:
            return open(path, mode)  # legacy plaintext log: keep appending
        # "ab" pins every write to EOF regardless of seek, which would
        # desync the position-keyed stream if the header read moved the
        # cursor; r+b positioned at EOF has identical append semantics
        f = open(path, "r+b")
        f.seek(0, os.SEEK_END)
        return CipherFile(f, key, nonce)
    if mode in ("rb", "r+b"):
        nonce = _sniff(path)
        if nonce is None:
            return open(path, mode)
        f = open(path, mode)
        f.seek(HEADER)
        return CipherFile(f, key, nonce)
    raise ValueError(f"unsupported data-file mode {mode!r}")


def _sniff(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            hdr = f.read(HEADER)
    except OSError:
        return None
    if len(hdr) == HEADER and hdr[:len(MAGIC)] == MAGIC:
        return hdr[len(MAGIC):len(MAGIC) + 16]
    return None


def is_encrypted(path: str) -> bool:
    return _sniff(path) is not None


def logical_size(path: str) -> int:
    """Plaintext byte count of a data file (physical minus the cipher
    header when encrypted) — what a reader of open_data_file() will
    actually serve. File-transfer metadata must use THIS, not
    os.path.getsize, or receivers wait for header bytes that the
    decrypting reader never yields."""
    size = os.path.getsize(path)
    return size - HEADER if _sniff(path) is not None else size


def repair_truncate(path: str, valid_end: int) -> None:
    """Crash-repair a framed log: keep logical bytes [0, valid_end).

    Plaintext files are truncated in place. Encrypted files are
    REWRITTEN to a temp file under a fresh nonce and renamed over —
    truncating and then appending at the same logical offsets with the
    original nonce would emit two ciphertexts under one keystream
    position (a two-time pad), letting anyone holding a pre-crash copy
    XOR out the plaintext."""
    if _sniff(path) is None:
        with open(path, "r+b") as f:
            f.truncate(valid_end)
        return
    with open_data_file(path, "rb") as f:
        keep = f.read(valid_end)
    tmp = path + ".repair.tmp"
    with open_data_file(tmp, "wb") as f:
        f.write(keep)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def copy_data_tree(src_dir: str, dst_dir: str) -> None:
    """Copy a data directory decrypt-at-source / re-encrypt-at-dest.

    A raw byte copy (shutil.copytree) of encrypted files is only valid
    when source and destination share a data key; a shared-fs learn
    copies the PRIMARY's checkpoint into the LEARNER's zone, and each
    server has its own key. Reading through open_data_file and writing
    through it again makes the copy key-correct in every combination
    (plain->plain, plain->encrypted, encrypted->re-encrypted)."""
    os.makedirs(dst_dir, exist_ok=True)
    for base, dirs, files in os.walk(src_dir):
        rel = os.path.relpath(base, src_dir)
        out_base = (dst_dir if rel == os.curdir
                    else os.path.join(dst_dir, rel))
        for d in dirs:
            os.makedirs(os.path.join(out_base, d), exist_ok=True)
        for name in files:
            src = os.path.join(base, name)
            if _sniff(src) is not None and zone_for(src) is None:
                # an encrypted file we hold no key for: copying it (raw
                # OR re-encrypted) can only produce garbage at the
                # destination — fail here with the real cause instead
                raise RuntimeError(
                    f"{src} is encrypted but no key is registered for "
                    "its path; cross-server shared-fs copies need the "
                    "transfer path (which re-encrypts), not a file copy")
            with open_data_file(src, "rb") as fin:
                data = fin.read()
            with open_data_file(os.path.join(out_base, name), "wb") as fout:
                fout.write(data)
                fout.flush()
                os.fsync(fout.fileno())
