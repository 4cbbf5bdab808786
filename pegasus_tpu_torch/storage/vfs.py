"""The storage layers' single door to the disk.

Every durable data file (SSTables, the WAL) opens, syncs and repairs
through here. Plaintext files only: at-rest encryption and disk-fault
injection of the JAX package's vfs are not part of the port yet.
"""

from __future__ import annotations

import os


def open_data_file(path: str, mode: str = "rb"):
    return open(path, mode)


def fsync_file(f) -> None:
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Directory-entry durability after a rename."""
    dir_fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def repair_truncate(path: str, valid_end: int) -> None:
    """Crash-repair a framed log: keep bytes [0, valid_end)."""
    with open(path, "r+b") as f:
        f.truncate(valid_end)
