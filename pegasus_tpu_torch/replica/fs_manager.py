"""FsManager: multi-data-dir layout, capacity tracking, trash cleanup,
and per-dir health.

Parity: src/common/fs_manager.h:115 (dir_node capacity tracking +
per-disk replica placement + disk_status NORMAL/SPACE_INSUFFICIENT/
IO_ERROR — fs_manager.h:52), src/replica/disk_cleaner.* (removed
replicas rename to trash and age out instead of vanishing instantly),
and src/replica/replica_disk_migrator.h (move a replica between disks).

Health: the stub reports storage OSErrors here (`note_io_error`); a dir
that produced EIO-class failures goes IO_ERROR, ENOSPC goes
SPACE_INSUFFICIENT, and `replica_dir` stops placing NEW replicas on
sick dirs (existing replicas stay until the quarantine/cure machinery
moves them — the reference likewise only excludes sick dir_nodes from
placement, fs_manager.cpp:select_target_dir_node).
"""

from __future__ import annotations

import errno as _errno
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

Gpid = Tuple[int, int]

TRASH_SUFFIX = ".gar"

# per-dir health states (parity: disk_status::type, fs_manager.h:52)
DIR_NORMAL = "NORMAL"
DIR_SPACE_INSUFFICIENT = "SPACE_INSUFFICIENT"
DIR_IO_ERROR = "IO_ERROR"


class FsManager:
    def __init__(self, data_dirs: List[str]) -> None:
        if not data_dirs:
            raise ValueError("need at least one data dir")
        self.data_dirs = [os.path.abspath(d) for d in data_dirs]
        for d in self.data_dirs:
            os.makedirs(d, exist_ok=True)
        self._dir_status: Dict[str, str] = {
            d: DIR_NORMAL for d in self.data_dirs}
        self._dir_errors: Dict[str, int] = {d: 0 for d in self.data_dirs}

    # ---- layout --------------------------------------------------------

    @staticmethod
    def _entry_name(gpid: Gpid) -> str:
        return f"{gpid[0]}.{gpid[1]}"

    def scan_replicas(self) -> Dict[Gpid, str]:
        """gpid -> replica dir, across every data dir (parity: the boot
        scan, replica_stub.cpp:594 load_replicas per disk)."""
        out: Dict[Gpid, str] = {}
        for d in self.data_dirs:
            for entry in sorted(os.listdir(d)):
                if entry.endswith(".migrating"):
                    # crashed mid-migration copy: the source is intact
                    shutil.rmtree(os.path.join(d, entry),
                                  ignore_errors=True)
                    continue
                parts = entry.split(".")
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    out[(int(parts[0]), int(parts[1]))] = os.path.join(
                        d, entry)
        return out

    def dir_of(self, gpid: Gpid) -> Optional[str]:
        for d in self.data_dirs:
            path = os.path.join(d, self._entry_name(gpid))
            if os.path.isdir(path):
                return path
        return None

    def replica_dir(self, gpid: Gpid) -> str:
        """Existing home, or a placement on the least-loaded HEALTHY
        disk (parity: fs_manager picks the dir with most headroom and
        skips non-NORMAL dir_nodes; replica COUNT is the capacity proxy
        here — byte usage shifts with compaction and would make
        placement flappy). When every dir is sick the least-loaded one
        is still returned — refusing placement entirely would wedge
        cures, and the reference degrades the same way."""
        existing = self.dir_of(gpid)
        if existing is not None:
            return existing
        candidates = self.healthy_dirs() or self.data_dirs
        counts = {d: 0 for d in self.data_dirs}
        for _g, path in self.scan_replicas().items():
            counts[os.path.dirname(path)] += 1
        best = min(candidates, key=lambda d: (counts[d], d))
        return os.path.join(best, self._entry_name(gpid))

    # ---- health (parity: fs_manager dir_node status) -------------------

    def healthy_dirs(self) -> List[str]:
        return [d for d in self.data_dirs
                if self._dir_status[d] == DIR_NORMAL]

    def dir_status(self, data_dir: str) -> str:
        return self._dir_status[os.path.abspath(data_dir)]

    def dir_of_path(self, path: str) -> Optional[str]:
        """The managed data dir containing `path` (any depth), or None."""
        p = os.path.abspath(path)
        for d in self.data_dirs:
            if p == d or p.startswith(d + os.sep):
                return d
        return None

    def note_io_error(self, path: str, exc: OSError) -> Optional[str]:
        """Record a storage OSError against the owning dir: ENOSPC
        marks SPACE_INSUFFICIENT, everything else IO_ERROR. Returns the
        dir marked (None when the path is outside every managed dir).
        An IO_ERROR verdict is sticky over SPACE_INSUFFICIENT — a disk
        that both filled and errored is treated as broken."""
        d = self.dir_of_path(path)
        if d is None:
            return None
        self._dir_errors[d] += 1
        status = (DIR_SPACE_INSUFFICIENT
                  if getattr(exc, "errno", None) == _errno.ENOSPC
                  else DIR_IO_ERROR)
        if not (self._dir_status[d] == DIR_IO_ERROR
                and status == DIR_SPACE_INSUFFICIENT):
            self._dir_status[d] = status
        return d

    def mark_dir_normal(self, data_dir: str) -> None:
        """Operator reset (disk replaced / space freed)."""
        self._dir_status[os.path.abspath(data_dir)] = DIR_NORMAL

    def health(self) -> List[dict]:
        """Per-dir state + error counts (shell `disk_health`)."""
        out = []
        for d in self.data_dirs:
            try:
                disk = shutil.disk_usage(d)
                avail = disk.free
            except OSError:
                avail = -1
            out.append({"dir": d, "status": self._dir_status[d],
                        "io_errors": self._dir_errors[d],
                        "disk_available": avail})
        return out

    # ---- capacity ------------------------------------------------------

    def stats(self) -> List[dict]:
        out = []
        for d in self.data_dirs:
            replicas = []
            used = 0
            for entry in sorted(os.listdir(d)):
                path = os.path.join(d, entry)
                if not os.path.isdir(path) or entry.endswith(TRASH_SUFFIX):
                    continue
                parts = entry.split(".")
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    replicas.append(entry)
                    used += _dir_bytes(path)
            disk = shutil.disk_usage(d)
            out.append({"dir": d, "replicas": replicas,
                        "used_bytes": used,
                        "disk_total": disk.total,
                        "disk_available": disk.free})
        return out

    # ---- trash (parity: disk_cleaner — .gar aging) ---------------------

    def trash_replica(self, gpid: Gpid) -> Optional[str]:
        """Removed replicas move to trash (name.<ts>.gar) instead of
        instant deletion — an operator can still recover from a wrong
        GC decision until the cleaner ages it out."""
        path = self.dir_of(gpid)
        if path is None:
            return None
        dest = f"{path}.{int(time.time())}{TRASH_SUFFIX}"
        os.rename(path, dest)
        return dest

    def clean_trash(self, max_age_seconds: float = 86400.0) -> List[str]:
        removed = []
        now = time.time()
        for d in self.data_dirs:
            for entry in os.listdir(d):
                if not entry.endswith(TRASH_SUFFIX):
                    continue
                try:
                    ts = int(entry[:-len(TRASH_SUFFIX)].rsplit(".", 1)[1])
                except (IndexError, ValueError):
                    ts = 0
                if now - ts >= max_age_seconds:
                    shutil.rmtree(os.path.join(d, entry),
                                  ignore_errors=True)
                    removed.append(entry)
        return removed

    # ---- migration (parity: replica_disk_migrator.h) -------------------

    def migrate(self, gpid: Gpid, dest_data_dir: str) -> str:
        """Copy a (closed) replica dir to another disk and retire the
        old copy to trash; caller must have closed the replica first and
        reopens it from the returned path."""
        dest_data_dir = os.path.abspath(dest_data_dir)
        if dest_data_dir not in self.data_dirs:
            raise ValueError(f"{dest_data_dir} is not a managed data dir")
        src = self.dir_of(gpid)
        if src is None:
            raise ValueError(f"replica {gpid} not found")
        if os.path.dirname(src) == dest_data_dir:
            return src
        dest = os.path.join(dest_data_dir, self._entry_name(gpid))
        # copy under a temp name, then rename: a crash mid-copy must not
        # leave a truncated dir with the REPLICA'S name that could shadow
        # the intact source at the next boot scan
        tmp = dest + ".migrating"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(src, tmp)
        os.rename(src, f"{src}.{int(time.time())}{TRASH_SUFFIX}")
        os.rename(tmp, dest)
        return dest


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total
