"""Stand-ins for the meta services of ROADMAP slice 6(b)(4).

The reference's `MetaService` builds its backup, bulk-load and
duplication services unconditionally (`meta/meta_service.py:88-100`),
loads their state at start and on every leadership change, and ticks
them on every leader tick. Their bodies need `server/backup`,
`server/bulk_load`, `storage/block_service` and the duplication
pipeline, which the port does not have yet. Each class below takes the
place of one of them:

- its `__init__` and its load method read the same storage keys as the
  reference's service, and raise `ServiceNotPortedError` if any of them
  holds state (a store written by a cluster that ran the service);
- its `tick` does what the reference's does on empty state: nothing
  (the backup stand-in also leaves `meta.pending_restores` alone, as
  `drive_restores` does when nothing is pending, and raises if a
  restore is pending);
- every admin verb and every message that reaches it raises
  `ServiceNotPortedError` before any state changes.

The two hooks the meta calls on every report or rename with no state
behind them (`MetaDuplicationService.on_report`,
`MetaBackupService.on_app_renamed`) do nothing, as the reference's do
when no duplication or policy exists.
"""

from __future__ import annotations

from typing import Tuple

SLICE = "ROADMAP slice 6(b)(4)"


class ServiceNotPortedError(NotImplementedError):
    """A backup, restore, bulk-load or duplication path reached the port,
    which has no block service, backup engine, bulk load or duplication
    pipeline yet (ROADMAP slice 6(b)(4))."""


def not_ported(what: str) -> ServiceNotPortedError:
    return ServiceNotPortedError(f"{what} is not ported ({SLICE})")


class _StandIn:
    """Shared body: the storage keys a service persists, checked empty."""

    NAME = ""
    KEYS: Tuple[str, ...] = ()
    # the reference service's admin verbs and message handlers
    VERBS: Tuple[str, ...] = ()

    def __init__(self, meta) -> None:
        self.meta = meta
        self._check_empty()

    def _check_empty(self) -> None:
        st = self.meta.state._storage
        for key in self.KEYS:
            if st.get(key):
                raise not_ported(
                    f"{self.NAME}: meta storage key {key} holds state; "
                    f"the service")

    def tick(self) -> None:
        """The reference's tick on empty state does nothing."""

    def __getattr__(self, name: str):
        if name not in self.VERBS:
            raise AttributeError(name)

        def refuse(*_args, **_kwargs):
            raise not_ported(f"{self.NAME}.{name}")

        return refuse


class MetaBackupService(_StandIn):
    """Stand-in for `meta/backup_service.MetaBackupService`."""

    NAME = "meta backup service"
    KEYS = ("/backup/policies", "/backup/inflight", "/backup/completed")
    VERBS = ("add_policy", "list_policies", "query_policy", "modify_policy",
             "enable_policy", "start_backup", "backup_status",
             "on_backup_partition_done", "create_app_from_backup",
             "on_restore_partition_done")

    def _load(self) -> None:
        self._check_empty()

    def on_app_renamed(self, old_name: str, new_name: str) -> None:
        """No policy exists, so no policy covers either name."""

    def drive_restores(self) -> None:
        if self.meta.pending_restores:
            raise not_ported("restoring a table from a backup")

    def tick(self) -> None:
        self.drive_restores()


class MetaBulkLoadService(_StandIn):
    """Stand-in for `meta/bulk_load_service.MetaBulkLoadService`."""

    NAME = "meta bulk-load service"
    KEYS = ("/bulk_load/inflight", "/bulk_load/failed")
    VERBS = ("start_bulk_load", "bulk_load_status", "pause_bulk_load",
             "restart_bulk_load", "cancel_bulk_load", "clear_bulk_load",
             "on_ingest_done")

    def _load_state(self) -> None:
        self._check_empty()


class MetaDuplicationService(_StandIn):
    """Stand-in for `meta/duplication_service.MetaDuplicationService`."""

    NAME = "meta duplication service"
    KEYS = ("/duplication/dups", "/duplication/failover")
    VERBS = ("add_duplication", "on_admin_reply", "list_all",
             "query_duplication", "remove_duplication", "pause_duplication",
             "resume_duplication", "set_fail_mode", "on_duplication_sync",
             "dup_stats", "start_failover", "failover_status",
             "on_flip_reply")

    def _load(self) -> None:
        self._check_empty()

    def on_report(self, node: str, payload: dict) -> None:
        """The reference keeps only entries of duplications it owns, and
        this meta owns none."""
