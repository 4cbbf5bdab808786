"""Cluster-level compaction coordinator: the meta half of the
background-I/O scheduler.

A cluster where every node starts its env-triggered manual compaction
in the same config-sync round (the trigger env reaches everyone
together) compacts EVERYWHERE at once — every replica of every
partition loses its disk bandwidth simultaneously, which is exactly
when quorum reads have nowhere healthy to go. The coordinator
staggers the heavy runs: nodes report compaction demand on the
EXISTING config-sync channel (the PR 6 signal-channel pattern —
`{running, waiting, bytes_per_s}` rides the same payload as the
elasticity load signals), and the reply carries a leased boolean
grant. At most `compaction_concurrent_nodes` nodes hold a grant at a
time; holders are preferred while they still report running work (a
revoked mid-run compaction saves nothing — the IO is already spent),
waiters are admitted in report order as slots free, and a holder that
stops reporting (dead node) ages out after the lease.

Failure posture is deliberately soft: the node side fails OPEN (no
coordinator answer, or an expired lease, means "run") — the stagger
is a bandwidth optimization, and a meta outage must never wedge
compaction cluster-wide.
"""

from __future__ import annotations

from typing import Dict, Optional

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.meta", "compaction_concurrent_nodes", 1,
            "how many nodes may run heavy (env-triggered) manual "
            "compactions concurrently; 0 = no stagger (every node "
            "granted)", mutable=True)
define_flag("pegasus.meta", "compaction_grant_lease_s", 30.0,
            "seconds a grant survives without the holder reporting "
            "demand (running or waiting) on config-sync", mutable=True)


class CompactionCoordinator:
    """One per MetaService; leader-only (followers drop config_sync)."""

    def __init__(self, meta) -> None:
        self.meta = meta
        # node -> latest report {running, waiting, bytes_per_s, at}
        self._reports: Dict[str, dict] = {}
        # node -> grant issue time (the live grant set)
        self._grants: Dict[str, float] = {}
        # waiters in first-seen order (dict preserves insertion)
        self._queue: Dict[str, float] = {}
        ent = METRICS.entity("meta", meta.name)
        self._g_granted = ent.gauge("compact_grant_nodes")
        self._c_grants = ent.counter("compact_grant_count")

    # ---- intake (rides _on_config_sync) --------------------------------

    def on_report(self, node: str, payload: dict) -> Optional[bool]:
        """Record the node's compaction block and answer its grant for
        this round, or None when the node reported no compaction block
        (an older node — say nothing rather than gate it)."""
        comp = payload.get("compaction")
        if comp is None:
            return None
        now = self.meta.clock()
        running = int(comp.get("running", 0))
        waiting = bool(comp.get("waiting"))
        self._reports[node] = {"running": running, "waiting": waiting,
                               "bytes_per_s":
                                   int(comp.get("bytes_per_s", 0)),
                               "at": now}
        if waiting or running:
            self._queue.setdefault(node, now)
        else:
            self._queue.pop(node, None)
        lease = float(FLAGS.get("pegasus.meta",
                                "compaction_grant_lease_s"))
        granted_at = self._grants.get(node)
        if granted_at is not None and not running \
                and now - granted_at > lease / 3:
            # a holder that is NOT running releases its slot — whether
            # it finished (no demand left) or it still reports waiting
            # (it had its turn; more demand means the BACK of the
            # queue, or rotation never advances — in-process sim nodes
            # even share the governor's waiting flag, so camping here
            # livelocks every other node's heavy compactions). The
            # lease/3 grace covers the delivery race: the grant rides
            # the NEXT reply to this node, so its first report after
            # being granted predates it ever seeing the slot — a
            # graceless release would pass the grant around the ring
            # forever with no reply ever saying yes.
            self._grants.pop(node, None)
            if node in self._queue:
                del self._queue[node]
                self._queue[node] = now  # re-queue at the tail
        self._admit(now)
        k = int(FLAGS.get("pegasus.meta", "compaction_concurrent_nodes"))
        if k <= 0:
            return True  # stagger off: everyone may run
        return node in self._grants

    def _admit(self, now: float) -> None:
        lease = float(FLAGS.get("pegasus.meta",
                                "compaction_grant_lease_s"))
        k = int(FLAGS.get("pegasus.meta", "compaction_concurrent_nodes"))
        # expire grants whose holder went silent (dead node / dropped
        # channel): a slot must never leak
        for node in list(self._grants):
            rep = self._reports.get(node)
            if rep is None or now - rep["at"] > lease:
                del self._grants[node]
        # age out reports of nodes that stopped reporting entirely
        # (removed/replaced hosts): a long-lived meta must not grow a
        # dict entry per node ever seen, and `compact_sched` must not
        # dump dead nodes forever
        for node in list(self._reports):
            if now - self._reports[node]["at"] > 10 * lease:
                del self._reports[node]
                self._queue.pop(node, None)
        if k <= 0:
            self._g_granted.set(len(self._grants))
            return
        # admit waiters in first-seen order while slots are free
        for node in list(self._queue):
            if len(self._grants) >= k:
                break
            if node in self._grants:
                continue
            rep = self._reports.get(node)
            if rep is None or now - rep["at"] > lease:
                self._queue.pop(node, None)
                continue
            self._grants[node] = now
            self._c_grants.increment()
        self._g_granted.set(len(self._grants))

    # ---- observability --------------------------------------------------

    def status(self) -> dict:
        return {
            "granted": sorted(self._grants),
            "waiting": [n for n in self._queue
                        if n not in self._grants],
            "reports": {n: dict(r)
                        for n, r in sorted(self._reports.items())},
            "concurrent_limit": int(FLAGS.get(
                "pegasus.meta", "compaction_concurrent_nodes")),
        }
