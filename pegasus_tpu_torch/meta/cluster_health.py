"""ClusterHealth: the meta-side view of every node's watchdog.

Each node's HealthEngine ships a compact digest (status + firing rules)
and its new typed events on the EXISTING config-sync report; this
machine folds them into per-node and per-table status
(ok/degraded/critical) plus one bounded cluster-wide event journal —
the `shell health` / `shell timeline` surfaces and the collector's
`_health`/`_alerts` stat rows all read from here.

Flap damping, meta side: a node's cluster-visible status WORSENS
immediately (degradation is urgent) but only IMPROVES after
`IMPROVE_REPORTS` consecutive calmer reports — a node oscillating at a
rule boundary shows one steady degraded state, not a strobe. A node
that stops reporting entirely goes `stale` after `STALE_S` (its last
digest may be arbitrarily old; the failure detector owns dead-node
truth, this just refuses to claim health it cannot see).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from pegasus_tpu_torch.utils.health import worse

IMPROVE_REPORTS = 2
STALE_S = 60.0
JOURNAL_CAP = 1024


class ClusterHealth:
    def __init__(self, meta) -> None:
        self.meta = meta
        # node -> {"status", "firing", "candidate", "candidate_n",
        #          "at", "ring_bytes", "events_total", "dropped"}
        self._nodes: Dict[str, dict] = {}
        self.journal: "deque[dict]" = deque()

    # ---- ingest (config-sync) ------------------------------------------

    def on_report(self, node: str, payload: dict) -> Optional[int]:
        """Fold one node's health block; returns the high-water event
        seq to ack on the reply (None = no health block). Nodes re-ship
        unacked events, so the journal dedupes by seq."""
        health = payload.get("health")
        if not isinstance(health, dict):
            return None
        now = self.meta.clock()
        st = self._nodes.setdefault(node, {
            "status": "ok", "firing": [], "candidate": "ok",
            "candidate_n": 0, "at": now, "ring_bytes": 0,
            "events_total": 0, "dropped": 0, "last_seq": 0})
        reported = health.get("status", "ok")
        # damped fold: worse wins now; better must repeat
        if worse(reported, st["status"]) == reported \
                and reported != st["status"]:
            st["status"] = reported
            st["candidate"], st["candidate_n"] = reported, 0
        elif reported != st["status"]:
            if reported == st["candidate"]:
                st["candidate_n"] += 1
            else:
                st["candidate"], st["candidate_n"] = reported, 1
            if st["candidate_n"] >= IMPROVE_REPORTS:
                st["status"] = reported
                st["candidate_n"] = 0
        else:
            st["candidate"], st["candidate_n"] = reported, 0
        st["firing"] = list(health.get("firing") or [])
        st["at"] = now
        st["ring_bytes"] = int(health.get("ring_bytes") or 0)
        st["events_total"] = int(health.get("events_total") or 0)
        st["dropped"] += int(health.get("dropped") or 0)
        last_seq = st.setdefault("last_seq", 0)
        hw = int(health.get("seq_hw") or 0)
        if hw < last_seq:
            # the node's seq moved backward: its process restarted with
            # a fresh engine — reset the dedupe cursor or every event
            # it fires post-restart would be silently skipped and acked
            last_seq = 0
        for ev in health.get("events") or []:
            seq = int(ev.get("seq") or 0)
            if seq and seq <= last_seq:
                continue  # re-shipped (reply lost): already journaled
            last_seq = max(last_seq, seq)
            self.journal.append(dict(ev, node=node))
        st["last_seq"] = last_seq
        while len(self.journal) > JOURNAL_CAP:
            self.journal.popleft()
        return last_seq

    # ---- derived views --------------------------------------------------

    def _table_status(self, now: float) -> Dict[str, dict]:
        """Per-table fold: a firing rule on a replica entity ("app.pidx")
        or a duplication entity marks that table through its app id.
        Stale nodes are skipped — their frozen firing list must not
        assert table health this meta can no longer see."""
        tables: Dict[str, dict] = {}
        for node, st in self._nodes.items():
            if now - st["at"] > STALE_S:
                continue
            for f in st["firing"]:
                etype, eid = f.get("entity", (None, None))
                app_id = None
                if etype == "replica":
                    app_id = eid.split(".")[0]
                elif etype == "duplication":
                    # node.app.pidx.dupN ids carry the app in slot 2
                    parts = eid.split(".")
                    if len(parts) >= 2:
                        app_id = parts[1]
                if app_id is None:
                    continue
                t = tables.setdefault(app_id, {"status": "ok",
                                               "firing": []})
                t["status"] = worse(t["status"], f.get("severity", "ok"))
                t["firing"].append(dict(f, node=node))
        return tables

    def status(self) -> dict:
        """The `shell health` surface: per-node + per-table status and
        the cluster-wide worst."""
        now = self.meta.clock()
        nodes = {}
        cluster = "ok"
        for node, st in sorted(self._nodes.items()):
            stale = now - st["at"] > STALE_S
            nodes[node] = {
                "status": "stale" if stale else st["status"],
                "firing": st["firing"],
                "ring_bytes": st["ring_bytes"],
                "events_total": st["events_total"],
                "report_age_s": round(now - st["at"], 1),
            }
            if not stale:
                cluster = worse(cluster, st["status"])
        tables = self._table_status(now)
        for t in tables.values():
            cluster = worse(cluster, t["status"])
        return {"cluster": cluster, "nodes": nodes, "tables": tables}

    def events(self, node: Optional[str] = None,
               table: Optional[str] = None,
               since: Optional[float] = None,
               limit: int = 128) -> List[dict]:
        """Cluster journal slice (the `shell timeline` ledger): filter
        by reporting node, by table (replica/duplication entities of
        that app id), and/or by start time."""
        out = []
        for ev in self.journal:
            if node is not None and ev.get("node") != node:
                continue
            if since is not None and ev.get("ts", 0.0) < since:
                continue
            if table is not None:
                etype, eid = ev.get("entity", (None, ""))
                parts = (eid or "").split(".")
                app = (parts[0] if etype == "replica"
                       else parts[1] if etype == "duplication"
                       and len(parts) >= 2 else None)
                if app != str(table):
                    continue
            out.append(ev)
        return out[-limit:]
