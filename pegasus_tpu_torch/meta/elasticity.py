"""Elasticity controller: the detect→decide→act closed loop.

Parity: the pieces the reference ships separately — the collector's
hotspot_partition_calculator (detect), meta_split_service and
greedy_load_balancer (act), and the operator who connects them — closed
into one meta-side loop on the guardian timer:

- **detect** — per-partition load signals flow node→meta on the
  EXISTING config-sync report channel: each stored-replica entry a node
  reports for a partition it leads carries the partition's cumulative
  capacity units (server/capacity_units.py) and the HotkeyCollector's
  published result; the node additionally reports its foreground
  pressure counters (deadline_expired_count + read_shed_count — the
  PR 2 shed/deadline machinery) and fence rejects.
- **decide** — z-score outlier over per-partition CU rates
  (server/hotkey.hotspot_partition_indices — the same statistic the
  reference's hotspot calculator applies to partition QPS). A flagged
  partition first gets hotkey detection STARTED on its primary (the
  `detect_hotkey` message); what comes back splits the diagnosis:
  a DOMINANT hashkey means the heat is one key — a split cannot shed
  it (a hashkey never spans partitions), so the cure is a load-driven
  primary move off the hot node; diffuse heat (detection window passes
  with no dominant key) or sustained whole-table overload is
  capacity-shaped — the cure is a SPLIT doubling the partition count.
- **act** — split via MetaSplitService.start_partition_split (which
  refuses on unhealthy/quarantined partitions and on pending balancer
  moves), rebalance via MetaService.rebalance (which skips apps with an
  in-flight split). Actions are PACED: at most one per act interval,
  and whenever any node's pressure counters grew since the last look
  the controller backs off exponentially instead of acting —
  background elasticity must never pile data movement onto a cluster
  already shedding foreground work.

Metrics (meta entity): partition_split_inflight (gauge),
balance_proposal_count, elasticity_split_count, elasticity_move_count,
elasticity_backoff_count. The `hot_partitions` admin/shell verb dumps
the signals and the controller's state, so an operator sees exactly
what the loop sees.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from pegasus_tpu_torch.server.hotkey import hotspot_partition_indices
from pegasus_tpu_torch.utils.errors import PegasusError
from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

Gpid = Tuple[int, int]

define_flag("pegasus.meta", "elasticity_act_interval_s", 15.0,
            "minimum seconds between elasticity actions (split or "
            "load-driven move); pressure backoff multiplies this",
            mutable=True)
define_flag("pegasus.meta", "elasticity_split_cu_rate", 2000.0,
            "sustained per-partition capacity-unit rate (CU/s averaged "
            "over the whole table) above which the table is considered "
            "oversized and split",
            mutable=True)
define_flag("pegasus.meta", "elasticity_detect_grace_s", 10.0,
            "seconds a started hotkey detection may run before diffuse "
            "heat is concluded (and a split considered)",
            mutable=True)


class ElasticityController:
    """One per MetaService; leader-only tick (the guardian timer)."""

    HOT_ZSCORE = 3.0
    MAX_BACKOFF = 16

    def __init__(self, meta) -> None:
        self.meta = meta
        ent = METRICS.entity("meta", meta.name)
        self._split_inflight = ent.gauge("partition_split_inflight")
        self._proposal_count = ent.counter("balance_proposal_count")
        self._split_count = ent.counter("elasticity_split_count")
        self._move_count = ent.counter("elasticity_move_count")
        self._backoff_count = ent.counter("elasticity_backoff_count")
        # gpid -> latest primary-reported load sample:
        # {node, read_cu, write_cu, hot_key, hot_state, at}
        self._reports: Dict[Gpid, dict] = {}
        # gpid -> (node, cu_total, at) of the previous sample (rate
        # basis; the node matters — two nodes' cumulative counters
        # are unrelated, so a failover must re-base, not diff)
        self._last_cu: Dict[Gpid, Tuple[str, int, float]] = {}
        # gpid -> smoothed CU/s rate
        self.rates: Dict[Gpid, float] = {}
        # gpid -> latest UNsmoothed CU/s rate (episode-end signal)
        self._inst: Dict[Gpid, float] = {}
        # node -> latest cumulative pressure count (shed + expired)
        self._pressure: Dict[str, int] = {}
        self._pressure_seen = 0
        self._backoff = 1
        self._next_act = 0.0
        # gpid -> sim-time a hotkey detection was commanded
        self._detect_started: Dict[Gpid, float] = {}
        self.last_action: Optional[dict] = None

    # ---- detect: node→meta report intake ------------------------------

    def on_report(self, node: str, payload: dict) -> None:
        """Config-sync intake (the existing report channel): pick up the
        per-partition load samples and the node pressure counters."""
        pressure = payload.get("pressure")
        if pressure:
            self._pressure[node] = int(pressure.get("deadline_expired", 0)
                                       + pressure.get("read_shed", 0))
        for entry in payload.get("stored", []):
            load = entry.get("load")
            if not load:
                continue
            gpid = tuple(entry["gpid"])
            self._reports[gpid] = {
                "node": node,
                "read_cu": int(load.get("read_cu", 0)),
                "write_cu": int(load.get("write_cu", 0)),
                "hot_key": load.get("hot_key"),
                "hot_state": load.get("hot_state"),
                "at": float(load.get("at", 0.0)),
            }

    def _update_rates(self) -> None:
        for gpid, rep in self._reports.items():
            total = rep["read_cu"] + rep["write_cu"]
            prev = self._last_cu.get(gpid)
            self._last_cu[gpid] = (rep["node"], total, rep["at"])
            if prev is None:
                continue
            prev_node, prev_total, prev_at = prev
            if prev_node != rep["node"]:
                continue  # leadership moved: diffing the new node's
                # counter against the old node's would manufacture a
                # huge phantom rate (or clamp a real one to zero) —
                # re-base and wait for the next same-node sample
            dt = rep["at"] - prev_at
            if dt <= 0:
                continue  # same sample re-reported; keep the old rate
            inst = max(0.0, (total - prev_total) / dt)
            self._inst[gpid] = inst
            old = self.rates.get(gpid)
            # light smoothing: one noisy interval must not trigger a
            # split, one quiet one must not un-flag a real hotspot
            self.rates[gpid] = (inst if old is None
                                else 0.5 * old + 0.5 * inst)

    def node_load(self) -> Dict[str, float]:
        """node -> summed CU/s over the partitions it leads."""
        out: Dict[str, float] = {}
        for gpid, rate in self.rates.items():
            rep = self._reports.get(gpid)
            if rep is not None:
                out[rep["node"]] = out.get(rep["node"], 0.0) + rate
        return out

    # ---- decide + act --------------------------------------------------

    def tick(self, act: bool = True) -> None:
        """`act=False` (steady level): keep the signal pipeline and
        metrics warm for `hot_partitions`, but never split or move —
        acting is the lively level's contract, like auto-balance."""
        meta = self.meta
        self._split_inflight.set(len(meta.split._splits))
        apps = meta.list_apps()
        # drop signal state for gpids that no longer exist (dropped
        # table, admin split flip): a frozen hot rate would otherwise
        # haunt node_load() forever and skew every move decision
        live = {(a.app_id, p) for a in apps
                for p in range(a.partition_count)}
        for d in (self._reports, self._last_cu, self.rates,
                  self._inst, self._detect_started):
            for gpid in [g for g in d if g not in live]:
                del d[gpid]
        self._update_rates()
        if not act:
            return
        now = meta.clock()
        interval = float(FLAGS.get("pegasus.meta",
                                   "elasticity_act_interval_s"))
        # foreground-pressure gate: if shed/deadline counters grew since
        # the last look, the cluster is fighting for its life — back off
        # instead of adding split/learn traffic
        pressure_now = sum(self._pressure.values())
        if pressure_now > self._pressure_seen:
            self._pressure_seen = pressure_now
            self._backoff = min(self._backoff * 2, self.MAX_BACKOFF)
            self._backoff_count.increment()
            self._next_act = max(self._next_act,
                                 now + interval * self._backoff)
            return
        self._pressure_seen = pressure_now
        if self._backoff > 1:
            self._backoff -= 1
        if now < self._next_act:
            return
        for app in apps:
            if app.app_id in meta.split._splits:
                continue  # the in-flight split IS the elasticity action
            action = self._decide(app, now)
            if action is None:
                continue
            if self._act(app, action, now):
                self._next_act = now + interval * self._backoff
                return  # one action per interval, cluster-wide
            # guarded off: a refusal is not an action — keep scanning
            # so one perpetually-refused app can't starve the rest

    def _decide(self, app, now: float) -> Optional[dict]:
        rates = [self.rates.get((app.app_id, p), 0.0)
                 for p in range(app.partition_count)]
        if not any(rates):
            return None
        split_rate = float(FLAGS.get("pegasus.meta",
                                     "elasticity_split_cu_rate"))
        hot = hotspot_partition_indices(rates, self.HOT_ZSCORE)
        # a detection window belongs to ONE flag episode, and the
        # episode ends on the INSTANTANEOUS rate: a z-score over the
        # smoothed rates can never un-flag a lone outlier (z saturates
        # at sqrt(n-1) however small the gap), so judging "cooled" on
        # the smoothed signal would let a stale stamp survive the quiet
        # weeks and instantly conclude "diffuse" — splitting unprovoked
        # — the moment the partition re-flags
        inst = [self._inst.get((app.app_id, p), 0.0)
                for p in range(app.partition_count)]
        inst_hot = set(hotspot_partition_indices(inst, self.HOT_ZSCORE))
        live = {(app.app_id, p) for p in hot if p in inst_hot}
        for gpid in [g for g in self._detect_started
                     if g[0] == app.app_id and g not in live]:
            del self._detect_started[gpid]
        if hot:
            pidx = max(hot, key=lambda p: rates[p])
            gpid = (app.app_id, pidx)
            if pidx not in inst_hot:
                # smoothed memory of a cooling partition: no new
                # episode, no action — let the rate decay
                return None
            rep = self._reports.get(gpid) or {}
            if rep.get("hot_key"):
                # one dominant hashkey: a split cannot shed it (the key
                # stays whole in one partition) — move the load instead
                return {"kind": "move", "gpid": gpid,
                        "hot_key": rep["hot_key"]}
            started = self._detect_started.get(gpid)
            grace = float(FLAGS.get("pegasus.meta",
                                    "elasticity_detect_grace_s"))
            if started is None:
                # detect: command the two-phase hotkey detection on the
                # partition's primary and wait for its verdict; no
                # alive primary to command -> no window, retry next tick
                if self._start_detection(gpid):
                    self._detect_started[gpid] = now
                return None
            if now - started < grace:
                # detector sampling; re-send each tick (a no-op on a
                # running collector) so a lost command or a failed-over
                # primary still gets a detector under the window
                self._start_detection(gpid)
                return None
            if not self._detection_ran(rep):
                # grace elapsed but no collector ever sampled (command
                # lost, or the primary died and its successor reports
                # fresh stopped collectors): concluding "diffuse" here
                # would split on zero evidence — restart the window
                if self._start_detection(gpid):
                    self._detect_started[gpid] = now
                return None
            # diffuse heat: many keys share the load — capacity-shaped,
            # a split halves every key range
            return {"kind": "split", "reason": "diffuse_hotspot",
                    "gpid": gpid}
        avg = sum(rates) / len(rates)
        if avg >= split_rate:
            return {"kind": "split", "reason": "oversized", "avg": avg}
        return None

    def _act(self, app, action: dict, now: float) -> bool:
        meta = self.meta
        record = dict(action, app=app.app_name, at=now)
        try:
            if action["kind"] == "split":
                new_count = meta.split.start_partition_split(app.app_name)
                record["new_count"] = new_count
                self._split_count.increment()
                self._split_inflight.set(len(meta.split._splits))
                # the count flip re-keys every (app_id, pidx) signal;
                # stale pre-split rates must not double-trigger
                self._forget_app(app.app_id)
            else:
                moved = self._move_hot_primary(action["gpid"])
                record["moved_to"] = moved
                if moved:
                    self._move_count.increment()
                # the verdict is consumed: re-arm detection (restart
                # clears the collector's FINISHED result) so the NEXT
                # episode must re-prove a dominant key — a stale verdict
                # must never pin this partition to "move" forever while
                # later heat is actually diffuse and needs a split
                if self._start_detection(action["gpid"]):
                    self._detect_started[action["gpid"]] = now
        except PegasusError as e:
            # guarded off (unhealthy partition, pending balancer move,
            # concurrent split): record it; tick scans the next app
            record["refused"] = str(e)
            self.last_action = record
            return False
        self.last_action = record
        return True

    @staticmethod
    def _detection_ran(rep: dict) -> bool:
        """True when the latest primary report shows a hotkey collector
        actually sampling — evidence the detect command landed. Reports
        without the hot_state block (older nodes) are trusted."""
        hs = rep.get("hot_state")
        if hs is None:
            return True
        return any(v != "stopped" for v in hs.values())

    def _move_hot_primary(self, gpid: Gpid) -> Optional[str]:
        """Load-driven primary move: hand the hot partition's
        leadership to its coolest alive secondary (zero-copy — the
        balancer's move_primary shape, chosen by CU load instead of
        counts)."""
        meta = self.meta
        pc = meta.state.get_partition(*gpid)
        loads = self.node_load()
        here = loads.get(pc.primary, 0.0)
        candidates = [s for s in pc.secondaries if meta.fd.is_alive(s)]
        if not candidates:
            return None
        target = min(candidates, key=lambda n: loads.get(n, 0.0))
        # the move only helps if the target stays cooler than the
        # source was WITH the partition's own load on board — otherwise
        # the partition remains the outlier on its new node and the
        # next interval moves it straight back (ballot-bumping
        # ping-pong that never reduces heat)
        rate = self.rates.get(gpid, 0.0)
        if loads.get(target, 0.0) + rate >= here:
            return None
        meta._move_primary(gpid, target)
        self._proposal_count.increment()
        return target

    def _start_detection(self, gpid: Gpid) -> bool:
        pc = self.meta.state.get_partition(*gpid)
        if not pc.primary:
            return False
        self.meta.net.send(self.meta.name, pc.primary,
                           "detect_hotkey", {"gpid": gpid})
        return True

    def _forget_app(self, app_id: int) -> None:
        for d in (self._reports, self._last_cu, self.rates,
                  self._inst, self._detect_started):
            for gpid in [g for g in d if g[0] == app_id]:
                del d[gpid]

    # ---- observability (the hot_partitions verb) -----------------------

    def status(self, app_name: str = "") -> dict:
        meta = self.meta
        apps = meta.list_apps()
        if app_name:
            apps = [a for a in apps if a.app_name == app_name]
        partitions = []
        for app in apps:
            for pidx in range(app.partition_count):
                gpid = (app.app_id, pidx)
                rep = self._reports.get(gpid) or {}
                hk = rep.get("hot_key")
                partitions.append({
                    "app": app.app_name, "gpid": list(gpid),
                    "primary": meta.state.get_partition(*gpid).primary,
                    "cu_rate": round(self.rates.get(gpid, 0.0), 1),
                    "read_cu": rep.get("read_cu", 0),
                    "write_cu": rep.get("write_cu", 0),
                    "hot_key": (hk.decode(errors="replace")
                                if isinstance(hk, (bytes, bytearray))
                                else hk),
                    "splitting": app.app_id in meta.split._splits,
                })
        partitions.sort(key=lambda p: -p["cu_rate"])
        return {
            "partitions": partitions,
            "node_load": {n: round(v, 1)
                          for n, v in sorted(self.node_load().items())},
            "splits_inflight": sorted(meta.split._splits),
            "pressure": dict(self._pressure),
            "backoff": self._backoff,
            "last_action": self.last_action,
        }
