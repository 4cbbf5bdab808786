"""FaultPlan: chaos injection for the REAL TcpTransport.

Parity: the toollet fault_injector (src/runtime/fault_injector.cpp:62-118)
applied to the asio network path — the same per-link drop / delay /
duplicate / partition surface the deterministic SimNetwork exposes
(runtime/sim.py), so a chaos schedule written against the simulator runs
unchanged against real multi-process oneboxes.

Gating: a transport with no plan installed pays one attribute check per
send; an installed plan only acts while the fail-point registry is
enabled (utils/fail_point.py setup/teardown is the cluster-wide chaos
kill-switch), so `FAIL_POINTS.teardown()` ends an injection run without
un-wiring every node. All probabilistic decisions draw from one seeded
RNG per plan — reproducible per process.

Semantics (matching SimNetwork where the wire allows):
- drop: the frame is lost at the SENDER, before the socket — the peer
  sees silence, exactly like simulated loss;
- delay: the sender thread for that peer holds the frame for the extra
  latency; per-link FIFO order is preserved (delays on a link are
  cumulative under sustained load — a bandwidth-shaped pipe, slightly
  harsher than the simulator's pipelined latency);
- duplicate: the frame is written twice back-to-back (TCP cannot
  duplicate on its own; protocols must tolerate redelivery);
- partition: a named node sends nothing and — on its own transport —
  delivers nothing, isolating it in both directions even when only a
  subset of processes installed the plan.

Loopback (self-addressed) messages honor drop/duplicate/partition but
not delay: the in-process inbox has no timing wheel, and a node's
self-messages are control-plane steps the simulator also delivers
promptly.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple

Link = Tuple[Optional[str], Optional[str]]


def link_rule_lookup(table: Dict, src: str, dst: str) -> float:
    """Most-specific link rule wins: (src,dst) > (src,*) > (*,dst) >
    global. Shared by FaultPlan and SimNetwork so the two chaos
    surfaces can never diverge on precedence. Partial wildcards let a
    schedule fault 'everything one node sends' without enumerating
    peers."""
    for key in ((src, dst), (src, None), (None, dst), None):
        v = table.get(key)
        if v is not None:
            return v
    return 0.0


class FaultPlan:
    """Per-link fault schedule for TcpTransport. Keys are (src, dst)
    node names; `None` keys configure the global default, like
    SimNetwork.set_drop/set_delay with no link arguments."""

    def __init__(self, seed: int = 0) -> None:
        self._drop: Dict[Optional[Link], float] = {}
        self._delay: Dict[Optional[Link], float] = {}
        self._dup: Dict[Optional[Link], float] = {}
        self._partitioned: set = set()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()  # send() runs on many threads
        self.dropped = 0
        self.duplicated = 0

    # ---- configuration (SimNetwork-compatible surface) -----------------

    def set_drop(self, prob: float, src: Optional[str] = None,
                 dst: Optional[str] = None) -> None:
        key = None if src is None and dst is None else (src, dst)
        with self._lock:
            if prob <= 0:
                self._drop.pop(key, None)
            else:
                self._drop[key] = prob

    def set_delay(self, extra_s: float, src: Optional[str] = None,
                  dst: Optional[str] = None) -> None:
        key = None if src is None and dst is None else (src, dst)
        with self._lock:
            if extra_s <= 0:
                self._delay.pop(key, None)
            else:
                self._delay[key] = extra_s

    def set_duplicate(self, prob: float, src: Optional[str] = None,
                      dst: Optional[str] = None) -> None:
        key = None if src is None and dst is None else (src, dst)
        with self._lock:
            if prob <= 0:
                self._dup.pop(key, None)
            else:
                self._dup[key] = prob

    def partition(self, addr: str) -> None:
        with self._lock:
            self._partitioned.add(addr)

    def heal(self, addr: str) -> None:
        with self._lock:
            self._partitioned.discard(addr)

    @classmethod
    def from_config(cls, cfg: dict) -> "FaultPlan":
        """Build from a cluster.json-style dict:
        {"seed": 7, "drop": [{"prob": .1, "src": "node0", "dst": null}],
         "delay": [{"extra_s": .02}], "duplicate": [{"prob": .05}],
         "partition": ["node2"]} — how node_main wires chaos into real
        onebox processes without any in-process test hook."""
        plan = cls(seed=int(cfg.get("seed", 0)))
        for d in cfg.get("drop", ()):
            plan.set_drop(float(d["prob"]), d.get("src"), d.get("dst"))
        for d in cfg.get("delay", ()):
            plan.set_delay(float(d["extra_s"]), d.get("src"), d.get("dst"))
        for d in cfg.get("duplicate", ()):
            plan.set_duplicate(float(d["prob"]), d.get("src"),
                               d.get("dst"))
        for name in cfg.get("partition", ()):
            plan.partition(name)
        return plan

    # ---- decisions -----------------------------------------------------

    @property
    def active(self) -> bool:
        from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS

        return FAIL_POINTS.enabled

    def is_partitioned(self, addr: str) -> bool:
        return addr in self._partitioned

    def outbound(self, src: str, dst: str, msg_type: Optional[str] = None
                 ) -> Optional[Tuple[float, int]]:
        """Sender-side verdict for one message: None = drop it;
        otherwise (extra_delay_seconds, copies). Faults apply at the
        sender only, so a plan installed cluster-wide charges each link
        once, not once per endpoint. client_write is exempt from
        DUPLICATION (only): neither the stub nor the 2PC dedups by rid,
        so a duplicated atomic write (incr/cas/cam) would double-apply —
        the exact hazard the client's own lost-reply handling refuses to
        create. Loss and delay stay fair game for writes."""
        with self._lock:
            if src in self._partitioned or dst in self._partitioned:
                self.dropped += 1
                return None
            prob = link_rule_lookup(self._drop, src, dst)
            if prob > 0 and self._rng.random() < prob:
                self.dropped += 1
                return None
            copies = 1
            from pegasus_tpu_torch.rpc.transport import WRITE_REQS

            dup = link_rule_lookup(self._dup, src, dst)
            if dup > 0 and msg_type not in WRITE_REQS \
                    and self._rng.random() < dup:
                copies = 2
                self.duplicated += 1
            return link_rule_lookup(self._delay, src, dst), copies
