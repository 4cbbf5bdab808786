"""Meta group: lease-based leader election + replicated meta storage.

Parity: the reference elects its meta leader through a distributed lock
and keeps cluster state in a replicated store (meta_service.cpp:384-401
elect via ZK lock; meta_state_service_zookeeper.h:50), with followers
forwarding every request to the leader (check_leader,
meta_service.h:304). Without an external ZooKeeper, the meta GROUP
provides both itself:

- Election: term-numbered vote rounds. A follower whose leader lease
  expires becomes a candidate, increments its term, and asks every peer
  for a vote; a peer grants iff the term is new AND the candidate's
  storage sequence is at least its own (the up-to-date gate). A majority
  of the full group elects. The leader heartbeats {term, seq}; any
  message with a newer term demotes.
- Storage replication: every leader-side storage mutation gets a
  sequence number and fans out to followers, which apply it to their
  local stores. A follower that detects a gap (heartbeat seq ahead of
  its own) pulls a full snapshot — meta state is small, so snapshot
  catch-up beats log reconciliation in complexity. The vote gate then
  guarantees the next leader has the most complete state among any
  electing majority.

Window semantics: an update acked to a client but not yet replicated
when the leader dies can be lost (the reference accepts the analogous
window only because ZK persists first). The cluster self-heals: replica
config-sync reports carry ballots, and the new leader adopts any
reported config whose ballot is ahead of its own state — the replicas
are the recovery source of truth (parity: `recover` from replica list,
shell commands.h:209).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from pegasus_tpu_torch.meta.meta_storage import MetaStorage

LEASE_SECONDS = 8.0
HEARTBEAT_EVERY = 2.0


class ReplicatedMetaStorage(MetaStorage):
    """MetaStorage that notifies a replication hook on every mutation.
    The hook fires ONLY for locally-originated writes (the leader's);
    follower-applied updates go through `apply_replicated`."""

    def __init__(self, path: str) -> None:
        super().__init__(path)
        self.seq = int(self._tree.get("/__meta_seq", 0))
        # the TERM whose leader wrote the latest mutation: freshness is
        # (state_term, seq) lexicographic, so a deposed leader that kept
        # writing (inflating seq under its OLD term) can never outrank
        # state written under a newer term
        self.state_term = int(self._tree.get("/__meta_term", 0))
        self.term_source: Callable[[], int] = lambda: 0
        self.on_mutate: Optional[Callable[[Dict[str, Any]], None]] = None

    @property
    def version(self):
        return (self.state_term, self.seq)

    def _bump(self, updates: Dict[str, Any]) -> Dict[str, Any]:
        self.seq += 1
        self.state_term = self.term_source()
        updates = dict(updates)
        updates["/__meta_seq"] = self.seq
        updates["/__meta_term"] = self.state_term
        return updates

    def set(self, node: str, value: Any) -> None:
        self.set_batch({node: value})

    def set_batch(self, updates: Dict[str, Any]) -> None:
        updates = self._bump(updates)
        super().set_batch(updates)
        if self.on_mutate is not None:
            self.on_mutate(updates)

    def delete(self, node: str) -> None:
        # deletions replicate as explicit tombstone lists inside a batch
        keys = [k for k in self._tree
                if k == node or k.startswith(node + "/")]
        for k in keys:
            self._tree.pop(k, None)
        self.seq += 1
        self.state_term = self.term_source()
        self._tree["/__meta_seq"] = self.seq
        self._tree["/__meta_term"] = self.state_term
        self._persist()
        if self.on_mutate is not None:
            self.on_mutate({"/__meta_seq": self.seq,
                            "/__meta_term": self.state_term,
                            "/__tombstones": keys})

    def apply_replicated(self, seq: int, updates: Dict[str, Any]) -> None:
        """Follower-side apply (no re-replication). Caller has already
        gap-checked seq."""
        tombs = updates.pop("/__tombstones", None)
        if tombs:
            for k in tombs:
                self._tree.pop(k, None)
            updates = {k: v for k, v in updates.items() if v is not None}
        self._tree.update(updates)
        self.seq = max(self.seq, seq)
        self.state_term = int(updates.get("/__meta_term",
                                          self.state_term))
        self._tree["/__meta_seq"] = self.seq
        self._persist()

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._tree)

    def load_snapshot(self, tree: Dict[str, Any]) -> None:
        self._tree = dict(tree)
        self.seq = int(self._tree.get("/__meta_seq", 0))
        self.state_term = int(self._tree.get("/__meta_term", 0))
        self._persist()


class MetaElection:
    """Election + replication sidecar for one MetaService instance."""

    def __init__(self, meta, peers: List[str],
                 storage: ReplicatedMetaStorage) -> None:
        self.meta = meta
        self.peers = [p for p in peers if p != meta.name]
        self.group = sorted(set(peers) | {meta.name})
        self.storage = storage
        self.term = 0
        self.voted_term = 0
        self.is_leader = len(self.peers) == 0  # single-meta: always lead
        self._peer_contact: Dict[str, float] = {}
        self._prevotes: Optional[set] = None
        self.leader: Optional[str] = meta.name if self.is_leader else None
        # boot counts as a heartbeat: with -inf every member would
        # campaign on its FIRST tick simultaneously and split the vote;
        # the staggered delays only order timers measured from a common
        # reference point
        self._last_heartbeat = meta.clock()
        self._last_sent_hb = float("-inf")
        self._votes: set = set()
        # staggered election timeouts break split-vote livelock the way
        # Raft's randomized timeouts do, but DETERMINISTICALLY (the sim
        # must replay from its seed). The per-index stagger must exceed
        # the slowest tick interval (SimCluster ticks each 3s) or two
        # timers cross within one tick and split the vote; 2 heartbeats
        # (4s) clears it, so the lowest-indexed live member campaigns
        # alone and wins before the next member's timer fires
        self._election_delay = (LEASE_SECONDS
                                + self.group.index(meta.name)
                                * 2 * HEARTBEAT_EVERY)
        storage.term_source = lambda: self.term
        storage.on_mutate = self._replicate

    # ---- leader-side ---------------------------------------------------

    def _replicate(self, updates: Dict[str, Any]) -> None:
        if not self.is_leader:
            return
        for peer in self.peers:
            self.meta.net.send(self.meta.name, peer, "meta_replicate", {
                "term": self.term, "seq": self.storage.seq,
                "updates": updates})

    def _send_heartbeats(self, now: float) -> None:
        if now - self._last_sent_hb < HEARTBEAT_EVERY:
            return
        self._last_sent_hb = now
        for peer in self.peers:
            self.meta.net.send(self.meta.name, peer, "meta_heartbeat", {
                "term": self.term,
                "version": list(self.storage.version)})

    # ---- follower/candidate side ---------------------------------------

    def _refuses_depose(self, src: str, now: float) -> bool:
        """Live evidence the cluster already has a working leader, so
        this member should neither grant (pre-)votes nor campaign:
        - as LEADER: fresh ack contact with a majority (check-quorum —
          a seated leader must not help a flaky-linked member assemble
          a deposing majority);
        - as follower: a fresh lease from a leader other than `src`
          (the leader itself re-campaigning is never refused)."""
        if self.is_leader:
            fresh = 1 + sum(1 for t in self._peer_contact.values()
                            if now - t <= LEASE_SECONDS
                            - HEARTBEAT_EVERY)
            return fresh * 2 > len(self.group)
        return (self.leader is not None
                and self.leader != self.meta.name
                and src != self.leader
                and now - self._last_heartbeat <= LEASE_SECONDS)

    def _start_prevote(self) -> None:
        """Raft-style pre-vote: ask whether a majority WOULD grant a
        vote at term+1 before touching self.term. An isolated member
        (e.g. one-way link loss from the leader) fails the pre-vote and
        never inflates its term — so it cannot force the healthy
        majority to adopt a higher term, silence their heartbeat acks,
        and dethrone a leader they can still reach; and after the link
        heals, its un-inflated term lets the leader's heartbeats
        reintegrate it immediately."""
        self._prevotes = {self.meta.name}
        # we campaign because the lease EXPIRED — drop the leader
        # binding now, or tick()'s re-arm of _last_heartbeat would make
        # the dead leader look fresh to our own _refuses_depose and we
        # would discard every prevote ack; a real heartbeat re-binds it
        # and cancels this round
        self.leader = None
        for peer in self.peers:
            self.meta.net.send(self.meta.name, peer, "meta_prevote_req", {
                "term": self.term + 1,
                "version": list(self.storage.version)})

    def _start_election(self) -> None:
        self.term += 1
        self.voted_term = self.term  # vote for self
        self._votes = {self.meta.name}
        self.is_leader = False
        self.leader = None
        for peer in self.peers:
            self.meta.net.send(self.meta.name, peer, "meta_vote_req", {
                "term": self.term,
                "version": list(self.storage.version)})
        self._maybe_win()

    def _maybe_win(self) -> None:
        if len(self._votes) * 2 > len(self.group):
            self.is_leader = True
            self.leader = self.meta.name
            self._peer_contact = {p: self.meta.clock()
                                  for p in self._votes
                                  if p != self.meta.name}
            self._last_sent_hb = float("-inf")
            self._send_heartbeats(self.meta.clock())
            # a fresh leader re-learns worker liveness before curing:
            # without this, the guardian would treat every worker as dead
            self.meta.on_leadership_acquired()

    # ---- message handlers (wired from MetaService.on_message) ----------

    def on_message(self, src: str, msg_type: str, payload: dict) -> bool:
        """Returns True if the message was an election-internal one."""
        if msg_type == "meta_heartbeat":
            if payload["term"] >= self.term:
                if payload["term"] > self.term or self.is_leader:
                    self._step_down(payload["term"])
                self.leader = src
                self._last_heartbeat = self.meta.clock()
                self._prevotes = None  # live leader: cancel any prevote
                # the ack is the leader's lease evidence: without it a
                # partitioned leader would keep is_leader forever and
                # serve stale leader-only reads (split-brain)
                self.meta.net.send(self.meta.name, src,
                                   "meta_heartbeat_ack",
                                   {"term": payload["term"]})
                if tuple(payload["version"]) > self.storage.version:
                    self.meta.net.send(self.meta.name, src,
                                       "meta_fetch_state", {})
            return True
        if msg_type == "meta_heartbeat_ack":
            if self.is_leader and payload["term"] == self.term:
                self._peer_contact[src] = self.meta.clock()
            return True
        if msg_type == "meta_replicate":
            if payload["term"] >= self.term:
                if payload["seq"] > self.storage.seq + 1:
                    # a replicated update was lost: applying past the gap
                    # would silently fork state while seq ties defeat
                    # every later freshness check — pull a full snapshot
                    self.meta.net.send(self.meta.name, src,
                                       "meta_fetch_state", {})
                elif payload["seq"] == self.storage.seq + 1:
                    self.storage.apply_replicated(payload["seq"],
                                                  dict(payload["updates"]))
                    self.meta.reload_state()
                # seq <= ours: stale duplicate, ignore
            return True
        if msg_type == "meta_prevote_req":
            if (payload["term"] > self.voted_term
                    and not self._refuses_depose(src, self.meta.clock())
                    and tuple(payload["version"])
                    >= self.storage.version):
                # NO state change: a pre-vote promises nothing
                self.meta.net.send(self.meta.name, src,
                                   "meta_prevote_ack",
                                   {"term": payload["term"]})
            return True
        if msg_type == "meta_prevote_ack":
            if (not self.is_leader
                    and payload["term"] == self.term + 1
                    and self._prevotes is not None
                    # a heartbeat may have landed between our prevote
                    # and this (possibly jitter-delayed) ack — a fresh
                    # leader cancels the round
                    and not self._refuses_depose("", self.meta.clock())):
                self._prevotes.add(src)
                if len(self._prevotes) * 2 > len(self.group):
                    self._prevotes = None  # one real campaign per round
                    self._start_election()
            return True
        if msg_type == "meta_vote_req":
            if payload["term"] > self.term:
                # ALWAYS adopt a higher term, granted or not — otherwise
                # a stale-state member campaigning faster permanently
                # outruns everyone else's term and no leader ever wins
                self._step_down(payload["term"])
            # lease-sticky voting / check-quorum: while we hold live
            # evidence of a working leader we refuse to elect anyone
            # else — otherwise a node that merely lost its INBOUND link
            # from the leader can win a majority while the leader
            # (still acked by the rest) keeps its lease: split brain
            grant = (payload["term"] > self.voted_term
                     and not self._refuses_depose(src,
                                                  self.meta.clock())
                     and tuple(payload["version"])
                     >= self.storage.version)
            if grant:
                self.voted_term = payload["term"]
                self.meta.net.send(self.meta.name, src, "meta_vote_ack", {
                    "term": payload["term"]})
            return True
        if msg_type == "meta_vote_ack":
            if (not self.is_leader and payload["term"] == self.term
                    and self.voted_term == self.term):
                self._votes.add(src)
                self._maybe_win()
            return True
        if msg_type == "meta_fetch_state":
            if self.is_leader:
                self.meta.net.send(self.meta.name, src,
                                   "meta_state_snapshot", {
                                       "term": self.term,
                                       "seq": self.storage.seq,
                                       "tree": self.storage.snapshot()})
            return True
        if msg_type == "meta_state_snapshot":
            if payload["term"] >= self.term and not self.is_leader:
                self.storage.load_snapshot(dict(payload["tree"]))
                self.meta.reload_state()
            return True
        return False

    def _step_down(self, term: int) -> None:
        self.term = term
        self.is_leader = False

    # ---- timer ---------------------------------------------------------

    def tick(self) -> None:
        if not self.peers:
            return  # single-meta
        now = self.meta.clock()
        if self.is_leader:
            self._send_heartbeats(now)
            # margin of one heartbeat below the followers' minimum
            # election delay: the leader must demote strictly BEFORE
            # any follower can start a winning campaign, even with the
            # ack's one-way delay anchoring our clock later than theirs
            fresh = 1 + sum(1 for t in self._peer_contact.values()
                            if now - t <= LEASE_SECONDS
                            - HEARTBEAT_EVERY)
            if fresh * 2 <= len(self.group):
                # contact lost with a majority: the lease can no longer
                # be presumed held — demote BEFORE a newly elected peer
                # and this node answer leader-only requests differently
                self.is_leader = False
                self.leader = None
                self._last_heartbeat = now  # full (staggered) delay
        elif now - self._last_heartbeat > self._election_delay:
            # re-arm before campaigning so a failed round retries after
            # another full (still staggered) delay, not every tick
            self._last_heartbeat = now
            self._start_prevote()

    def forward_to_leader(self, src: str, msg_type: str,
                          payload: dict) -> bool:
        """Follower-side request forwarding (parity: check_leader →
        forward, meta_service.h:304). The original request is WRAPPED —
        spoofing the original src would make a TCP leader bind the
        requester's name to the follower's connection, blackholing the
        leader's replies to the real requester."""
        if self.is_leader:
            return False
        if self.leader is not None and self.leader != self.meta.name:
            self.meta.net.send(self.meta.name, self.leader,
                               "meta_forward", {
                                   "src": src, "msg_type": msg_type,
                                   "payload": payload})
        return True
