"""Connection auth negotiation state machine.

Parity: src/security/negotiation.h:37 + negotiation_manager — the
SASL-style multi-step handshake every authenticated RPC session runs
before application traffic: LIST_MECHANISMS -> SELECT_MECHANISMS ->
INITIATE -> CHALLENGE/RESPONSE -> SUCC, with any out-of-order message
failing the whole negotiation (negotiation.cpp rejects invalid
transitions outright).

The reference's mechanism is SASL/GSSAPI (Kerberos). This image has no
KDC, so the one registered mechanism is HMAC-SHA256 challenge/response
over the cluster secret: the server issues a fresh nonce and the client
proves possession of the secret with HMAC(secret, user || nonce) —
unlike the static per-request token, the proof is UNREPLAYABLE (a
sniffed proof is useless for any other nonce).

On SUCC the server binds the authenticated identity to the peer's
CONNECTION (the stub keys peers as (src, transport session id) — a
self-reported frame name alone would be forgeable); later requests on
that connection may omit per-request credentials and inherit the
session identity, and the identity dies with the connection (the
reference likewise attaches the negotiated user to the RPC session).
Per-request tokens keep working — negotiation is an upgrade, not a
break.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Dict, Optional, Tuple

MECH_HMAC = "HMAC-SHA256"

# negotiation_status parity (negotiation.h enum): the server enforces
# this exact order per peer; anything else -> FAIL + state reset
_ORDER = ("list_mechanisms", "select", "respond")


def _proof(secret: str, user: str, nonce: bytes) -> str:
    return hmac.new(secret.encode(), user.encode() + nonce,
                    hashlib.sha256).hexdigest()


class NegotiationServer:
    """Per-node server side: one in-flight state machine per peer
    address, plus the table of negotiated identities."""

    def __init__(self, secret: str) -> None:
        self._secret = secret
        # peer -> (stage_reached, user, nonce)
        self._inflight: Dict[str, Tuple[str, str, bytes]] = {}
        self._identities: Dict[str, str] = {}

    def identity(self, peer: str) -> Optional[str]:
        return self._identities.get(peer)

    def on_message(self, peer: str, payload: dict) -> dict:
        """Advance the peer's negotiation; returns the reply payload.
        Any out-of-order or malformed stage FAILS the negotiation and
        clears the peer's state (invalid-transition rejection)."""
        stage = payload.get("stage")
        rid = payload.get("rid")
        st = self._inflight.get(peer)
        if stage == "list_mechanisms":
            # always a legal (re)start; a new handshake voids any
            # previously negotiated identity for this peer
            self._identities.pop(peer, None)
            self._inflight[peer] = ("list_mechanisms", "", b"")
            return {"stage": "mechanisms", "mechanisms": [MECH_HMAC],
                    "rid": rid}
        if stage == "select":
            if st is None or st[0] != "list_mechanisms":
                return self._fail(peer, rid, "select before list")
            if payload.get("mechanism") != MECH_HMAC:
                return self._fail(peer, rid, "unsupported mechanism")
            user = payload.get("user") or ""
            if not user:
                return self._fail(peer, rid, "empty user")
            nonce = os.urandom(16)
            self._inflight[peer] = ("select", user, nonce)
            return {"stage": "challenge", "nonce": nonce, "rid": rid}
        if stage == "respond":
            if st is None or st[0] != "select":
                return self._fail(peer, rid, "respond before challenge")
            _stage, user, nonce = st
            want = _proof(self._secret, user, nonce)
            if not hmac.compare_digest(want,
                                       payload.get("proof") or ""):
                return self._fail(peer, rid, "bad proof")
            self._inflight.pop(peer, None)
            self._identities[peer] = user
            return {"stage": "succ", "user": user, "rid": rid}
        return self._fail(peer, rid, f"unknown stage {stage!r}")

    def _fail(self, peer: str, rid, reason: str) -> dict:
        self._inflight.pop(peer, None)
        self._identities.pop(peer, None)
        return {"stage": "fail", "reason": reason, "rid": rid}

    def forget(self, peer) -> None:
        """Connection teardown: a reconnected peer must renegotiate."""
        self._inflight.pop(peer, None)
        self._identities.pop(peer, None)

    def forget_session(self, sess: str) -> None:
        """Drop every identity/handshake bound to a closed connection
        (peers are keyed (src, session) by the stub)."""
        for d in (self._inflight, self._identities):
            for key in [k for k in d
                        if isinstance(k, tuple) and len(k) == 2
                        and k[1] == sess]:
                d.pop(key, None)


class NegotiationClient:
    """Client side: drives the three steps through a send/await pair.

    `call(dst, payload) -> reply` is the transport adapter (the cluster
    client binds its request plumbing here)."""

    def __init__(self, user: str, secret: str) -> None:
        self.user = user
        self._secret = secret

    def negotiate(self, call) -> bool:
        reply = call({"stage": "list_mechanisms"})
        if (reply.get("stage") != "mechanisms"
                or MECH_HMAC not in reply.get("mechanisms", [])):
            return False
        reply = call({"stage": "select", "mechanism": MECH_HMAC,
                      "user": self.user})
        if reply.get("stage") != "challenge":
            return False
        proof = _proof(self._secret, self.user, reply["nonce"])
        reply = call({"stage": "respond", "proof": proof})
        return reply.get("stage") == "succ"
