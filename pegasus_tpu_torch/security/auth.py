"""Authentication + table ACLs.

Parity role: src/security/negotiation.h:37 (the RPC-connection auth
negotiation — SASL/Kerberos there; a shared-secret HMAC here, since
this environment has no KDC) and the Ranger-style per-table allow-list
(src/ranger/ranger_resource_policy_manager.h:67, enforced at the
replica's client gates like replica_2pc.cpp:117 / replica.cpp:388).

Model: the cluster holds one secret. A client identity is
(user, HMAC(secret, user)); servers verify the token and then check the
table's `replica.allowed_users` app-env (empty / absent = open table).
Inter-node traffic authenticates as the reserved NODE_USER.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple

NODE_USER = "__node__"


def sign(user: str, secret: str) -> str:
    return hmac.new(secret.encode(), user.encode(),
                    hashlib.sha256).hexdigest()


def verify(user: str, token: str, secret: str) -> bool:
    return hmac.compare_digest(sign(user, secret), token)


def make_credentials(user: str, secret: str) -> Tuple[str, str]:
    return user, sign(user, secret)


# per-verb access classes (parity: src/ranger/access_type.h — READ /
# WRITE / and the control-plane classes collapsed to "a" here; meta
# admin verbs run under the operator identity)
ACCESS_READ = "r"
ACCESS_WRITE = "w"
ACCESS_ADMIN = "a"


def parse_policy(policy: str) -> dict:
    """`replica.access_policy` app-env: "alice=rw;bob=r;*=r" ->
    {user: set-of-access-chars}. "*" is the any-authenticated-user
    entry. Malformed segments are ignored (a typo must not open the
    table)."""
    out = {}
    for seg in policy.split(";"):
        seg = seg.strip()
        if not seg or "=" not in seg:
            continue
        user, grants = seg.split("=", 1)
        out[user.strip()] = {c for c in grants.strip()
                             if c in (ACCESS_READ, ACCESS_WRITE,
                                      ACCESS_ADMIN)}
    return out


def check_client(auth: Optional[tuple], secret: Optional[str],
                 allowed_users: str = "", policy: str = "",
                 access: str = "") -> bool:
    """The gate servers run per request: authentication (when the
    cluster has a secret), then the per-verb access policy, then the
    legacy table allow-list.

    `allowed_users`: comma-separated env value; empty = every
    authenticated user (parity: tables without ranger policies are
    governed by legacy allowed-user lists; empty list = open).

    `policy` + `access`: the Ranger-style per-verb layer
    (access_type.h) — when the table carries a `replica.access_policy`
    env, the request's access class ("r"/"w"/"a") must be granted to
    the user (or to "*"); inter-node traffic (NODE_USER) is exempt, as
    the reference exempts intra-cluster RPCs."""
    if secret:
        if not auth:
            return False
        user, token = auth[0], auth[1]
        if not verify(user, token, secret):
            return False
    else:
        user = auth[0] if auth else ""
    if policy and access and user != NODE_USER:
        grants = parse_policy(policy)
        g = grants.get(user, grants.get("*"))
        if g is None or access not in g:
            return False
    if allowed_users:
        allowed = {u.strip() for u in allowed_users.split(",") if u.strip()}
        return user in allowed or user == NODE_USER
    return True
