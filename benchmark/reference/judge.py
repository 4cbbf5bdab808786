"""Judge a run's answers against the plain reference, in request order.

The log is what the benchmark sent and what came back, in the order the
client saw the replies:
- ("scan", pidx, start_key, limit, rows): rows [(key, value)] or None
  when the call failed;
- ("insert", h, acked): a new record h written through multi_set.

Every number returned is a count of faults, and each has the limit 0.
"""

from __future__ import annotations

from .kv import Table

# the numbers a kind of request is judged by
CHECKS = {
    "scan": ("pages_wrong", "expired_served", "inserts_unseen"),
    "insert": ("inserts_unseen",),
}


def checks_for(kinds) -> list:
    """The judged numbers of a traffic of these request kinds, in order."""
    out = []
    for kind in kinds:
        for name in CHECKS[kind]:
            if name not in out:
                out.append(name)
    return out + ["unanswered"]


def judge(table: Table, log: list) -> dict:
    """{number: faults} over every request of `log`."""
    out = dict.fromkeys(("pages_wrong", "expired_served", "inserts_unseen",
                         "unanswered"), 0)
    inserted: set = set()
    for ev in log:
        kind = ev[0]
        if kind == "insert":
            _kind, h, acked = ev
            if acked:
                table.insert(h)
                inserted.add(h)
            else:
                out["unanswered"] += 1
        elif kind == "scan":
            _kind, pidx, start, limit, rows = ev
            if rows is None:
                out["unanswered"] += 1
                continue
            want = table.page(pidx, start, limit)
            if rows != want:
                out["pages_wrong"] += 1
                got = {k for k, _v in rows}
                out["expired_served"] += sum(
                    table.is_expired_key(k) for k in got)
                out["inserts_unseen"] += sum(
                    1 for k, _v in want
                    if k not in got and _hashkey_number(k) in inserted)
        else:
            raise ValueError(f"unknown request kind {kind!r}")
    return out


def _hashkey_number(key: bytes) -> int:
    hlen = int.from_bytes(key[:2], "big")
    try:
        return int(key[6:2 + hlen])
    except ValueError:
        return -1
