"""The bytes of one compaction-filter launch: the yardstick of
`compaction_filter_roofline`, frozen here so that a change to the
program cannot move it.

Copied from chip_smoke.py (compaction_bound): every input byte a launch
needs read once and every output byte written once.
"""

from __future__ import annotations


def filter_bytes(rows: int, k: int, *, keys: bool, hash_lo: bool,
                 pidx_col: bool, pack: bool, want_ets: bool,
                 slots: int = 0) -> int:
    """The bytes one launch over `rows` rows moves: valid 1 B and
    expire_ts 4 B a row; the key row k B and key_len 4 B where a pattern
    rule or the key hash reads them; hash_lo and a pidx column 4 B each
    where read; the slot gate's pidx (4 B) and allowed (1 B) once a slot
    of `slots`; out the drop mask (1/8 B packed, else 1 B) and ets2 4 B
    when asked."""
    per = 5 + (k + 4 if keys else 0) + (4 if hash_lo else 0) \
        + (4 if pidx_col else 0) + (4 if want_ets else 0)
    return rows * per + (-(-rows // 8) if pack else rows) + 5 * slots
