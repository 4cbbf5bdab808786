"""metrics_lint: static drift check over every metric registration.

The Prometheus exposition (utils/metrics.py to_prometheus) groups all
samples of one metric NAME under a single TYPE header — if the same
name is registered as a counter in one file and a gauge in another,
whichever entity renders first silently decides the advertised type
and every scraper mislabels the other. Likewise a name the
``_prom_name`` sanitizer has to rewrite aliases with any other name
that sanitizes to the same string. Both are cross-file drift no unit
test sees, so this linter walks the tree, extracts every
``counter(`` / ``gauge(`` / ``percentile(`` registration with a
string-literal name, and fails on:

- one name registered with conflicting kinds (counter families —
  counter/relaxed/volatile — all count as "counter");
- a name the Prometheus sanitizer would rewrite (or that collides
  with another name after sanitizing).

A tier-1 test runs it over the package so metric-name drift is caught
at PR time, not at the dashboard.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# .counter("name") / .gauge('name') / .percentile("name"), tolerating
# a line break between the call and its name literal
_REG_RE = re.compile(
    r"\.(counter|relaxed_counter|volatile_counter|gauge|percentile)\(\s*"
    r"(?:\n\s*)?([\"'])([^\"'\n]+)\2",
    re.MULTILINE)

# PerfContext field registrations (utils/perf_context.py perf_field):
# context fields ride the same rules — a field named like an existing
# metric of a DIFFERENT kind, or a name the sanitizer would rewrite,
# is the same cross-file drift (slow-log perf dicts and explain
# reports render these names next to real metrics)
_PERF_RE = re.compile(
    r"\bperf_field\(\s*(?:\n\s*)?([\"'])([^\"'\n]+)\1\s*"
    r"(?:,\s*(?:\n\s*)?(?:kind\s*=\s*)?"
    r"([\"'])(counter|gauge|percentile)\3)?",
    re.MULTILINE)

_KIND = {"counter": "counter", "relaxed_counter": "counter",
         "volatile_counter": "counter", "gauge": "gauge",
         "percentile": "percentile"}

# tenant-labeled metric entities: the per-tenant series are BOUNDED
# (server/tenancy.py caps the registry at MAX_TENANTS and folds
# unknown wire tags into "default"). Any other call site minting an
# .entity("tenant", ...) bypasses that bound — a raw request-supplied
# string there is an unbounded-cardinality leak into the metric
# registry and every scrape — so the linter fails it.
_TENANT_ENTITY_RE = re.compile(
    r"\.entity\(\s*(?:\n\s*)?([\"'])tenant\1")
_TENANT_ENTITY_HOME = os.path.join("server", "tenancy.py")


def scan_file(path: str) -> List[Tuple[str, str, int]]:
    """(metric_name, kind, line_number) registrations in one file."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    out = []
    for m in _REG_RE.finditer(text):
        line = text.count("\n", 0, m.start()) + 1
        out.append((m.group(3), _KIND[m.group(1)], line))
    for m in _PERF_RE.finditer(text):
        line = text.count("\n", 0, m.start()) + 1
        out.append((m.group(2), m.group(4) or "counter", line))
    return out


def scan_tree(root: str = _PKG_ROOT) -> Dict[str, Dict[str, List[str]]]:
    """name -> kind -> ["path:line", ...] across every .py in `root`."""
    found: Dict[str, Dict[str, List[str]]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn == "metrics_lint.py":
                continue  # this file's own docstring shows the pattern
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            for name, kind, line in scan_file(path):
                found.setdefault(name, {}).setdefault(kind, []).append(
                    f"{rel}:{line}")
    return found


def scan_tenant_entities(root: str = _PKG_ROOT) -> List[str]:
    """\"path:line\" sites minting a tenant-labeled metric entity
    OUTSIDE server/tenancy.py (the bounded registry's home)."""
    sites: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn == "metrics_lint.py":
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            if rel == _TENANT_ENTITY_HOME:
                continue
            with open(path, encoding="utf-8") as f:
                text = f.read()
            for m in _TENANT_ENTITY_RE.finditer(text):
                line = text.count("\n", 0, m.start()) + 1
                sites.append(f"{rel}:{line}")
    return sites


def lint_tenant_entities(sites: List[str]) -> List[str]:
    return [
        f"tenant metric entity minted outside server/tenancy.py at "
        f"{site} — per-tenant series must come from the bounded "
        f"registry (MAX_TENANTS cap + unknown-tag folding), or a raw "
        f"wire tag becomes unbounded metric cardinality"
        for site in sites]


def lint(root: str = _PKG_ROOT) -> List[str]:
    """Problems found (empty = clean)."""
    return (lint_scan(scan_tree(root))
            + lint_tenant_entities(scan_tenant_entities(root)))


def lint_scan(found: Dict[str, Dict[str, List[str]]]) -> List[str]:
    """Problems in an already-scanned registration map."""
    from pegasus_tpu_torch.utils.metrics import _prom_name

    problems: List[str] = []
    for name, kinds in sorted(found.items()):
        if len(kinds) > 1:
            detail = "; ".join(
                f"{kind} at {', '.join(sites)}"
                for kind, sites in sorted(kinds.items()))
            problems.append(
                f"metric {name!r} registered with conflicting kinds: "
                f"{detail} — the Prometheus TYPE header can only "
                f"advertise one")
    sanitized: Dict[str, str] = {}
    for name in sorted(found):
        clean = _prom_name(name)
        if clean != name:
            sites = [s for kinds in (found[name],)
                     for ss in kinds.values() for s in ss]
            problems.append(
                f"metric {name!r} breaks the Prometheus sanitizer "
                f"(would export as {clean!r}) at {', '.join(sites)}")
        prior = sanitized.get(clean)
        if prior is not None and prior != name:
            problems.append(
                f"metrics {prior!r} and {name!r} collide after "
                f"Prometheus sanitizing (both export as {clean!r})")
        sanitized[clean] = name
    return problems


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    root = args[0] if args else _PKG_ROOT
    found = scan_tree(root)  # ONE walk: lint + the status counts
    problems = (lint_scan(found)
                + lint_tenant_entities(scan_tenant_entities(root)))
    if problems:
        for p in problems:
            print(f"metrics-lint: {p}")
        print(f"metrics-lint: FAILED ({len(problems)} problem(s), "
              f"{len(found)} metric names scanned)")
        return 1
    print(f"metrics-lint: OK ({len(found)} metric names, "
          f"{sum(len(s) for k in found.values() for s in k.values())} "
          f"registration sites)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
