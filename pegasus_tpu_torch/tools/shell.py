"""pegasus_tpu_torch shell — data access + table administration CLI.

Parity: the reference's interactive shell (src/shell/main.cpp:874, 87
commands in commands.h) and the Go admin-cli/pegic split. One binary
serves both roles here:

    python -m pegasus_tpu_torch.tools.shell --root /data/onebox <command> ...

Run with no command for the interactive REPL (`use <table>` scopes data
verbs, parity: the linenoise REPL + `use`). Command families:
  table mgmt : create_app, drop_app, recall_app, rename, ls, app,
               get/set_replica_count
  data       : set, get, del, exist, ttl, incr, multi_set, multi_get,
               multi_get_range, multi_get_sortkeys, multi_del,
               multi_del_range, check_and_set, check_and_mutate, count,
               scan, hash_scan, full_scan, copy_data, clear_data,
               count_data, hash
  envs       : set/get/del/clear_app_envs
  ops        : manual_compact, partition_split, start_split, flush,
               flush_log, backup, restore, start/query_backup,
               restore_app, *_backup_policy, start/query/pause/restart/
               cancel/clear_bulk_load, add/query/remove/pause/start_dup,
               set_dup_fail_mode, dup_stats, dup_failover [--status]
  cluster    : cluster_info, nodes, server_info, server_stat, app_stat,
               app_disk, ddd_diagnose, propose, rebalance, offline_node,
               get/set_meta_level, detect_hotkey, remote_command,
               slow_queries, metrics, storage_stats, disk_health,
               scrub, hot_partitions, compact_sched
  tracing    : trace <id> (fan out + stitch one cross-node span tree),
               traces --slow (tail-kept slow trace roots, one meta call)
  query-perf : explain <table> <op-spec> (execute one captured op,
               render the plan tree with actual per-stage counters),
               explain --from-trace <id> (same report off a kept slow
               trace's span perf tags), workload <table> (op mix /
               batch + value sizes / scan selectivity / hot share),
               placement [workload] (offload verdict + cost-model
               drift audit)
  offline    : sst_dump, mlog_dump, local_get, rdb_key_str2hex,
               rdb_key_hex2str, rdb_value_hex2str

Bytes arguments accept UTF-8 strings.
"""

from __future__ import annotations

import argparse
import json
import sys


def _b(s: str) -> bytes:
    return s.encode()


_ESCAPE_ALL = False  # REPL `escape_all` setting (parity: shell escape_all)


def _s(b: bytes) -> str:
    """Render bytes for output: UTF-8 with replacement, or fully
    C-escaped when the REPL's escape_all setting is on (parity:
    c_escape_sensitive_string in base/pegasus_utils.h)."""
    if _ESCAPE_ALL:
        return "".join(chr(c) if 32 <= c < 127 else "\\x%02x" % c
                       for c in b)
    return b.decode(errors="replace")


# reference verb spellings -> canonical verbs (argparse keeps the ALIAS
# in args.cmd, so dispatch normalizes through this map)
_CANONICAL = {
    "create": "create_app", "drop": "drop_app", "recall": "recall_app",
    "balance": "rebalance", "query_bulk_load_status": "query_bulk_load",
    "local_partition_split": "partition_split",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pegasus-shell",
                                     description=__doc__)
    parser.add_argument("--root", default=None,
                        help="in-process onebox catalog root directory")
    parser.add_argument("--cluster", default=None,
                        help="multi-process onebox directory (wire mode: "
                             "commands go over TCP through meta and the "
                             "replica servers)")
    parser.add_argument("--device", default=None,
                        help="where the in-process onebox (--root) "
                             "serves: the card (default) or cpu; the "
                             "wire mode never touches the card")
    parser.add_argument("-i", "--interactive", action="store_true",
                        help="force the REPL even when stdin is not a "
                             "tty (the REPL also starts when no command "
                             "is given on an interactive terminal)")
    sub = parser.add_subparsers(dest="cmd", required=False)

    p = sub.add_parser("create_app", aliases=["create"])
    p.add_argument("name")
    p.add_argument("-p", "--partition_count", type=int, default=8)
    p = sub.add_parser("drop_app", aliases=["drop"])
    p.add_argument("name")
    sub.add_parser("ls")
    p = sub.add_parser("app")
    p.add_argument("name")

    for cmd in ("set", "get", "del", "exist", "ttl"):
        p = sub.add_parser(cmd)
        p.add_argument("table")
        p.add_argument("hash_key")
        p.add_argument("sort_key")
        if cmd == "set":
            p.add_argument("value")
            p.add_argument("--ttl", type=int, default=0)
    p = sub.add_parser("incr")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("sort_key")
    p.add_argument("increment", type=int)
    p = sub.add_parser("multi_set")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("kvs", nargs="+", help="sortkey=value pairs")
    p = sub.add_parser("multi_get")
    p.add_argument("table")
    p.add_argument("hash_key")
    p = sub.add_parser("count")
    p.add_argument("table")
    p.add_argument("hash_key")
    p = sub.add_parser("scan")
    p.add_argument("table")
    p.add_argument("--hash_prefix", default="")
    p.add_argument("--max", type=int, default=100)
    # extended data surface (parity: shell data commands, commands.h)
    p = sub.add_parser("check_and_set")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("check_sort_key")
    p.add_argument("check_type", help="not_exist|exist|match_prefix|"
                                      "match_anywhere|match_postfix|"
                                      "bytes_less|bytes_equal|...")
    p.add_argument("check_operand")
    p.add_argument("set_sort_key")
    p.add_argument("set_value")
    p.add_argument("--ttl", type=int, default=0)
    p = sub.add_parser("check_and_mutate")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("check_sort_key")
    p.add_argument("check_type")
    p.add_argument("check_operand")
    p.add_argument("mutations", nargs="+",
                   help="sortkey=value (put; empty value allowed) or "
                        "del:sortkey (delete)")
    p = sub.add_parser("multi_del")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("sort_keys", nargs="+")
    p = sub.add_parser("multi_del_range")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("--start", default="")
    p.add_argument("--stop", default="")
    p = sub.add_parser("multi_get_range")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("--start", default="")
    p.add_argument("--stop", default="")
    p.add_argument("--max", type=int, default=100)
    p = sub.add_parser("multi_get_sortkeys")
    p.add_argument("table")
    p.add_argument("hash_key")
    p = sub.add_parser("hash_scan")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("--start", default="")
    p.add_argument("--stop", default="")
    p.add_argument("--max", type=int, default=100)
    p = sub.add_parser("full_scan")
    p.add_argument("table")
    p.add_argument("--max", type=int, default=100)
    p = sub.add_parser("copy_data")
    p.add_argument("src_table")
    p.add_argument("dst_table")
    p.add_argument("--max", type=int, default=0,
                   help="0 = everything")
    p = sub.add_parser("clear_data")
    p.add_argument("table")
    p.add_argument("--force", action="store_true",
                   help="required: deletes every record")
    p = sub.add_parser("count_data")
    p.add_argument("table")
    p = sub.add_parser("hash")
    p.add_argument("table")
    p.add_argument("hash_key")
    p.add_argument("sort_key")
    p = sub.add_parser("local_get")
    p.add_argument("path", help="a replica's sst dir (offline read)")
    p.add_argument("hash_key")
    p.add_argument("sort_key")
    p = sub.add_parser("rdb_key_str2hex")
    p.add_argument("hash_key")
    p.add_argument("sort_key")
    p = sub.add_parser("rdb_key_hex2str")
    p.add_argument("hex_key")
    p = sub.add_parser("rdb_value_hex2str")
    p.add_argument("hex_value")

    p = sub.add_parser("set_app_envs")
    p.add_argument("table")
    p.add_argument("envs", nargs="+", help="key=value pairs")
    p = sub.add_parser("get_app_envs")
    p.add_argument("table")
    p = sub.add_parser("manual_compact")
    p.add_argument("table")
    p = sub.add_parser("partition_split", aliases=["local_partition_split"])
    p.add_argument("table")
    p = sub.add_parser("flush")
    p.add_argument("table")
    p = sub.add_parser("metrics")
    p.add_argument("--entity_type", default=None)
    p = sub.add_parser("backup")
    p.add_argument("table")
    p.add_argument("--bucket", required=True)
    p.add_argument("--policy", default="manual")
    p.add_argument("--backup_id", type=int, required=True)
    p = sub.add_parser("restore")
    p.add_argument("table")
    p.add_argument("--bucket", required=True)
    p.add_argument("--policy", default="manual")
    p.add_argument("--backup_id", type=int, required=True)
    p.add_argument("--new_name", default=None)

    # meta-orchestrated ops (wire mode; parity: the shell's backup/dup/
    # split/bulk-load admin verbs over ddl_client)
    p = sub.add_parser("start_backup")
    p.add_argument("table")
    p.add_argument("--bucket", required=True)
    p.add_argument("--policy", default="manual")
    p = sub.add_parser("query_backup")
    p.add_argument("backup_id", type=int)
    p = sub.add_parser("restore_app")
    p.add_argument("new_name")
    p.add_argument("--bucket", required=True)
    p.add_argument("--policy", default="manual")
    p.add_argument("--backup_id", type=int, required=True)
    p = sub.add_parser("start_bulk_load")
    p.add_argument("table")
    p.add_argument("--bucket", required=True)
    p.add_argument("--staged_app", default=None)
    p = sub.add_parser("query_bulk_load", aliases=["query_bulk_load_status"])
    p.add_argument("table")
    p = sub.add_parser("add_dup")
    p.add_argument("table")
    p.add_argument("follower_app")
    p.add_argument("--follower_meta", default="meta")
    p = sub.add_parser("query_dup")
    p.add_argument("table")
    p = sub.add_parser("remove_dup")
    p.add_argument("dupid", type=int)
    p = sub.add_parser("start_split")
    p.add_argument("table")
    p = sub.add_parser("query_split")
    p.add_argument("table")
    p = sub.add_parser("nodes")
    p = sub.add_parser("hot_partitions")
    p.add_argument("table", nargs="?", default="",
                   help="one table, or the whole cluster when omitted")
    sub.add_parser("compact_sched",
                   help="the meta compaction coordinator's stagger "
                        "state: granted/waiting nodes + per-node "
                        "demand reports")
    p = sub.add_parser("rebalance", aliases=["balance"])
    p = sub.add_parser("offline_node")
    p.add_argument("node", help="drain all primaries off this node")
    # offline debugging (parity: shell sst_dump / mlog_dump and
    # src/tools/mutation_log_tool.*) — read files directly, no cluster
    p = sub.add_parser("sst_dump")
    p.add_argument("path", help="one .sst file or a replica sst dir")
    p.add_argument("--max", type=int, default=20)
    p = sub.add_parser("mlog_dump")
    p.add_argument("path", help="a replica's plog file (mlog.bin)")
    p.add_argument("--max", type=int, default=20)
    p = sub.add_parser("remote_command")
    p.add_argument("node", help="node name (meta / node0 / ...)")
    p.add_argument("verb", help="registered verb ('help' lists them)")
    p.add_argument("cmd_args", nargs="*")
    p = sub.add_parser("slow_queries")
    p.add_argument("node")
    # distributed tracing: one-command cross-node stitching
    p = sub.add_parser("trace",
                       help="fan trace-dump out to every node, stitch "
                            "the spans into one tree, render the "
                            "timeline with per-hop skew bounds")
    p.add_argument("trace_id")
    p.add_argument("--json", action="store_true",
                   help="print the stitched tree as JSON instead of "
                        "the rendered timeline")
    p = sub.add_parser("traces",
                       help="list recent tail-kept slow trace roots "
                            "(one meta call; nodes report them on "
                            "config-sync)")
    p.add_argument("--slow", action="store_true",
                   help="kept slow traces only (the default view)")
    p.add_argument("--limit", type=int, default=16)
    # cluster flight recorder: watchdog status + incident timelines
    p = sub.add_parser("health",
                       help="cluster health: damped per-node/per-table "
                            "status + firing watchdog rules (one meta "
                            "call off the config-sync digests)")
    p.add_argument("--json", action="store_true")
    p = sub.add_parser("timeline",
                       help="one-command incident report for a node or "
                            "table: flight-recorder ring slices, typed "
                            "health events, and kept slow traces "
                            "stitched into one rendered timeline")
    p.add_argument("target", help="node name or table name")
    p.add_argument("--window", default="5m",
                   help="lookback window, e.g. 90s / 5m / 1h")
    p.add_argument("--json", action="store_true",
                   help="print the raw bundle instead of the rendering")
    # query-level observability: one-command EXPLAIN + workload shapes
    p = sub.add_parser(
        "explain",
        help="execute ONE captured op and render its plan tree with "
             "actual per-stage counters and timings (PerfContext), or "
             "--from-trace to rebuild the report from a kept slow "
             "trace's span perf tags")
    p.add_argument("table", nargs="?", default=None)
    p.add_argument("spec", nargs="*",
                   help="op spec: get <hash_key> [sort_key] | "
                        "multi_get <hash_key> <sk> [sk...] | "
                        "scan [hash_key] [batch_size]")
    p.add_argument("--from-trace", dest="from_trace", default=None,
                   help="rebuild the explain report from this trace id "
                        "instead of executing an op")
    p.add_argument("--json", action="store_true")
    p = sub.add_parser(
        "workload",
        help="per-table workload shape profile: op mix, batch/value "
             "size distributions, scan selectivity, hot-hashkey share "
             "(one meta call off the config-sync digests)")
    p.add_argument("table")
    p.add_argument("--json", action="store_true")
    p = sub.add_parser(
        "tenants",
        help="per-tenant QoS view: weights, CU budgets and bucket "
             "levels, consumed CU, shed/over-budget counts, brownout "
             "state (one meta call off the config-sync tenant blocks)")
    p.add_argument("--json", action="store_true")
    p = sub.add_parser(
        "placement",
        help="the offload pays/doesn't-pay verdict "
             "(ops/placement.offload_breakdown) + the live cost-model "
             "drift audit, per node")
    p.add_argument("workload", nargs="?", default="rules",
                   help="workload class: ttl|probe|rules|match")
    p.add_argument("--bytes", type=int, default=1 << 20,
                   help="batch size for the breakdown estimate")
    p.add_argument("--windows", type=int, default=0,
                   help="model the compaction block at this many "
                        "filter windows (0 = default pipeline "
                        "geometry)")
    p.add_argument("--node", default=None,
                   help="one node (wire mode); default = first node")
    # cluster/node admin breadth (parity: shell admin commands)
    sub.add_parser("cluster_info")
    p = sub.add_parser("server_info")
    p.add_argument("node", nargs="?", default=None,
                   help="one node, or all when omitted")
    p = sub.add_parser("server_stat")
    p.add_argument("node", nargs="?", default=None)
    p = sub.add_parser("storage_stats")
    p.add_argument("table",
                   help="dump cache/bloom/phash/codec counters per "
                        "partition (block codec, compression ratio, "
                        "decode and encoded-probe counts, resident "
                        "index memory bloom-vs-phash split)")
    p = sub.add_parser("disk_health")
    p.add_argument("node", nargs="?", default=None,
                   help="one node, or all replica nodes when omitted")
    p = sub.add_parser("scrub")
    p.add_argument("table")
    p.add_argument("--status", action="store_true",
                   help="report background-scrub progress/last-result "
                        "only (no trigger)")
    p = sub.add_parser("app_stat")
    p.add_argument("table")
    p = sub.add_parser("app_disk")
    p.add_argument("table")
    sub.add_parser("ddd_diagnose")
    p = sub.add_parser("detect_hotkey")
    p.add_argument("node")
    p.add_argument("action", choices=["start", "query", "stop"])
    p.add_argument("app_id", type=int)
    p.add_argument("pidx", type=int)
    p.add_argument("kind", choices=["read", "write"])
    sub.add_parser("get_meta_level")
    p = sub.add_parser("set_meta_level")
    p.add_argument("level", choices=["freezed", "steady", "lively"])
    p = sub.add_parser("get_replica_count")
    p.add_argument("table")
    p = sub.add_parser("set_replica_count")
    p.add_argument("table")
    p.add_argument("count", type=int)
    p = sub.add_parser("propose")
    p.add_argument("table")
    p.add_argument("pidx", type=int)
    p.add_argument("action",
                   choices=["assign_primary", "add_secondary",
                            "downgrade"])
    p.add_argument("node")
    p.add_argument("--force", action="store_true")
    p = sub.add_parser("recall_app", aliases=["recall"])
    p.add_argument("table")
    p = sub.add_parser("rename")
    p.add_argument("old_name")
    p.add_argument("new_name")
    p = sub.add_parser("del_app_envs")
    p.add_argument("table")
    p.add_argument("keys", nargs="+")
    p = sub.add_parser("clear_app_envs")
    p.add_argument("table")
    p.add_argument("--prefix", default="")
    p = sub.add_parser("add_backup_policy")
    p.add_argument("name")
    p.add_argument("--tables", nargs="+", required=True)
    p.add_argument("--bucket", required=True)
    p.add_argument("--interval", type=int, default=86400)
    p.add_argument("--history", type=int, default=3)
    sub.add_parser("ls_backup_policy")
    p = sub.add_parser("query_backup_policy")
    p.add_argument("name")
    p = sub.add_parser("modify_backup_policy")
    p.add_argument("name")
    p.add_argument("--add_tables", nargs="*", default=None)
    p.add_argument("--remove_tables", nargs="*", default=None)
    p.add_argument("--interval", type=int, default=None)
    p.add_argument("--history", type=int, default=None)
    p = sub.add_parser("enable_backup_policy")
    p.add_argument("name")
    p = sub.add_parser("disable_backup_policy")
    p.add_argument("name")
    p = sub.add_parser("pause_dup")
    p.add_argument("dupid", type=int)
    p = sub.add_parser("start_dup")
    p.add_argument("dupid", type=int)
    p = sub.add_parser("set_dup_fail_mode")
    p.add_argument("dupid", type=int)
    p.add_argument("fail_mode", choices=["slow", "skip"])
    p = sub.add_parser("pause_bulk_load")
    p.add_argument("table")
    p = sub.add_parser("restart_bulk_load")
    p.add_argument("table")
    p = sub.add_parser("cancel_bulk_load")
    p.add_argument("table")
    p = sub.add_parser("clear_bulk_load")
    p.add_argument("table")
    p = sub.add_parser("flush_log")
    p.add_argument("node")
    sub.add_parser("dups")
    p = sub.add_parser("dup_stats",
                       help="cluster-wide duplication health: per-dup "
                            "lag (decrees+ms), inflight decree, "
                            "fail_mode, shipped bytes, last error")
    p.add_argument("table", nargs="?", default="")
    p = sub.add_parser("dup_failover",
                       help="controlled failover drill: fence the "
                            "source table (writes get retryable "
                            "ERR_DUP_FENCED), drain confirmed decrees, "
                            "flip the follower writable")
    p.add_argument("table")
    p.add_argument("--status", action="store_true",
                   help="report the in-flight drill instead of "
                        "starting one")
    sub.add_parser("recover")
    p = sub.add_parser("query_restore_status")
    p.add_argument("table", nargs="?", default="")
    for cmd in ("enable_atomic_idempotent", "disable_atomic_idempotent",
                "get_atomic_idempotent"):
        p = sub.add_parser(cmd)
        p.add_argument("table")

    args = parser.parse_args(argv)
    args.cmd = _CANONICAL.get(args.cmd, args.cmd)

    if args.cmd in ("sst_dump", "mlog_dump", "local_get"):
        return _offline_dump(args, sys.stdout)
    if args.cmd in ("rdb_key_str2hex", "rdb_key_hex2str",
                    "rdb_value_hex2str"):
        return _dispatch(args, None, sys.stdout)  # pure codec tools
    if (args.root is None) == (args.cluster is None):
        print("error: exactly one of --root / --cluster is required",
              file=sys.stderr)
        return 2
    if args.cluster is not None:
        box = _ClusterBox(args.cluster)
    else:
        from pegasus_tpu_torch.tools.onebox import Onebox

        box = Onebox(args.root, device=args.device)
    from pegasus_tpu_torch.utils.errors import (
        PegasusError,
        StorageCorruptionError,
    )

    out = sys.stdout
    try:
        if args.cmd is None:
            if not (args.interactive or sys.stdin.isatty()):
                # a script that lost its verb must fail loudly, not
                # hang on (or EOF out of) an accidental REPL
                print("error: no command given and stdin is not a tty "
                      "(pass -i to force the REPL)", file=sys.stderr)
                return 2
            return _repl(parser, box, out)
        return _dispatch(args, box, out)
    except AttributeError as exc:
        print(f"error: {exc} (this command may need wire mode: "
              f"--cluster)", file=sys.stderr)
        return 1
    except (KeyError, ValueError, NotImplementedError,
            PegasusError, StorageCorruptionError) as exc:
        # StorageCorruptionError: the offline dump tools exist to poke
        # at exactly the corrupt files that raise it — report, don't
        # traceback
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        box.close()


# data verbs that take the current table as their first argument when a
# `use <table>` is active in the REPL (parity: the shell's use/cc model)
_TABLE_VERBS = frozenset({
    "set", "get", "del", "exist", "ttl", "incr", "multi_set",
    "multi_get", "count", "scan", "check_and_set", "check_and_mutate",
    "multi_del", "multi_del_range", "multi_get_range",
    "multi_get_sortkeys", "hash_scan", "full_scan", "count_data",
    "clear_data", "hash", "set_app_envs", "get_app_envs",
    "manual_compact", "partition_split", "flush", "app_stat",
    "app_disk", "scrub", "get_replica_count", "explain", "workload",
    "enable_atomic_idempotent",
    "disable_atomic_idempotent", "get_atomic_idempotent",
})


def _repl(parser, box, out) -> int:
    """Interactive mode (parity: the shell's linenoise REPL,
    src/shell/main.cpp:874): `use <table>` scopes data commands,
    `help` lists verbs, `exit`/`quit` leaves. Errors never kill the
    session."""
    import shlex

    from pegasus_tpu_torch.utils.errors import (
        PegasusError,
        StorageCorruptionError,
    )

    import pegasus_tpu_torch

    current_table = None
    print(f"pegasus_tpu_torch shell {pegasus_tpu_torch.__version__} — "
          f"'help' for commands, 'exit' to leave", file=out)
    while True:
        try:
            prompt = f"{current_table or ''}> "
            line = input(prompt)
        except EOFError:
            return 0
        except KeyboardInterrupt:
            print(file=out)
            continue
        try:
            words = shlex.split(line)
        except ValueError as exc:
            print(f"error: {exc}", file=out)
            continue
        if not words:
            continue
        verb = _CANONICAL.get(words[0], words[0])
        words[0] = verb
        if verb in ("exit", "quit"):
            return 0
        if verb == "use":
            if len(words) != 2:
                print("usage: use <table>", file=out)
                continue
            current_table = words[1]
            print(f"OK: using {current_table}", file=out)
            continue
        if verb == "version":
            print(pegasus_tpu_torch.__version__, file=out)
            continue
        if verb == "mycluster":
            print(getattr(box, "root", None) or getattr(box, "path", "?"),
                  file=out)
            continue
        if verb == "cc":
            # switch cluster (parity: shell cc — change cluster): point
            # the session at another onebox catalog / cluster dir
            if len(words) != 2:
                print("usage: cc <onebox-dir>", file=out)
                continue
            # an in-process onebox keeps the session's device
            kw = {"device": box.device} if hasattr(box, "device") else {}
            try:
                new_box = type(box)(words[1], **kw)
            except Exception as exc:  # noqa: BLE001 - operator feedback
                print(f"error: {exc}", file=out)
                continue
            box.close()
            box = new_box
            current_table = None
            print(f"OK: now on {words[1]}", file=out)
            continue
        if verb == "timeout":
            # REPL setting (parity: shell `timeout`): admin RPC deadline
            if len(words) == 1:
                print(f"{getattr(box, 'admin_timeout', 15.0)}s", file=out)
                continue
            try:
                box.admin_timeout = float(words[1])
            except ValueError:
                print("usage: timeout [seconds]", file=out)
                continue
            print("OK", file=out)
            continue
        if verb == "escape_all":
            # REPL setting (parity: shell escape_all): escape every
            # non-printable byte in printed values, not just invalid
            # UTF-8
            global _ESCAPE_ALL
            if len(words) == 2 and words[1] in ("true", "false"):
                _ESCAPE_ALL = words[1] == "true"
            print("escape_all: %s" % str(_ESCAPE_ALL).lower(), file=out)
            continue
        if verb == "help":
            choices = parser._subparsers._group_actions[0].choices
            print("  ".join(sorted(choices)) +
                  "\n  plus: use <table>, cc <dir>, mycluster, timeout, "
                  "escape_all, version, exit", file=out)
            continue
        if verb in _TABLE_VERBS and current_table is not None:
            words = [verb, current_table] + words[1:]
        try:
            cmd_args = parser.parse_args(words)
            cmd_args.cmd = _CANONICAL.get(cmd_args.cmd, cmd_args.cmd)
        except SystemExit:
            continue  # argparse already printed the usage error
        try:
            if verb in ("sst_dump", "mlog_dump", "local_get"):
                _offline_dump(cmd_args, out)
            else:
                _dispatch(cmd_args, box, out)
        except AttributeError as exc:
            print(f"error: {exc} (this command may need wire mode: "
                  f"--cluster)", file=out)
        except (KeyError, ValueError, NotImplementedError,
                PegasusError, StorageCorruptionError) as exc:
            print(f"error: {exc}", file=out)


def _offline_dump(args, out) -> int:
    import os

    from pegasus_tpu_torch.base.key_schema import restore_key
    from pegasus_tpu_torch.base.value_schema import (
        extract_expire_ts,
        extract_user_data,
    )

    with _offline_key_zone(args.path, out):
        return _offline_dump_body(args, out, restore_key,
                                  extract_user_data)


def _offline_key_zone(path, out):
    """Offline forensics on an ENCRYPTED cluster's files: walk up from
    the dump target to the server data root (the dir holding
    .pegasus_data_key), unwrap it with the operator's exported
    PEGASUS_KMS_ROOT_KEY(_FILE), and register a temporary zone so the
    dump reads plaintext. Without the root key the dump fails with the
    actual reason instead of showing ciphertext as an empty log."""
    import contextlib
    import os

    from pegasus_tpu_torch.security.kms import (
        KEY_FILE, KeyProvider, LocalKmsClient, root_key_from_env)
    from pegasus_tpu_torch.storage import efile

    @contextlib.contextmanager
    def zone():
        probe = os.path.abspath(path)
        key_root = None
        while True:
            parent = (probe if os.path.isdir(probe)
                      else os.path.dirname(probe))
            if os.path.exists(os.path.join(parent, KEY_FILE)):
                key_root = parent
                break
            up = os.path.dirname(parent)
            if up == parent:
                break
            probe = up
        if key_root is None:
            yield  # plaintext cluster: nothing to do
            return
        root = root_key_from_env()
        if root is None:
            raise SystemExit(
                f"{key_root} holds encrypted data "
                f"({KEY_FILE} present) — export PEGASUS_KMS_ROOT_KEY "
                "or PEGASUS_KMS_ROOT_KEY_FILE to dump it")
        efile.enable_encryption(
            key_root, KeyProvider(key_root, LocalKmsClient(root)))
        try:
            yield
        finally:
            efile.disable_encryption(key_root)

    return zone()


def _offline_dump_body(args, out, restore_key, extract_user_data) -> int:
    import os

    if args.cmd == "local_get":
        # parity: shell local_get — read one key straight from a replica's
        # sst files, newest first (no running cluster needed)
        from pegasus_tpu_torch.base.key_schema import generate_key
        from pegasus_tpu_torch.storage.sstable import SSTable

        key = generate_key(args.hash_key.encode(),
                           args.sort_key.encode())

        def newest_first(name):
            # files are "l<level>-<seq>.sst": lower level = newer data,
            # higher seq = newer within a level
            level, _, seq = name[:-4].partition("-")
            try:
                return (int(level.lstrip("l")), -int(seq))
            except ValueError:
                return (99, 0)

        paths = [os.path.join(args.path, n)
                 for n in sorted((n for n in os.listdir(args.path)
                                  if n.endswith(".sst")),
                                 key=newest_first)]
        for path in paths:
            t = SSTable(path)
            hit = t.get(key)
            t.close()
            if hit is None:
                continue
            value, ets = hit
            if value is None:
                print("DELETED (tombstone)", file=out)
                return 1
            data = extract_user_data(1, value)
            print(f"{_s(data)} (ets={ets}, "
                  f"from {os.path.basename(path)})", file=out)
            return 0
        print("not found", file=out)
        return 1
    if args.cmd == "sst_dump":
        from pegasus_tpu_torch.storage.sstable import SSTable

        paths = ([args.path] if args.path.endswith(".sst") else sorted(
            os.path.join(args.path, n) for n in os.listdir(args.path)
            if n.endswith(".sst")))
        shown = 0
        for path in paths:
            t = SSTable(path)
            print(f"# {path}: {t.total_count} records, "
                  f"{len(t.blocks)} blocks, meta={t.meta}", file=out)
            for key, value, ets in t.iterate():
                if shown >= args.max:
                    break
                hk, sk = restore_key(key)
                if value is None:
                    print(f"  DEL {hk!r} : {sk!r}", file=out)
                else:
                    data = extract_user_data(1, value)
                    print(f"  {hk!r} : {sk!r} => {data!r} "
                          f"(ets={ets})", file=out)
                shown += 1
            t.close()
            if shown >= args.max:
                break
        return 0
    # mlog_dump
    from pegasus_tpu_torch.replica.mutation_log import MutationLog

    shown = 0
    for mu in MutationLog.replay(args.path):
        if shown >= args.max:
            break
        ops = ", ".join(f"op{wo.op}" for wo in mu.ops)
        print(f"decree={mu.decree} ballot={mu.ballot} "
              f"last_committed={mu.last_committed} "
              f"ts_us={mu.timestamp_us} ops=[{ops}]", file=out)
        shown += 1
    print(f"# {shown} mutation(s) shown", file=out)
    return 0


class _ClusterBox:
    """Adapter: the shell's verbs over the wire clients (parity: the
    reference shell drives ddl_client + client_lib RPCs, never local
    state)."""

    def __init__(self, directory: str) -> None:
        from pegasus_tpu_torch.tools.onebox_cluster import OneboxAdmin

        self.directory = directory
        self.admin = OneboxAdmin(directory)
        self._clients = {}

    def client(self, app_name: str):
        c = self._clients.get(app_name)
        if c is None:
            from pegasus_tpu_torch.tools.onebox_cluster import connect

            c = connect(app_name, self.directory)
            self._clients[app_name] = c
        return c

    def create_table(self, name: str, partition_count: int):
        return self.admin.create_table(name, partition_count)

    def drop_table(self, name: str) -> None:
        self.admin.call("drop_app", app_name=name)

    def list_tables(self):
        return [{"app_id": a["app_id"], "name": a["app_name"],
                 "partition_count": a["partition_count"]}
                for a in self.admin.call("list_apps")]

    def update_app_envs(self, name: str, envs) -> None:
        self.admin.call("update_app_envs", app_name=name, envs=envs)

    def manual_compact_table(self, name: str) -> None:
        """Remote manual compaction: set the one-shot trigger env; every
        replica compacts when config-sync delivers it (parity: the shell
        writing MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY,
        pegasus_manual_compact_service.cpp)."""
        import time as _time

        self.update_app_envs(name, {
            "manual_compact.once.trigger_time": str(int(_time.time()))})

    def remote_command(self, node: str, verb: str, cmd_args):
        """Invoke a registered control verb on one node (parity: shell
        remote_command over RPC_CLI_CLI_CALL) — the poll protocol lives
        on OneboxAdmin (the chaos harness shares it); this surfaces its
        failures in the shell's ValueError error space."""
        from pegasus_tpu_torch.utils.errors import PegasusError

        try:
            return self.admin.remote_command(node, verb, cmd_args)
        except PegasusError as e:
            raise ValueError(str(e))

    def open_table(self, name: str):
        raise NotImplementedError(
            "this command needs local table access — use --root mode, or "
            "the admin verbs in wire mode")

    def split_table(self, name: str):
        raise NotImplementedError(
            "online split over the wire lands with the meta split service")

    def close(self) -> None:
        for c in self._clients.values():
            c.net.close()
        self.admin.close()


_CHECK_TYPES = {
    "no_check": 0, "not_exist": 1, "not_exist_or_empty": 2, "exist": 3,
    "not_empty": 4, "match_anywhere": 5, "match_prefix": 6,
    "match_postfix": 7, "bytes_less": 8, "bytes_less_or_equal": 9,
    "bytes_equal": 10, "bytes_greater_or_equal": 11, "bytes_greater": 12,
    "int_less": 13, "int_less_or_equal": 14, "int_equal": 15,
    "int_greater_or_equal": 16, "int_greater": 17,
}


def _check_type(name: str) -> int:
    try:
        return _CHECK_TYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown check type {name!r}; one of "
            f"{', '.join(_CHECK_TYPES)}") from None


def _full_scan_records(box, table, limit, with_ttl=False):
    """Iterate every record of a table via unordered scanners (parity:
    full_scan's total-order seek across partitions). Yields
    (hk, sk, value) — or (hk, sk, value, expire_ts) with `with_ttl`.
    Open server scan contexts are closed even on early exit."""
    from pegasus_tpu_torch.client import ScanOptions

    c = box.client(table)
    opts = ScanOptions(batch_size=500, return_expire_ts=with_ttl)
    n = 0
    for sc in c.get_unordered_scanners(4, opts):
        try:
            while True:
                try:
                    rec = sc.next_record() if with_ttl else next(sc)
                except StopIteration:
                    break
                yield rec
                n += 1
                if limit and n >= limit:
                    return
        finally:
            sc.close()


def _build_timeline(box, target: str, window_s: float) -> dict:
    """Assemble ONE incident bundle for a node or table: the meta's
    damped status + event ledger, the implicated flight-recorder ring
    slices fetched from the reporting nodes via `timeseries-dump`, and
    the tail-kept slow-trace roots from the config-sync trace reports.
    The time window anchors on the newest evidence (node clocks, not
    the shell's), so it renders correctly over sim and wall clocks."""
    nodes = box.admin.call("list_nodes")
    status = box.admin.call("cluster_health")
    if target in nodes or target in status.get("nodes", {}):
        node, table = target, None
        events = box.admin.call("health_events", node=target, limit=256)
        tstat = status["nodes"].get(target, {}).get("status", "?")
    else:
        apps = {a["app_name"]: str(a["app_id"])
                for a in box.admin.call("list_apps")}
        app_id = apps.get(target)
        if app_id is None:
            raise ValueError(
                f"{target!r} is neither a live node nor a table")
        node, table = None, app_id
        events = box.admin.call("health_events", table=app_id, limit=256)
        tstat = status.get("tables", {}).get(app_id,
                                             {}).get("status", "ok")
    # ring slices: every series the events implicate, fetched from the
    # node that reported it; a node timeline adds the pressure pair so
    # a quiet incident still shows its load context
    wanted = {(ev.get("node"), tuple(ev["entity"]), ev["metric"])
              for ev in events if ev.get("node")}
    if node is not None:
        wanted.add((node, ("rpc", node), "read_shed_count"))
        wanted.add((node, ("rpc", node), "deadline_expired_count"))
    series = []
    for n, (et, ei), metric in sorted(wanted):
        try:
            rows = box.remote_command(
                n, "timeseries-dump", [et, ei, metric, str(window_s)])
        except (ValueError, KeyError):
            rows = None  # node gone mid-incident: render what we have
        for row in rows or []:
            row["node"] = n
            series.append(row)
    # anchor the window on the newest evidence timestamp
    t1 = None
    for ev in events:
        t1 = ev["ts"] if t1 is None else max(t1, ev["ts"])
    for row in series:
        if row["points"]:
            ts = row["points"][-1][0]
            t1 = ts if t1 is None else max(t1, ts)
    bundle = {"target": target, "status": tstat,
              "events": events, "series": series, "traces": []}
    if t1 is not None:
        t0 = t1 - window_s
        bundle["window"] = [t0, t1]
        bundle["events"] = [ev for ev in events if ev["ts"] >= t0]
        for row in series:
            row["points"] = [p for p in row["points"] if p[0] >= t0]
    reports = box.admin.call("slow_traces") or {}
    for rep_node, rep in sorted(reports.items()):
        if node is not None and rep_node != node:
            continue
        for root in rep.get("roots", []):
            if t1 is not None and not (
                    t1 - window_s <= root.get("start", 0.0) <= t1 + 1.0):
                continue
            bundle["traces"].append(root)
    return bundle


def _dispatch(args, box, out) -> int:
    from pegasus_tpu_torch.ops.predicates import FT_MATCH_PREFIX
    from pegasus_tpu_torch.utils.errors import StorageStatus

    if args.cmd == "create_app":
        box.create_table(args.name, args.partition_count)
        print(f"OK: created {args.name} "
              f"({args.partition_count} partitions)", file=out)
    elif args.cmd == "drop_app":
        box.drop_table(args.name)
        print(f"OK: dropped {args.name}", file=out)
    elif args.cmd == "ls":
        for row in box.list_tables():
            print(f"{row['app_id']:>4}  {row['name']:<24} "
                  f"partitions={row['partition_count']}", file=out)
    elif args.cmd == "app":
        t = box.open_table(args.name)
        for p_ in t.all_partitions():
            print(f"  {t.app_id}.{p_.pidx}: decree="
                  f"{p_.engine.last_committed_decree} "
                  f"records~{sum(s.total_count for s in p_.engine.lsm.l0) + sum(s.total_count for s in p_.engine.lsm.l1_runs)}",
                  file=out)
    elif args.cmd == "set":
        c = box.client(args.table)
        err = c.set(_b(args.hash_key), _b(args.sort_key), _b(args.value),
                    ttl_seconds=args.ttl)
        print("OK" if err == 0 else f"error {err}", file=out)
        if err != 0:
            return 1
    elif args.cmd == "get":
        c = box.client(args.table)
        err, value = c.get(_b(args.hash_key), _b(args.sort_key))
        if err == int(StorageStatus.NOT_FOUND):
            print("not found", file=out)
            return 1
        print(_s(value), file=out)
    elif args.cmd == "del":
        c = box.client(args.table)
        err = c.delete(_b(args.hash_key), _b(args.sort_key))
        print("OK" if err == 0 else f"error {err}", file=out)
        if err != 0:
            return 1
    elif args.cmd == "exist":
        c = box.client(args.table)
        print("true" if c.exist(_b(args.hash_key), _b(args.sort_key))
              else "false", file=out)
    elif args.cmd == "ttl":
        c = box.client(args.table)
        err, ttl = c.ttl(_b(args.hash_key), _b(args.sort_key))
        if err != 0:
            print("not found", file=out)
            return 1
        print("no ttl" if ttl < 0 else f"{ttl}s", file=out)
    elif args.cmd == "incr":
        c = box.client(args.table)
        resp = c.incr(_b(args.hash_key), _b(args.sort_key),
                      args.increment)
        if resp.error != 0:
            print(f"error {resp.error}", file=out)
            return 1
        print(resp.new_value, file=out)
    elif args.cmd == "multi_set":
        c = box.client(args.table)
        kvs = dict(kv.split("=", 1) for kv in args.kvs)
        err = c.multi_set(_b(args.hash_key),
                          {_b(k): _b(v) for k, v in kvs.items()})
        print("OK" if err == 0 else f"error {err}", file=out)
        if err != 0:
            return 1
    elif args.cmd == "multi_get":
        c = box.client(args.table)
        err, kvs = c.multi_get(_b(args.hash_key))
        if err != 0:
            print(f"error {err}", file=out)
            return 1
        for k, v in sorted(kvs.items()):
            print(f"{_s(k)} : "
                  f"{_s(v)}", file=out)
        print(f"{len(kvs)} record(s)", file=out)
    elif args.cmd == "count":
        c = box.client(args.table)
        err, n = c.sortkey_count(_b(args.hash_key))
        if err != 0:
            print(f"error {err}", file=out)
            return 1
        print(n, file=out)
    elif args.cmd == "scan":
        from pegasus_tpu_torch.client import ScanOptions
        c = box.client(args.table)
        opts = ScanOptions(batch_size=args.max)
        if args.hash_prefix:
            opts.hash_key_filter_type = FT_MATCH_PREFIX
            opts.hash_key_filter_pattern = _b(args.hash_prefix)
        n = 0
        for sc in c.get_unordered_scanners(1, opts):
            for hk, sk, v in sc:
                print(f"{_s(hk)} : "
                      f"{_s(sk)} => "
                      f"{_s(v)}", file=out)
                n += 1
                if n >= args.max:
                    break
            if n >= args.max:
                break
        print(f"{n} record(s)", file=out)
    elif args.cmd == "check_and_set":
        c = box.client(args.table)
        resp = c.check_and_set(
            _b(args.hash_key), _b(args.check_sort_key),
            _check_type(args.check_type), _b(args.check_operand),
            _b(args.set_sort_key), _b(args.set_value),
            ttl_seconds=args.ttl, return_check_value=True)
        # TRY_AGAIN is ambiguous: a FAILED CHECK carries the check value
        # back (we asked for it); a gate rejection (throttle/deny) is a
        # bare error and must not read as "check failed"
        check_failed = (resp.error == int(StorageStatus.TRY_AGAIN)
                        and resp.check_value_returned)
        if resp.error != 0 and not check_failed:
            print(f"error {resp.error}", file=out)
            return 1
        print("set" if resp.error == 0 else "not set (check failed)",
              file=out)
        if resp.check_value_returned:
            print(f"check value: "
                  f"{_s(resp.check_value)}",
                  file=out)
    elif args.cmd == "check_and_mutate":
        from pegasus_tpu_torch.server.types import Mutate, MutateOperation
        c = box.client(args.table)
        muts = []
        for m in args.mutations:
            if m.startswith("del:"):
                muts.append(Mutate(MutateOperation.MO_DELETE,
                                   _b(m[4:])))
            elif "=" in m:
                sk, _, v = m.partition("=")
                muts.append(Mutate(MutateOperation.MO_PUT, _b(sk),
                                   _b(v)))
            else:
                raise ValueError(
                    f"mutation {m!r}: use sortkey=value (put, empty "
                    "value allowed) or del:sortkey (delete)")
        resp = c.check_and_mutate(
            _b(args.hash_key), _b(args.check_sort_key),
            _check_type(args.check_type), _b(args.check_operand), muts,
            return_check_value=True)
        check_failed = (resp.error == int(StorageStatus.TRY_AGAIN)
                        and resp.check_value_returned)
        if resp.error != 0 and not check_failed:
            print(f"error {resp.error}", file=out)
            return 1
        print("mutated" if resp.error == 0
              else "not mutated (check failed)", file=out)
    elif args.cmd == "multi_del":
        c = box.client(args.table)
        err, n = c.multi_del(_b(args.hash_key),
                             [_b(s) for s in args.sort_keys])
        if err != 0:
            print(f"error {err}", file=out)
            return 1
        print(f"deleted {n} record(s)", file=out)
    elif args.cmd == "multi_del_range":
        c = box.client(args.table)
        # paginate: the server caps one multi_get at its read-limiter
        # budget (INCOMPLETE=7); delete page by page until exhausted
        deleted = 0
        cursor = _b(args.start)
        inclusive = True
        while True:
            err, kvs = c.multi_get(_b(args.hash_key),
                                   start_sortkey=cursor,
                                   stop_sortkey=_b(args.stop),
                                   start_inclusive=inclusive,
                                   no_value=True)
            if err not in (0, int(StorageStatus.INCOMPLETE)):
                print(f"error {err}", file=out)
                return 1
            if kvs:
                derr, n = c.multi_del(_b(args.hash_key), sorted(kvs))
                if derr != 0:
                    print(f"error {derr}", file=out)
                    return 1
                deleted += n
            if err == 0 or not kvs:
                break
            cursor = max(kvs)  # resume past the page's last sort key
            inclusive = False
        print(f"deleted {deleted} record(s)", file=out)
    elif args.cmd == "multi_get_range":
        c = box.client(args.table)
        err, kvs = c.multi_get(_b(args.hash_key),
                               start_sortkey=_b(args.start),
                               stop_sortkey=_b(args.stop),
                               max_kv_count=args.max)
        incomplete = err == int(StorageStatus.INCOMPLETE)
        if err != 0 and not incomplete:
            print(f"error {err}", file=out)
            return 1
        for k, v in sorted(kvs.items()):
            print(f"{_s(k)} : "
                  f"{_s(v)}", file=out)
        print(f"{len(kvs)} record(s)"
              + (" (truncated — narrow the range or raise --max)"
                 if incomplete else ""), file=out)
    elif args.cmd == "multi_get_sortkeys":
        c = box.client(args.table)
        err, sks = c.multi_get_sortkeys(_b(args.hash_key))
        if err != 0:
            print(f"error {err}", file=out)
            return 1
        for sk in sks:
            print(_s(sk), file=out)
        print(f"{len(sks)} sort key(s)", file=out)
    elif args.cmd == "hash_scan":
        c = box.client(args.table)
        sc = c.get_scanner(_b(args.hash_key), _b(args.start),
                           _b(args.stop))
        n = 0
        for hk, sk, v in sc:
            print(f"{_s(sk)} => "
                  f"{_s(v)}", file=out)
            n += 1
            if n >= args.max:
                sc.close()
                break
        print(f"{n} record(s)", file=out)
    elif args.cmd == "full_scan":
        n = 0
        for hk, sk, v in _full_scan_records(box, args.table, args.max):
            print(f"{_s(hk)} : "
                  f"{_s(sk)} => "
                  f"{_s(v)}", file=out)
            n += 1
        print(f"{n} record(s)", file=out)
    elif args.cmd == "count_data":
        n = 0
        for _ in _full_scan_records(box, args.table, 0):
            n += 1
        print(n, file=out)
    elif args.cmd == "copy_data":
        from pegasus_tpu_torch.base.value_schema import epoch_now

        dst = box.client(args.dst_table)
        n = 0
        for hk, sk, v, ets in _full_scan_records(
                box, args.src_table, args.max, with_ttl=True):
            # preserve remaining TTL (the reference's copy_data keeps
            # expire timestamps) — `now` per record, or a long scan
            # would inflate TTLs and resurrect records that expired
            # mid-scan
            if ets > 0:
                ttl = ets - epoch_now()
                if ttl <= 0:
                    continue
            else:
                ttl = 0
            err = dst.set(hk, sk, v, ttl_seconds=ttl)
            if err != 0:
                print(f"error {err} at {hk!r}:{sk!r}", file=out)
                return 1
            n += 1
        print(f"copied {n} record(s)", file=out)
    elif args.cmd == "clear_data":
        if not args.force:
            print("refusing without --force (deletes every record)",
                  file=out)
            return 1
        c = box.client(args.table)
        # stream: records arrive in key order per partition, so one
        # hash key's sort keys are contiguous — flush per hash key
        # instead of materializing the whole table's keys
        n = 0
        cur_hk, cur_sks = None, []

        def flush_hk():
            nonlocal n
            if cur_hk is not None and cur_sks:
                err, deleted = c.multi_del(cur_hk, cur_sks)
                if err != 0:
                    raise ValueError(f"error {err} at {cur_hk!r}")
                n += deleted

        for hk, sk, _v in _full_scan_records(box, args.table, 0):
            if hk != cur_hk:
                flush_hk()
                cur_hk, cur_sks = hk, []
            cur_sks.append(sk)
        flush_hk()
        print(f"deleted {n} record(s)", file=out)
    elif args.cmd == "hash":
        from pegasus_tpu_torch.base.key_schema import (
            generate_key, key_hash_parts)
        h = key_hash_parts(_b(args.hash_key), _b(args.sort_key))
        count = next((row["partition_count"]
                      for row in box.list_tables()
                      if row["name"] == args.table), None)
        key = generate_key(_b(args.hash_key), _b(args.sort_key))
        print(f"key_hash: {h}", file=out)
        print(f"encoded_key: {key.hex()}", file=out)
        if count:
            print(f"partition: {h % count} (of {count})", file=out)
    elif args.cmd == "rdb_key_str2hex":
        from pegasus_tpu_torch.base.key_schema import generate_key
        print(generate_key(_b(args.hash_key), _b(args.sort_key)).hex(),
              file=out)
    elif args.cmd == "rdb_key_hex2str":
        from pegasus_tpu_torch.base.key_schema import restore_key
        hk, sk = restore_key(bytes.fromhex(args.hex_key))
        print(f"hash_key: {_s(hk)}", file=out)
        print(f"sort_key: {_s(sk)}", file=out)
    elif args.cmd == "rdb_value_hex2str":
        from pegasus_tpu_torch.base.value_schema import (
            extract_expire_ts, extract_user_data)
        raw = bytes.fromhex(args.hex_value)
        print(f"expire_ts: {extract_expire_ts(1, raw)}", file=out)
        print(f"user_data: "
              f"{extract_user_data(1, raw).decode(errors='replace')}",
              file=out)
    elif args.cmd == "set_app_envs":
        envs = dict(kv.split("=", 1) for kv in args.envs)
        box.update_app_envs(args.table, envs)
        print("OK", file=out)
    elif args.cmd == "get_app_envs":
        t = box.open_table(args.table)
        print(json.dumps(t.partitions[0].app_envs, indent=1), file=out)
    elif args.cmd == "manual_compact":
        mc = getattr(box, "manual_compact_table", None)
        if mc is not None:  # wire mode: env-triggered remote compaction
            mc(args.table)
        else:
            box.open_table(args.table).manual_compact_all()
        print("OK", file=out)
    elif args.cmd == "partition_split":
        new_count = box.split_table(args.table)
        print(f"OK: partition count now {new_count}", file=out)
    elif args.cmd == "flush":
        box.open_table(args.table).flush_all()
        print("OK", file=out)
    elif args.cmd == "metrics":
        from pegasus_tpu_torch.utils.metrics import METRICS
        print(json.dumps(METRICS.snapshot(args.entity_type), indent=1),
              file=out)
    elif args.cmd == "storage_stats":
        # per-partition filter / cache observability (round-8): block
        # cache + bloom + row cache counters, plus each partition's
        # filter coverage (how many runs actually carry blooms — a
        # mixed old/new-format store shows it here)
        from pegasus_tpu_torch.server.row_cache import ROW_CACHE
        from pegasus_tpu_torch.utils.metrics import METRICS

        t = box.open_table(args.table)
        rows = []
        for p_ in t.all_partitions():
            lsm = p_.engine.lsm
            tables = list(lsm.l0) + list(lsm.l1_runs)
            snap = p_.metrics.snapshot()["metrics"]
            # codec coverage + compression ratio (round-11): a mixed
            # legacy/compressed store shows partial coverage here, and
            # the ratio sums each run's logical-vs-stored byte stats
            codecs = sorted({x.codec or "none" for x in tables}) \
                if tables else []
            raw_b = sum((x.codec_stats or {}).get("raw_bytes", 0)
                        for x in tables)
            stored_b = sum((x.codec_stats or {}).get("stored_bytes", 0)
                           for x in tables)
            rows.append({
                "gpid": [p_.app_id, p_.pidx],
                "generation": lsm.generation,
                "l0_tables": len(lsm.l0),
                "l1_runs": len(lsm.l1_runs),
                "block_codec": codecs,
                "runs_compressed": sum(
                    1 for x in tables if x.codec is not None),
                "compression_ratio": (round(stored_b / raw_b, 4)
                                      if raw_b else None),
                "compressed_bytes": stored_b,
                "logical_bytes": raw_b,
                "runs_with_bloom": sum(
                    1 for x in tables if x.bloom is not None),
                "bloom_bits": sum(
                    x.bloom.m for x in tables if x.bloom is not None),
                # resident index memory, bloom-vs-phash split (round
                # 15): the perfect-hash index's bytes against the
                # filter bytes it retires at probe time, plus how many
                # runs actually carry one (a build-failure or pre-index
                # file shows partial coverage here)
                "runs_with_phash": sum(
                    1 for x in tables if x.phash is not None),
                "index_bloom_bytes": sum(
                    x.index_memory()["bloom"] for x in tables),
                "index_phash_bytes": sum(
                    x.index_memory()["phash"] for x in tables),
                "cached_blocks": sum(len(x._cache) for x in tables),
                "cached_block_bytes": sum(x._cache_bytes
                                          for x in tables),
                "bloom_useful_count": snap.get(
                    "bloom_useful_count", {}).get("value", 0),
                "phash_useful_count": snap.get(
                    "phash_useful_count", {}).get("value", 0),
                "row_cache_hit": snap.get(
                    "row_cache_hit", {}).get("value", 0),
                "row_cache_miss": snap.get(
                    "row_cache_miss", {}).get("value", 0),
            })
        node_wide = [s["metrics"]
                     for s in METRICS.snapshot("storage")] or [{}]
        # round-12: the compaction pipeline's stage counters
        # (compact_{read,filter,write}_stall_ms, queue depths,
        # compaction_bytes_per_s) land in the node-wide `storage`
        # block above; `compaction` is the governor's live throttle /
        # grant state
        from pegasus_tpu_torch.storage.compact_governor import GOVERNOR
        print(json.dumps({
            "partitions": rows,
            "storage": {n: m.get("value", 0)
                        for n, m in node_wide[0].items()},
            "row_cache": ROW_CACHE.stats(),
            "compaction": GOVERNOR.status(),
        }, indent=1), file=out)
    elif args.cmd == "backup":
        from pegasus_tpu_torch.server.backup import BackupEngine
        from pegasus_tpu_torch.storage.block_service import block_service_for
        t = box.open_table(args.table)  # NotImplementedError in wire mode
        be = BackupEngine(block_service_for(args.bucket), args.policy)
        for p_ in t.all_partitions():
            be.backup_partition(args.backup_id, t.app_id, p_.pidx,
                                p_.engine, server=p_)
        be.finish_backup(args.backup_id, t.app_id, args.table,
                         t.partition_count)
        print(f"OK: backup {args.backup_id}", file=out)
    elif args.cmd == "start_backup":
        bid = box.admin.call("start_backup", app_name=args.table,
                             root=args.bucket, policy=args.policy)
        print(f"OK: backup {bid} started", file=out)
    elif args.cmd == "query_backup":
        print(json.dumps(box.admin.call("backup_status",
                                        backup_id=args.backup_id)),
              file=out)
    elif args.cmd == "restore_app":
        app_id = box.admin.call("restore_app", new_name=args.new_name,
                                root=args.bucket, policy=args.policy,
                                backup_id=args.backup_id)
        print(f"OK: restoring into {args.new_name} (app {app_id})",
              file=out)
    elif args.cmd == "start_bulk_load":
        box.admin.call("start_bulk_load", app_name=args.table,
                       root=args.bucket, src_app=args.staged_app)
        print("OK: bulk load started", file=out)
    elif args.cmd == "query_bulk_load":
        print(json.dumps(box.admin.call("bulk_load_status",
                                        app_name=args.table)), file=out)
    elif args.cmd == "add_dup":
        dupid = box.admin.call("add_dup", app_name=args.table,
                               follower_meta=args.follower_meta,
                               follower_app=args.follower_app)
        print(f"OK: dup {dupid}", file=out)
    elif args.cmd == "query_dup":
        print(json.dumps(box.admin.call("query_dup",
                                        app_name=args.table)), file=out)
    elif args.cmd == "remove_dup":
        box.admin.call("remove_dup", dupid=args.dupid)
        print("OK", file=out)
    elif args.cmd == "dups":
        print(json.dumps(box.admin.call("list_dups")), file=out)
    elif args.cmd == "dup_stats":
        # meta-aggregated dup health (the config-sync dup block), plus
        # each node's live session/governor view from the dup.stats verb
        rows = box.admin.call("dup_stats", app_name=args.table)
        print(json.dumps(rows, indent=1), file=out)
        for n in box.admin.call("list_nodes"):
            node_stats = box.remote_command(n, "dup.stats", [])
            if node_stats and node_stats.get("sessions"):
                print(json.dumps(node_stats, indent=1), file=out)
    elif args.cmd == "dup_failover":
        verb = ("dup_failover_status" if args.status
                else "dup_failover")
        print(json.dumps(box.admin.call(verb, app_name=args.table),
                         indent=1), file=out)
    elif args.cmd == "recover":
        print(json.dumps(box.admin.call("recover")), file=out)
    elif args.cmd == "query_restore_status":
        print(json.dumps(box.admin.call("query_restore_status",
                                        app_name=args.table)), file=out)
    elif args.cmd in ("enable_atomic_idempotent",
                      "disable_atomic_idempotent"):
        val = "true" if args.cmd.startswith("enable") else "false"
        box.update_app_envs(args.table,
                            {"replica.atomic_idempotent": val})
        print("OK", file=out)
    elif args.cmd == "get_atomic_idempotent":
        t = box.open_table(args.table)
        envs = t.partitions[0].app_envs
        print(envs.get("replica.atomic_idempotent", "false"), file=out)
    elif args.cmd == "start_split":
        n = box.admin.call("start_partition_split", app_name=args.table)
        print(f"OK: splitting to {n} partitions", file=out)
    elif args.cmd == "query_split":
        print(json.dumps(box.admin.call("split_status",
                                        app_name=args.table)), file=out)
    elif args.cmd == "cluster_info":
        print(json.dumps(box.admin.call("cluster_info"), indent=1),
              file=out)
    elif args.cmd in ("server_info", "server_stat"):
        nodes = ([args.node] if args.node
                 else box.admin.call("list_nodes"))
        verb = ("server.info" if args.cmd == "server_info"
                else "metrics")
        for n in nodes:
            print(json.dumps({n: box.remote_command(n, verb, [])},
                             indent=1), file=out)
    elif args.cmd == "disk_health":
        # per-dir health state + io error counts across the fleet
        # (parity: shell query_disk_info over the fs_manager states)
        nodes = ([args.node] if args.node
                 else box.admin.call("list_nodes"))
        for n in nodes:
            print(json.dumps(
                {n: box.remote_command(n, "fs.health", [])},
                indent=1), file=out)
    elif args.cmd == "scrub":
        # trigger (or query) the storage scrub for one table: every
        # node scrubs its hosted partitions and reports per-partition
        # progress + last result
        app_ids = {row["app_id"] for row in box.list_tables()
                   if row["name"] == args.table}
        if not app_ids:
            raise ValueError(f"no such table {args.table!r}")
        app_id = str(sorted(app_ids)[0])
        verb_args = (["status", app_id] if args.status else [app_id])
        for n in box.admin.call("list_nodes"):
            rows = box.remote_command(n, "replica.scrub", verb_args)
            for row in rows:
                print(json.dumps(dict(row, node=n)), file=out)
    elif args.cmd == "app_stat":
        rows = []
        for n in box.admin.call("list_nodes"):
            for rep in box.remote_command(n, "replica.info", []):
                rows.append(dict(rep, node=n))
        app_ids = {row["app_id"] for row in box.list_tables()
                   if row["name"] == args.table}
        for rep in sorted(rows, key=lambda r: tuple(r["gpid"])):
            if rep["gpid"][0] in app_ids:
                print(json.dumps(rep), file=out)
    elif args.cmd == "app_disk":
        app_ids = {row["app_id"] for row in box.list_tables()
                   if row["name"] == args.table}
        total = 0
        for n in box.admin.call("list_nodes"):
            for rep in box.remote_command(n, "replica.disk", []):
                if rep["gpid"][0] in app_ids:
                    print(json.dumps(dict(rep, node=n)), file=out)
                    total += rep["sst_bytes"] + rep["log_bytes"]
        print(f"total: {total} bytes", file=out)
    elif args.cmd == "ddd_diagnose":
        for d in box.admin.call("ddd_diagnose"):
            print(json.dumps(d), file=out)
    elif args.cmd == "detect_hotkey":
        print(json.dumps(box.remote_command(
            args.node, "hotkey",
            [args.action, str(args.app_id), str(args.pidx),
             args.kind])), file=out)
    elif args.cmd == "get_meta_level":
        print(box.admin.call("get_meta_level"), file=out)
    elif args.cmd == "set_meta_level":
        print(box.admin.call("set_meta_level", level=args.level),
              file=out)
    elif args.cmd == "get_replica_count":
        print(box.admin.call("get_replica_count", app_name=args.table),
              file=out)
    elif args.cmd == "set_replica_count":
        print(box.admin.call("set_replica_count", app_name=args.table,
                             count=args.count), file=out)
    elif args.cmd == "propose":
        box.admin.call("propose", app_name=args.table, pidx=args.pidx,
                       action=args.action, node=args.node,
                       force=args.force)
        print("OK", file=out)
    elif args.cmd == "recall_app":
        app_id = box.admin.call("recall_app", app_name=args.table)
        print(f"OK: recalled {args.table} (app {app_id})", file=out)
    elif args.cmd == "rename":
        box.admin.call("rename_app", old_name=args.old_name,
                       new_name=args.new_name)
        print("OK", file=out)
    elif args.cmd == "del_app_envs":
        n = box.admin.call("del_app_envs", app_name=args.table,
                           keys=args.keys)
        print(f"OK: removed {n}", file=out)
    elif args.cmd == "clear_app_envs":
        n = box.admin.call("clear_app_envs", app_name=args.table,
                           prefix=args.prefix)
        print(f"OK: removed {n}", file=out)
    elif args.cmd == "add_backup_policy":
        box.admin.call("add_backup_policy", name=args.name,
                       app_names=args.tables, root=args.bucket,
                       interval_seconds=args.interval,
                       backup_history_count=args.history)
        print("OK", file=out)
    elif args.cmd == "ls_backup_policy":
        for pol in box.admin.call("ls_backup_policy"):
            print(json.dumps(pol), file=out)
    elif args.cmd == "query_backup_policy":
        print(json.dumps(box.admin.call("query_backup_policy",
                                        name=args.name), indent=1),
              file=out)
    elif args.cmd == "modify_backup_policy":
        pol = box.admin.call(
            "modify_backup_policy", name=args.name,
            add_apps=args.add_tables, remove_apps=args.remove_tables,
            interval_seconds=args.interval,
            backup_history_count=args.history)
        print(json.dumps(pol), file=out)
    elif args.cmd == "enable_backup_policy":
        box.admin.call("enable_backup_policy", name=args.name)
        print("OK", file=out)
    elif args.cmd == "disable_backup_policy":
        box.admin.call("disable_backup_policy", name=args.name)
        print("OK", file=out)
    elif args.cmd == "pause_dup":
        box.admin.call("pause_dup", dupid=args.dupid)
        print("OK", file=out)
    elif args.cmd == "start_dup":
        box.admin.call("start_dup", dupid=args.dupid)
        print("OK", file=out)
    elif args.cmd == "set_dup_fail_mode":
        box.admin.call("set_dup_fail_mode", dupid=args.dupid,
                       fail_mode=args.fail_mode)
        print("OK", file=out)
    elif args.cmd == "pause_bulk_load":
        box.admin.call("pause_bulk_load", app_name=args.table)
        print("OK", file=out)
    elif args.cmd == "restart_bulk_load":
        box.admin.call("restart_bulk_load", app_name=args.table)
        print("OK", file=out)
    elif args.cmd == "cancel_bulk_load":
        box.admin.call("cancel_bulk_load", app_name=args.table)
        print("OK", file=out)
    elif args.cmd == "clear_bulk_load":
        box.admin.call("clear_bulk_load", app_name=args.table)
        print("OK", file=out)
    elif args.cmd == "flush_log":
        print(box.remote_command(args.node, "flush", []), file=out)
    elif args.cmd == "remote_command":
        print(json.dumps(box.remote_command(args.node, args.verb,
                                            args.cmd_args), indent=1),
              file=out)
    elif args.cmd == "slow_queries":
        for rep in box.remote_command(args.node, "slow-query-dump", []):
            print(json.dumps(rep), file=out)
    elif args.cmd == "trace":
        from pegasus_tpu_torch.utils import tracing

        # local rings first (this process's client spans), then fan the
        # trace-dump verb out to every node; stitch dedupes overlaps
        spans = list(tracing.dump_all(args.trace_id))
        if isinstance(box, _ClusterBox):
            for n in box.admin.call("list_nodes"):
                res = box.remote_command(n, "trace-dump",
                                         [args.trace_id])
                if res:
                    spans.extend(res)
        tree = tracing.stitch(spans)
        if tree is None:
            print(f"no spans for trace {args.trace_id}", file=out)
        elif args.json:
            print(json.dumps(tree, indent=1, default=str), file=out)
        else:
            print(tracing.render(tree), file=out)
    elif args.cmd == "traces":
        from pegasus_tpu_torch.utils import tracing

        if isinstance(box, _ClusterBox):
            reports = box.admin.call("slow_traces")
            for rep in reports.values():  # newest last per node
                if isinstance(rep.get("roots"), list):
                    rep["roots"] = rep["roots"][-args.limit:]
            print(json.dumps(reports, indent=1), file=out)
        else:
            print(json.dumps(tracing.slow_roots_all(args.limit),
                             indent=1), file=out)
    elif args.cmd == "health":
        status = box.admin.call("cluster_health")
        if args.json:
            print(json.dumps(status, indent=1), file=out)
        else:
            print(f"cluster: {status['cluster']}", file=out)
            for node, st in sorted(status["nodes"].items()):
                firing = ", ".join(
                    f"{f['rule']}[{f['entity'][0]}/{f['entity'][1]}]"
                    for f in st["firing"]) or "-"
                print(f"  {node:<12} {st['status']:<9} "
                      f"rings={st['ring_bytes']}B "
                      f"events={st['events_total']}  {firing}",
                      file=out)
            for table, st in sorted(status["tables"].items()):
                rules = ", ".join(f"{f['rule']}@{f['node']}"
                                  for f in st["firing"])
                print(f"  table {table:<6} {st['status']:<9} {rules}",
                      file=out)
    elif args.cmd == "timeline":
        from pegasus_tpu_torch.utils.health import parse_window, render_timeline

        bundle = _build_timeline(box, args.target,
                                 parse_window(args.window))
        if args.json:
            print(json.dumps(bundle, indent=1), file=out)
        else:
            print(render_timeline(bundle), file=out)
    elif args.cmd == "explain":
        from pegasus_tpu_torch.server import explain as explain_mod

        if args.from_trace:
            # rebuild the report from a kept slow trace's span perf
            # tags: local rings + (wire mode) every node's trace-dump
            from pegasus_tpu_torch.utils import tracing

            spans = list(tracing.dump_all(args.from_trace))
            if isinstance(box, _ClusterBox):
                for n in box.admin.call("list_nodes"):
                    res = box.remote_command(n, "trace-dump",
                                             [args.from_trace])
                    if res:
                        spans.extend(res)
            report = explain_mod.from_trace(spans, args.from_trace)
            if args.json:
                print(json.dumps(report, indent=1, default=str),
                      file=out)
            else:
                print(explain_mod.render_trace_report(report),
                      file=out)
        else:
            if args.table is None or not args.spec:
                raise ValueError(
                    "usage: explain <table> <op-spec>  |  "
                    "explain --from-trace <trace_id>")
            spec = explain_mod.spec_from_words(args.spec)
            if isinstance(box, _ClusterBox):
                from pegasus_tpu_torch.base.key_schema import key_hash_parts

                ph = key_hash_parts(
                    spec.get("hash_key", "").encode(), b"")
                # one meta call resolves the hosting primary; the
                # probe loop below is only the fallback for a config
                # racing the resolution
                info = box.admin.call("partition_primary",
                                      app_name=args.table,
                                      partition_hash=ph)
                spec["app_id"] = info["app_id"]
                nodes = box.admin.call("list_nodes")
                if info.get("primary"):
                    nodes = [info["primary"]] + [
                        n for n in nodes if n != info["primary"]]
                report = None
                last_err = None
                for n in nodes:
                    # the hosting primary answers; others raise
                    try:
                        res = box.remote_command(n, "perf.explain",
                                                 [json.dumps(spec)])
                    except ValueError as e:
                        last_err = str(e)
                        continue
                    if isinstance(res, dict):
                        report = dict(res, node=n)
                        break
                if report is None:
                    raise ValueError(
                        f"no node could explain: {last_err}")
            else:
                t = box.open_table(args.table)
                op, op_args, ph = explain_mod.op_from_spec(spec)
                if ph is not None:
                    srv = t.partitions[ph % t.partition_count]
                else:
                    srv = t.partitions[0]
                report = explain_mod.explain_op(srv, op, op_args,
                                                partition_hash=ph)
            if args.json:
                print(json.dumps(report, indent=1, default=str),
                      file=out)
            else:
                print(explain_mod.render_report(report), file=out)
    elif args.cmd == "tenants":
        if isinstance(box, _ClusterBox):
            # one meta call off the config-sync tenant blocks
            status = box.admin.call("tenant_stats")
        else:
            from pegasus_tpu_torch.server.tenancy import TENANTS

            status = {"tenants": TENANTS.snapshot(),
                      "nodes_reporting": 1}
        if args.json:
            print(json.dumps(status, indent=1), file=out)
        else:
            print(f"tenants ({status.get('nodes_reporting', 0)} nodes "
                  f"reporting):", file=out)
            for name, st in sorted(
                    (status.get("tenants") or {}).items()):
                brown = "BROWNOUT" if st.get("browned") else "-"
                budget = st.get("cu_budget") or 0
                print(f"  {name:<16} w={st.get('weight')} "
                      f"budget={budget if budget else 'unlimited'} "
                      f"cu={st.get('cu_total', 0)} "
                      f"ratio={st.get('cu_ratio', 0.0)} "
                      f"shed={st.get('shed', 0)} "
                      f"overbudget={st.get('overbudget', 0)}  {brown}",
                      file=out)
    elif args.cmd == "workload":
        if isinstance(box, _ClusterBox):
            # one meta call off the config-sync workload digests
            status = box.admin.call("workload", app_name=args.table)
        else:
            from pegasus_tpu_torch.server.workload import (
                DRIFT,
                fold_summaries,
            )

            t = box.open_table(args.table)
            rows = [dict(p_.workload.summary(),
                         gpid=[p_.app_id, p_.pidx])
                    for p_ in t.all_partitions()]
            status = {args.table: {"partitions": rows,
                                   "table": fold_summaries(rows)},
                      "drift": DRIFT.status()}
        if args.json:
            print(json.dumps(status, indent=1), file=out)
        else:
            for name, tbl in sorted(status.items()):
                if name == "drift":
                    print(f"drift: {json.dumps(tbl)}", file=out)
                    continue
                fold = tbl.get("table", {})
                print(f"table {name}: "
                      f"{fold.get('partitions', 0)} partitions  "
                      f"reads={fold.get('read_ops', 0)} "
                      f"scans={fold.get('scan_ops', 0)} "
                      f"(pushdown {fold.get('pushdown_ops', 0)}, "
                      f"plain {max(0, fold.get('scan_ops', 0) - fold.get('pushdown_ops', 0))}) "
                      f"writes={fold.get('write_ops', 0)}  "
                      f"selectivity_p50="
                      f"{fold.get('scan_selectivity_p50', 0.0)}%  "
                      f"hot_share={fold.get('hot_share', 0.0)}",
                      file=out)
                for row in tbl.get("partitions", []):
                    print(f"  {row.get('gpid')} "
                          f"r/s/w={row.get('read_ops', 0)}/"
                          f"{row.get('scan_ops', 0)}/"
                          f"{row.get('write_ops', 0)} "
                          f"read_batch_p99={row.get('read_batch_p99')} "
                          f"value_p99={row.get('value_bytes_p99')}",
                          file=out)
    elif args.cmd == "placement":
        if isinstance(box, _ClusterBox):
            nodes = box.admin.call("list_nodes")
            targets = [args.node] if args.node else nodes[:1]
            for n in targets:
                print(json.dumps(
                    {n: box.remote_command(
                        n, "placement",
                        [args.workload, str(args.bytes),
                         str(args.windows or "")])},
                    indent=1), file=out)
        else:
            from pegasus_tpu_torch.ops.placement import (
                compact_breakdown,
                offload_breakdown,
            )
            from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
            from pegasus_tpu_torch.server.workload import DRIFT

            bd = offload_breakdown(args.workload, args.bytes)
            if args.windows:
                bd["compact"] = compact_breakdown(
                    args.bytes, n_windows=args.windows)
            print(json.dumps(
                {"breakdown": bd,
                 "drift": DRIFT.status(),
                 "mesh": MESH_SERVING.status()}, indent=1), file=out)
    elif args.cmd == "nodes":
        for n in box.admin.call("list_nodes"):
            print(n, file=out)
    elif args.cmd == "hot_partitions":
        # the elasticity controller's view: per-partition CU rates +
        # hotkey signals, node load, in-flight splits, pressure backoff
        status = box.admin.call("hot_partitions", app_name=args.table)
        for row in status.pop("partitions", []):
            print(json.dumps(row), file=out)
        print(json.dumps(status, indent=1), file=out)
    elif args.cmd == "compact_sched":
        # the cluster background-IO scheduler's meta half: who holds
        # the heavy-compaction grant, who waits, what each node
        # reported (running / waiting / paced bytes_per_s)
        print(json.dumps(box.admin.call("compact_sched"), indent=1),
              file=out)
    elif args.cmd == "rebalance":
        n = box.admin.call("rebalance")
        print(f"OK: {n} proposals", file=out)
    elif args.cmd == "offline_node":
        n = box.admin.call("drain_node", node=args.node)
        print(f"OK: moved {n} primaries off {args.node}", file=out)
    elif args.cmd == "restore":
        if isinstance(box, _ClusterBox):
            raise NotImplementedError(
                "restore needs local table access — use --root mode")
        from pegasus_tpu_torch.server.backup import BackupEngine
        from pegasus_tpu_torch.storage.block_service import block_service_for
        be = BackupEngine(block_service_for(args.bucket), args.policy)
        meta = be.read_backup_metadata(args.backup_id)
        new_name = args.new_name or f"{args.table}_restored"
        t = box.create_table(new_name, meta["partition_count"])
        for p_ in t.all_partitions():
            p_.engine.close()
            p_.install_engine(be.restore_partition(
                args.backup_id, meta["app_id"], p_.pidx,
                p_.engine.data_dir, device=p_.device))
        print(f"OK: restored into {new_name}", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
