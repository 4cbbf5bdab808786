"""The port's shell, in-process onebox and HTTP endpoints
(tools/shell.py, tools/onebox.py, http/http_server.py), on the CPU.

- tests/test_tools_http.py, tests/test_shell_breadth.py (its wire case
  starts a process onebox with `device="cpu"`) and
  tests/test_split.py's onebox case run on the port through
  `load_spec`; every in-process shell call is given `--device cpu`;
- the shell's in-process data and admin verbs, with both packages'
  clocks frozen, print byte-equal output in both packages;
- the HTTP routes (/version, /config, /command, /metrics as JSON and as
  Prometheus text, and a meta's REST routes) give equal bodies in both
  packages, and the Prometheus text of both passes metrics_lint's rules.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.http import MetricsHttpServer as JHttp
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.tools import metrics_lint as jlint
from pegasus_tpu.tools import shell as jshell
from pegasus_tpu.tools.cluster import SimCluster as JCluster
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils.command_manager import CommandManager as JCommands
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.http import MetricsHttpServer as THttp
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.tools import metrics_lint as tlint
from pegasus_tpu_torch.tools import shell as tshell
from pegasus_tpu_torch.tools.cluster import SimCluster as TCluster
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils.command_manager import CommandManager as TCommands
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS
from torch_mesh_helpers import Clock, T0, load_spec, restore_process_state

SPEC = (load_spec("test_tools_http.py", globals(), "http_spec")
        + load_spec("test_shell_breadth.py", globals(), "shell_spec")
        + load_spec("test_split.py", globals(), "split_spec",
                    keep=lambda name: "onebox" in name))


@pytest.fixture(autouse=True)
def _isolated():
    with restore_process_state():
        yield


def test_every_spec_case_was_taken():
    assert len(SPEC) == 20, SPEC


# ---- the shell's in-process verbs, byte for byte -----------------------
# (the wire-only verbs, app_stat, app_disk, scrub and the like, run in
# test_shell_spec_admin_verbs_over_wire)

VERBS = [
    ["create_app", "demo", "-p", "4"],
    ["create_app", "t2", "-p", "2"],
    ["ls"],
    ["app", "demo"],
    ["set", "demo", "hk", "sk", "hello"],
    ["set", "demo", "hk2", "sk", "v2", "--ttl", "3600"],
    ["get", "demo", "hk", "sk"],
    ["ttl", "demo", "hk2", "sk"],
    ["exist", "demo", "hk", "sk"],
    ["incr", "demo", "hk", "cnt", "5"],
    ["incr", "demo", "hk", "cnt", "2"],
    ["multi_set", "demo", "cart", "a=1", "b=2", "c=3", "d=4"],
    ["multi_get", "demo", "cart"],
    ["multi_get_range", "demo", "cart", "--start", "b", "--stop", "d"],
    ["multi_get_sortkeys", "demo", "cart"],
    ["hash_scan", "demo", "cart", "--start", "b"],
    ["count", "demo", "cart"],
    ["scan", "demo", "--hash_prefix", "hk"],
    ["full_scan", "demo"],
    ["count_data", "demo"],
    ["check_and_set", "demo", "h", "ck", "not_exist", "", "sk", "v1"],
    ["set", "demo", "h", "ck", "present"],
    ["check_and_set", "demo", "h", "ck", "match_prefix", "pre", "sk",
     "v3"],
    ["check_and_mutate", "demo", "h", "ck", "exist", "", "m1=a", "m2=b",
     "del:sk"],
    ["multi_del", "demo", "cart", "a"],
    ["multi_del_range", "demo", "cart", "--start", "b", "--stop", "c"],
    ["copy_data", "demo", "t2"],
    ["count_data", "t2"],
    ["clear_data", "t2"],
    ["clear_data", "t2", "--force"],
    ["hash", "demo", "hk", "sk"],
    ["set_app_envs", "demo", "default_ttl=7200"],
    ["get_app_envs", "demo"],
    ["set", "demo", "late", "s", "v"],
    ["flush", "demo"],
    ["manual_compact", "demo"],
    ["get_atomic_idempotent", "demo"],
    ["enable_atomic_idempotent", "demo"],
    ["get_atomic_idempotent", "demo"],
    ["partition_split", "demo"],
    ["ls"],
    ["full_scan", "demo"],
    ["ttl", "demo", "late", "s"],
    ["del", "demo", "hk", "sk"],
    ["get", "demo", "hk", "sk"],
    ["drop_app", "t2"],
    ["ls"],
    ["rdb_key_str2hex", "hk", "sk"],
]


def _shell_output(main, root, extra, capsys):
    out = []
    for argv in VERBS:
        code = main(["--root", root] + extra + argv)
        cap = capsys.readouterr()
        out.append((argv[0], code, cap.out.replace(root, "<root>"),
                    cap.err.replace(root, "<root>")))
    return out


def test_shell_verbs_print_alike(tmp_path, capsys, monkeypatch):
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    jax = _shell_output(jshell.main, str(tmp_path / "jax"), [], capsys)
    port = _shell_output(tshell.main, str(tmp_path / "port"),
                         ["--device", "cpu"], capsys)
    for j, t in zip(jax, port):
        assert j == t
    assert sum(code == 0 for _v, code, _o, _e in port) == len(VERBS) - 2
    assert "hello" in port[6][2]


# ---- HTTP routes --------------------------------------------------------

def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.read().decode()
    except urllib.error.HTTPError as e:
        return f"{e.code} {e.read().decode()}"


def _bodies(http_cls, metrics, commands_cls, cluster):
    ent = metrics.METRICS.entity("server", "http-diff")
    ent.counter("probe_count").increment(3)
    ent.gauge("probe_bytes").set(17)
    cmds = commands_cls()
    cmds.register("echo", lambda args: " ".join(args), "echo the args")
    srv = http_cls(commands=cmds,
                   routes=cluster.meta.http_routes()).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        paths = ["/version", "/config", "/command?verb=echo&args=a,b",
                 "/metrics?with_metric_entity_type=server"
                 "&with_metrics=probe_count,probe_bytes",
                 "/metrics?with_metric_entity_type=server"
                 "&with_metrics=probe_count,probe_bytes&format=prom"]
        paths += sorted(cluster.meta.http_routes())
        paths.append("/meta/app?name=web")
        return {p: _get(base, p) for p in paths}
    finally:
        srv.stop()
        with metrics.METRICS._lock:
            metrics.METRICS._entities.pop(("server", "http-diff"), None)


def _prom_found(text):
    """The Prometheus text's TYPE lines as metrics_lint's scan result."""
    found = {}
    for name, kind in re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M):
        kind = {"summary": "percentile"}.get(kind, kind)
        found.setdefault(name, {}).setdefault(kind, []).append("prom")
    return found


def test_http_routes_answer_alike(tmp_path):
    clusters = {"jax": JCluster(str(tmp_path / "j"), n_nodes=2),
                "port": TCluster(str(tmp_path / "t"), n_nodes=2,
                                 device="cpu")}
    try:
        for c in clusters.values():
            c.create_table("web", partition_count=2, replica_count=2)
        jax = _bodies(JHttp, jmetrics, JCommands, clusters["jax"])
        port = _bodies(THttp, tmetrics, TCommands, clusters["port"])
    finally:
        for c in clusters.values():
            c.close()
    assert jax.keys() == port.keys()
    for path in jax:
        if path == "/version":
            j, t = json.loads(jax[path]), json.loads(port[path])
            assert (j["framework"], t["framework"]) == (
                "pegasus_tpu", "pegasus_tpu_torch")
            assert j["version"] == t["version"]
        elif path == "/config":
            # each package's registry; the flags both define agree
            j, t = json.loads(jax[path]), json.loads(port[path])
            assert j == JFLAGS.snapshot() and t == TFLAGS.snapshot()
            shared = {s: {n: v for n, v in j[s].items() if n in t[s]}
                      for s in j if s in t}
            assert shared and all(
                t[s][n] == v for s in shared for n, v in shared[s].items())
        else:
            assert jax[path] == port[path], path
    prom = "/metrics?with_metric_entity_type=server" \
           "&with_metrics=probe_count,probe_bytes&format=prom"
    assert "probe_count" in port[prom]
    for lint, text in ((jlint, jax[prom]), (tlint, port[prom])):
        assert lint.lint_scan(_prom_found(text)) == []
