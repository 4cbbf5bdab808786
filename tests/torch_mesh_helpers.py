"""Shared set-up of the port's parity tests.

- The resident-image files (test_torch_mesh_serving.py,
  test_torch_mesh_compact.py): a frozen clock, both packages' METRICS
  zeroed in place, flags set in both registries, and `mesh_guard`, which
  resets and restores both packages' MESH_SERVING, flags, DRIFT and
  METRICS around a test.
- The cluster and onebox files (test_torch_{backup_bulk_load,
  duplication,cluster,act,process_onebox,...}.py): `load_spec` runs a test
  file of the JAX package's on the port, and `restore_process_state`
  puts back what a cluster test leaves in either package's process-wide
  registries.
"""

import ast
import contextlib
import copy
import os
import re
import time

from pegasus_tpu.base import value_schema as jvs
from pegasus_tpu.ops import placement as jplacement
from pegasus_tpu.parallel.mesh_resident import MESH_SERVING as JMESH
from pegasus_tpu.server import write_service as jws
from pegasus_tpu.server.workload import DRIFT as JDRIFT
from pegasus_tpu.utils import metrics as jmetrics
from pegasus_tpu.utils.flags import FLAGS as JFLAGS
from pegasus_tpu_torch.base import value_schema as tvs
from pegasus_tpu_torch.ops import placement
from pegasus_tpu_torch.parallel.mesh_resident import MESH_SERVING
from pegasus_tpu_torch.server import write_service as tws
from pegasus_tpu_torch.server.workload import DRIFT as TDRIFT
from pegasus_tpu_torch.utils import metrics as tmetrics
from pegasus_tpu_torch.utils.flags import FLAGS as TFLAGS

T0 = 1_790_000_000.25


class Clock:
    """Stands in for a module's `time`: `time()` is frozen at `t`."""

    def __init__(self, t: float) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def zero_metrics(registry) -> None:
    """Every metric of every entity back to zero, in place."""
    for ent in registry.entities():
        for m in list(ent._metrics.values()):
            if isinstance(m, (jmetrics.Percentile, tmetrics.Percentile)):
                with m._lock:
                    m._samples = []
                    m._idx = 0
                    m._version += 1
            elif hasattr(m, "_cursors"):
                m._value = 0
                m._cursors.clear()
            else:
                m._value = 0


def set_flags(section, name, value) -> None:
    for reg in (JFLAGS, TFLAGS):
        reg.set(section, name, value, force=True)


def _clean() -> None:
    for mesh in (JMESH, MESH_SERVING):
        mesh.reset()
    for drift in (JDRIFT, TDRIFT):
        drift.reset()
    for reg in (jmetrics.METRICS, tmetrics.METRICS):
        zero_metrics(reg)
    jplacement.reset_probe()
    placement.reset_probe()


@contextlib.contextmanager
def mesh_guard(monkeypatch, flag_names):
    """Frozen clocks (value_schema and write_service) in both packages;
    both MESH_SERVINGs detached, both DRIFTs and METRICS zeroed and both
    probes forgotten, before and after; `flag_names` ((section, name)
    pairs) restored in both registries after. Yields the clock."""
    clk = Clock(T0)
    for mod in (jvs, tvs, jws, tws):
        monkeypatch.setattr(mod, "time", clk)
    saved = [(reg, s, n, reg.get(s, n)) for reg in (JFLAGS, TFLAGS)
             for s, n in flag_names]
    _clean()
    try:
        yield clk
    finally:
        _clean()
        for reg, s, n, v in saved:
            reg.set(s, n, v, force=True)


# ---- the JAX package's own test files, run on the port -------------------

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

# the port's classes and methods that serve on the card unless told
# otherwise: a spec run calls each of them with device="cpu"
CPU_CALLS = ("SimCluster", "ActRunner", "Table", "PartitionServer",
             "StorageEngine", "ReplicaStub", "Replica", "restore_partition",
             "Onebox", "GeoClient", "run_scale_test", "run_wan_test")
# module names under which the tests call onebox_cluster.start
ONEBOX_MODULES = ("ob", "onebox_cluster")


def _with_cpu_device(items: list) -> list:
    """An argv (the elements of a call or a list) with "--device", "cpu"
    after its "--root" DIR pair: the shell's in-process onebox then
    serves on the CPU."""
    consts = [getattr(e, "value", None) for e in items]
    if "--root" not in consts or "--device" in consts:
        return items
    at = consts.index("--root") + 2
    return items[:at] + [ast.Constant("--device"),
                         ast.Constant("cpu")] + items[at:]


class _OnCpu(ast.NodeTransformer):
    def visit_List(self, node):
        self.generic_visit(node)
        node.elts = _with_cpu_device(node.elts)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = (f.id if isinstance(f, ast.Name) else
                f.attr if isinstance(f, ast.Attribute) else None)
        onebox_start = (name == "start" and isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id in ONEBOX_MODULES)
        if (name in CPU_CALLS or onebox_start) and not any(
                k.arg == "device" for k in node.keywords):
            node.keywords.append(ast.keyword(
                arg="device", value=ast.Constant("cpu")))
        node.args = _with_cpu_device(node.args)
        return node


def spec_code(ref_file: str):
    """tests/`ref_file` compiled with every import of the JAX package
    (and every module named in a command line) rewritten to the port's;
    every call in CPU_CALLS, every `ob.start` / `onebox_cluster.start`
    and every shell argv with "--root" asks for the CPU."""
    with open(os.path.join(TESTS_DIR, ref_file)) as f:
        src = f.read()
    src = re.sub(r"\bpegasus_tpu\b(?!_torch)", "pegasus_tpu_torch", src)
    tree = ast.fix_missing_locations(_OnCpu().visit(ast.parse(src)))
    return compile(tree, f"<port spec of {ref_file}>", "exec")


def load_spec(ref_file: str, ns: dict, prefix: str,
              keep=lambda name: True) -> list:
    """Run tests/`ref_file` (the JAX package's) against the port: its
    source, as `spec_source` rewrites it, is executed in a namespace of
    its own; its fixtures and helpers are copied into `ns` (the calling
    test module's globals) and each test `test_x` that `keep(name)`
    accepts becomes `test_{prefix}_x` there. Returns the names taken."""
    mod = {"__name__": f"port_spec_{prefix}",
           "__file__": os.path.join(TESTS_DIR, ref_file)}
    exec(spec_code(ref_file), mod)
    taken = []
    for name, obj in mod.items():
        if name.startswith("test_") and callable(obj):
            if keep(name):
                new = f"test_{prefix}_{name[5:]}"
                ns[new] = obj
                taken.append(new)
        elif getattr(obj, "_pytestfixturefunction", None) is not None or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            ns.setdefault(name, obj)
    return taken


@contextlib.contextmanager
def restore_process_state():
    """Both packages' process-wide state around a cluster test: the
    metric entities and span rings it created are removed, and the
    TENANTS clocks, GOVERNORs, DRIFT monitors, flags and fail points are
    put back."""
    from pegasus_tpu.server.tenancy import TENANTS as JTENANTS
    from pegasus_tpu.storage.compact_governor import GOVERNOR as JGOV
    from pegasus_tpu.utils import tracing as jtracing
    from pegasus_tpu.utils.fail_point import FAIL_POINTS as JFP
    from pegasus_tpu_torch.server.tenancy import TENANTS as TTENANTS
    from pegasus_tpu_torch.storage.compact_governor import GOVERNOR as TGOV
    from pegasus_tpu_torch.utils import tracing as ttracing
    from pegasus_tpu_torch.utils.fail_point import FAIL_POINTS as TFP

    regs = (jmetrics.METRICS, tmetrics.METRICS)
    before = [set(reg._entities) for reg in regs]
    rings = [set(t._rings) for t in (jtracing, ttracing)]
    clocks = [t._clock for t in (JTENANTS, TTENANTS)]
    govs = [{k: v for k, v in g.__dict__.items() if k != "_lock"}
            for g in (JGOV, TGOV)]
    drifts = [(d, copy.deepcopy(d._classes), d._gauge.value())
              for d in (JDRIFT, TDRIFT)]
    flags = [(reg, {k: f.value for k, f in reg._flags.items()})
             for reg in (JFLAGS, TFLAGS)]
    fps = [(fp, fp._enabled, dict(fp._actions)) for fp in (JFP, TFP)]
    try:
        yield
    finally:
        for fp, enabled, actions in fps:
            fp.teardown()
            fp._actions.update(actions)
            fp._enabled = enabled
        for reg, keys in zip(regs, before):
            with reg._lock:
                for key in set(reg._entities) - keys:
                    del reg._entities[key]
        for tracing, nodes in zip((jtracing, ttracing), rings):
            for node in set(tracing._rings) - nodes:
                tracing.drop_ring(node)
        for tenants, clock in zip((JTENANTS, TTENANTS), clocks):
            tenants.set_clock(clock)
        for gov, saved in zip((JGOV, TGOV), govs):
            gov.__dict__.update(saved)
        for drift, classes, gauge in drifts:
            with drift._lock:
                drift._classes = classes
                drift._gauge.set(gauge)
        for reg, values in flags:
            for key, value in values.items():
                if key in reg._flags:
                    reg._flags[key].value = value
