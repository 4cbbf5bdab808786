"""Shared set-up of the resident-image parity tests
(test_torch_mesh_serving.py, test_torch_mesh_compact.py): a frozen
clock, both packages' METRICS zeroed in place, flags set in both
registries, and `mesh_guard`, which resets and restores both packages'
MESH_SERVING, flags, DRIFT and METRICS around a test."""

import contextlib
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
