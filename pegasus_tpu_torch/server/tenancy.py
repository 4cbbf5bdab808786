"""Multi-tenant QoS: the bounded tenant registry and CU-budget governor.

Prior to this layer every protection mechanism was cluster-global —
the transport shed gate, the read limiter, overload backpressure all
punish every client equally, and `tools/scale_test.py` faked per-tenant
QoS with client-side throttles. This module promotes tenancy into the
data plane (shared-cloud stores like Taurus treat per-tenant isolation
as a first-class server obligation, PAPERS.md):

- **Bounded registry** (``TENANTS``): tenants are REGISTERED — from
  per-table app-envs (``qos.tenants = "name:weight:cu_rate,..."``) or
  explicitly — never minted from raw wire strings. An unknown or
  malformed wire tag folds into the ``default`` tenant, so metric
  entity cardinality is bounded by the registry cap, not by whatever
  bytes clients send (the tools/metrics_lint.py tenant rule enforces
  that entity creation stays inside this module).

- **CU budgets, post-debit**: each tenant may carry a token bucket
  (utils/token_bucket.py) denominated in capacity units. Serving paths
  charge the ACTUAL capacity units after the fact (the existing
  CapacityUnitCalculator funnels feed `charge_ambient`), and admission
  gates the NEXT op on the bucket's sign — over-budget ops get typed
  retryable ERR_CU_OVERBUDGET (jittered-backoff retry, no config
  refresh). **Borrow when idle**: when every OTHER budgeted tenant has
  been quiet for `tenant_idle_borrow_s`, an over-budget tenant is
  admitted anyway — budgets cap contention, not idle throughput.

- **Weighted-fair admission inputs**: per-tenant weights (env-set,
  clamped by the operator-mutable ``tenant_min_weight``/
  ``tenant_max_weight`` flags) feed the transport dispatcher's
  deficit-weighted round-robin.

- **Aggressor-only brownout**: per-tenant metric series
  (``tenant_cu_rate``, ``tenant_shed_count``, ``tenant_queue_age_ms``,
  ``tenant_cu_ratio``) ride the flight recorder; the
  ``tenant_brownout`` health rule fires on the tenant whose
  consumed-rate/budget ratio is sustained over threshold, and the
  stub's read gate sheds ONLY that tenant while the rule holds.

Process-global singleton (the METRICS/FLAGS/DRIFT pattern): in-process
sim clusters share one registry, exactly like they share one metric
registry — per-node attribution rides the flight recorder's ownership
predicate, not separate registries.

The port's copy of the JAX package's server/tenancy.py, its imports rewritten to
pegasus_tpu_torch (it imports nothing of that package).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, Optional

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS
from pegasus_tpu_torch.utils.token_bucket import TokenBucket

define_flag("pegasus.qos", "tenant_enforce", True,
            "enforce per-tenant CU budgets and brownout shedding (kill "
            "switch; weighted-fair dispatch stays on — it is "
            "work-conserving and free when single-tenant)", mutable=True)
define_flag("pegasus.qos", "tenant_min_weight", 0.25,
            "operator floor for per-tenant admission weights (env-set "
            "weights clamp into [min, max])", mutable=True)
define_flag("pegasus.qos", "tenant_max_weight", 16.0,
            "operator ceiling for per-tenant admission weights",
            mutable=True)
define_flag("pegasus.qos", "tenant_cu_burst_s", 2.0,
            "CU bucket burst, in seconds of budget rate: a tenant may "
            "burst rate*burst_s units before admission gates it")
define_flag("pegasus.qos", "tenant_borrow_when_idle", True,
            "admit over-budget ops while every OTHER budgeted tenant "
            "is idle — budgets cap contention, not idle throughput",
            mutable=True)
define_flag("pegasus.qos", "tenant_idle_borrow_s", 2.0,
            "quiescence horizon for borrow-when-idle: other tenants "
            "count as idle after this many seconds without a charge",
            mutable=True)

DEFAULT_TENANT = "default"

# wire-tag sanitizer: lowercase slug, bounded length. Anything else
# folds into the default tenant (never into a fresh metric entity).
TENANT_RE = re.compile(r"^[a-z0-9][a-z0-9_\-]{0,31}$")

# registry cap: tenants beyond this fold into default. Keeps the
# per-tenant entity space (and the recorder rings over it) bounded no
# matter what envs ask for.
MAX_TENANTS = 64

# app-env key carrying per-table tenant declarations:
#   qos.tenants = "gold:4:10000,free:1:500"   (name:weight:cu_rate;
#   weight and cu_rate optional — "gold", "gold:4", "gold:4:10000")
TENANTS_ENV_KEY = "qos.tenants"
# app-env naming the tenant tag clients of this table default to
DEFAULT_TENANT_ENV_KEY = "qos.default_tenant"


def sanitize_tenant(raw) -> str:
    """Fold a wire tenant tag into the bounded label space."""
    if isinstance(raw, str) and TENANT_RE.match(raw):
        return raw
    return DEFAULT_TENANT


class TenantState:
    """One registered tenant: weight, optional CU bucket, metrics."""

    def __init__(self, name: str, weight: float, cu_rate: float,
                 clock) -> None:
        self.name = name
        self.weight = weight
        self.cu_rate = cu_rate  # CU/s budget; 0 = unlimited
        burst_s = FLAGS.get("pegasus.qos", "tenant_cu_burst_s")
        self.bucket: Optional[TokenBucket] = (
            TokenBucket(cu_rate, cu_rate * burst_s, clock=clock)
            if cu_rate > 0 else None)
        self.last_active = 0.0  # last charge timestamp (governor clock)
        ent = METRICS.entity("tenant", name, {"tenant": name})
        # counter named for the series the recorder derives from it:
        # rings record counters as per-second rates, and the health
        # rule watches the RATE of CU consumption
        self.cu_counter = ent.counter("tenant_cu_rate")
        self.shed = ent.counter("tenant_shed_count")
        self.overbudget = ent.counter("tenant_overbudget_count")
        self.queue_age = ent.percentile("tenant_queue_age_ms")
        # consumed-rate / budget ratio, refreshed each governor tick —
        # the series the aggressor-only brownout rule fires on
        self.ratio = ent.gauge("tenant_cu_ratio")
        self.brownout_gauge = ent.gauge("tenant_brownout_active")
        self._ratio_last_cu = 0
        self._ratio_last_ts: Optional[float] = None

    def config(self, weight: float, cu_rate: float, clock) -> None:
        """Re-apply env config in place (full_set env pushes re-send
        everything; bucket level carries over only if rate unchanged —
        a budget change is an operator action, restart the bucket)."""
        self.weight = weight
        if cu_rate != self.cu_rate:
            self.cu_rate = cu_rate
            burst_s = FLAGS.get("pegasus.qos", "tenant_cu_burst_s")
            self.bucket = (TokenBucket(cu_rate, cu_rate * burst_s,
                                       clock=clock)
                           if cu_rate > 0 else None)


# ambient tenant: bound by the serving seams (stub handlers, batch
# coordinators) so the CU funnels deep below can attribute charges
# without threading a tenant argument through every storage call —
# the same discipline as utils/perf_context.py
_tls = threading.local()


def current() -> Optional[str]:
    return getattr(_tls, "tenant", None)


class bind:
    """Context manager: make `tenant` the ambient tenant for CU
    attribution on this thread (None = leave unattributed)."""

    __slots__ = ("_tenant", "_prev")

    def __init__(self, tenant: Optional[str]) -> None:
        self._tenant = tenant
        self._prev = None

    def __enter__(self) -> "bind":
        self._prev = getattr(_tls, "tenant", None)
        if self._tenant is not None:
            _tls.tenant = self._tenant
        return self

    def __exit__(self, *exc) -> None:
        _tls.tenant = self._prev


class TenantRegistry:
    """The process-global governor. All lookups resolve through the
    bounded registry; unknown tags fold into the default tenant."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._clock = time.monotonic
        self._tenants: Dict[str, TenantState] = {}
        self._browned: set = set()
        self._default = self._make(DEFAULT_TENANT, 1.0, 0.0)

    # -- clock (sim support) ------------------------------------------

    def set_clock(self, clock) -> None:
        """Switch the governor (and every bucket) onto a virtual
        clock — SimCluster stubs call this so budget refill tracks
        virtual seconds, the same threading scrub_tick/health_tick
        use. Existing buckets are rebuilt on the new timebase."""
        with self._lock:
            if clock is self._clock:
                return
            self._clock = clock
            burst_s = FLAGS.get("pegasus.qos", "tenant_cu_burst_s")
            for st in self._tenants.values():
                if st.cu_rate > 0:
                    st.bucket = TokenBucket(
                        st.cu_rate, st.cu_rate * burst_s, clock=clock)

    def _now(self) -> float:
        return self._clock()

    # -- registration --------------------------------------------------

    def _make(self, name: str, weight: float,
              cu_rate: float) -> TenantState:
        st = TenantState(name, weight, cu_rate, self._clock)
        self._tenants[name] = st
        return st

    def ensure(self, name: str, weight: float = 1.0,
               cu_rate: float = 0.0) -> TenantState:
        """Register (or reconfigure) one tenant. Beyond MAX_TENANTS the
        registration folds into default — bounded cardinality is a
        hard property, not a convention."""
        name = sanitize_tenant(name)
        with self._lock:
            st = self._tenants.get(name)
            if st is None:
                if len(self._tenants) >= MAX_TENANTS:
                    return self._tenants[DEFAULT_TENANT]
                return self._make(name, weight, cu_rate)
            st.config(weight, cu_rate, self._clock)
            return st

    def configure_from_envs(self, envs: Dict[str, str]) -> None:
        """Apply a table's app-envs: ``qos.tenants`` declares tenants
        with weights/budgets. Called from the stubs' update_app_envs
        seam, so `shell set_app_envs` re-shapes QoS online."""
        spec = (envs or {}).get(TENANTS_ENV_KEY, "")
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            name = fields[0].strip()
            try:
                weight = float(fields[1]) if len(fields) > 1 else 1.0
                cu_rate = float(fields[2]) if len(fields) > 2 else 0.0
            except ValueError:
                continue  # malformed field: skip, never crash env sync
            self.ensure(name, weight, cu_rate)

    def resolve(self, raw) -> TenantState:
        """Wire tag -> registered state; unknown folds into default."""
        # lock-free fast path for the per-request funnels: registered
        # names are already sanitized, and dict reads are atomic under
        # the GIL while registration (the only writer) is rare
        if type(raw) is str:
            st = self._tenants.get(raw)
            if st is not None:
                return st
        name = sanitize_tenant(raw)
        with self._lock:
            return self._tenants.get(name) or self._default

    def known(self, raw) -> bool:
        return sanitize_tenant(raw) in self._tenants

    def names(self):
        with self._lock:
            return sorted(self._tenants)

    # -- weighted-fair inputs -----------------------------------------

    def weight(self, raw) -> float:
        """Admission weight, clamped into the operator min/max flags."""
        st = self.resolve(raw)
        lo = FLAGS.get("pegasus.qos", "tenant_min_weight")
        hi = FLAGS.get("pegasus.qos", "tenant_max_weight")
        return max(lo, min(hi, st.weight))

    # -- CU budget enforcement ----------------------------------------

    def admit(self, raw, kind: str = "read") -> int:
        """Gate one op. Returns 0 (admitted) or ERR_CU_OVERBUDGET.

        Post-debit model: the bucket went negative because of PAST
        consumption; refill pays the debt down and admission resumes.
        Brownout shedding is separate (`browned()` + the stub's read
        gate) — this is the budget, not the outlier response.
        """
        if not FLAGS.get("pegasus.qos", "tenant_enforce"):
            return 0
        st = self.resolve(raw)
        if st.bucket is None or st.bucket.level() > 0.0:
            return 0
        if (FLAGS.get("pegasus.qos", "tenant_borrow_when_idle")
                and self._others_idle(st)):
            return 0  # soft mode: nobody is contending, let it run
        st.overbudget.increment()
        from pegasus_tpu_torch.utils.errors import ErrorCode

        return int(ErrorCode.ERR_CU_OVERBUDGET)

    def _others_idle(self, st: TenantState) -> bool:
        horizon = FLAGS.get("pegasus.qos", "tenant_idle_borrow_s")
        now = self._now()
        with self._lock:
            for other in self._tenants.values():
                if other is st:
                    continue
                if now - other.last_active <= horizon:
                    return False
        return True

    def charge(self, raw, cu: int) -> None:
        """Post-debit: bill `cu` capacity units to the tenant (reads
        and writes alike — the budget is total capacity)."""
        if cu <= 0:
            return
        st = self.resolve(raw)
        st.cu_counter.increment(cu)
        st.last_active = self._now()
        if st.bucket is not None:
            st.bucket.debit(float(cu))

    def charge_ambient(self, cu: int) -> None:
        """The CapacityUnitCalculator hook: bill the thread's bound
        tenant (no-op when no tenant is ambient — background work like
        compaction/scrub is not client traffic)."""
        t = current()
        if t is not None:
            self.charge(t, cu)

    # -- shed / queue-age series --------------------------------------

    def note_shed(self, raw) -> None:
        self.resolve(raw).shed.increment()

    def note_queue_age(self, raw, age_ms: float) -> None:
        self.resolve(raw).queue_age.set(age_ms)

    # -- brownout ------------------------------------------------------

    def refresh(self) -> None:
        """Governor tick (ridden by stub.health_tick, the scrub_tick/
        health_tick cadence): publish each tenant's consumed-rate /
        budget ratio so the `tenant_brownout` rule has its series."""
        now = self._now()
        with self._lock:
            states = list(self._tenants.values())
        for st in states:
            cu = st.cu_counter.value()
            if st._ratio_last_ts is None:
                st._ratio_last_ts, st._ratio_last_cu = now, cu
                continue
            dt = now - st._ratio_last_ts
            if dt <= 0:
                continue
            rate = (cu - st._ratio_last_cu) / dt
            st._ratio_last_ts, st._ratio_last_cu = now, cu
            st.ratio.set(round(rate / st.cu_rate, 4)
                         if st.cu_rate > 0 else 0.0)

    def set_brownout(self, name: str, firing: bool) -> None:
        """Driven by the HealthEngine's `tenant_brownout` transitions:
        ONLY the outlier tenant gets shed-gated (and released when the
        rule clears — the hold/clear_hold hysteresis is the damper)."""
        st = self.resolve(name)
        with self._lock:
            if firing:
                self._browned.add(st.name)
            else:
                self._browned.discard(st.name)
        st.brownout_gauge.set(1.0 if firing else 0.0)

    def browned(self, raw) -> bool:
        if not self._browned:  # hot-path fast exit, before the flag
            return False
        if not FLAGS.get("pegasus.qos", "tenant_enforce"):
            return False
        return sanitize_tenant(raw) in self._browned

    # -- surfaces ------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant stats for shell `tenants`, the collector's
        `_tenants` row, and the meta config-sync tenant block."""
        with self._lock:
            states = list(self._tenants.values())
            browned = set(self._browned)
        out: Dict[str, dict] = {}
        for st in states:
            out[st.name] = {
                "weight": st.weight,
                "cu_budget": st.cu_rate,
                "cu_total": st.cu_counter.value(),
                "cu_level": (round(st.bucket.level(), 1)
                             if st.bucket is not None else None),
                "cu_ratio": st.ratio.value(),
                "shed": st.shed.value(),
                "overbudget": st.overbudget.value(),
                "browned": st.name in browned,
            }
        return out

    def reset(self) -> None:
        """Test isolation: drop every registration (metric entities
        persist — counters are monotonic, same rule as workload
        entities) and clear brownout state."""
        with self._lock:
            self._tenants.clear()
            self._browned.clear()
            self._clock = time.monotonic
            self._default = self._make(DEFAULT_TENANT, 1.0, 0.0)


TENANTS = TenantRegistry()
