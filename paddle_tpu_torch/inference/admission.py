"""Counterpart of ``paddle_tpu/inference/admission.py``, copied.

Overload control for the serving engine: admit cheaply or shed at
the front door.

Under sustained overload an engine that accepts everything burns
prefill tokens on requests it will later deadline-evict — the worst
possible place to spend capacity. The production-proven shape (DAGOR,
WeChat's adaptive overload control; SOSP'19 overload-control study) is
the opposite: reject EXCESS AT SUBMIT TIME from a cheap load signal,
keep a priority order so latency-sensitive traffic rides out the storm,
and adapt the admission threshold to measured queueing delay rather
than a static constant.

Three cooperating pieces, all host-side and model-free:

- :class:`EngineLoad` — the live load signal
  :meth:`ContinuousBatchingEngine.load` snapshots every step: queue
  depth, KV-block occupancy, token backlog (queued + in-flight work),
  EWMA step latency/throughput, and the derived queueing-delay
  estimate. Routers and tests read the same struct the controller
  decides from.
- :class:`AdmissionConfig` — the knobs: bounded waiting queue
  (``max_queue``), shed watermarks, the degraded-mode KV watermarks
  (pause prefill admission / clamp batch token grants), and the
  DAGOR-style delay target driving the adaptive level.
- :class:`AdmissionController` — the decision. Two priority classes
  (``interactive`` ahead of ``batch``; deadline-aware ordering within a
  class), watermark shedding of batch traffic, queue-full displacement
  (an interactive arrival evicts the worst queued batch request instead
  of being shed), a deadline-feasibility test (a request that cannot
  finish inside its budget is shed now, not expired later), and an
  adaptive admission level that tightens batch → everything as the
  measured queueing delay crosses the target (hysteresis + hold to
  avoid flapping).

Per-tenant isolation rides on the same front door. DAGOR
sheds *total* overload but is tenant-blind: one hot tenant fills the
queue and every other tenant's attainment collapses while the engine
is nominally healthy. Two mechanisms close that hole:

- **token-bucket quotas** (:class:`TenantPolicy` ``rate_tokens_per_s``/
  ``burst_tokens``): a tenant that exceeds its refill rate is shed with
  reason ``tenant-quota`` at submit time, before it costs anything.
  Refill is computed from the injected clock, so a seeded schedule
  replays to identical verdicts.
- **weighted fair queueing** (start-time fair queueing / SFQ): each
  admission is stamped with a virtual start/finish tag
  (``finish = start + cost / weight``); the engine orders its queue by
  finish tag within a priority class, and feeds served start tags back
  via :meth:`AdmissionController.wfq_served` to advance virtual time.
  A quiet tenant's first arrival tags at the current virtual time and
  overtakes a hot tenant's long backlog — starvation becomes
  structurally impossible rather than merely visible.

The controller is deliberately engine-agnostic: it consumes
:class:`EngineLoad` values and returns verdicts, so it unit-tests
without a model and could front any engine with the same signal.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

__all__ = [
    "PRIORITIES",
    "priority_rank",
    "EngineLoad",
    "TenantPolicy",
    "AdmissionConfig",
    "AdmissionController",
]

# lower rank = more important; admission order and shedding order both
# key off this (batch absorbs the shedding first)
PRIORITIES = ("interactive", "batch")
_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority: str) -> int:
    try:
        return _RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of {PRIORITIES}"
        ) from None


@dataclass
class EngineLoad:
    """One step's load snapshot (the struct ``engine.load()`` returns).

    ``token_backlog`` counts REAL tokens of committed work: queued
    prompts + their full generation budgets, plus the un-prefilled and
    un-generated remainder of every in-flight slot.
    ``est_queue_delay_s`` is ``token_backlog / tokens_per_step *
    ewma_step_s`` — how long a new arrival waits before its work is
    scheduled, at the measured service rate."""

    queue_depth: int = 0
    queue_limit: Optional[int] = None
    queued_interactive: int = 0
    queued_batch: int = 0
    # tokens AHEAD of a new interactive arrival: in-flight remainders
    # plus queued interactive work (priority insertion puts it in
    # front of every queued batch request, so batch backlog does not
    # delay it)
    token_backlog_interactive: int = 0
    active_slots: int = 0
    max_batch: int = 0
    prefilling: int = 0
    kv_free_blocks: int = 0
    kv_total_blocks: int = 0
    kv_occupancy: float = 0.0
    token_backlog: int = 0
    tokens_per_step: float = 0.0
    ewma_step_s: Optional[float] = None
    est_queue_delay_s: float = 0.0
    admission_level: int = 0
    prefill_paused: bool = False
    n_shed_interactive: int = 0
    n_shed_batch: int = 0
    n_expired: int = 0
    # host/device pipelining occupancy: fraction of recent
    # step time the host spent BLOCKED on device fetches (EWMA), and
    # the async pipeline's current in-flight dispatch count. A replica
    # with a high blocked fraction is host-bound — more work queued on
    # it returns later than its queue depth alone suggests, so the
    # router scores it down.
    host_blocked_frac: float = 0.0
    dispatch_depth: int = 0

    @property
    def queue_frac(self) -> float:
        if not self.queue_limit:
            return 0.0
        return self.queue_depth / float(self.queue_limit)

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant isolation knobs.

    ``weight`` steers WFQ service share (a weight-2 tenant drains twice
    as fast as a weight-1 tenant under contention). ``rate_tokens_per_s``
    enables a token-bucket quota over REAL work (prompt + generation
    budget tokens); ``burst_tokens`` is the bucket depth (defaults to
    one second of rate). ``None`` rate means unmetered."""

    weight: float = 1.0
    rate_tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError("weight must be > 0")
        if self.rate_tokens_per_s is not None and self.rate_tokens_per_s <= 0:
            raise ValueError("rate_tokens_per_s must be > 0 or None")
        if self.burst_tokens is not None and self.burst_tokens <= 0:
            raise ValueError("burst_tokens must be > 0 or None")

    @property
    def burst(self) -> Optional[float]:
        if self.rate_tokens_per_s is None:
            return None
        return (self.burst_tokens if self.burst_tokens is not None
                else self.rate_tokens_per_s)


_DEFAULT_POLICY = TenantPolicy()


@dataclass
class AdmissionConfig:
    """Knobs for :class:`AdmissionController` and the engine's degraded
    modes. Defaults are deliberately permissive: only the bounded queue
    and the expired-at-submit fast path are active until watermarks /
    targets are tightened."""

    max_queue: int = 64           # bounded waiting queue (DAGOR front door)
    high_watermark: float = 0.85  # load score that sheds batch traffic
    low_watermark: float = 0.5    # adaptive level relaxes below this
    # degraded modes (engine-side): pause NEW admissions when KV blocks
    # are scarce; clamp batch-class token grants under pressure. 1.0
    # means "only when the pool is fully allocated" — effectively off.
    kv_pause_watermark: float = 1.0
    kv_clamp_watermark: float = 1.0
    batch_clamp_tokens: Optional[int] = None  # None = never clamp
    # DAGOR-style adaptation: tighten the admission level when the
    # estimated queueing delay crosses the target (None = static)
    target_delay_s: Optional[float] = None
    level_hold: int = 8           # observations between level moves
    ewma_alpha: float = 0.3
    # shed requests that cannot finish inside their deadline at the
    # measured service rate (margin > 1 sheds earlier)
    deadline_feasibility: bool = True
    feasibility_margin: float = 1.0
    # per-tenant isolation: policies keyed by tenant name ("*" is the
    # fallback for unlisted tenants). Any policy — or wfq=True — turns
    # on WFQ queue tagging; quotas only meter tenants with a rate.
    tenants: Dict[str, TenantPolicy] = field(default_factory=dict)
    wfq: bool = False

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.low_watermark > self.high_watermark:
            raise ValueError("low_watermark must be <= high_watermark")


class AdmissionController:
    """Stateful front door: verdicts from load snapshots.

    ``level`` is the adaptive priority threshold (DAGOR's admission
    level collapsed to this engine's two classes): 0 admits every
    class, 1 sheds batch, 2 sheds everything. It tightens one notch
    when the delay EWMA exceeds ``target_delay_s`` and relaxes when the
    EWMA falls below ``target_delay_s * low_watermark``, holding
    ``level_hold`` observations between moves so one noisy step cannot
    flap the threshold."""

    MAX_LEVEL = 2

    def __init__(self, config: Optional[AdmissionConfig] = None, *,
                 clock=time.monotonic):
        self.config = config if config is not None else AdmissionConfig()
        self._clock = clock
        self.level = 0
        self.delay_ewma = 0.0
        self._since_change = self.config.level_hold  # free first move
        # per-tenant isolation state (SFQ virtual time + token buckets)
        self._vtime = 0.0
        self._tenant_finish: Dict[str, float] = {}
        self._buckets: Dict[str, list] = {}  # tenant -> [level, last_t]
        self.n_quota_shed = 0
        # obs registry mirror: the controller's adaptive state, readable
        # from the registry without holding a reference to the engine
        from ..obs.metrics import registry as _reg
        self._g_level = _reg().gauge(
            "admission_level", help="adaptive admission level (0..2)")
        self._g_delay = _reg().gauge(
            "admission_delay_ewma_seconds",
            help="EWMA of the estimated queueing delay")
        # per-(verdict, reason) decision counters: alert
        # rules watch WHY load is being shed, not just how much
        self._reg = _reg()

    # -- load tracking --------------------------------------------------
    def observe(self, load: EngineLoad, *,
                allow_tighten: bool = True) -> None:
        """Fold one load snapshot into the delay EWMA and maybe move
        the admission level (hysteresis + hold). ``allow_tighten=False``
        restricts this observation to DOWNWARD moves — the idle-decay
        path, where the caller cannot vouch for a fresh service-rate
        estimate."""
        cfg = self.config
        a = cfg.ewma_alpha
        self.delay_ewma = (a * load.est_queue_delay_s
                           + (1.0 - a) * self.delay_ewma)
        self._g_delay.set(self.delay_ewma)
        self._since_change += 1
        if cfg.target_delay_s is None or self._since_change < cfg.level_hold:
            self._g_level.set(self.level)
            return
        if (self.delay_ewma > cfg.target_delay_s
                and self.level < self.MAX_LEVEL and allow_tighten):
            self.level += 1
            self._since_change = 0
        elif (self.delay_ewma < cfg.target_delay_s * cfg.low_watermark
                and self.level > 0):
            self.level -= 1
            self._since_change = 0
        self._g_level.set(self.level)

    def score(self, load: EngineLoad) -> float:
        """Composite load score in [0, inf): the worst of queue
        pressure and (when a target is set) normalized queueing delay.
        KV scarcity is handled by the engine's degraded modes, not the
        shed score — a full pool at steady state is healthy."""
        cfg = self.config
        q = (load.queue_frac if load.queue_limit
             else load.queue_depth / float(cfg.max_queue))
        d = 0.0
        if cfg.target_delay_s:
            d = self.delay_ewma / cfg.target_delay_s
        return max(q, d)

    # -- per-tenant isolation -------------------------------------------
    @property
    def wfq_enabled(self) -> bool:
        return self.config.wfq or bool(self.config.tenants)

    def _policy(self, tenant: str) -> TenantPolicy:
        t = self.config.tenants
        return t.get(tenant) or t.get("*") or _DEFAULT_POLICY

    @staticmethod
    def _cost(req) -> float:
        return float(int(req.prompt.size) + int(req.max_new_tokens))

    def wfq_tag(self, tenant: str, cost: float) -> Tuple[float, float]:
        """Start-time-fair-queueing tags for one admission:
        ``start = max(vtime, tenant's last finish)``,
        ``finish = start + cost / weight``. The engine orders its queue
        by the finish tag (within a priority class) and reports served
        start tags back via :meth:`wfq_served`."""
        w = self._policy(tenant).weight
        start = max(self._vtime, self._tenant_finish.get(tenant, 0.0))
        finish = start + float(cost) / w
        self._tenant_finish[tenant] = finish
        return start, finish

    def wfq_served(self, start: Optional[float]) -> None:
        """Service feedback: virtual time advances to the start tag of
        the request entering service (SFQ). This is what lets a newly
        arrived quiet tenant tag *at* vtime and overtake a hot tenant's
        queued backlog."""
        if start is not None:
            self._vtime = max(self._vtime, float(start))

    def _bucket_level(self, tenant: str, pol: TenantPolicy,
                      now: float) -> float:
        """Refilled bucket level (does not deduct)."""
        burst = pol.burst
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = [burst, now]
        level, last = b
        level = min(burst, level + max(now - last, 0.0)
                    * pol.rate_tokens_per_s)
        b[0], b[1] = level, now
        return level

    def _quota_verdict(self, req) -> bool:
        """True when the tenant's bucket covers this request's cost.
        Unmetered tenants always pass."""
        tenant = getattr(req, "tenant", "default")
        pol = self._policy(tenant)
        if pol.rate_tokens_per_s is None:
            return True
        return self._bucket_level(tenant, pol, self._clock()) \
            >= self._cost(req)

    def _quota_charge(self, req) -> None:
        tenant = getattr(req, "tenant", "default")
        pol = self._policy(tenant)
        if pol.rate_tokens_per_s is None:
            return
        b = self._buckets.get(tenant)
        if b is not None:
            b[0] = max(b[0] - self._cost(req), 0.0)

    # -- the decision ---------------------------------------------------
    def decide(self, req, load: EngineLoad) -> Tuple[str, str]:
        """Verdict for one submission: ``("admit", "")``,
        ``("shed", reason)``, or ``("displace", reason)`` — admit this
        interactive request by shedding the worst queued batch request
        (the engine performs the displacement). ``req`` needs
        ``priority``, ``prompt``, ``max_new_tokens``, ``deadline``/
        ``expired()`` — the engine's GenRequest shape."""
        verdict = self._decide(req, load)
        if verdict[0] in ("admit", "displace"):
            # charge the tenant bucket only for work actually taken on
            self._quota_charge(req)
        self._reg.counter(
            "admission_decisions_total",
            {"verdict": verdict[0],
             "reason": verdict[1] or "ok"}).inc()
        return verdict

    def _decide(self, req, load: EngineLoad) -> Tuple[str, str]:
        cfg = self.config
        rank = priority_rank(req.priority)
        if req.expired():
            # fast path: a dead-on-arrival budget never enters the queue
            return ("shed", "expired-at-submit")
        if not self._quota_verdict(req):
            # over-quota tenants shed at the front door regardless of
            # engine health: isolation, not overload control
            self.n_quota_shed += 1
            return ("shed", "tenant-quota")
        if self.level >= 2:
            return ("shed", "overload")
        if self.level >= 1 and rank >= 1:
            return ("shed", "overload-batch")
        # feasibility BEFORE the queue-full/displace branch: a doomed
        # arrival must never evict viable queued work only to expire
        # itself — shedding it here loses zero requests
        if (cfg.deadline_feasibility and req.deadline is not None
                and load.ewma_step_s):
            tps = max(load.tokens_per_step, 1.0)
            own = int(req.prompt.size) + int(req.max_new_tokens)
            service = own / tps * load.ewma_step_s
            if rank == 0:
                # interactive jumps ahead of queued batch work: only
                # the class-aware backlog delays it — reasoning from
                # the whole backlog would shed exactly the latency-
                # sensitive traffic this controller exists to protect
                wait = (load.token_backlog_interactive / tps
                        * load.ewma_step_s)
            else:
                wait = load.est_queue_delay_s
            if req.deadline.remaining() < (wait + service) * \
                    cfg.feasibility_margin:
                return ("shed", "deadline-infeasible")
        if load.queue_depth >= cfg.max_queue:
            if rank == 0 and load.queued_batch > 0:
                return ("displace", "queue-full-displaces-batch")
            return ("shed", "queue-full")
        if rank >= 1 and self.score(load) >= cfg.high_watermark:
            return ("shed", "watermark")
        return ("admit", "")

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "delay_ewma_s": self.delay_ewma,
            "target_delay_s": self.config.target_delay_s,
            "max_queue": self.config.max_queue,
            "wfq": self.wfq_enabled,
            "vtime": self._vtime,
            "n_quota_shed": self.n_quota_shed,
            "buckets": {t: b[0] for t, b in self._buckets.items()},
        }
