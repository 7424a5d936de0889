"""Deterministic fault-injection harness for the RPC layer.

A :class:`FaultPlan` scripts per-endpoint failures — N errors then success,
latency spikes, insufficient-capacity errors — and is consumed by the fault
seams in :class:`~karpenter_tpu.cloudprovider.fake.FakeCloudProvider`, the
HTTP cloud service (``CloudHTTPService(fault_plan=...)``) and the scripted
transport below. Scripts are ordered queues, so every retry/breaker/ICE
behavior is testable deterministically: "2 transient 5xx then success" is a
script, not a probability, and the plan's ``log`` records exactly which
faults fired in which order. No randomness, and no real sleeps unless a
latency fault explicitly asks for one (tests inject ``sleep=lambda s: None``
and assert on the recorded delay instead).
"""

from __future__ import annotations

import threading
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Fault:
    """One scripted failure.

    kind:
      * ``"error"``    — transient failure; ``status`` is the HTTP status the
        wire surfaces (0 means a connection-level error with no response).
      * ``"capacity"`` — insufficient capacity: the provider raises/returns
        its ICE shape so the offering lands in the unavailable cache.
      * ``"latency"``  — delay ``latency_s`` then proceed normally.
    """

    kind: str = "error"
    status: int = 503
    latency_s: float = 0.0
    reason: str = "injected"


def errors(n: int, status: int = 503) -> List[Fault]:
    """N transient errors then success — the canonical retry script."""
    return [Fault(kind="error", status=status) for _ in range(n)]


class FaultPlan:
    """Scripted per-endpoint fault queues.

    ``script(endpoint, faults)`` appends faults to the endpoint's queue;
    each matching call pops one fault until the queue drains, after which
    the endpoint behaves normally. ``"*"`` scripts apply to any endpoint
    without its own queue. ``log`` records ``(endpoint, fault)`` in firing
    order; ``sleep`` is the latency-fault sleeper (injectable so tests run
    latency scripts without wall-clock delay).
    """

    def __init__(
        self,
        sleep: Callable[[float], None] = time.sleep,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._scripts: Dict[str, List[Fault]] = {}
        self._lock = threading.Lock()
        self.sleep = sleep
        self.log: List[Tuple[str, Fault]] = []
        # shared-clock contract (the soak's ChurnScript injects ONE clock
        # into every fault surface it unifies): when set, ``timeline``
        # additionally records (clock(), endpoint, fault) so fired faults
        # line up against the churn timeline on the same axis
        self.clock = clock
        self.timeline: List[Tuple[float, str, Fault]] = []

    def script(self, endpoint: str, faults: Sequence[Fault]) -> "FaultPlan":
        with self._lock:
            self._scripts.setdefault(endpoint, []).extend(faults)
        return self

    def fail(self, endpoint: str, n: int = 1, status: int = 503) -> "FaultPlan":
        """Convenience: N transient errors then success on ``endpoint``."""
        return self.script(endpoint, errors(n, status=status))

    def capacity_error(self, endpoint: str, n: int = 1, reason: str = "ICE") -> "FaultPlan":
        return self.script(endpoint, [Fault(kind="capacity", reason=reason)] * n)

    def latency(self, endpoint: str, seconds: float, n: int = 1) -> "FaultPlan":
        return self.script(endpoint, [Fault(kind="latency", latency_s=seconds)] * n)

    def next(self, endpoint: str) -> Optional[Fault]:
        """Pop the next scripted fault for ``endpoint`` (exact queue first,
        then the ``"*"`` wildcard queue); None when the script is drained."""
        with self._lock:
            for key in (endpoint, "*"):
                queue = self._scripts.get(key)
                if queue:
                    fault = queue.pop(0)
                    self.log.append((endpoint, fault))
                    if self.clock is not None:
                        self.timeline.append((self.clock(), endpoint, fault))
                    return fault
        return None

    def pending(self, endpoint: Optional[str] = None) -> int:
        with self._lock:
            if endpoint is not None:
                return len(self._scripts.get(endpoint, []))
            return sum(len(q) for q in self._scripts.values())

    def clear(self, endpoint: Optional[str] = None) -> int:
        """Drop un-fired faults (one endpoint's queue, or every queue) and
        return how many were dropped — chaos scenarios end a scripted outage
        early (e.g. unblock terminate before restarting a killed operator)
        without constructing a fresh plan. The firing log is untouched."""
        with self._lock:
            if endpoint is not None:
                return len(self._scripts.pop(endpoint, []))
            dropped = sum(len(q) for q in self._scripts.values())
            self._scripts.clear()
            return dropped


def raise_for_fault(fault: Optional[Fault], plan: "FaultPlan", endpoint: str) -> None:
    """Provider-side fault application: turn a scripted fault into the
    exception the in-process provider seam raises (transient errors become
    ``TransientCloudError``, capacity becomes ``InsufficientCapacityError``,
    latency sleeps through the plan's injectable sleeper)."""
    if fault is None:
        return
    from ..cloudprovider.interface import InsufficientCapacityError, TransientCloudError

    if fault.kind == "latency":
        if fault.latency_s > 0:
            plan.sleep(fault.latency_s)
        return
    if fault.kind == "capacity":
        raise InsufficientCapacityError(
            f"injected capacity failure on {endpoint}", reason=fault.reason
        )
    raise TransientCloudError(
        f"injected {fault.status or 'connection'} error on {endpoint}"
    )


# ---------------------------------------------------------------------------
# Scripted interruption schedules (the FaultPlan idea, generalized from
# per-endpoint RPC faults to cluster-level capacity events): reclaim waves
# per capacity pool and spot price spikes, keyed by round number. Drives the
# spot_churn bench scenario and the interruption-storm tests — sustained,
# deterministic reclamation with zero randomness, like every fault here.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReclaimWave:
    """One spot-reclaim wave: at ``round_no``, a ``fraction`` of the nodes in
    ``pool`` (``(instance_type, zone, capacity_type)``; ``*`` wildcards a
    segment) receive interruption events. ``rebalance_first=True`` sends the
    rebalance recommendation instead of the 2-minute warning — the proactive
    path's trigger."""

    round_no: int
    pool: Tuple[str, str, str]
    fraction: float = 1.0
    rebalance_first: bool = False

    def selects(self, pool: Tuple[str, str, str]) -> bool:
        return all(w in ("*", p) for w, p in zip(self.pool, pool))


@dataclass(frozen=True)
class PriceSpike:
    """At ``round_no``, multiply one spot pool's live price by ``factor`` —
    the market moving against a pool mid-churn."""

    round_no: int
    instance_type: str
    zone: str
    factor: float


class InterruptionSchedule:
    """A deterministic capacity-event timeline over bench/test rounds.

    ``waves_for(round)`` / ``spikes_for(round)`` return the events scripted
    for that round; ``victims(wave, nodes)`` picks the wave's victim nodes
    deterministically (sorted by name, first ceil(fraction * count)), so two
    runs of the same schedule reclaim the same nodes in the same order.
    ``log`` records every fired event like FaultPlan's."""

    def __init__(
        self,
        waves: Sequence[ReclaimWave] = (),
        spikes: Sequence[PriceSpike] = (),
        clock: Optional[Callable[[], float]] = None,
    ):
        self.waves = list(waves)
        self.spikes = list(spikes)
        self.log: List[Tuple[int, object]] = []
        # same shared-clock contract as FaultPlan: events fired through a
        # ChurnScript-owned schedule stamp the unified timeline
        self.clock = clock
        self.timeline: List[Tuple[float, object]] = []

    def waves_for(self, round_no: int) -> List[ReclaimWave]:
        out = [w for w in self.waves if w.round_no == round_no]
        self.log.extend((round_no, w) for w in out)
        if self.clock is not None:
            self.timeline.extend((self.clock(), w) for w in out)
        return out

    def spikes_for(self, round_no: int) -> List[PriceSpike]:
        out = [s for s in self.spikes if s.round_no == round_no]
        self.log.extend((round_no, s) for s in out)
        if self.clock is not None:
            self.timeline.extend((self.clock(), s) for s in out)
        return out

    @staticmethod
    def victims(wave: ReclaimWave, pool_nodes: Sequence[Tuple[Tuple[str, str, str], str]]) -> List[str]:
        """The wave's victim node names from ``(pool, node_name)`` pairs:
        matching pools, name-sorted, first ceil(fraction * matching)."""
        import math

        names = sorted(name for pool, name in pool_nodes if wave.selects(pool))
        if not names:
            return []
        return names[: max(1, math.ceil(wave.fraction * len(names)))]

    def last_round(self) -> int:
        rounds = [w.round_no for w in self.waves] + [s.round_no for s in self.spikes]
        return max(rounds) if rounds else -1


# ---------------------------------------------------------------------------
# Device-path fault injection (the solver fault domain's chaos surface):
# scripted failures of the JAX kernel path — compile errors, dispatch
# hangs, device OOM, NaN/garbage results, staging corruption — consumed by
# the seams in solver/jax_solver.py (AOTCache.compile), solver/solver.py
# (dispatch + result fetch) and solver/staging.py (DeviceStager.stage).
# Same ordered-queue discipline as FaultPlan: "2 garbage plans then clean"
# is a script, not a probability, so every breaker/validator behavior is
# testable deterministically.
# ---------------------------------------------------------------------------

#: injection sites the solver seams consult
DEVICE_SITES = ("compile", "dispatch", "result", "staging")

#: fault kinds per site — the seams refuse unknown kinds loudly
DEVICE_KINDS = {
    "compile": ("compile-error",),
    "dispatch": ("dispatch-hang", "device-oom"),
    "result": ("nan-result", "garbage-result"),
    "staging": ("staging-corruption",),
}


class InjectedDeviceError(RuntimeError):
    """Carrier for injected compile/OOM failures — shaped like the
    RuntimeError XLA raises, distinguishable in fault-domain tests."""


@dataclass(frozen=True)
class DeviceFault:
    """One scripted device-path failure.

    kind:
      * ``"compile-error"``       — AOTCache.compile raises (miscompile/XLA abort)
      * ``"dispatch-hang"``       — the dispatched buffer stays un-ready for
        ``hang_s`` seconds (inf = forever; the dispatch deadline must rescue)
      * ``"device-oom"``          — the dispatch raises RESOURCE_EXHAUSTED
      * ``"nan-result"``          — the kernel answer's costs come back non-finite
      * ``"garbage-result"``      — the assignment counts come back corrupted
        (a plausible-shaped but invalid plan — the validator must catch it)
      * ``"staging-corruption"``  — one staged problem tensor is perturbed on
        its way to the device (the plan solves a DIFFERENT problem)
    """

    kind: str = "garbage-result"
    hang_s: float = float("inf")
    reason: str = "injected"

    @property
    def site(self) -> str:
        for site, kinds in DEVICE_KINDS.items():
            if self.kind in kinds:
                return site
        raise ValueError(f"unknown device fault kind {self.kind!r}")


class DeviceFaultPlan:
    """Scripted per-site device-fault queues, with optional timed arming.

    ``script(faults)`` appends to each fault's site queue (consumed in
    order by the solver seams via :func:`device_fault`); ``at(t, fault)``
    schedules a fault to ARM ``t`` seconds after :meth:`start` — the soak's
    wall-clock bursts. ``log``/``timeline`` record firings like FaultPlan's.
    """

    def __init__(
        self,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._queues: Dict[str, List[DeviceFault]] = {s: [] for s in DEVICE_SITES}
        self._timed: List[Tuple[float, DeviceFault]] = []
        self._lock = threading.Lock()
        self.sleep = sleep
        self.clock = clock
        self._t0: Optional[float] = None
        self.log: List[Tuple[str, DeviceFault]] = []
        self.timeline: List[Tuple[float, str, DeviceFault]] = []

    # -- building -----------------------------------------------------------
    def script(self, faults: Sequence[DeviceFault]) -> "DeviceFaultPlan":
        with self._lock:
            for f in faults:
                self._queues[f.site].append(f)
        return self

    def compile_error(self, n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="compile-error")] * n)

    def dispatch_hang(self, seconds: float = float("inf"), n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="dispatch-hang", hang_s=seconds)] * n)

    def device_oom(self, n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="device-oom")] * n)

    def nan_result(self, n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="nan-result")] * n)

    def garbage_result(self, n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="garbage-result")] * n)

    def staging_corruption(self, n: int = 1) -> "DeviceFaultPlan":
        return self.script([DeviceFault(kind="staging-corruption")] * n)

    def at(self, t: float, fault: DeviceFault) -> "DeviceFaultPlan":
        """Arm ``fault`` ``t`` seconds after :meth:`start` — it joins its
        site's queue the first time the elapsed clock passes ``t``."""
        with self._lock:
            self._timed.append((t, fault))
            self._timed.sort(key=lambda e: e[0])
        return self

    def start(self) -> "DeviceFaultPlan":
        with self._lock:
            self._t0 = self.clock()
        return self

    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return self.clock() - self._t0

    # -- consumption --------------------------------------------------------
    def next(self, site: str) -> Optional[DeviceFault]:
        """Pop the next scripted fault for ``site``; None when drained.
        Timed entries whose offset has elapsed arm into their queues first."""
        if site not in DEVICE_SITES:
            raise ValueError(f"unknown device fault site {site!r}")
        with self._lock:
            if self._timed and self._t0 is not None:
                now = self.clock() - self._t0
                while self._timed and self._timed[0][0] <= now:
                    _, fault = self._timed.pop(0)
                    self._queues[fault.site].append(fault)
            queue = self._queues[site]
            if not queue:
                return None
            fault = queue.pop(0)
            self.log.append((site, fault))
            self.timeline.append((self.elapsed(), site, fault))
            return fault

    def pending(self, site: Optional[str] = None) -> int:
        with self._lock:
            timed = len(self._timed) if site is None else sum(
                1 for _, f in self._timed if f.site == site
            )
            if site is not None:
                return len(self._queues[site]) + timed
            return sum(len(q) for q in self._queues.values()) + timed

    def clear(self, site: Optional[str] = None) -> int:
        """Drop un-fired faults (one site, or everything incl. timed
        entries); returns how many were dropped. The firing log survives."""
        with self._lock:
            if site is not None:
                dropped = len(self._queues[site])
                dropped += sum(1 for _, f in self._timed if f.site == site)
                self._queues[site] = []
                self._timed = [e for e in self._timed if e[1].site != site]
                return dropped
            dropped = sum(len(q) for q in self._queues.values()) + len(self._timed)
            for q in self._queues.values():
                q.clear()
            self._timed.clear()
            return dropped

    # -- wire format (settings/env plumbing for the soak operator) ----------
    def serialize(self) -> str:
        """``t=SECONDS,kind=KIND[,n=N][,hang=S]`` entries joined by ``;`` —
        the shape :meth:`parse` reads back (timed entries only: the soak
        hands a full timeline to a freshly spawned operator process)."""
        with self._lock:
            parts = []
            for t, f in self._timed:
                p = f"t={t:g},kind={f.kind}"
                if f.kind == "dispatch-hang" and f.hang_s != float("inf"):
                    p += f",hang={f.hang_s:g}"
                parts.append(p)
            return ";".join(parts)

    @classmethod
    def parse(cls, script: str) -> "DeviceFaultPlan":
        """Inverse of :meth:`serialize`; ``n=`` repeats an entry. Raises on
        malformed input — a silently dropped chaos script is worse than a
        loud boot failure."""
        plan = cls()
        for part in filter(None, (p.strip() for p in script.split(";"))):
            kv = dict(
                item.split("=", 1) for item in part.split(",") if "=" in item
            )
            if "kind" not in kv:
                raise ValueError(f"device fault entry missing kind=: {part!r}")
            fault = DeviceFault(
                kind=kv["kind"],
                hang_s=float(kv.get("hang", "inf")),
            )
            fault.site  # validate the kind loudly at parse time
            t = float(kv.get("t", "0"))
            for _ in range(int(kv.get("n", "1"))):
                plan.at(t, fault)
        return plan


#: the process-global injection point the solver seams consult; None (the
#: production state) short-circuits every seam to a single attribute read
_DEVICE_PLAN: Optional[DeviceFaultPlan] = None


def install_device_faults(plan: Optional[DeviceFaultPlan]) -> Optional[DeviceFaultPlan]:
    """Install (or, with None, remove) the process-global device-fault plan;
    returns the previous one. The plan's timed entries arm from install."""
    global _DEVICE_PLAN
    previous = _DEVICE_PLAN
    _DEVICE_PLAN = plan
    if plan is not None:
        plan.start()
    return previous


def device_fault(site: str) -> Optional[DeviceFault]:
    """The solver seams' accessor: pop the next scripted fault for ``site``
    (None when no plan is installed or its queue is drained)."""
    plan = _DEVICE_PLAN
    if plan is None:
        return None
    return plan.next(site)


class ScriptedTransport:
    """A fake HTTP transport for the client retry tests: wraps a real
    transport callable and applies a FaultPlan in front of it, raising the
    wire-shaped exceptions a urllib transport would (HTTPError for status
    faults, URLError for connection faults) — so ``HTTPCloudProvider._call``
    and ``HTTPCluster._call`` exercise their true classification paths
    without a flaky server."""

    def __init__(self, plan: FaultPlan, inner: Callable[..., dict]):
        self.plan = plan
        self.inner = inner
        self.calls: List[str] = []

    def __call__(self, *args, **kwargs):
        endpoint = _endpoint_of(args)
        self.calls.append(endpoint)
        fault = self.plan.next(endpoint)
        if fault is not None:
            if fault.kind == "latency":
                if fault.latency_s > 0:
                    self.plan.sleep(fault.latency_s)
            elif fault.status == 0:
                raise urllib.error.URLError("injected connection failure")
            else:
                raise urllib.error.HTTPError(
                    endpoint, fault.status, fault.reason, hdrs=None, fp=None
                )
        return self.inner(*args, **kwargs)


def _endpoint_of(args: tuple) -> str:
    """The path-like positional arg: transports are called (path, body) or
    (method, path, body)."""
    for a in args:
        if isinstance(a, str) and a.startswith("/"):
            return a.split("?", 1)[0]
    return args[0] if args else ""
