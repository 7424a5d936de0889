"""ChurnScript: one deterministic, seedable timeline for every chaos input.

The port's copy of the JAX package's ``soak/churn.py``, unchanged in what
it computes: the timelines are pure functions of their arguments, so the
two packages derive the same events, device-fault script and federation
storm from the same seed.

``utils/faults.py`` scripts per-endpoint RPC faults (``FaultPlan``) and
round-keyed capacity events (``InterruptionSchedule``) — but they share no
clock and no RNG, so composing "an ICE wave while a reclaim storm runs and
the apiserver restarts" would mean three ad-hoc schedules that could never
be replayed as one experiment. ``ChurnScript`` unifies them into a single
time-keyed event timeline with ONE seeded ``random.Random`` and ONE
injected clock:

* every event kind the soak drives — deploy scale-ups/downs, spot-reclaim
  waves, ICE waves, node drift, price spikes, RPC fault bursts, apiserver
  listener restarts, operator SIGKILL/SIGTERM+restart — is a
  :class:`ChurnEvent` at a timeline offset;
* ``generate(seed, ...)`` derives the whole timeline from the seed, so an
  identical seed reproduces an identical event sequence across the bench,
  the ``python -m karpenter_tpu_torch.soak`` CLI, and any re-run triaging a
  replayed capsule;
* the script OWNS the fault surfaces it feeds: ``script.faults`` is a
  :class:`~karpenter_tpu_torch.utils.faults.FaultPlan` bound to the script clock
  (fired faults land on the same time axis as everything else), and
  ``interruption_schedule()`` projects the reclaim/price events onto the
  round-keyed ``InterruptionSchedule`` shape its consumers expect.

The harness (``soak/harness.py``) walks the timeline against wall-clock and
translates events into real-HTTP operations; this module never talks to the
network — it is the pure, reproducible half of the soak.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..utils.faults import (
    FaultPlan,
    InterruptionSchedule,
    PriceSpike,
    ReclaimWave,
)

#: every event kind the timeline DSL knows; the harness refuses unknown
#: kinds loudly rather than silently dropping scripted chaos
KINDS = (
    "deploy-up",        # create `replicas` pods for a fresh app
    "deploy-down",      # delete every pod of an existing app
    "reclaim-wave",     # mark a fraction of a pool's nodes for deletion
    "ice-start",        # mask a capacity pool (cloud-side ICE)
    "ice-end",          # unmask it again
    "drift",            # touch labels on k nodes (watch-stream churn)
    "price-spike",      # multiply a spot pool's live price
    "rpc-fault-burst",  # script N transient errors on a cloud endpoint
    "device-fault-burst",  # script N device-path faults in the operator's solver
    "apiserver-restart",  # bounce the apiserver listener (store survives)
    "operator-restart",   # SIGKILL (crash) or SIGTERM (clean) + respawn
    # federation fault domain (federation/fleet.py consumes these): regional
    # compute loss vs. control-plane partition are DIFFERENT failures — a
    # blackout loses the gangs (whole-gang failover fires), a partition only
    # degrades the arbiter link (region schedules locally, keeps its gangs)
    "region-blackout",      # a whole region's compute goes dark
    "region-heal",          # the blacked-out region rejoins empty
    "arbiter-partition",    # a region loses its arbiter link (compute fine)
    "arbiter-heal",         # the partitioned link recovers
    "regional-spot-storm",  # reclaim a fraction of ONE region's spot nodes
)


@dataclass(frozen=True)
class ChurnEvent:
    """One scripted chaos event at timeline offset ``t`` (seconds from soak
    start). ``params`` is a sorted tuple of (key, value) pairs so events are
    hashable/comparable; ``weight`` is how many unit events this one counts
    for in the aggregate churn rate (a 25-replica deploy-up is 25 events)."""

    t: float
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()
    weight: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown churn event kind {self.kind!r}")

    def get(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def to_dict(self) -> Dict:
        return {"t": round(self.t, 4), "kind": self.kind,
                "weight": self.weight, **dict(self.params)}


def _params(**kw) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(kw.items()))


class ChurnScript:
    """An ordered chaos timeline plus the unified fault surfaces.

    Build one by hand (``script.add(...)`` / the ``at()`` builder) for
    targeted scenarios, or derive a full soak from a seed with
    :meth:`generate`. ``start()`` pins the timeline to the injected clock;
    ``due()`` then yields events whose offset has elapsed, exactly once, in
    timeline order. ``log`` records (fire wall-offset, event) for every
    event handed out — the same shape FaultPlan/InterruptionSchedule keep.
    """

    def __init__(
        self,
        events: Sequence[ChurnEvent] = (),
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock
        self.events: List[ChurnEvent] = sorted(events, key=lambda e: (e.t, e.kind))
        self.log: List[Tuple[float, ChurnEvent]] = []
        self._cursor = 0
        self._t0: Optional[float] = None
        # the unified RPC fault surface: scripted bursts land here AND the
        # plan stamps its own firings on the script clock, so "which fault
        # fired when" reads off one axis
        self.faults = FaultPlan(clock=self.elapsed)

    # -- clock ---------------------------------------------------------------
    def start(self) -> "ChurnScript":
        self._t0 = self.clock()
        return self

    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return self.clock() - self._t0

    # -- building ------------------------------------------------------------
    def add(self, event: ChurnEvent) -> "ChurnScript":
        self.events.append(event)
        self.events.sort(key=lambda e: (e.t, e.kind))
        return self

    class _At:
        def __init__(self, script: "ChurnScript", t: float):
            self._script, self._t = script, t

        def _add(self, kind: str, weight: int = 1, **kw) -> "ChurnScript":
            return self._script.add(
                ChurnEvent(t=self._t, kind=kind, params=_params(**kw), weight=weight)
            )

        def deploy_up(self, app: str, replicas: int, cpu: str = "100m",
                      memory: str = "128Mi") -> "ChurnScript":
            return self._add("deploy-up", weight=replicas, app=app,
                             replicas=replicas, cpu=cpu, memory=memory)

        def deploy_down(self, app: str, replicas: int) -> "ChurnScript":
            return self._add("deploy-down", weight=replicas, app=app)

        def reclaim_wave(self, pool=("*", "*", "*"), fraction: float = 0.25) -> "ChurnScript":
            return self._add("reclaim-wave", pool=tuple(pool), fraction=fraction)

        def ice(self, pool, duration_s: float) -> "ChurnScript":
            self._add("ice-start", pool=tuple(pool))
            return self._script.add(ChurnEvent(
                t=self._t + duration_s, kind="ice-end",
                params=_params(pool=tuple(pool)),
            ))

        def drift(self, nodes: int = 1) -> "ChurnScript":
            return self._add("drift", nodes=nodes)

        def price_spike(self, instance_type: str = "*", zone: str = "*",
                        factor: float = 2.0) -> "ChurnScript":
            return self._add("price-spike", instance_type=instance_type,
                             zone=zone, factor=factor)

        def rpc_fault_burst(self, endpoint: str, n: int = 3,
                            status: int = 503) -> "ChurnScript":
            return self._add("rpc-fault-burst", endpoint=endpoint, n=n,
                             status=status)

        def device_fault_burst(self, fault_kind: str = "garbage-result",
                               n: int = 2) -> "ChurnScript":
            return self._add("device-fault-burst", fault_kind=fault_kind, n=n)

        def apiserver_restart(self) -> "ChurnScript":
            return self._add("apiserver-restart")

        def operator_restart(self, signal: str = "kill") -> "ChurnScript":
            return self._add("operator-restart", signal=signal)

        def region_blackout(self, region: str, duration_s: float) -> "ChurnScript":
            self._add("region-blackout", region=region)
            return self._script.add(ChurnEvent(
                t=self._t + duration_s, kind="region-heal",
                params=_params(region=region),
            ))

        def arbiter_partition(self, region: str, duration_s: float) -> "ChurnScript":
            self._add("arbiter-partition", region=region)
            return self._script.add(ChurnEvent(
                t=self._t + duration_s, kind="arbiter-heal",
                params=_params(region=region),
            ))

        def regional_spot_storm(self, region: str,
                                fraction: float = 0.5) -> "ChurnScript":
            return self._add("regional-spot-storm", region=region,
                             fraction=fraction)

    def at(self, t: float) -> "_At":
        return self._At(self, t)

    # -- consumption ---------------------------------------------------------
    def due(self, now: Optional[float] = None) -> Iterator[ChurnEvent]:
        """Yield (exactly once, in order) every event whose offset has
        elapsed. ``now`` defaults to the script clock; pass an explicit
        offset for clock-free tests."""
        if now is None:
            now = self.elapsed()
        while self._cursor < len(self.events):
            event = self.events[self._cursor]
            if event.t > now:
                return
            self._cursor += 1
            self.log.append((now, event))
            yield event

    def pending(self) -> int:
        return len(self.events) - self._cursor

    def last_t(self) -> float:
        return self.events[-1].t if self.events else 0.0

    def total_weight(self) -> int:
        return sum(e.weight for e in self.events)

    def summary(self) -> Dict:
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        return {
            "seed": self.seed,
            "events": len(self.events),
            "weight": self.total_weight(),
            "by_kind": dict(sorted(by_kind.items())),
            "span_s": round(self.last_t(), 3),
        }

    def device_fault_script(self) -> str:
        """The timeline's device-fault bursts in ``DeviceFaultPlan.parse``
        wire format (settings.device_fault_script): the soak harness hands
        it to the spawned operator process, whose solver seams consume the
        faults — device chaos cannot be injected over HTTP, it lives inside
        the solver's address space."""
        parts = []
        for e in self.events:
            if e.kind != "device-fault-burst":
                continue
            parts.append(
                f"t={e.t:g},kind={e.get('fault_kind', 'garbage-result')}"
                f",n={int(e.get('n', 1))}"
            )
        return ";".join(parts)

    # -- projections onto the legacy fault shapes ----------------------------
    def interruption_schedule(self, round_s: float = 1.0) -> InterruptionSchedule:
        """Project reclaim/price events onto the round-keyed
        ``InterruptionSchedule`` (round = floor(t / round_s)), sharing the
        script clock — round-driven consumers (the spot_churn bench loop)
        consume the same timeline the wall-clock harness drives."""
        waves = [
            ReclaimWave(
                round_no=int(e.t // round_s),
                pool=tuple(e.get("pool", ("*", "*", "*"))),
                fraction=float(e.get("fraction", 1.0)),
            )
            for e in self.events if e.kind == "reclaim-wave"
        ]
        spikes = [
            PriceSpike(
                round_no=int(e.t // round_s),
                instance_type=str(e.get("instance_type", "*")),
                zone=str(e.get("zone", "*")),
                factor=float(e.get("factor", 1.0)),
            )
            for e in self.events if e.kind == "price-spike"
        ]
        return InterruptionSchedule(waves=waves, spikes=spikes, clock=self.elapsed)

    # -- seeded generation ---------------------------------------------------
    @classmethod
    def generate(
        cls,
        seed: int,
        duration_s: float,
        rate_hz: float = 1000.0,
        live_pods: int = 300,
        replica_range: Tuple[int, int] = (10, 30),
        zones: Sequence[str] = ("zone-a", "zone-b", "zone-c"),
        reclaim_every_s: float = 15.0,
        ice_every_s: float = 20.0,
        ice_duration_s: Tuple[float, float] = (3.0, 8.0),
        drift_every_s: float = 2.0,
        spike_every_s: float = 25.0,
        rpc_burst_every_s: float = 10.0,
        device_fault_every_s: float = 20.0,
        operator_restarts: Sequence[Tuple[float, str]] = ((0.35, "kill"),),
        apiserver_restarts: Sequence[float] = (0.65,),
        clock: Callable[[], float] = time.monotonic,
    ) -> "ChurnScript":
        """Derive a full soak timeline from ``seed``. Everything below is a
        pure function of the arguments: the pod-churn schedule keeps the live
        population near ``live_pods`` while emitting ~``rate_hz`` unit events
        per second; waves/bursts recur on their cadences with seeded jitter;
        ``operator_restarts``/``apiserver_restarts`` are fractions of the
        duration (the scaled soak runs at least one of each)."""
        rng = random.Random(seed)
        events: List[ChurnEvent] = []
        lo, hi = replica_range

        # pod churn: per-second budget of `rate_hz` unit events, spent on
        # deploy scale-ups/downs that hold the live population near target.
        # ``live`` tracks each app's up-event time: a scale-down drawn in
        # the same second as its app's scale-up must be scheduled strictly
        # AFTER it (independent sub-second jitters could order the delete
        # first, making it a no-op and leaking the app's pods forever —
        # the generator's population bookkeeping would silently diverge
        # from what the harness actually applies).
        app_seq = 0
        live: Dict[str, Tuple[int, float]] = {}  # app -> (replicas, t_up)
        live_count = 0
        for sec in range(int(math.ceil(duration_s))):
            budget = rate_hz
            while budget > 0:
                scale_up = (
                    live_count < live_pods * 0.8
                    or (live_count <= live_pods * 1.2 and rng.random() < 0.5)
                    or not live
                )
                if scale_up:
                    replicas = rng.randint(lo, hi)
                    app = f"app-{seed:x}-{app_seq:04d}"
                    app_seq += 1
                    t_up = sec + rng.random()
                    live[app] = (replicas, t_up)
                    live_count += replicas
                    events.append(ChurnEvent(
                        t=t_up, kind="deploy-up", weight=replicas,
                        params=_params(app=app, replicas=replicas,
                                       cpu="100m", memory="128Mi"),
                    ))
                    budget -= replicas
                else:
                    app = rng.choice(sorted(live))
                    replicas, t_up = live.pop(app)
                    live_count -= replicas
                    # a quarter second past the up-event also gives the
                    # harness's create ops time to drain ahead of the
                    # deletes at realistic injector rates
                    t_down = max(sec + rng.random(), t_up + 0.25)
                    events.append(ChurnEvent(
                        t=t_down, kind="deploy-down",
                        weight=replicas, params=_params(app=app),
                    ))
                    budget -= replicas

        def cadence(every_s: float) -> List[float]:
            if every_s <= 0:
                return []
            out, t = [], every_s * rng.uniform(0.5, 1.0)
            while t < duration_s:
                out.append(t)
                t += every_s * rng.uniform(0.8, 1.2)
            return out

        for t in cadence(reclaim_every_s):
            pool = ("*", rng.choice(list(zones)), "*") if rng.random() < 0.7 else ("*", "*", "*")
            events.append(ChurnEvent(
                t=t, kind="reclaim-wave",
                params=_params(pool=pool, fraction=round(rng.uniform(0.15, 0.35), 3)),
            ))
        for t in cadence(ice_every_s):
            pool = ("*", rng.choice(list(zones)), rng.choice(["on-demand", "spot"]))
            end = t + rng.uniform(*ice_duration_s)
            events.append(ChurnEvent(t=t, kind="ice-start", params=_params(pool=pool)))
            events.append(ChurnEvent(t=end, kind="ice-end", params=_params(pool=pool)))
        for t in cadence(drift_every_s):
            events.append(ChurnEvent(
                t=t, kind="drift", params=_params(nodes=rng.randint(1, 3)),
            ))
        for t in cadence(spike_every_s):
            events.append(ChurnEvent(
                t=t, kind="price-spike",
                params=_params(instance_type="*", zone=rng.choice(list(zones)),
                               factor=round(rng.uniform(1.5, 4.0), 3)),
            ))
        for t in cadence(rpc_burst_every_s):
            events.append(ChurnEvent(
                t=t, kind="rpc-fault-burst",
                params=_params(
                    endpoint=rng.choice(
                        ["/v1/run-instances", "/v1/describe", "/v1/instance-types"]
                    ),
                    n=rng.randint(2, 4),
                    status=rng.choice([500, 503, 0]),
                ),
            ))
        for t in cadence(device_fault_every_s):
            # device-path chaos rides the same timeline: the harness hands
            # these to the operator as its settings.device_fault_script, so
            # the solver seams fire them by wall-clock inside that process
            events.append(ChurnEvent(
                t=t, kind="device-fault-burst",
                params=_params(
                    fault_kind=rng.choice([
                        "garbage-result", "nan-result", "compile-error",
                        "device-oom", "staging-corruption",
                    ]),
                    n=rng.randint(1, 3),
                ),
            ))
        for frac, sig in operator_restarts:
            events.append(ChurnEvent(
                t=duration_s * frac, kind="operator-restart",
                params=_params(signal=sig),
            ))
        for frac in apiserver_restarts:
            events.append(ChurnEvent(t=duration_s * frac, kind="apiserver-restart"))
        return cls(events=events, seed=seed, clock=clock)


def federation_storm_script(
    storm_region: str,
    blackout_region: str,
    partition_region: str,
    round_s: float = 10.0,
    rounds: int = 12,
    storm_fraction: float = 0.5,
    clock: Callable[[], float] = time.monotonic,
) -> ChurnScript:
    """The canonical federation survivability timeline — deterministic and
    seedless (every offset is a pure function of the arguments), so the bench
    and a triage re-run drive identical fault sequences. One pass exercises
    every federation fault kind: an arbiter partition (degraded-local rounds)
    that heals, a regional spot storm, and a full region blackout held long
    enough for the staleness sweep to declare it lost and fail its gangs over
    whole, then a heal so post-heal rounds (epoch-bumped rejoin) are captured
    too."""
    span = round_s * rounds
    script = ChurnScript(clock=clock)
    # partition early: degraded rounds must appear BEFORE the blackout so the
    # capture window holds both failure shapes independently
    script.at(round_s * 1).arbiter_partition(partition_region,
                                             duration_s=round_s * 2)
    script.at(round_s * 4).regional_spot_storm(storm_region,
                                               fraction=storm_fraction)
    # hold the blackout past the staleness sweep (fleet summary_stale_s is
    # under 2 rounds) so the arbiter declares the region lost and the
    # whole-gang failover fires, then heal with rounds to spare
    script.at(round_s * 5).region_blackout(blackout_region,
                                           duration_s=round_s * 4)
    if script.last_t() >= span:
        raise ValueError(
            f"federation storm timeline ({script.last_t():g}s) does not fit "
            f"in {rounds} rounds of {round_s:g}s — raise `rounds`"
        )
    return script
