"""The operator: wires every controller and runs the reconcile loops.

The analogue of the reference's entry point (``upstream cmd/controller/
main.go:33-71``): build the provider context, construct the cloud provider,
register core controllers (provisioning, deprovisioning, termination) and the
provider-side controllers (interruption, nodetemplate, drift, GC), then run.

``step()`` advances every loop once in dependency order (useful for tests and
simulations); ``run()`` drives them continuously with the reference's cadences
(provisioning batched 1s/10s; nodetemplate and GC every 5m; interruption as a
fast poll — SURVEY §2.1 rows).

Differences from the reference, each also listed in ``ROADMAP.md``'s
deliberate differences or under the Queue 1 item that brings what is missing:

* The default solver is ``TorchSolver`` on the card (``device="cuda"``, or
  the caller's ``device``); it raises without CUDA and never falls back to
  the CPU. Its stager takes ``device_staging_enabled`` and
  ``device_staging_capacity_mb``.
* No AOT cache and no pre-compile: the reference's ``AOT_CACHE.configure``
  and its ``drain-background-compiles`` shutdown step have no counterpart,
  since the port compiles nothing per shape (its kernel library is loaded
  in ``TorchSolver.__init__``). The ``aot_*`` settings are accepted,
  validated and unread.
* Left out: ``profiling.configure``, ``sentinel_tick`` and the
  ``stop-profiler`` step (the profiler, item 9).
  ``profiling_enabled=True`` makes ``new`` raise; ``perf_sentinel_enabled``
  has no effect until item 9.
* Federation (item 9) and the multi-device tier (item 10) raise in the
  provisioning controller's constructor, as in earlier slices.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .api.settings import Settings
from .cloudprovider.fake import FakeCloudProvider
from .cloudprovider.interface import CloudProvider
from .controllers.deprovisioning import DeprovisioningController
from .controllers.drift import DriftController
from .controllers.garbagecollect import GarbageCollectionController
from .controllers.interruption import FakeQueue, InterruptionController
from .controllers.metricsscraper import build_scrapers
from .controllers.nodetemplate import NodeTemplateController
from .controllers.provisioning import ProvisioningController
from .controllers.termination import TerminationController
from .solver.solver import Solver, TorchSolver
from .state.cluster import Cluster
from .utils.cache import Clock
from .utils.events import Recorder


@dataclass
class Operator:
    cluster: Cluster
    provider: CloudProvider
    settings: Settings
    recorder: Recorder
    provisioning: ProvisioningController
    termination: TerminationController
    deprovisioning: DeprovisioningController
    interruption: Optional[InterruptionController]
    nodetemplate: Optional[NodeTemplateController]
    drift: DriftController
    garbagecollect: GarbageCollectionController
    pricing: Optional[object] = None
    # federation arbiter link: the reference builds it when
    # settings.federation_enabled; federation is not ported (Queue 1 item
    # 9), and the provisioning controller refuses the setting, so it stays
    # None
    federation: Optional[object] = None
    # cost ledger (utils/costledger.py), present only when
    # settings.cost_ledger_enabled and the provider serves a price book:
    # meters realized spend from watch events, feeds the cost metrics via
    # the registry refresher, /debug/costs, and the federation summary
    costledger: Optional[object] = None
    clock: Clock = field(default_factory=Clock)
    # state-observability scrapers (controllers/metricsscraper): periodic
    # cluster-state -> gauge controllers on the operator loop
    scrapers: List[object] = field(default_factory=list)
    # leader elector (utils/leaderelection.py) adopted from the entrypoint:
    # close() releases the lease as part of the ordered shutdown so a
    # SIGTERM'd leader hands over immediately instead of making the standby
    # wait out the lease TTL (only SIGKILL should cost the TTL)
    elector: Optional[object] = None

    @staticmethod
    def new(
        provider: Optional[CloudProvider] = None,
        settings: Optional[Settings] = None,
        solver: Optional[Solver] = None,
        queue: Optional[FakeQueue] = None,
        clock: Optional[Clock] = None,
        cluster: Optional[Cluster] = None,
        device: str = "cuda",
    ) -> "Operator":
        """``cluster`` defaults to the in-process store; pass an
        ``HTTPCluster`` to run every controller against the apiserver wire
        surface (reads from the informer cache, writes + admission over
        HTTP). ``device`` places the default solver, which is built only
        when no ``solver`` is given: the card unless the caller asks for the
        CPU (the port's addition; the reference has no such argument)."""
        settings = settings or Settings()
        settings.validate()
        if settings.profiling_enabled:
            # the continuous profiler, tracemalloc's top allocators and the
            # perf sentinel come together with the profiler module
            raise NotImplementedError(
                "profilingEnabled: the profiler is not ported yet "
                "(ROADMAP.md, Queue 1 item 9)"
            )
        clock = clock or Clock()
        cluster = cluster if cluster is not None else Cluster()
        provider = provider or FakeCloudProvider()
        if getattr(provider, "node_template_lookup", "absent") is None:
            # let the cloud provider resolve NodeTemplate refs at launch time
            # (the reference fetches the AWSNodeTemplate by ref inside Create)
            provider.node_template_lookup = cluster.node_templates.get
        if getattr(provider, "unavailable_offerings", None) is not None:
            # settings own the ICE TTL (reference: 3m, cache.go:20-36)
            provider.unavailable_offerings.set_ttl(settings.insufficient_capacity_ttl)
        recorder = Recorder()
        # decision audit ring sized from settings (0 disables recording)
        from .utils.decisions import DECISIONS

        DECISIONS.configure(settings.decision_log_capacity)
        # reconcile flight recorder: capsule ring capacity + anomaly dump
        # target from settings (0 disables capture entirely)
        from .utils.flightrecorder import FLIGHT

        FLIGHT.configure(
            settings.flight_recorder_capacity,
            dump_dir=settings.flight_recorder_dump_dir or None,
        )
        # pod-lifecycle attribution tracker + SLO burn-rate engine (both
        # process-global like DECISIONS/FLIGHT): the tracker stamps per-pod
        # stage waterfalls, completions feed the pod_ready objective, and a
        # pre-scrape refresher exports the burn/budget gauges
        from .utils import slo
        from .utils.lifecycle import LIFECYCLE

        LIFECYCLE.configure(
            enabled=settings.lifecycle_tracking_enabled,
            retention=settings.lifecycle_retention,
        )
        slo.SLO.configure({
            "pod_ready_p99": (
                settings.slo_pod_ready_p99_s,
                settings.slo_pod_ready_target_frac,
            ),
        })
        slo.install_exporter()
        # risk-aware spot capacity pools: the risk cache feeds offering
        # interruption probabilities (provider stamping), the solver's risk
        # penalty, and the rebalance controller's pool choices
        risk_cache = None
        if settings.spot_enabled:
            from .utils.riskcache import InterruptionRiskCache

            risk_cache = InterruptionRiskCache(
                halflife_s=settings.risk_decay_halflife_s, clock=clock
            )
            if hasattr(provider, "attach_risk_cache"):
                provider.attach_risk_cache(risk_cache)
        # TPU slice topology: a provider that can synthesize ICI-coordinate
        # offerings (the fake; a real TPU API serves them natively and the
        # HTTP provider gets them from its server's catalog) expands its
        # catalog so the gang gate's adjacency machinery has coordinates to
        # score. Sliceless providers degrade to the zone-granular gate.
        if settings.slice_topology_enabled and hasattr(
            provider, "enable_slice_topology"
        ):
            provider.enable_slice_topology()
        # No AOT cache and no mesh: the reference configures its AOT
        # executable cache here and resolves the 2D mesh shape. The port
        # compiles nothing per shape (the kernel library is loaded in
        # TorchSolver.__init__), so the aot_* settings are read by nothing;
        # mesh_enabled makes the provisioning controller raise (Queue 1 item
        # 10).
        if solver is None:
            solver = TorchSolver(
                dispatch_timeout_s=settings.kernel_dispatch_timeout_s,
                device=device,
            )
            # the reference's solver takes these in its constructor
            solver._stager.enabled = settings.device_staging_enabled
            solver._stager.capacity_bytes = int(settings.device_staging_capacity_mb) << 20
        # kernel-backend circuit breaker thresholds (process-global board —
        # sweep worker clones share its quarantines)
        from .solver.solver import KERNEL_BOARD

        KERNEL_BOARD.configure(
            failure_threshold=settings.kernel_breaker_failure_threshold,
        )
        # the reference arms a scripted device-fault timeline here from
        # settings.device_fault_script; the port's solver has no fault seams
        # yet, so Settings.validate refused a script above (Queue 1 item 4)
        provisioning = ProvisioningController(
            cluster, provider, solver=solver, settings=settings, recorder=recorder
        )
        # runtime-health gauges: process RSS always; tracemalloc top
        # allocators only when the (costly) profiling setting asks for it.
        # The {cell}-aware memory scrape installs ONLY under cell sharding —
        # flat-mode metric series stay byte-identical (no dashboard breakage)
        from .utils import runtimehealth

        runtimehealth.install(
            memory_profiling=settings.profiling_enabled,
            cell_bytes=(
                provisioning.cell_memory_bytes
                if settings.cell_sharding_enabled
                else None
            ),
        )
        # the reference configures its continuous profiler and the
        # perf-regression sentinel here (profiling.configure); neither is
        # ported (Queue 1 item 9): profiling_enabled raised above, and
        # perf_sentinel_enabled (default on) has no effect until then
        termination = TerminationController(cluster, provider, recorder=recorder, clock=clock)
        deprovisioning = DeprovisioningController(
            cluster, provider, termination, solver=solver, settings=settings,
            recorder=recorder, clock=clock,
        )
        interruption = None
        if settings.interruption_queue_name is not None:
            # NOT `queue or FakeQueue()`: FakeQueue has __len__, so an empty
            # caller-supplied queue is falsy and would be silently replaced.
            # With no injected queue, a provider-served queue (the HTTP
            # cloud's /v1/queue SQS-analog) wins over a process-local fake:
            # notices then cross the same wire the launches do.
            if queue is None:
                queue = getattr(provider, "queue", None)
            interruption = InterruptionController(
                cluster, queue if queue is not None else FakeQueue(), termination,
                unavailable_offerings=getattr(provider, "unavailable_offerings", None),
                recorder=recorder,
                risk_cache=risk_cache,
                provisioning=provisioning,
                provider=provider if settings.spot_enabled else None,
                settings=settings,
                clock=clock,
            )
        nodetemplate = (
            NodeTemplateController(cluster, provider, recorder=recorder)
            if hasattr(provider, "describe_security_groups")
            else None
        )
        pricing = None
        if getattr(provider, "pricing", None) is not None:
            from .cloudprovider.pricing import PricingController

            pricing = PricingController(provider.pricing, clock=clock)
        costledger = None
        if settings.cost_ledger_enabled and getattr(provider, "pricing", None) is not None:
            from .utils import metrics as metrics_module
            from .utils.costledger import CostLedger

            costledger = CostLedger(
                cluster, provider.pricing, settings=settings, clock=clock
            ).attach()
            costledger.register_refresher(metrics_module.REGISTRY)
            # realized consolidation savings: the deprovisioner reports each
            # EXECUTED action; exactly-once reclaim losses: the interruption
            # controller reports next to its risk note (same late-bound hook
            # shape as the federation link)
            deprovisioning.costs = costledger
            if interruption is not None:
                interruption.costs = costledger
        # the reference builds its FederationClient here when
        # settings.federation_enabled; the provisioning controller above
        # already refused that setting (Queue 1 item 9)
        federation = None
        drift = DriftController(cluster, provider, settings=settings, recorder=recorder)
        garbagecollect = GarbageCollectionController(
            cluster, provider, recorder=recorder, clock=clock
        )
        return Operator(
            cluster=cluster,
            provider=provider,
            settings=settings,
            recorder=recorder,
            provisioning=provisioning,
            termination=termination,
            deprovisioning=deprovisioning,
            interruption=interruption,
            nodetemplate=nodetemplate,
            drift=drift,
            garbagecollect=garbagecollect,
            pricing=pricing,
            federation=federation,
            costledger=costledger,
            clock=clock,
            scrapers=build_scrapers(cluster),
        )

    # -- single synchronous pass over every loop (tests/simulation) --------
    def step(self) -> None:
        """Deprovisioning runs BEFORE provisioning so pods evicted by a replace
        action re-bind (onto the pre-launched replacement) in the same pass."""
        if self.interruption is not None:
            self.interruption.reconcile()
        if self.nodetemplate is not None:
            self.nodetemplate.reconcile()
        if self.pricing is not None:
            self.pricing.reconcile()
        self.drift.reconcile()
        self.deprovisioning.reconcile()
        self.provisioning.reconcile()
        # the reference ticks its perf sentinel here (Queue 1 item 9)
        self.termination.reconcile()
        self.garbagecollect.reconcile()
        for scraper in self.scrapers:
            scraper.scrape()

    # -- continuous run -----------------------------------------------------
    def run(
        self,
        stop: threading.Event,
        tick: float = 0.25,
        http_port: Optional[int] = None,
        http_server: Optional[object] = None,
    ) -> None:
        """Drive the loops until `stop` is set. Cadences follow the reference:
        provisioning honors its batch window; slow loops (nodetemplate 5m, GC 5m,
        drift 5m) tick on their own schedule. ``http_port`` serves /metrics,
        /healthz and /readyz for the lifetime of the loop (the reference's
        manager endpoints, cmd/controller/main.go:33-71); 0 picks a free port,
        exposed as ``self.http_server.port``. Alternatively pass an already
        started ``http_server`` (the entrypoint starts one before leader
        election so standbys answer probes); it is adopted and stopped here."""
        self.http_server = http_server
        if self.http_server is None and http_port is not None:
            from .utils.httpserver import OperatorHTTPServer

            self.http_server = OperatorHTTPServer(
                port=http_port, recorder=self.recorder
            ).start()
        elif self.http_server is not None and getattr(self.http_server, "recorder", None) is None:
            # adopted server (the entrypoint starts it before the operator
            # exists): late-bind the events recorder so /debug/events works
            self.http_server.recorder = self.recorder
        if self.http_server is not None and getattr(self.http_server, "cells", None) is None:
            # late-bind the sharded-control-plane partition view the same way
            self.http_server.cells = self.provisioning.cell_status
        # the reference late-binds /debug/federation to its federation
        # client here; federation is not ported, so the route serves
        # {"enabled": false}
        if (
            self.http_server is not None
            and getattr(self.http_server, "costs", None) is None
            and self.costledger is not None
        ):
            # /debug/costs serves the ledger's settled rollups
            self.http_server.costs = self.costledger.debug_payload
        try:
            self._run_loop(stop, tick)
        finally:
            self.close()

    def close(self) -> None:
        """Ordered shutdown. run() calls this on exit; step()-driven code
        (tests, simulations) should call it too — the cluster watch pins
        controllers against GC, so an unclosed worker pool outlives the
        operator object.

        The ordering is the SIGTERM contract the chaos soak exercises
        (SIGKILL skips all of it — that's the crash-restart path):

        1. join in-flight controller worker threads (the interruption
           pool) so no reconcile work mutates state mid-teardown;
        2. flush pending flight-recorder anomaly dumps — the post-mortem
           evidence must hit disk before the process is gone;
        3. release the leader lease so a standby takes over NOW, not after
           the lease TTL;
        4. LAST, release the HTTP port — probes stay answerable until the
           process truly has nothing left to report, and a crashed loop
           must never keep serving ready probes (or block a supervised
           restart with EADDRINUSE).

        The reference has two more steps, which the port leaves out: it
        stops the profiler first (Queue 1 item 9), and between 1 and 2 it
        drains its background XLA compiles (the port compiles nothing per
        shape, so there is nothing to drain).

        Every step is individually guarded: a failure in one must not skip
        the rest (previously only the port release was guarded) — and the
        whole sequence sits in a try/finally so even a BaseException (a
        second Ctrl-C landing while a step joins workers) cannot leave a
        dead loop serving ready probes or holding the port against a
        supervised restart."""
        import logging

        from .utils.logging import get_logger, kv

        log = get_logger("operator")

        def step(name, fn):
            # guarded but NEVER silent: a failure in the step that preserves
            # post-mortem evidence (flush_dumps) or hands over leadership
            # (lease release — the standby otherwise waits out the TTL)
            # must be visible in the logs, or the ordered-shutdown contract
            # is unverifiable
            try:
                fn()
            except Exception as e:
                kv(log, logging.WARNING, "shutdown step failed",
                   step=name, error=f"{type(e).__name__}: {e}")

        def _flush_capsules():
            from .utils.flightrecorder import FLIGHT

            FLIGHT.flush_dumps()

        try:
            if self.interruption is not None:
                step("join-interruption-workers",
                     lambda: self.interruption.close(wait=True))
            step("flush-flightrecorder-dumps", _flush_capsules)
            if self.elector is not None:
                step("release-leader-lease", self.elector.release)
        finally:
            # ALWAYS release the port, whatever the steps above did
            if getattr(self, "http_server", None) is not None:
                self.http_server.stop()

    def _run_loop(self, stop: threading.Event, tick: float) -> None:
        from .controllers.kit import SingletonController
        from .utils.gctuning import freeze_long_lived

        state = {"frozen": False, "last_retry": 0.0}

        def provision() -> None:
            # The batch window is the primary provisioning trigger: pod
            # arrivals (fresh or re-pending after eviction) arm it via watch
            # events, so batch_idle/batch_max govern continuous mode
            # (reference: batcher.Wait gates the provisioning loop, SURVEY
            # §3.2). The slow retry poll restores liveness for pods whose
            # batch already fired but could not be placed (launch failures,
            # ICE, no provisioner yet) — no watch event ever re-arms those
            # (reference analogue: workqueue requeue-with-backoff).
            now = time.monotonic()
            retry_due = False
            if now - state["last_retry"] >= 5.0:
                state["last_retry"] = now  # pace the pending_pods scan itself
                retry_due = bool(self.cluster.pending_pods())
            if self.provisioning.batcher.ready() or retry_due:
                self.provisioning.reconcile()
                # the reference ticks its perf sentinel here (item 9)
                if not state["frozen"]:
                    # freeze AFTER the first reconcile built the long-lived
                    # state (pods, nodes, encoder caches) so gen-2 GC scans
                    # exclude it — see utils/gctuning.py
                    freeze_long_lived()
                    state["frozen"] = True

        # Every loop runs through the controller kit: per-loop cadence
        # (reference: nodetemplate/drift/GC every 5m) and exponential error
        # backoff per controller — one crashing loop backs itself off instead
        # of killing the operator.
        controllers = [
            SingletonController("provisioning", provision),
            SingletonController("deprovisioning", self.deprovisioning.reconcile),
            SingletonController("termination", self.termination.reconcile),
        ]
        if self.interruption is not None:
            controllers.insert(
                0, SingletonController("interruption", self.interruption.reconcile)
            )
        if self.nodetemplate is not None:
            controllers.append(
                SingletonController(
                    "nodetemplate", self.nodetemplate.reconcile, interval=300.0
                )
            )
        if self.pricing is not None:
            controllers.append(
                SingletonController("pricing", self.pricing.reconcile, interval=300.0)
            )
        # the reference adds the federation-summary heartbeat here when a
        # federation client exists (Queue 1 item 9)
        controllers.append(SingletonController("drift", self.drift.reconcile, interval=300.0))
        controllers.append(
            SingletonController(
                "garbagecollect", self.garbagecollect.reconcile,
                interval=self.settings.garbage_collect_interval,
            )
        )
        # idle-window GC maintenance: run the full collection while idle (NOT
        # freeze — see gctuning.maintain) so the high-threshold auto gen-2
        # collection never fires mid-solve
        from .utils.gctuning import maintain as gc_maintain

        controllers.append(
            SingletonController("gcmaintain", gc_maintain, interval=60.0)
        )
        # state scrapers ride the kit like every loop (cadence + backoff +
        # reconcile metrics + correlation ids); the interval is the
        # reference's metrics-controller resync, tunable via settings
        for scraper in self.scrapers:
            controllers.append(
                SingletonController(
                    scraper.name, scraper.scrape,
                    interval=self.settings.metrics_scrape_interval,
                )
            )
        self.controllers = controllers
        while not stop.is_set():
            for c in controllers:
                c.run_if_due()
            stop.wait(tick)
