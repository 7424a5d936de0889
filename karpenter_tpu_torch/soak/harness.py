"""SoakHarness: drive the full real-HTTP stack through a ChurnScript.

Topology (the production shape, scaled to one box):

* the **apiserver** (``state/apiserver.py``) and the **cloud service**
  (``cloudprovider/httpcloud.py``) run in the harness process but serve
  REAL HTTP — every injected pod, node mutation and launch crosses the
  wire exactly as in the HA deployment;
* the **operator** runs as a genuinely separate process
  (``python -m karpenter_tpu_torch --cluster-endpoint ... --cloud-endpoint
  ... --device <SoakConfig.device>``)
  because it is the chaos target: the script SIGKILLs it mid-churn and the
  harness respawns it, exercising crash-restart re-adoption (relist-driven
  state rebuild, termination resuming mid-deletion nodes, GC adopting or
  collecting instances the crash orphaned);
* **apiserver restarts** bounce the HTTP listener over the SAME backing
  store (etcd persists through a kube-apiserver restart; the store is the
  etcd here) — clients see connection failures, then a fresh event-log
  incarnation that "gone"s their stale bookmarks into a relist.

The injector pool translates timeline events into HTTP operations (each
worker retries through server-restart windows); the
:class:`~karpenter_tpu_torch.soak.monitor.InvariantMonitor` watches everything
and renders the verdict. ``run_soak`` is the one-call entry that
``chip_smoke.py``, the tests and the CLI all share.

The port's differences from the reference's harness: ``SoakConfig.device``
(default ``cuda``, no fallback) places the operator's solver through its
``--device`` flag and the monitor's offline replay; the spawned operator's
environment carries no JAX platform and no AOT pre-compile switch, since
the port compiles nothing per shape. And an operator that exits before it
is ready (the first spawn or a respawn after a kill) is respawned after
``restart_delay_s``, up to ``BOOT_RESPAWNS`` times, as a Deployment
restarts a crashed pod: the operator's boot check fails fast by design
(``context.py``), so a scripted burst of 503s on ``/v1/instance-types``
at boot kills it. Each such respawn counts under ``restarts
["operator_boot_exit"]``; past the bound the soak fails with that reason.
The reference's harness never respawns it, and its soak then fails with
every later pod pending.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import labels as wk
from ..api.codec import to_wire
from ..api.objects import ObjectMeta, Pod, Provisioner, Resources
from ..utils.logging import get_logger
from .churn import ChurnScript
from .monitor import InvariantMonitor

_log = get_logger("soak")

#: respawns of an operator that exits before it is ready, per boot (the
#: port's addition; the module docstring)
BOOT_RESPAWNS = 3

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def calibrate_rate(
    target_hz: float = 1000.0,
    fraction: float = 0.25,
    sample: int = 200,
    threads: int = 4,
    floor_hz: float = 50.0,
) -> float:
    """Box-scaled churn rate: measure what this machine's apiserver can
    actually ingest over real HTTP (a throwaway in-process server, the
    injector's own POST path), then target a sustainable ``fraction`` of it,
    capped at ``target_hz``. The >=1k events/s target is a number for a
    large dedicated host: on a shared 1-core box the operator must ALSO fit on
    the measured core, and pinning the target rate there just proves the box
    is over capacity, not that the system leaks or stalls."""
    from ..state.apiserver import ClusterAPIServer

    api = ClusterAPIServer().start()
    try:
        port = api._server.server_address[1]
        per_thread = max(1, sample // threads)

        def worker(tid: int) -> None:
            for i in range(per_thread):
                pod = Pod(
                    meta=ObjectMeta(name=f"cal-{tid}-{i}"),
                    requests=Resources(cpu="50m", memory="32Mi"),
                )
                body = json.dumps(to_wire(pod)).encode()
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                    conn.request("POST", "/api/pods", body,
                                 {"Content-Type": "application/json"})
                    conn.getresponse().read()
                    conn.close()
                except Exception:
                    pass

        t0 = time.monotonic()
        workers = [
            threading.Thread(target=worker, args=(t,)) for t in range(threads)
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        elapsed = max(time.monotonic() - t0, 1e-3)
        measured = (per_thread * threads) / elapsed
    finally:
        api.stop()
    return max(floor_hz, min(target_hz, measured * fraction))


@dataclass
class SoakConfig:
    """Scaled defaults target the ~60–90 s bench/gate soak; the CLI raises
    ``duration_s`` for the full-length run. Budgets are per-run knobs, not
    constants, because the soak must stay meaningful from a shared 1-core CI
    box to a large dedicated host."""

    duration_s: float = 60.0
    # aggregate unit events / second. <= 0 calibrates to the box: a
    # sustainable fraction of the measured apiserver ingest rate, capped at
    # rate_target_hz (the target on a large dedicated host)
    rate_hz: float = 0.0
    rate_target_hz: float = 1000.0
    seed: int = 11
    n_types: int = 20
    live_pods: int = 300
    injector_threads: int = 4
    # operator cadences (CLI flags / env of the spawned process)
    batch_idle_s: float = 0.1
    batch_max_s: float = 0.5
    tick_s: float = 0.05
    gc_interval_s: float = 5.0
    watch_queue_capacity: int = 8192
    # chaos schedule (fractions of duration; passed to ChurnScript.generate).
    # The kill lands EARLY (0.25) by design: the post-kill incarnation must
    # live long enough for its RSS to clear the leak detector's per-segment
    # warmup + min-span window, or the restart blinds the memory arm.
    operator_restarts: Tuple[Tuple[float, str], ...] = ((0.25, "kill"),)
    apiserver_restarts: Tuple[float, ...] = (0.6,)
    restart_delay_s: float = 0.5
    # invariant budgets. The scaled memory ceiling (512 KiB/s) is set to
    # catch the failure CLASS the soak exists for — unbounded queue/ring
    # growth runs at MB/s under churn — while riding above the decelerating
    # warmup ramp (session caches, pattern pools, allocator high-water) a
    # 60-90 s window cannot fully exclude; the full-length CLI defaults to a
    # much tighter 64 KiB/s because hours amortize warmup.
    ready_p99_budget_s: float = 60.0
    loop_lag_budget_s: float = 20.0
    mem_slope_budget_bps: float = 524_288.0
    settle_timeout_s: float = 120.0
    boot_timeout_s: float = 120.0
    replay_limit: int = 0            # 0 = replay every dumped capsule
    dump_dir: str = ""               # empty: a fresh temp dir per run
    script: Optional[ChurnScript] = None  # override the generated timeline
    extra_env: Dict[str, str] = field(default_factory=dict)
    # the device of the operator's solver (its --device flag) and of the
    # monitor's offline replay; the port's addition, default the card
    device: str = "cuda"
    # perf-sentinel assertion (monitor.report): False asserts ZERO sentinel
    # trips (a clean calibrated run), True asserts at least one trip AND a
    # warmed baseline (an injected dispatch-hang slowdown run); None — the
    # default, right for soaks whose own chaos schedule already injects
    # device faults — records trip counts without asserting either way.
    perf_trips_expected: Optional[bool] = None


class SoakHarness:
    def __init__(self, config: Optional[SoakConfig] = None):
        self.cfg = config or SoakConfig()
        self.rate_hz = (
            self.cfg.rate_hz if self.cfg.rate_hz > 0
            else calibrate_rate(self.cfg.rate_target_hz)
        )
        self.script = self.cfg.script or ChurnScript.generate(
            seed=self.cfg.seed,
            duration_s=self.cfg.duration_s,
            rate_hz=self.rate_hz,
            live_pods=self.cfg.live_pods,
            operator_restarts=self.cfg.operator_restarts,
            apiserver_restarts=self.cfg.apiserver_restarts,
        )
        self.monitor = InvariantMonitor(
            ready_p99_budget_s=self.cfg.ready_p99_budget_s,
            loop_lag_budget_s=self.cfg.loop_lag_budget_s,
            mem_slope_budget_bps=self.cfg.mem_slope_budget_bps,
        )
        self.dump_dir = self.cfg.dump_dir or tempfile.mkdtemp(prefix="soak-capsules-")
        self.api = None
        self.cloud = None
        self.api_port: Optional[int] = None
        self.operator_port: Optional[int] = None
        self.operator: Optional[subprocess.Popen] = None
        self.observer = None          # the monitor's informer client
        self._apps: Dict[str, List[str]] = {}
        self._ops: "queue.Queue" = queue.Queue(maxsize=50_000)
        self._ops_done = threading.Event()
        self._counts_lock = threading.Lock()
        self.events_applied = 0
        self.events_by_kind: Dict[str, int] = {}
        self.op_failures = 0
        self.restarts = {"operator_kill": 0, "operator_term": 0, "apiserver": 0,
                         "operator_boot_exit": 0}
        self._incarnation = 0
        # the boot watch of a respawned operator (its own thread, so the
        # timeline keeps pumping while the operator boots), and the reason
        # the soak fails when an operator kept exiting at boot
        self._boot_watch: Optional[threading.Thread] = None
        self.boot_failure: Optional[str] = None
        # each boot's seconds from its spawn until it served /metrics (the
        # port's; in the report as ``operator_boot_s``)
        self._spawned_at = 0.0
        self.boot_s: List[float] = []
        self._workers: List[threading.Thread] = []

    # -- accounting ----------------------------------------------------------
    def _count(self, kind: str, n: int = 1) -> None:
        with self._counts_lock:
            self.events_applied += n
            self.events_by_kind[kind] = self.events_by_kind.get(kind, 0) + n

    # -- raw HTTP (injector side; independent of the informer machinery) ----
    def _http(self, method: str, path: str, body=None, tries: int = 5):
        """One apiserver op with retries wide enough to ride out a listener
        restart. Returns (status, payload) or None when every try failed."""
        payload = json.dumps(body).encode() if body is not None else None
        for attempt in range(tries):
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", self.api_port, timeout=10
                )
                conn.request(
                    method, path, payload,
                    {"Content-Type": "application/json"} if payload else {},
                )
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
                if resp.status >= 500:
                    raise RuntimeError(f"HTTP {resp.status}")
                return resp.status, json.loads(data or b"{}")
            except Exception:
                if attempt == tries - 1:
                    with self._counts_lock:
                        self.op_failures += 1
                    return None
                time.sleep(0.2 * (attempt + 1))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SoakHarness":
        from ..cloudprovider import generate_catalog
        from ..cloudprovider.httpcloud import CloudHTTPService
        from ..state import HTTPCluster
        from ..state.apiserver import ClusterAPIServer

        os.makedirs(self.dump_dir, exist_ok=True)
        self.cloud = CloudHTTPService(
            catalog=generate_catalog(n_types=self.cfg.n_types),
            fault_plan=self.script.faults,
        ).start()
        self.api = ClusterAPIServer().start()
        self.api_port = self.api._server.server_address[1]
        self.api.backing.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
        self.operator_port = _free_port()
        self._spawn_operator()
        # the monitor's own informer client (watch=True): ready-latency
        # completion + RESYNC handling ride the same machinery controllers use
        self.observer = HTTPCluster(
            self.api.endpoint, queue_capacity=self.cfg.watch_queue_capacity
        )
        self.monitor.attach(self.observer)
        self.monitor.start_sampling(
            f"http://127.0.0.1:{self.operator_port}/metrics"
        )
        if not self._boot_operator():
            # fail LOUD and EARLY: churning for minutes against an operator
            # that never booted produces misleading invariant violations
            # ("pods permanently unschedulable") instead of the actual
            # diagnosis, and misdirects gate triage
            raise RuntimeError(
                f"{self.boot_failure} — see "
                f"{os.path.join(self.dump_dir, f'operator-{self._incarnation - 1}.log')}"
            )
        return self

    def _spawn_operator(self) -> None:
        env = dict(os.environ)
        env.update({
            "KARPENTER_TPU_FLIGHT_RECORDER_DUMP_DIR": self.dump_dir,
            "KARPENTER_TPU_GARBAGE_COLLECT_INTERVAL": str(self.cfg.gc_interval_s),
            "KARPENTER_TPU_WATCH_QUEUE_CAPACITY": str(self.cfg.watch_queue_capacity),
            # interruption notices ride the cloud service's /v1/queue
            # SQS-analog: the operator's InterruptionController polls it over
            # real HTTP (Operator.new adopts the HTTP provider's queue), and
            # the harness's reclaim ops inject messages into it over the wire
            "KARPENTER_TPU_INTERRUPTION_QUEUE_NAME": "soak-queue",
        })
        # device-path chaos: the timeline's device-fault bursts install as
        # the operator's scripted DeviceFaultPlan (solver-side seams; no
        # HTTP surface can reach them). A respawned operator re-arms the
        # remaining timeline from ITS boot — chaos precision is secondary
        # to the faults actually firing under churn.
        dev_script = self.script.device_fault_script()
        if dev_script:
            env["KARPENTER_TPU_DEVICE_FAULT_SCRIPT"] = dev_script
        env.update(self.cfg.extra_env)
        log_path = os.path.join(self.dump_dir, f"operator-{self._incarnation}.log")
        self._incarnation += 1
        self._spawned_at = time.monotonic()
        # files, not pipes: an unread pipe blocks the child and loses every
        # diagnostic on failure (the leader-HA test learned this the hard way)
        log = open(log_path, "w")
        self.operator = subprocess.Popen(
            [
                sys.executable, "-m", "karpenter_tpu_torch",
                "--cluster-endpoint", self.api.endpoint,
                "--cloud-endpoint", self.cloud.endpoint,
                "--metrics-port", str(self.operator_port),
                "--metrics-bind", "127.0.0.1",
                "--batch-idle-duration", str(self.cfg.batch_idle_s),
                "--batch-max-duration", str(self.cfg.batch_max_s),
                "--tick", str(self.cfg.tick_s),
                "--device", self.cfg.device,
            ],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
        )

    def _wait_operator_ready(self, timeout: Optional[float] = None) -> bool:
        """True once the operator serves ``/metrics``; False at the boot
        timeout or as soon as the process has exited (the port's: the
        reference waits out the timeout for a process that is gone)."""
        deadline = time.monotonic() + (timeout or self.cfg.boot_timeout_s)
        url = f"http://127.0.0.1:{self.operator_port}/healthz"
        proc = self.operator
        while time.monotonic() < deadline:
            if self.monitor.sample_operator(url.replace("/healthz", "/metrics")):
                self.boot_s.append(round(time.monotonic() - self._spawned_at, 2))
                return True
            if proc is not None and proc.poll() is not None:
                return False
            time.sleep(0.5)
        return False

    def _log_tail(self, lines: int = 12) -> str:
        path = os.path.join(self.dump_dir, f"operator-{self._incarnation - 1}.log")
        try:
            with open(path) as fh:
                return "".join(fh.readlines()[-lines:]).strip()
        except OSError:
            return ""

    def _boot_operator(self) -> bool:
        """Wait until the operator just spawned is ready. When it exits
        first, log the tail of its log and respawn it after
        ``restart_delay_s``, up to ``BOOT_RESPAWNS`` times, each counted
        under ``restarts["operator_boot_exit"]``. Past the bound, or when
        it never became ready, ``boot_failure`` holds the reason and the
        answer is False."""
        respawns = 0
        while True:
            if self._wait_operator_ready():
                return True
            proc = self.operator
            if proc is None or proc.poll() is None:
                self.boot_failure = (
                    f"operator never became scrapeable within {self.cfg.boot_timeout_s}s")
                return False
            tail = self._log_tail()
            if respawns >= BOOT_RESPAWNS:
                self.boot_failure = (
                    f"operator_boot_exit: the operator exited with code {proc.returncode} "
                    f"before it was ready, {respawns} respawns in a row; its log ends: {tail}")
                _log.error(self.boot_failure)
                return False
            _log.warning("operator exited with code %s before it was ready; respawning "
                         "in %.1f s; its log ends: %s", proc.returncode,
                         self.cfg.restart_delay_s, tail)
            respawns += 1
            with self._counts_lock:
                self.restarts["operator_boot_exit"] += 1
            time.sleep(self.cfg.restart_delay_s)
            self._spawn_operator()

    # -- chaos control events (pump thread) ----------------------------------
    def restart_apiserver(self) -> None:
        from ..state.apiserver import ClusterAPIServer

        backing = self.api.backing
        port = self.api_port
        self.api.stop()
        # a fresh incarnation over the same backing store: new event log,
        # same object versions — exactly a kube-apiserver bounce over
        # surviving etcd. Stale client bookmarks exceed the new log and get
        # "gone", forcing the relist path.
        for attempt in range(20):
            try:
                self.api = ClusterAPIServer(backing=backing, port=port).start()
                break
            except OSError:
                time.sleep(0.25)
        else:
            raise RuntimeError(f"could not rebind apiserver port {port}")
        self.restarts["apiserver"] += 1
        self._count("apiserver-restart")

    def restart_operator(self, sig: str = "kill") -> None:
        proc = self.operator
        if proc is not None and proc.poll() is None:
            if sig == "term":
                proc.send_signal(signal.SIGTERM)
            else:
                proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self.restarts["operator_term" if sig == "term" else "operator_kill"] += 1
        time.sleep(self.cfg.restart_delay_s)
        self._spawn_operator()
        self._count("operator-restart")
        # the port's: watch the respawn's boot on a thread of its own (the
        # timeline keeps pumping) and respawn it again if it exits first
        self._boot_watch = threading.Thread(target=self._boot_operator, daemon=True)
        self._boot_watch.start()

    def _resolve_pools(self, pattern: Tuple[str, str, str]) -> List[Tuple[str, str, str]]:
        out = []
        for it in self.cloud.catalog:
            for o in it.offerings:
                pool = (it.name, o.zone, o.capacity_type)
                if all(w in ("*", p) for w, p in zip(pattern, pool)):
                    out.append(pool)
        return out

    def _managed_nodes(self, deleting: bool = False) -> List:
        with self.api.backing._lock:
            nodes = list(self.api.backing.nodes.values())
        return [
            n for n in nodes
            if n.meta.labels.get(wk.PROVISIONER_NAME)
            and (n.meta.deletion_timestamp is not None) == deleting
        ]

    # -- event translation ---------------------------------------------------
    def _handle_event(self, event) -> None:
        kind = event.kind
        if kind == "deploy-up":
            app = event.get("app")
            names = [f"{app}-{i}" for i in range(int(event.get("replicas", 1)))]
            self._apps[app] = names
            for name in names:
                self._ops.put((kind, self._make_create_op(
                    name, app, event.get("cpu", "100m"), event.get("memory", "128Mi")
                )))
        elif kind == "deploy-down":
            for name in self._apps.pop(event.get("app"), []):
                self._ops.put((kind, self._make_delete_op(name)))
        elif kind == "reclaim-wave":
            pattern = tuple(event.get("pool", ("*", "*", "*")))
            frac = float(event.get("fraction", 0.25))
            candidates = sorted(
                n.meta.name for n in self._managed_nodes()
                if all(w in ("*", p) for w, p in zip(pattern, (
                    n.meta.labels.get(wk.INSTANCE_TYPE, ""),
                    n.meta.labels.get(wk.ZONE, ""),
                    n.meta.labels.get(wk.CAPACITY_TYPE, ""),
                )))
            )
            victims = candidates[: max(1, math.ceil(frac * len(candidates)))] if candidates else []
            for name in victims:
                self._ops.put((kind, self._make_reclaim_op(name)))
        elif kind == "ice-start":
            pools = self._resolve_pools(tuple(event.get("pool")))
            self.cloud.insufficient_capacity_pools.update(pools)
            self._count(kind, max(1, len(pools)))
        elif kind == "ice-end":
            pools = self._resolve_pools(tuple(event.get("pool")))
            self.cloud.insufficient_capacity_pools.difference_update(pools)
            self._count(kind, max(1, len(pools)))
        elif kind == "drift":
            k = int(event.get("nodes", 1))
            names = sorted(n.meta.name for n in self._managed_nodes())[:k]
            for name in names:
                self._ops.put((kind, self._make_drift_op(name)))
        elif kind == "price-spike":
            factor = float(event.get("factor", 2.0))
            pools = self._resolve_pools(
                (str(event.get("instance_type", "*")), str(event.get("zone", "*")), "spot")
            )
            for it_name, zone, _ in pools:
                cur = self.cloud.pricing.spot_price(it_name, zone)
                if cur:
                    self.cloud.pricing.set_spot_price(
                        it_name, zone, round(cur * factor, 6)
                    )
            self._count(kind, max(1, len(pools)))
        elif kind == "rpc-fault-burst":
            # status 0 passes through untouched: it scripts a genuine
            # connection-drop (the cloud service closes the socket with no
            # reply), a distinct fault class from any HTTP status
            self.script.faults.fail(
                str(event.get("endpoint")), n=int(event.get("n", 2)),
                status=int(event.get("status", 503)),
            )
            self._count(kind, int(event.get("n", 2)))
        elif kind == "device-fault-burst":
            # the operator process owns this fault surface: its boot env
            # carried the WHOLE device-fault timeline (device_fault_script),
            # so the burst fires inside its solver seams on schedule — the
            # harness only accounts the event
            self._count(kind, int(event.get("n", 1)))
        elif kind == "apiserver-restart":
            self.restart_apiserver()
        elif kind == "operator-restart":
            self.restart_operator(str(event.get("signal", "kill")))
        else:  # pragma: no cover - ChurnEvent validates kinds at build time
            raise ValueError(f"unhandled churn event kind {kind!r}")

    def _make_create_op(self, name: str, app: str, cpu: str, memory: str):
        def op() -> None:
            pod = Pod(
                meta=ObjectMeta(name=name, labels={"app": app},
                                owner_kind="ReplicaSet"),
                requests=Resources(cpu=cpu, memory=memory),
            )
            out = self._http("POST", "/api/pods", to_wire(pod))
            if out is not None and out[0] < 400:
                self.monitor.note_added(name)
                self._count("deploy-up")
        return op

    def _make_delete_op(self, name: str):
        def op() -> None:
            out = self._http("DELETE", f"/api/pods/{name}")
            if out is not None:
                self._count("deploy-down")
        return op

    def _make_reclaim_op(self, name: str):
        def op() -> None:
            got = self._http("GET", f"/api/nodes/{name}")
            if got is None or got[0] != 200:
                return
            wire = got[1]
            if wire["meta"].get("deletionTimestamp") is not None:
                return  # already going away
            # the REAL notice path: a spot-interruption message into the
            # cloud service's /v1/queue SQS-analog, over the wire — the
            # operator's interruption controller receives it over HTTP,
            # drains the node and deletes the queue message (exactly-once)
            iid = str(wire.get("providerId", "")).rsplit("/", 1)[-1]
            if iid and self._cloud_queue_send(
                {
                    "version": "0",
                    "source": "cloud.compute",
                    "detail-type": "Spot Instance Interruption Warning",
                    "detail": {"instance-id": iid},
                }
            ):
                self._count("reclaim-wave")
                return
            # fallback (no provider id yet / queue POST failed): direct
            # deletion-timestamp stamp, the pre-queue reclaim shape
            wire["meta"]["deletionTimestamp"] = time.time()
            out = self._http("PUT", f"/api/nodes/{name}", wire)
            if out is not None and out[0] < 400:
                self._count("reclaim-wave")
        return op

    def _cloud_queue_send(self, message: Dict) -> bool:
        """POST one interruption message to the cloud service's queue over
        the wire; False on any transport failure (callers fall back)."""
        try:
            body = json.dumps({"body": json.dumps(message)}).encode()
            req = urllib.request.Request(
                f"{self.cloud.endpoint}/v1/queue/send", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status == 200
        except Exception:
            return False

    def _make_drift_op(self, name: str):
        def op() -> None:
            got = self._http("GET", f"/api/nodes/{name}")
            if got is None or got[0] != 200:
                return
            wire = got[1]
            if wire["meta"].get("deletionTimestamp") is not None:
                return  # racing termination would resurrect the node
            labels = wire["meta"].setdefault("labels", {})
            labels["soak.karpenter-tpu/drift"] = str(int(time.time() * 1000) % 100000)
            out = self._http("PUT", f"/api/nodes/{name}", wire)
            if out is not None and out[0] < 400:
                self._count("drift")
        return op

    # -- the run -------------------------------------------------------------
    def _injector(self) -> None:
        while True:
            try:
                item = self._ops.get(timeout=0.5)
            except queue.Empty:
                if self._ops_done.is_set():
                    return
                continue
            _, op = item
            try:
                op()
            except Exception:
                with self._counts_lock:
                    self.op_failures += 1
            finally:
                self._ops.task_done()

    def run(self) -> Dict:
        """Pump the timeline to its end, settle, audit, replay. Returns the
        monitor's report; ``report['ok']`` is the soak verdict."""
        t_start = time.monotonic()
        self._workers = [
            threading.Thread(target=self._injector, daemon=True)
            for _ in range(self.cfg.injector_threads)
        ]
        for w in self._workers:
            w.start()
        self.script.start()
        horizon = max(self.cfg.duration_s, self.script.last_t() + 0.001)
        while self.script.elapsed() < horizon and self.script.pending():
            for event in self.script.due():
                self._handle_event(event)
            time.sleep(0.02)
        # drain queued ops, then settle: churn stops, the system must reach
        # zero pending pods / zero orphans before the budgets are judged
        self._ops.join()
        self._ops_done.set()
        for w in self._workers:
            w.join(timeout=10)
        churn_duration = time.monotonic() - t_start  # the rate denominator
        if self._boot_watch is not None:
            self._boot_watch.join(timeout=self.cfg.boot_timeout_s * (BOOT_RESPAWNS + 1))
        # no settle wait behind an operator that kept exiting at boot: it
        # would only add "pods still pending" to the real reason
        settle_deadline = time.monotonic() + (
            0.0 if self.boot_failure else self.cfg.settle_timeout_s)
        while time.monotonic() < settle_deadline:
            if self._pending_count() == 0 and not self._orphans():
                break
            time.sleep(1.0)
        pending_end = self._pending_count()
        orphans = self._orphans()
        audit = self.cloud.launch_audit()
        audit["machine_providerid_dups"] = self._machine_dups()
        if audit["machine_providerid_dups"]:
            audit.setdefault("duplicate_tokens", {}).update({
                f"machine:{pid}": names
                for pid, names in audit["machine_providerid_dups"].items()
            })
        # ordered teardown BEFORE replay: the SIGTERM path must flush any
        # pending anomaly dumps (Operator.close), and replay runs offline
        self._stop_operator()
        self.monitor.stop_sampling()
        replay = self.monitor.replay_dumped_capsules(
            self.dump_dir, limit=self.cfg.replay_limit, device=self.cfg.device
        )
        report = self.monitor.report(
            pending_end=pending_end,
            launch_audit=audit,
            orphan_instances=orphans,
            replay=replay,
            events_total=self.events_applied,
            duration_s=churn_duration,
            restarts=dict(self.restarts),
            perf_trips_expected=self.cfg.perf_trips_expected,
        )
        if self.boot_failure:
            # the reason first: every later violation follows from it
            report["violations"] = [self.boot_failure] + list(report.get("violations", []))
            report["ok"] = False
        report["wall_s"] = round(time.monotonic() - t_start, 2)
        report["events_by_kind"] = dict(sorted(self.events_by_kind.items()))
        report["op_failures"] = self.op_failures
        report["operator_boot_s"] = list(self.boot_s)
        report["rate_hz"] = round(self.rate_hz, 1)
        report["rate_target_hz"] = self.cfg.rate_target_hz
        report["script"] = self.script.summary()
        report["dump_dir"] = self.dump_dir
        return report

    def _pending_count(self) -> int:
        with self.api.backing._lock:
            return sum(
                1 for p in self.api.backing.pods.values()
                if p.node_name is None and p.meta.deletion_timestamp is None
            )

    def _orphans(self) -> List[str]:
        """Live cloud instances no in-cluster Machine references — what the
        GC/link path must keep at zero across crashes. Machine provider ids
        are URIs (``http:///<zone>/<iid>``); compare by instance id the way
        the provider itself does (httpcloud._instance_id)."""
        with self.api.backing._lock:
            known = {
                m.status.provider_id.rsplit("/", 1)[-1]
                for m in self.api.backing.machines.values()
                if m.status.provider_id
            }
        with self.cloud._lock:
            return [iid for iid in self.cloud.instances if iid not in known]

    def _machine_dups(self) -> Dict[str, List[str]]:
        by_pid: Dict[str, List[str]] = {}
        with self.api.backing._lock:
            for m in self.api.backing.machines.values():
                if m.status.provider_id:
                    by_pid.setdefault(m.status.provider_id, []).append(m.meta.name)
        return {pid: sorted(ns) for pid, ns in by_pid.items() if len(ns) > 1}

    def _stop_operator(self) -> None:
        proc = self.operator
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)

    def stop(self) -> None:
        self._ops_done.set()
        self._stop_operator()
        self.monitor.stop_sampling()
        if self.observer is not None:
            self.observer.close()
        if self.api is not None:
            self.api.stop()
        if self.cloud is not None:
            self.cloud.stop()


def run_soak(config: Optional[SoakConfig] = None) -> Dict:
    harness = SoakHarness(config)
    try:
        harness.start()
        return harness.run()
    finally:
        harness.stop()
