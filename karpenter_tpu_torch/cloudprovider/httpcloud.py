"""A second, non-fake CloudProvider: a process-local HTTP cloud
(a copy of ``karpenter_tpu/cloudprovider/httpcloud.py``).

This module hosts a cloud backend behind a REAL network
boundary — JSON over HTTP with injected per-request latency and an
eventually-consistent describe/list view — and a client `HTTPCloudProvider`
that implements the full `CloudProvider` protocol against it.

Division of labor mirrors the upstream AWS provider:

* the CLIENT runs the launch policy (price ordering, spot-vs-OD, top-N —
  `launchpolicy.py`, the analogue of
  upstream ``pkg/providers/instance/instance.go:87-264``), constructs
  `InstanceType` objects from the server's raw type descriptions (the
  DescribeInstanceTypes + pricing shape,
  upstream ``pkg/providers/instancetype/instancetype.go:95-148``),
  keeps the ICE cache, and batches point calls through windowed batchers
  (upstream ``pkg/batcher/{describeinstances,terminateinstances}.go``).
* the SERVER owns instances, subnet IP accounting, injected ICE pools and
  image pointers, and walks the client's price-ordered override list with the
  shared fallback policy (the CreateFleet-with-overrides shape,
  ``createfleet.go:33-110``).

Eventual consistency: mutations publish snapshots; describe/list serve the
newest snapshot older than ``consistency_lag_s`` — a just-created instance is
invisible (and a just-deleted one still visible) for the lag window, like
EC2's DescribeInstances.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import Machine, MachineStatus, ObjectMeta, Provisioner
from ..utils import tracing
from ..utils.cache import UnavailableOfferings
from ..utils.faults import FaultPlan
from ..utils.logging import context_fields, get_logger
from ..utils.resilience import (
    BreakerSet,
    CircuitOpenError,
    RetryPolicy,
    resilient_call,
)
from .interface import (
    CloudProvider,
    CloudProviderError,
    Image,
    InsufficientCapacityError,
    Instance,
    MachineNotFoundError,
    SecurityGroup,
    Subnet,
    WindowedBatchers,
)
from .catalog import make_instance_type
from .types import InstanceType, Offering

_log = get_logger("httpcloud")

# ---------------------------------------------------------------------------
# Wire codec: raw instance-type descriptions (the DescribeInstanceTypes shape)
# ---------------------------------------------------------------------------


def describe_instance_type(it: InstanceType) -> Dict:
    """Serialize the RAW parameters a client needs to reconstruct the type —
    not the finished object. Single-valued well-known labels carry the specs
    (types.go:67-122); offerings carry live prices."""
    labels = it.requirements.labels()
    return {
        "name": it.name,
        "category": labels.get(wk.INSTANCE_CATEGORY, ""),
        "generation": labels.get(wk.INSTANCE_GENERATION, ""),
        "size": labels.get(wk.INSTANCE_SIZE, ""),
        "vcpus": int(float(labels.get(wk.INSTANCE_CPU, "0"))),
        "memory_gib": float(labels.get(wk.INSTANCE_MEMORY, "0")) / 1024.0,
        "arch": labels.get(wk.ARCH, "amd64"),
        "accelerator": labels.get(wk.INSTANCE_ACCELERATOR_NAME, ""),
        "accelerator_count": int(float(labels.get(wk.INSTANCE_ACCELERATOR_COUNT, "0") or 0)),
        "local_nvme_gib": int(float(labels.get(wk.INSTANCE_LOCAL_NVME, "0") or 0)),
        "zones": sorted({o.zone for o in it.offerings}),
        "spot": any(o.capacity_type == wk.CAPACITY_TYPE_SPOT for o in it.offerings),
        "od_price": next(
            (o.price for o in it.offerings if o.capacity_type == wk.CAPACITY_TYPE_ON_DEMAND),
            0.0,
        ),
        # slice-topology flag, not the expansion itself: the per-zone torus
        # synthesis is deterministic (topology.zone_torus), so the client
        # re-derives identical coordinate offerings from this one bit
        "slice_topology": any(o.slice_pod for o in it.offerings),
    }


def instance_type_from_description(
    desc: Dict, prices: Optional[Dict[str, float]] = None
) -> InstanceType:
    """Client-side reconstruction (instancetype.go builds InstanceTypes from
    raw EC2/pricing data). ``prices`` maps "zone/capacity_type" to the live
    price; absent entries keep the deterministic static price."""
    it = make_instance_type(
        desc["name"],
        desc["category"],
        desc["generation"],
        desc["size"],
        desc["vcpus"],
        desc["memory_gib"],
        desc["od_price"],
        desc["zones"],
        accelerator=desc.get("accelerator", ""),
        accelerator_count=desc.get("accelerator_count", 0),
        local_nvme_gib=desc.get("local_nvme_gib", 0),
        spot=desc.get("spot", True),
        arch=desc.get("arch", "amd64"),
    )
    if prices:
        it = it.with_offerings(
            [
                Offering(
                    zone=o.zone,
                    capacity_type=o.capacity_type,
                    price=prices.get(f"{o.zone}/{o.capacity_type}", o.price),
                    available=o.available,
                )
                for o in it.offerings
            ]
        )
    if desc.get("slice_topology"):
        # expand AFTER pricing: coordinates copy their pool's live price
        from ..solver.topology import with_slice_topology

        it = with_slice_topology([it])[0]
    return it


def _instance_to_dict(inst: Instance) -> Dict:
    return {
        "id": inst.id,
        "instance_type": inst.instance_type,
        "zone": inst.zone,
        "capacity_type": inst.capacity_type,
        "image_id": inst.image_id,
        "state": inst.state,
        "tags": dict(inst.tags),
        "created": inst.created,
    }


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

#: reservation marker: the launch token is taken but its instance has not
#: committed yet (first attempt still in flight)
_PENDING = "__pending__"


class LaunchInFlight(Exception):
    """A retry raced its own still-in-flight first attempt; served as a
    retryable 503 so the client backs off and replays against the committed
    instance."""


class CloudHTTPService:
    """The cloud side: instance store + subnet IPs + ICE pools behind HTTP.

    ``latency_s`` sleeps per request (a tunable stand-in for cloud API RTT);
    ``consistency_lag_s`` makes describe/list serve a stale snapshot.
    """

    def __init__(
        self,
        catalog: Sequence[InstanceType],
        latency_s: float = 0.0,
        consistency_lag_s: float = 0.0,
        port: int = 0,
        fault_plan: Optional[FaultPlan] = None,
    ):
        from .pricing import PricingProvider
        from .subnet import SubnetProvider

        self.catalog = list(catalog)
        self._by_name = {it.name: it for it in self.catalog}
        self.pricing = PricingProvider(self.catalog)
        zones = sorted({o.zone for it in self.catalog for o in it.offerings})
        # shared inventory with the fake (inventory.py): discovery over HTTP
        # must resolve selectors identically to the in-process backend
        # and the service's current_images pointers
        # start from the same per-(family, variant) defaults
        from .inventory import default_inventory

        (self.subnets, self.security_groups, self.images,
         self.current_images) = default_inventory(zones)
        self.subnet_provider = SubnetProvider(self.subnets)
        self.latency_s = latency_s
        self.consistency_lag_s = consistency_lag_s
        # scripted server-side failures (utils/faults.py): handle() consumes
        # one fault per matching request BEFORE dispatch, so retry/breaker
        # behavior is exercisable against the real HTTP boundary
        self.fault_plan = fault_plan
        self.instances: Dict[str, Instance] = {}
        # idempotency index: client launch token -> instance id, or _PENDING
        # while the first attempt is still in flight (EC2 client-token
        # semantics; see run_instances)
        self._launch_tokens: Dict[str, str] = {}
        # append-only reservation log: every COMMITTED launch as
        # (client_token, instance_id, unix_time). Unlike _launch_tokens
        # (pruned at terminate) this survives the instance, so the chaos
        # soak's duplicate-launch audit can prove that no client token —
        # across retries, operator crashes and leader failovers — ever
        # committed two instances (see launch_audit()).
        self.launch_log: List[Tuple[str, str, float]] = []
        self.insufficient_capacity_pools: set = set()
        # cloud-side interruption queue (the SQS analogue), served over
        # /v1/queue/* so the notice pipeline crosses a REAL network boundary:
        # the operator's HTTPCloudProvider polls it, tests/the soak harness
        # inject messages into it over the wire
        from ..controllers.interruption import FakeQueue

        self.queue = FakeQueue()
        self.request_log: List[str] = []  # endpoint per backend call
        self._counter = 0
        self._lock = threading.Lock()
        # snapshot history for the eventually-consistent read path
        self._history: List[Tuple[float, Dict[str, Dict]]] = [(0.0, {})]
        self._server = None
        self._port = port

    # -- state helpers ------------------------------------------------------
    def _publish(self) -> None:
        """Record the post-mutation view; reads serve the newest snapshot
        older than the consistency lag."""
        snap = {iid: _instance_to_dict(i) for iid, i in self.instances.items()}
        self._history.append((time.monotonic(), snap))
        cutoff = time.monotonic() - self.consistency_lag_s - 60.0
        while len(self._history) > 2 and self._history[1][0] < cutoff:
            self._history.pop(0)

    def _view(self) -> Dict[str, Dict]:
        cutoff = time.monotonic() - self.consistency_lag_s
        view = self._history[0][1]
        for ts, snap in self._history:
            if ts <= cutoff:
                view = snap
        return view

    # -- operations (all called under the HTTP handler) ---------------------
    def run_instances(self, body: Dict) -> Dict:
        """Walk the client's price-ordered overrides with the shared fallback
        policy; the server contributes ICE pools + subnet IP accounting.

        ``client_token`` is an IDEMPOTENCY KEY (EC2 client-token semantics):
        the client mints one token per logical launch and every transport
        retry carries it, so a retried launch whose first attempt actually
        landed — the client's timeout fired after the server committed —
        returns the existing instance instead of a duplicate. A retry racing
        a still-IN-FLIGHT first attempt finds the token reserved and gets a
        retryable 503 (LaunchInFlight) rather than a second launch."""
        from .launchpolicy import launch_with_fallback

        token = body.get("client_token", "")
        if token:
            with self._lock:
                reserved = self._launch_tokens.get(token)
                if reserved == _PENDING:
                    raise LaunchInFlight(token)
                if reserved is not None and reserved in self.instances:
                    return {
                        "instance": _instance_to_dict(self.instances[reserved]),
                        "attempted": [],
                    }
                self._launch_tokens[token] = _PENDING
        machine = Machine(
            meta=ObjectMeta(name=body.get("name", "")),
            provisioner_name=body.get("provisioner_name", ""),
        )
        overrides = body.get("overrides", [])
        attempted: List[Dict] = []

        def try_launch(it: InstanceType, offering: Offering) -> Dict:
            key = (it.name, offering.zone, offering.capacity_type)
            if key in self.insufficient_capacity_pools:
                raise InsufficientCapacityError(f"ICE pool {key}")
            subnet = self.subnet_provider.zonal_subnet_for_launch(offering.zone)
            try:
                with self._lock:
                    self._counter += 1
                    iid = f"i-{self._counter:08d}"
                    slice_tags = {}
                    if offering.slice_pod:
                        from ..solver.topology import format_coord

                        slice_tags[wk.SLICE_POD] = offering.slice_pod
                        if offering.slice_coord is not None:
                            slice_tags[wk.SLICE_COORD] = format_coord(
                                offering.slice_coord
                            )
                    inst = Instance(
                        id=iid,
                        instance_type=it.name,
                        zone=offering.zone,
                        capacity_type=offering.capacity_type,
                        image_id=self.current_images.get("default", "image-001"),
                        tags={
                            wk.MANAGED_BY: "karpenter-tpu",
                            wk.PROVISIONER_NAME: machine.provisioner_name,
                            "subnet": subnet.id,
                            **slice_tags,
                            **({"launch-token": token} if token else {}),
                            **body.get("tags", {}),
                        },
                        created=time.time(),
                    )
                    self.subnet_provider.commit(subnet.id)
                    self.instances[iid] = inst
                    if token:
                        self._launch_tokens[token] = iid
                    self.launch_log.append((token, iid, time.time()))
                    self._publish()
                return _instance_to_dict(inst)
            except Exception:
                self.subnet_provider.release_inflight(subnet.id)
                raise

        candidates = []
        for entry in overrides:
            t, z, ct = entry[:3]
            it = self._by_name.get(t)
            if it is None:
                continue
            # optional slice-location pin (entries 4-5): the launched
            # instance must sit at exactly this ICI coordinate
            slice_pod = entry[3] if len(entry) > 3 else ""
            raw_coord = entry[4] if len(entry) > 4 else ""
            coord = None
            if raw_coord:
                from ..solver.topology import parse_coord

                coord = parse_coord(raw_coord)
            candidates.append(
                (
                    it,
                    Offering(
                        zone=z, capacity_type=ct, price=0.0,
                        slice_pod=slice_pod, slice_coord=coord,
                    ),
                )
            )
        try:
            launched = launch_with_fallback(
                machine,
                candidates,
                try_launch,
                lambda t, z, c, reason: attempted.append(
                    {"key": [t, z, c], "reason": reason}
                ),
            )
            return {"instance": launched, "attempted": attempted}
        except InsufficientCapacityError:
            return {
                "error": {"type": "ICE", "message": "all offerings exhausted"},
                "attempted": attempted,
            }
        finally:
            if token:
                with self._lock:
                    # a failed/aborted launch releases the reservation so a
                    # fresh retry with the same token can attempt again
                    if self._launch_tokens.get(token) == _PENDING:
                        self._launch_tokens.pop(token)

    def launch_audit(self) -> Dict:
        """Duplicate-launch audit over the reservation log: a client token
        that committed MORE than one instance is a broken idempotency
        contract — a retry, crash-restart or leader failover launched twice
        for one logical decision. The chaos soak's invariant monitor calls
        this at settle and requires ``duplicate_tokens`` empty."""
        with self._lock:
            log = list(self.launch_log)
        by_token: Dict[str, set] = {}
        for token, iid, _ in log:
            if token:
                by_token.setdefault(token, set()).add(iid)
        return {
            "launches": len(log),
            "tokens": len(by_token),
            "untokened": sum(1 for t, _, _ in log if not t),
            "duplicate_tokens": {
                t: sorted(ids) for t, ids in by_token.items() if len(ids) > 1
            },
        }

    def terminate(self, body: Dict) -> Dict:
        results = []
        with self._lock:
            for iid in body.get("instance_ids", []):
                inst = self.instances.pop(iid, None)
                if inst is None:
                    results.append({"error": "not-found"})
                    continue
                subnet_id = inst.tags.get("subnet")
                if subnet_id:
                    self.subnet_provider.release_ip(subnet_id)
                token = inst.tags.get("launch-token")
                if token:
                    self._launch_tokens.pop(token, None)
                results.append(None)
            self._publish()
        return {"results": results}

    def describe(self, body: Dict) -> Dict:
        view = self._view()
        return {
            "instances": [
                view.get(iid) or {"error": "not-found"}
                for iid in body.get("instance_ids", [])
            ]
        }

    def handle(self, path: str, body: Optional[Dict]) -> Tuple[int, Dict]:
        if self.latency_s:
            time.sleep(self.latency_s)
        self.request_log.append(path)
        if self.fault_plan is not None:
            fault = self.fault_plan.next(path)
            if fault is not None:
                if fault.kind == "latency":
                    if fault.latency_s > 0:
                        self.fault_plan.sleep(fault.latency_s)
                elif fault.kind == "capacity" and path == "/v1/run-instances":
                    # the all-offerings-exhausted wire shape run_instances
                    # itself produces; attempted= lets the client mark the
                    # offerings it asked for
                    return 200, {
                        "error": {"type": "ICE", "message": fault.reason},
                        "attempted": [
                            {"key": list(k), "reason": fault.reason}
                            for k in (body or {}).get("overrides", [])
                        ],
                    }
                elif fault.status == 0:
                    # connection-level fault (Fault docs: status 0 = no
                    # response at all): the HTTP layer drops the connection
                    # without writing a reply, so the client exercises its
                    # true connection-error classification path, not a 503
                    return 0, {}
                else:
                    return fault.status, {"error": fault.reason}
        if path == "/v1/instance-types":
            return 200, {
                "catalog_version": len(self.request_log),
                "types": [
                    {
                        **describe_instance_type(it),
                        "prices": {
                            f"{o.zone}/{o.capacity_type}": (
                                self.pricing.price(it.name, o.zone, o.capacity_type)
                                or o.price
                            )
                            for o in it.offerings
                        },
                    }
                    for it in self.catalog
                ],
            }
        if path == "/v1/run-instances":
            try:
                return 200, self.run_instances(body or {})
            except LaunchInFlight:
                return 503, {"error": "launch in flight; retry"}
        if path == "/v1/terminate":
            return 200, self.terminate(body or {})
        if path == "/v1/describe":
            return 200, self.describe(body or {})
        if path == "/v1/instances":
            return 200, {"instances": list(self._view().values())}
        if path == "/v1/images":
            return 200, {"images": dict(self.current_images)}
        if path == "/v1/describe-subnets":
            from .inventory import tags_match

            sel = (body or {}).get("selector", {})
            return 200, {
                "subnets": [
                    {"id": s.id, "zone": s.zone, "tags": dict(s.tags),
                     "available_ips": s.available_ips}
                    for s in self.subnets
                    if tags_match(s.tags, sel)
                ]
            }
        if path == "/v1/describe-security-groups":
            from .inventory import tags_match

            sel = (body or {}).get("selector", {})
            return 200, {
                "groups": [
                    {"id": g.id, "name": g.name, "tags": dict(g.tags)}
                    for g in self.security_groups
                    if tags_match(g.tags, sel)
                ]
            }
        if path == "/v1/describe-images":
            from .inventory import tags_match

            sel = (body or {}).get("selector", {})
            matched = [i for i in self.images if tags_match(i.tags, sel)]
            matched.sort(key=lambda i: -i.created)  # newest first (ami.go:236-245)
            return 200, {
                "images": [
                    {"id": i.id, "family": i.family, "created": i.created,
                     "tags": dict(i.tags)}
                    for i in matched
                ]
            }
        if path == "/v1/queue/send":
            raw = (body or {}).get("body", "")
            if not isinstance(raw, str):
                raw = json.dumps(raw)
            # send_raw verbatim: garbage bodies must cross the wire as
            # garbage (the parser-registry noop path and the flight
            # recorder's raw-message capture depend on byte fidelity)
            return 200, {"id": self.queue.send_raw(raw)}
        if path == "/v1/queue/receive":
            n = int((body or {}).get("max_messages", 10))
            msgs = self.queue.receive(n) if n > 0 else []
            return 200, {
                "messages": [
                    {"id": m.id, "body": m.body, "receiveCount": m.receive_count}
                    for m in msgs
                ],
                "count": len(self.queue),
            }
        if path == "/v1/queue/delete":
            self.queue.delete((body or {}).get("id", ""))
            return 200, {}
        if path == "/admin/ice":  # test injection, like fake ICE pools
            key = tuple((body or {})["key"])
            if (body or {}).get("clear"):
                self.insufficient_capacity_pools.discard(key)
            else:
                self.insufficient_capacity_pools.add(key)
            return 200, {}
        if path == "/admin/images":
            self.current_images[(body or {})["key"]] = (body or {})["image"]
            return 200, {}
        return 404, {"error": "not found"}

    # -- HTTP layer ----------------------------------------------------------
    def start(self) -> "CloudHTTPService":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        service = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, body: Optional[Dict]) -> None:
                path = self.path.split("?", 1)[0]
                # server span adopting the caller's trace context: the cloud
                # side of a launch joins the reconcile's trace by trace id,
                # carrying the originating reconcile_id
                attrs = {}
                reconcile_id = self.headers.get("x-karpenter-reconcile-id")
                if reconcile_id:
                    attrs["reconcile_id"] = reconcile_id
                with tracing.TRACER.server_span(
                    f"cloud.{self.command} {path}",
                    traceparent=self.headers.get("traceparent"),
                    **attrs,
                ) as span:
                    status, out = service.handle(path, body)
                    if span is not None:
                        span.attrs["status"] = status
                if status == 0:
                    # scripted connection-level fault: drop the connection
                    # with no response (the client sees a socket error)
                    self.close_connection = True
                    return
                payload = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self) -> None:  # noqa: N802
                self._respond(None)

            def do_POST(self) -> None:  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                self._respond(body)

            def log_message(self, fmt, *args) -> None:
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class HTTPQueue:
    """Interruption-queue client over the /v1/queue/* wire — the same
    receive/delete surface as controllers.interruption.FakeQueue, so the
    InterruptionController consumes the cloud service's queue through a real
    HTTP boundary (the SQS analogue upstream polls). Calls ride the
    provider's resilient transport (retries + breakers)."""

    def __init__(self, provider: "HTTPCloudProvider"):
        self._provider = provider

    def send(self, body: Dict) -> str:
        return self._provider._call("/v1/queue/send", {"body": json.dumps(body)})["id"]

    def send_raw(self, body: str) -> str:
        return self._provider._call("/v1/queue/send", {"body": body})["id"]

    def receive(self, max_messages: int = 10):
        from ..controllers.interruption import QueueMessage

        resp = self._provider._call(
            "/v1/queue/receive", {"max_messages": max_messages}
        )
        return [
            QueueMessage(
                id=m["id"], body=m["body"],
                receive_count=m.get("receiveCount", 0),
            )
            for m in resp.get("messages", [])
        ]

    def delete(self, message_id: str) -> None:
        self._provider._call("/v1/queue/delete", {"id": message_id})

    def __len__(self) -> int:
        return int(
            self._provider._call("/v1/queue/receive", {"max_messages": 0})["count"]
        )


class HTTPCloudProvider(WindowedBatchers, CloudProvider):
    """CloudProvider speaking JSON/HTTP to a CloudHTTPService.

    Client-side responsibilities (mirroring the upstream AWS provider):
    launch policy + ICE cache + instance-type construction + windowed
    terminate/describe batchers for concurrent point calls.
    """

    def __init__(
        self,
        endpoint: str,
        max_instance_types: int = 60,
        catalog_ttl_s: float = 10.0,
        timeout_s: float = 10.0,
        retry_policy: Optional[RetryPolicy] = None,
        breakers: Optional[BreakerSet] = None,
        ice_ttl_s: Optional[float] = None,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.max_instance_types = max_instance_types
        self.catalog_ttl_s = catalog_ttl_s
        self.timeout_s = timeout_s
        # shared resilience layer (utils/resilience.py): transient failures
        # retry with jittered backoff under per-endpoint circuit breakers
        self.retry_policy = retry_policy or RetryPolicy()
        self.breakers = breakers or BreakerSet("cloud")
        self._transport = self._http_transport  # swappable (ScriptedTransport)
        self.unavailable_offerings = (
            UnavailableOfferings(ttl=ice_ttl_s)
            if ice_ttl_s is not None
            else UnavailableOfferings()
        )
        self.node_template_lookup = None  # protocol attr; templates unsupported
        # the service's interruption queue, polled over the wire: handed to
        # the InterruptionController by Operator.new when no explicit queue
        # is injected, so interruption notices cross real HTTP end to end
        self.queue = HTTPQueue(self)
        self._lock = threading.Lock()
        self._catalog_cache: Optional[Tuple[float, List[InstanceType]]] = None
        self._by_name: Dict[str, InstanceType] = {}  # filled by _catalog()
        self._it_cache: Dict[Optional[str], tuple] = {}
        self._images_cache: Optional[Tuple[float, Dict[str, str]]] = None

    # -- transport -----------------------------------------------------------
    def _http_transport(self, path: str, body: Optional[Dict]) -> Dict:
        """One wire attempt; raises the raw urllib errors for classification."""
        url = f"{self.endpoint}{path}"
        if body is None:
            req = urllib.request.Request(url)
        else:
            req = urllib.request.Request(
                url,
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
        # trace propagation: the cloud service opens a server span in the
        # SAME trace (traceparent), stamped with the originating reconcile id
        traceparent = tracing.current_traceparent()
        if traceparent:
            req.add_header("traceparent", traceparent)
        reconcile_id = context_fields().get("reconcile_id")
        if reconcile_id:
            req.add_header("x-karpenter-reconcile-id", str(reconcile_id))
        timeout = self.retry_policy.attempt_timeout_s or self.timeout_s
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def _call(self, path: str, body: Optional[Dict] = None) -> Dict:
        """Transport with retries (429/5xx/connection errors, full-jitter
        backoff, total deadline) under the endpoint's circuit breaker.
        Terminal failures and exhausted retries surface as CloudProviderError
        so callers keep one exception seam."""
        try:
            # client span per call (the cloud API paths are a bounded set):
            # the resilience layer's retries/breaker trips land on it as
            # events, and its traceparent crosses the wire
            with tracing.TRACER.span(f"cloud.client.{path}"):
                return resilient_call(
                    lambda: self._transport(path, body),
                    policy=self.retry_policy,
                    breaker=self.breakers.get(path),
                    service="cloud",
                    endpoint=path,
                )
        except CircuitOpenError as e:
            raise CloudProviderError(f"cloud API circuit open: {e}") from e
        except urllib.error.URLError as e:
            raise CloudProviderError(f"cloud API unreachable: {e}") from e
        except (ConnectionError, TimeoutError, http.client.HTTPException) as e:
            raise CloudProviderError(f"cloud API transport error: {e}") from e

    # -- catalog -------------------------------------------------------------
    def _catalog(self) -> List[InstanceType]:
        with self._lock:
            cached = self._catalog_cache
            if cached is not None and time.monotonic() - cached[0] < self.catalog_ttl_s:
                return cached[1]
        try:
            data = self._call("/v1/instance-types")
        except CloudProviderError as e:
            # the port's: a refresh that fails keeps serving the last catalog
            # fetched (upstream's instance-type controller keeps its last good
            # refresh) and is tried again a TTL later; only a provider that
            # never fetched one raises, so the boot's connectivity check still
            # fails fast. The endpoint's retries and breaker see every failure
            if cached is None:
                raise
            _log.warning("instance-type refresh failed, serving the last catalog for another "
                         "%.1f s: %s", self.catalog_ttl_s, e)
            with self._lock:
                self._catalog_cache = (time.monotonic(), cached[1])
            return cached[1]
        catalog = [
            instance_type_from_description(d, prices=d.get("prices"))
            for d in data.get("types", [])
        ]
        with self._lock:
            self._catalog_cache = (time.monotonic(), catalog)
            self._by_name = {it.name: it for it in catalog}
        return catalog

    def get_instance_types(self, provisioner: Optional[Provisioner]) -> List[InstanceType]:
        """Catalog filtered to the provisioner with the client ICE mask
        applied — same shape as the fake's (cloudprovider.go:155-170)."""
        catalog = self._catalog()
        pname = provisioner.name if provisioner is not None else None
        key = (
            pname,
            provisioner.meta.resource_version if provisioner is not None else None,
            self.unavailable_offerings.seqnum,
            id(catalog),
            int(time.time() // 60),
        )
        cached = self._it_cache.get(pname)
        if cached is not None and cached[0] == key:
            return cached[1]
        out: List[InstanceType] = []
        for it in catalog:
            if provisioner is not None and not it.requirements.compatible(
                provisioner.requirements
            ):
                continue
            offerings = [
                Offering(
                    zone=o.zone,
                    capacity_type=o.capacity_type,
                    price=o.price,
                    available=o.available
                    and not self.unavailable_offerings.is_unavailable(
                        it.name, o.zone, o.capacity_type
                    ),
                    # slice identity passes through: the ICE mask stays
                    # keyed on the (type, zone, ct) pool
                    slice_pod=o.slice_pod,
                    slice_coord=o.slice_coord,
                )
                for o in it.offerings
            ]
            out.append(it.with_offerings(offerings))
        self._it_cache[pname] = (key, out)
        return out

    # -- CloudProvider -------------------------------------------------------
    @property
    def name(self) -> str:
        return "http"

    def create(self, machine: Machine) -> Machine:
        """Client-side policy ordering, server-side fallback walk — ONE wire
        call per launch (CreateFleet-with-overrides)."""
        from .launchpolicy import candidate_offerings

        candidates = candidate_offerings(
            machine.requirements,
            machine.requests,
            self._catalog(),
            is_unavailable=self.unavailable_offerings.is_unavailable,
            max_instance_types=self.max_instance_types,
        )
        if not candidates:
            raise InsufficientCapacityError(
                f"no compatible offerings for machine {machine.name}"
            )
        import uuid

        # lazy: cloudprovider modules stay importable without dragging the
        # solver package (and torch) in at import time
        from ..solver.topology import format_coord as _format_coord

        resp = self._call(
            "/v1/run-instances",
            {
                "name": machine.meta.name,
                "provisioner_name": machine.provisioner_name,
                # idempotency token, minted once per logical launch: every
                # transport retry reuses this body, so an ambiguous failure
                # (timeout after the server committed) replays instead of
                # double-launching; a fresh process mints fresh tokens, so a
                # restarted operator can never collide with old launches
                "client_token": uuid.uuid4().hex,
                "overrides": [
                    [it.name, o.zone, o.capacity_type]
                    + (
                        [
                            o.slice_pod,
                            _format_coord(o.slice_coord)
                            if o.slice_coord is not None
                            else "",
                        ]
                        if o.slice_pod
                        else []
                    )
                    for it, o in candidates
                ],
            },
        )
        # server-side ICE walk feeds the client ICE cache, like per-instance
        # CreateFleet errors feed upstream's cache (instance.go:400-406)
        for a in resp.get("attempted", []):
            t, z, c = a["key"]
            self.unavailable_offerings.mark_unavailable(t, z, c, reason=a["reason"])
        if "error" in resp:
            raise InsufficientCapacityError(
                f"all offerings exhausted for machine {machine.name}",
                offerings=[tuple(a["key"]) for a in resp.get("attempted", [])],
            )
        inst = resp["instance"]
        it = self._by_name[inst["instance_type"]]
        machine.status = MachineStatus(
            provider_id=f"http:///{inst['zone']}/{inst['id']}",
            capacity=it.capacity,
            allocatable=it.allocatable(),
            launched=True,
        )
        machine.meta.labels.update(it.requirements.labels())
        machine.meta.labels[wk.INSTANCE_TYPE] = inst["instance_type"]
        machine.meta.labels[wk.ZONE] = inst["zone"]
        machine.meta.labels[wk.CAPACITY_TYPE] = inst["capacity_type"]
        machine.meta.labels[wk.PROVISIONER_NAME] = machine.provisioner_name
        for key in (wk.SLICE_POD, wk.SLICE_COORD):
            if key in inst.get("tags", {}):
                machine.meta.labels[key] = inst["tags"][key]
        return machine

    def delete(self, machine: Machine) -> None:
        (err,) = self._execute_terminate([machine])
        if err is not None:
            raise err

    def delete_many(self, machines: Sequence[Machine]) -> List[Optional[Exception]]:
        return self._execute_terminate(machines)

    def _execute_terminate(self, machines: Sequence[Machine]) -> List[Optional[Exception]]:
        ids = [_instance_id(m.status.provider_id) for m in machines]
        resp = self._call("/v1/terminate", {"instance_ids": ids})
        out: List[Optional[Exception]] = []
        for iid, r in zip(ids, resp["results"]):
            out.append(
                MachineNotFoundError(f"instance {iid} not found") if r else None
            )
        return out

    def get(self, provider_id: str) -> Machine:
        result = self._execute_describe([provider_id])[0]
        if isinstance(result, BaseException):
            raise result
        return result

    def _execute_describe(self, provider_ids: Sequence[str]) -> List[object]:
        resp = self._call(
            "/v1/describe",
            {"instance_ids": [_instance_id(p) for p in provider_ids]},
        )
        out: List[object] = []
        for pid, inst in zip(provider_ids, resp["instances"]):
            if inst is None or "error" in inst:
                out.append(MachineNotFoundError(f"{pid} not found"))
            else:
                out.append(self._instance_to_machine(inst))
        return out

    def list(self) -> List[Machine]:
        resp = self._call("/v1/instances")
        return [self._instance_to_machine(d) for d in resp["instances"]]

    def _current_images(self) -> Dict[str, str]:
        """TTL-cached image pointers: a drift sweep over N machines fetches
        /v1/images once per window, not N times (the SSM-parameter cache
        shape, amifamily/resolver.go)."""
        with self._lock:
            cached = self._images_cache
            if cached is not None and time.monotonic() - cached[0] < self.catalog_ttl_s:
                return cached[1]
        images = self._call("/v1/images")["images"]
        with self._lock:
            self._images_cache = (time.monotonic(), images)
        return images

    def is_machine_drifted(self, machine: Machine) -> bool:
        """Image drift against the server's current default pointer (the
        isAMIDrifted shape, cloudprovider.go:207-236; this provider has no
        NodeTemplate surface, so only the default-image path exists)."""
        try:
            resp = self._call(
                "/v1/describe",
                {"instance_ids": [_instance_id(machine.status.provider_id)]},
            )
        except CloudProviderError:
            return False
        inst = resp["instances"][0]
        if inst is None or "error" in inst:
            return False
        return inst["image_id"] != self._current_images().get("default", "image-001")

    def liveness_probe(self) -> bool:
        try:
            self._call("/v1/images")
            return True
        except CloudProviderError:
            return False

    # -- test hooks (shared with the conformance suite) ----------------------
    # -- network/image discovery (selector = tag map; upstream
    # subnet.go:213-235, securitygroup.go:53, ami.go:99-133) -----------------
    def describe_subnets(self, selector: Dict[str, str]) -> List[Subnet]:
        out = self._call("/v1/describe-subnets", {"selector": selector})
        return [
            Subnet(id=s["id"], zone=s["zone"], tags=dict(s["tags"]),
                   available_ips=s.get("available_ips", 0))
            for s in out["subnets"]
        ]

    def describe_security_groups(self, selector: Dict[str, str]) -> List[SecurityGroup]:
        out = self._call("/v1/describe-security-groups", {"selector": selector})
        return [
            SecurityGroup(id=g["id"], name=g.get("name", ""), tags=dict(g["tags"]))
            for g in out["groups"]
        ]

    def describe_images(self, selector: Dict[str, str]) -> List[Image]:
        out = self._call("/v1/describe-images", {"selector": selector})
        return [
            Image(id=i["id"], family=i.get("family", ""), created=i.get("created", 0.0),
                  tags=dict(i["tags"]))
            for i in out["images"]
        ]

    def set_insufficient_capacity(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self._call("/admin/ice", {"key": [instance_type, zone, capacity_type]})

    def clear_insufficient_capacity(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self._call(
            "/admin/ice", {"key": [instance_type, zone, capacity_type], "clear": True}
        )

    def rotate_image(self, key: str, image: str) -> None:
        self._call("/admin/images", {"key": key, "image": image})
        with self._lock:
            self._images_cache = None  # test hook: see the rotation at once

    def _instance_to_machine(self, d: Dict) -> Machine:
        it = self._by_name.get(d["instance_type"])
        if it is None:
            self._catalog()
            it = self._by_name[d["instance_type"]]
        m = Machine(
            meta=ObjectMeta(
                name=d["id"],
                creation_timestamp=d.get("created", 0.0),  # GC too-young guard
                labels={
                    **it.requirements.labels(),
                    wk.INSTANCE_TYPE: d["instance_type"],
                    wk.ZONE: d["zone"],
                    wk.CAPACITY_TYPE: d["capacity_type"],
                    wk.PROVISIONER_NAME: d["tags"].get(wk.PROVISIONER_NAME, ""),
                    **{
                        k: d["tags"][k]
                        for k in (wk.SLICE_POD, wk.SLICE_COORD)
                        if k in d["tags"]
                    },
                },
            ),
            provisioner_name=d["tags"].get(wk.PROVISIONER_NAME, ""),
        )
        m.status = MachineStatus(
            provider_id=f"http:///{d['zone']}/{d['id']}",
            capacity=it.capacity,
            allocatable=it.allocatable(),
            launched=True,
        )
        return m

    def close(self) -> None:
        pass


def _instance_id(provider_id: str) -> str:
    return provider_id.rsplit("/", 1)[-1]
