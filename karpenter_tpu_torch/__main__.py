"""Operator entry point: ``python -m karpenter_tpu_torch``.

The analogue of upstream ``cmd/controller/main.go:33-71`` plus the
operator flag surface (settings.md:15-26): flags for the metrics/health port,
leader election, logging, batching and the interruption queue; settings also
ingest from KARPENTER_TPU_* env vars; SIGINT/SIGTERM stop the loops cleanly.

The port's flags are the reference's plus ``--device`` (default ``cuda``),
which places the operator's default ``TorchSolver``: the operator runs on
the card unless its caller asks for the CPU, and without CUDA the solver's
constructor raises. ``--cloud-endpoint`` talks to a ``CloudHTTPService``
through ``HTTPCloudProvider``, ``--cluster-endpoint`` reconciles against a
``ClusterAPIServer`` through ``HTTPCluster`` (both under the settings' retry
policy and circuit breakers), and ``--serve-cluster-api PORT`` serves this
operator's own store. The HA deployment is ``python -m
karpenter_tpu_torch.state.apiserver --port P`` plus two replicas started
with ``--leader-elect --cluster-endpoint ... --cloud-endpoint ...``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="karpenter-tpu", description="TPU-native cluster autoscaler operator"
    )
    p.add_argument("--cluster-name", default=None, help="cluster identity")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="serve /metrics,/healthz,/readyz on this port (0=ephemeral, -1=off)")
    p.add_argument("--metrics-bind", default="0.0.0.0",
                   help="bind address for the metrics/health server (pod probes "
                        "and Prometheus connect to the pod IP, not loopback)")
    p.add_argument("--leader-elect", action="store_true",
                   help="enable leader election before running loops")
    p.add_argument("--leader-elect-lease", default=None,
                   help="lease file path for leader election (default: the "
                        "leader_election_lease_path setting, so a ConfigMap-"
                        "configured shared-volume path survives the flag)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--log-format", choices=("console", "json"), default="console")
    p.add_argument("--batch-idle-duration", type=float, default=None)
    p.add_argument("--batch-max-duration", type=float, default=None)
    p.add_argument("--interruption-queue-name", default=None)
    p.add_argument("--cloud-endpoint", default=None,
                   help="HTTP cloud service endpoint; default is the "
                        "embedded fake provider. Replicas sharing a cluster "
                        "endpoint must also share the cloud.")
    p.add_argument("--leader-lease-duration", type=float, default=15.0)
    p.add_argument("--leader-renew-interval", type=float, default=5.0)
    p.add_argument("--cluster-endpoint", default=None,
                   help="apiserver endpoint (http://host:port) to reconcile "
                        "against; default is the embedded in-process store. "
                        "The reference operator's only mode is remote "
                        "(cmd/controller/main.go:33-71).")
    p.add_argument("--serve-cluster-api", type=int, default=None, metavar="PORT",
                   help="also serve this operator's cluster store as an "
                        "apiserver surface on PORT (watch/list/patch + "
                        "admission over HTTP) for external clients")
    p.add_argument("--tick", type=float, default=0.25, help="loop poll interval")
    p.add_argument("--device", default="cuda",
                   help="torch device of the operator's solver (the card by "
                        "default; 'cpu' runs the kernels' plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .api.settings import Settings
    from .context import OperatorContext
    from .utils.logging import configure, get_logger, kv

    configure(level=args.log_level, fmt=args.log_format)
    log = get_logger("main")

    settings = Settings.from_env()
    overrides = {
        k: v
        for k, v in (
            ("cluster_name", args.cluster_name),
            ("batch_idle_duration", args.batch_idle_duration),
            ("batch_max_duration", args.batch_max_duration),
            ("interruption_queue_name", args.interruption_queue_name),
        )
        if v is not None
    }
    if overrides:
        settings.apply(overrides)

    from .utils.resilience import breaker_set_from_settings, retry_policy_from_settings

    provider = None
    if args.cloud_endpoint:
        from .cloudprovider.httpcloud import HTTPCloudProvider

        provider = HTTPCloudProvider(
            args.cloud_endpoint,
            retry_policy=retry_policy_from_settings(settings),
            breakers=breaker_set_from_settings("cloud", settings),
            ice_ttl_s=settings.insufficient_capacity_ttl,
        )
    ctx = OperatorContext.discover(provider=provider, settings=settings)
    # the solver's modules (torch, the card) load only after the cloud
    # connectivity check: the check runs within a second of the spawn, not
    # after seconds of imports, so a respawned operator does not meet the
    # transient faults its cloud queued while it was down
    from .operator import Operator

    cluster = None
    if args.cluster_endpoint:
        from .state import HTTPCluster

        cluster = HTTPCluster(
            args.cluster_endpoint,
            retry_policy=retry_policy_from_settings(settings),
            breakers=breaker_set_from_settings("apiserver", settings),
            queue_capacity=settings.watch_queue_capacity,
        )
    op = Operator.new(provider=ctx.provider, settings=ctx.settings,
                      cluster=cluster, device=args.device)
    cluster_api = None
    if args.serve_cluster_api is not None:
        if args.cluster_endpoint:
            log.warning(
                "--serve-cluster-api ignored: this operator is a CLIENT of "
                "--cluster-endpoint; serve the API from the store owner"
            )
        else:
            from .state import ClusterAPIServer

            cluster_api = ClusterAPIServer(
                backing=op.cluster, port=args.serve_cluster_api
            ).start()
    import logging

    kv(log, logging.INFO, "operator starting",
       cluster=ctx.settings.cluster_name, region=ctx.region)

    elector = None
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    # The HTTP surface comes up BEFORE leader election: a standby replica must
    # answer /healthz and /readyz (Ready = able to serve and take over; the
    # reference serves readiness independent of leadership) or the kubelet
    # probes wedge a multi-replica rollout. Leadership is observable on
    # /leaderz (cmd/controller/main.go:33-71 serves manager endpoints
    # regardless of leadership).
    http_server = None
    if args.metrics_port >= 0:
        from .utils.httpserver import OperatorHTTPServer

        http_server = OperatorHTTPServer(
            port=args.metrics_port,
            host=args.metrics_bind,
            leader_check=lambda: elector is None or elector.is_leader,
            recorder=op.recorder,
        ).start()

    # leader election comes from the CLI flag OR the settings surface
    # (settings.leader_election_enabled — the ConfigMap/env path HA
    # deployments use). The lease path: an EXPLICIT --leader-elect-lease
    # wins, otherwise the setting — the flag's old built-in default must not
    # shadow a ConfigMap-configured shared-volume path, or every replica
    # elects on its own node-local /tmp file (split-brain, the exact
    # duplicate-launch failure the soak audits).
    leader_elect = args.leader_elect or ctx.settings.leader_election_enabled
    if leader_elect:
        from .utils.leaderelection import LeaderElector

        lease_path = (
            args.leader_elect_lease or ctx.settings.leader_election_lease_path
        )
        # on_lost=stop.set: a deposed leader must stop reconciling, not just
        # flip /readyz — two live reconcilers is split-brain (the reference's
        # controller-runtime exits the process on lost leadership)
        elector = LeaderElector(
            lease_path,
            lease_duration=args.leader_lease_duration,
            renew_interval=args.leader_renew_interval,
            on_lost=stop.set,
        )
        kv(log, logging.INFO, "waiting for leadership", lease=lease_path)
        if not elector.acquire(stop=stop):
            if http_server is not None:
                http_server.stop()
            return 0  # stopped before becoming leader
        kv(log, logging.INFO, "became leader", identity=elector.identity)
        # hand the lease to the operator: its ordered close() releases it
        # BEFORE the port drops, so a SIGTERM'd leader hands over at once
        op.elector = elector

    try:
        op.run(stop, tick=args.tick, http_server=http_server)
    finally:
        if elector is not None:
            elector.release()  # idempotent after op.close() released it
        if cluster_api is not None:
            cluster_api.stop()
        if cluster is not None:
            cluster.close()
    kv(log, logging.INFO, "operator stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
