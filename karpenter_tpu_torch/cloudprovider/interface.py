"""The CloudProvider seam between the engine and any cloud.

Reference interface: upstream ``pkg/cloudprovider/cloudprovider.go:79-205``
(Create, Delete, Get, List, GetInstanceTypes, IsMachineDrifted, LivenessProbe, Name).
Everything above this protocol (scheduler, controllers) is cloud-agnostic; everything
below it talks to real or fake infrastructure.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.objects import Machine, Provisioner
from .types import InstanceType


class CloudProviderError(Exception):
    #: retry classification consumed by utils/resilience.is_retryable:
    #: provider errors are terminal unless a subclass (or wrapper) says
    #: otherwise — retrying an unclassified failure risks double-launches.
    retryable = False


class TransientCloudError(CloudProviderError):
    """Retryable control-plane failure: throttle (429), 5xx, connection
    reset/timeout. The provisioning path retries these through the shared
    RetryPolicy instead of failing the reconcile round."""

    retryable = True


class InsufficientCapacityError(CloudProviderError):
    """All attempted offerings were unavailable (ICE).

    Mirrors the reference's unfulfillable-capacity error taxonomy
    (upstream pkg/errors/errors.go:31-64)."""

    def __init__(
        self,
        message: str,
        offerings: List[tuple] | None = None,
        reason: str = "ICE",
    ):
        super().__init__(message)
        self.offerings = offerings or []  # [(instance_type, zone, capacity_type)]
        self.reason = reason  # ICE-cache mark reason (e.g. "ICE", "ip-exhaustion")


class MachineNotFoundError(CloudProviderError):
    pass


@dataclass
class Subnet:
    id: str
    zone: str
    available_ips: int = 4096
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroup:
    id: str
    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class Image:
    id: str
    family: str = "default"
    arch: str = "amd64"
    created: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class Instance:
    """A launched cloud instance (fake or real)."""

    id: str
    instance_type: str
    zone: str
    capacity_type: str
    image_id: str = ""
    state: str = "running"
    tags: Dict[str, str] = field(default_factory=dict)
    created: float = 0.0
    # launch-config provenance (reference: instances carry their launch
    # template name + resolved AMI; drift keys on both)
    launch_template: str = ""
    image_family: str = ""
    image_variant: str = ""


class WindowedBatchers:
    """Shared plumbing for the windowed Terminate/Describe batchers
    (reference windows 100ms/1s/500, ``pkg/batcher/{terminateinstances,
    describeinstances}.go:36-39``). A provider mixes this in and supplies
    ``_execute_terminate(machines)`` / ``_execute_describe(provider_ids)``
    (one backend call each, per-item results); concurrent point callers then
    coalesce through ``delete_batched`` / ``get_batched``."""

    _TERMINATE_OPTS = dict(idle_timeout=0.1, max_timeout=1.0, max_items=500)
    _DESCRIBE_OPTS = dict(idle_timeout=0.1, max_timeout=1.0, max_items=500)

    @property
    def _terminate_batcher(self):
        b = getattr(self, "_terminate_batcher_obj", None)
        if b is None:
            from ..utils.batcher import Batcher, BatcherOptions

            b = Batcher(
                request_hasher=lambda m: "terminate",  # all terminations merge
                batch_executor=self._execute_terminate,
                options=BatcherOptions(**self._TERMINATE_OPTS),
            )
            self._terminate_batcher_obj = b
        return b

    @property
    def _describe_batcher(self):
        b = getattr(self, "_describe_batcher_obj", None)
        if b is None:
            from ..utils.batcher import Batcher, BatcherOptions

            b = Batcher(
                request_hasher=lambda pid: "describe",  # one filter shape here
                batch_executor=self._execute_describe,
                options=BatcherOptions(**self._DESCRIBE_OPTS),
            )
            self._describe_batcher_obj = b
        return b

    def delete_batched(self, machine: Machine) -> None:
        """delete() through the terminate batcher: concurrent callers coalesce
        into one TerminateInstances call (terminateinstances.go:40-52)."""
        result = self._terminate_batcher.add(machine)
        if isinstance(result, BaseException):
            raise result

    def get_batched(self, provider_id: str) -> Machine:
        """get() through the describe batcher: concurrent point lookups share
        one DescribeInstances call (describeinstances.go:46-52)."""
        result = self._describe_batcher.add(provider_id)
        if isinstance(result, BaseException):
            raise result
        return result


class CloudProvider(abc.ABC):
    @abc.abstractmethod
    def create(self, machine: Machine) -> Machine:
        """Launch capacity satisfying the machine's requirements; fill status."""

    @abc.abstractmethod
    def delete(self, machine: Machine) -> None: ...

    def delete_many(self, machines: List[Machine]) -> List[Optional[Exception]]:
        """Terminate a known set in as few backend calls as the provider can
        manage (reference batches TerminateInstances at 100ms/1s/500,
        pkg/batcher/terminateinstances.go:36-38). Returns one entry per
        machine: None on success, the exception otherwise — a partial failure
        must not abort the rest of the set. Base implementation loops
        ``delete``; providers override with a real batch call."""
        out: List[Optional[Exception]] = []
        for m in machines:
            try:
                self.delete(m)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - per-item fault isolation
                out.append(e)
        return out

    @abc.abstractmethod
    def get(self, provider_id: str) -> Machine: ...

    @abc.abstractmethod
    def list(self) -> List[Machine]: ...

    @abc.abstractmethod
    def get_instance_types(self, provisioner: Optional[Provisioner]) -> List[InstanceType]: ...

    @abc.abstractmethod
    def is_machine_drifted(self, machine: Machine) -> bool: ...

    def liveness_probe(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return "unknown"
