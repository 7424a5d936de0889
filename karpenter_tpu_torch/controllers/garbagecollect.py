"""Machine garbage collection + orphan adoption (linking).

Reference: ``pkg/controllers/machine/garbagecollect`` deletes cloud instances that
are ManagedBy-tagged but have no in-cluster Machine and are older than a minute
(``controller.go:57-111``); ``pkg/controllers/machine/link`` adopts instances
tagged by a provisioner but not yet represented as Machines
(``controller.go:64-115``) and deletes orphans whose provisioner is gone.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..api import labels as wk
from ..api.objects import Machine
from ..cloudprovider.interface import CloudProvider, MachineNotFoundError
from ..state.cluster import Cluster
from ..utils.cache import Clock
from ..utils.events import Recorder

LINK_ANNOTATION = f"{wk.GROUP}/linked"
MIN_AGE_SECONDS = 60.0


class GarbageCollectionController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,
        recorder: Optional[Recorder] = None,
        clock: Optional[Clock] = None,
        min_age_s: float = MIN_AGE_SECONDS,
    ):
        self.cluster = cluster
        self.provider = provider
        self.recorder = recorder or Recorder()
        self.clock = clock or Clock()
        # too-young-to-collect guard (reference: 1 minute): an instance whose
        # launch RPC just returned may not have its Machine written yet —
        # crash-recovery tests shrink this to exercise orphan collection
        # without waiting out the minute
        self.min_age_s = min_age_s

    def reconcile(self) -> dict:
        """One GC pass: adopt linkable instances, collect orphaned ones.
        Returns {"adopted": [...], "collected": [...]}."""
        adopted: List[str] = []
        collected: List[str] = []
        orphans: List[object] = []
        known_ids = {
            m.status.provider_id for m in self.cluster.machines.values() if m.status.provider_id
        }
        for machine in self.provider.list():
            pid = machine.status.provider_id
            if pid in known_ids:
                continue
            provisioner_name = machine.provisioner_name
            # the machine's creation stamp comes from the provider's instance
            # conversion (carried on meta), so the too-young launch guard works
            # for ANY provider, not only the fake's instance_for hook
            instance = getattr(self.provider, "instance_for", lambda m: None)(machine)
            created = instance.created if instance else machine.meta.creation_timestamp
            age = self.clock.now() - created
            if provisioner_name and provisioner_name in self.cluster.provisioners:
                # adoption: create the Machine object and mark it linked
                machine.meta.annotations[LINK_ANNOTATION] = pid
                self.cluster.add_machine(machine)
                adopted.append(machine.name)
                self.recorder.publish("Linked", f"adopted instance {pid}",
                                      object_name=machine.name, object_kind="Machine")
                continue
            if age < self.min_age_s:
                continue  # too young: launch may still be registering
            orphans.append(machine)
        # one batched TerminateInstances call for the whole orphan sweep
        # (reference batches terminate, terminateinstances.go:36-38); empty
        # sweeps must not make (or count) a backend call
        results = self.provider.delete_many(orphans) if orphans else []
        for machine, err in zip(orphans, results):
            if err is not None and not isinstance(err, MachineNotFoundError):
                continue  # transient failure: retry next pass
            pid = machine.status.provider_id
            # also remove any node object pointing at the dead instance
            for node in list(self.cluster.nodes.values()):
                if node.provider_id == pid:
                    self.cluster.delete_node(node.name)
            collected.append(machine.name)
            self.recorder.publish("GarbageCollected", f"deleted orphan instance {pid}",
                                  object_name=machine.name, object_kind="Machine")
        return {"adopted": adopted, "collected": collected}
