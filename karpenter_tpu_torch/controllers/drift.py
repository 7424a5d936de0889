"""Drift detection: machines whose cloud image no longer matches the resolved one.

Reference: the feature-gated machine drift controller calls
``CloudProvider.IsMachineDrifted`` (upstream ``pkg/cloudprovider/
cloudprovider.go:182-236``, isAMIDrifted) and annotates the node
``karpenter.sh/voluntary-disruption=drifted``; the deprovisioner then replaces it.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as wk
from ..api.settings import Settings
from ..cloudprovider.interface import CloudProvider
from ..state.cluster import Cluster
from ..utils.events import Recorder


class DriftController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,
        settings: Optional[Settings] = None,
        recorder: Optional[Recorder] = None,
    ):
        self.cluster = cluster
        self.provider = provider
        self.settings = settings or Settings()
        self.recorder = recorder or Recorder()

    def reconcile(self) -> List[str]:
        """Annotate nodes whose machines drifted; returns the annotated names."""
        if not self.settings.drift_enabled:
            return []
        drifted = []
        for node in self.cluster.nodes.values():
            if node.meta.annotations.get(wk.VOLUNTARY_DISRUPTION_ANNOTATION) == "drifted":
                continue
            machine = self.cluster.machine_for_node(node)
            if machine is None:
                continue
            if self.provider.is_machine_drifted(machine):
                node.meta.annotations[wk.VOLUNTARY_DISRUPTION_ANNOTATION] = "drifted"
                self.cluster.update(node)
                self.recorder.publish(
                    "Drifted", "machine image drifted from resolved image",
                    object_name=node.name, object_kind="Node",
                )
                drifted.append(node.name)
        return drifted
