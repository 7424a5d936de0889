"""NodeTemplate status controller: resolve selectors to concrete infrastructure.

Reference: ``pkg/controllers/nodetemplate`` reconciles AWSNodeTemplate.status by
resolving the subnet and security-group selectors to concrete ids every 5 minutes
(``controller.go:55-65,79-112``). Here images resolve too (newest first), feeding
the drift check.
"""

from __future__ import annotations

from typing import List, Optional

from ..cloudprovider.interface import CloudProvider
from ..state.cluster import Cluster
from ..utils.events import Recorder


class NodeTemplateController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,  # any provider with describe_* discovery
        recorder: Optional[Recorder] = None,
    ):
        self.cluster = cluster
        self.provider = provider
        self.recorder = recorder or Recorder()

    def reconcile(self) -> List[str]:
        updated = []
        for template in self.cluster.node_templates.values():
            subnets = [
                s.id for s in self.provider.describe_subnets(template.subnet_selector)
            ]
            groups = [
                g.id
                for g in self.provider.describe_security_groups(
                    template.security_group_selector
                )
            ]
            images = [i.id for i in self.provider.describe_images(template.image_selector)]
            if (
                subnets != template.resolved_subnets
                or groups != template.resolved_security_groups
                or images != template.resolved_images
            ):
                template.resolved_subnets = subnets
                template.resolved_security_groups = groups
                template.resolved_images = images
                self.cluster.update(template)
                updated.append(template.name)
        return updated
