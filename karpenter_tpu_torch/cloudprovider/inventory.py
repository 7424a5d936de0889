"""Shared network/image inventory defaults + tag-selector semantics.

Both cloud backends (the in-process fake and the HTTP cloud service) expose
the SAME discovery contract — subnets, security groups, images resolved by
tag selector (reference ``subnet.go:213-235``, ``securitygroup.go:53``,
``ami.go:99-133``) — and the conformance suite pins them together. One
constructor here keeps the inventories and the matcher from drifting apart
(a backend switch must not change what a selector resolves to).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .interface import Image, SecurityGroup, Subnet


def tags_match(tags: Dict[str, str], selector: Dict[str, str]) -> bool:
    """Tag selector semantics: every selector entry must match; '*' matches
    any value (key presence); the special key 'id' is handled by callers."""
    for k, v in selector.items():
        if v == "*":
            if k not in tags:
                return False
        elif tags.get(k) != v:
            return False
    return True


def default_inventory(
    zones: List[str],
) -> Tuple[List[Subnet], List[SecurityGroup], List[Image], Dict[str, str]]:
    """(subnets, security_groups, images, current_images) for a cluster over
    ``zones``: one discovery-tagged subnet per zone, the default + node
    security groups, and the per-(family, variant) image inventory with
    current pointers (the SSM default-AMI-parameter analogue,
    reference ``amifamily/{al2,bottlerocket,ubuntu}.go`` DefaultAMIs)."""
    subnets = [
        Subnet(
            id=f"subnet-{z}", zone=z,
            tags={"karpenter.tpu/discovery": "cluster", "zone": z},
        )
        for z in zones
    ]
    security_groups = [
        SecurityGroup(id="sg-default", name="default",
                      tags={"karpenter.tpu/discovery": "cluster"}),
        SecurityGroup(id="sg-nodes", name="nodes",
                      tags={"karpenter.tpu/discovery": "cluster", "role": "node"}),
    ]
    images = [
        Image(id="image-001", family="default", created=1.0,
              tags={"family": "default"})
    ]
    current_images = {"default": "image-001"}
    for fam in ("al2", "ubuntu", "bottlerocket"):
        for variant in ("standard", "accelerator"):
            img = f"img-{fam}-{variant}-001"
            images.append(
                Image(id=img, family=fam, created=1.0,
                      tags={"family": fam, "variant": variant})
            )
            current_images[f"{fam}/{variant}"] = img
    return subnets, security_groups, images, current_images
