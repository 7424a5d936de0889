"""Launch templates and image families on the CPU: the port's
``cloudprovider/imagefamily.py`` and ``launchtemplate.py``.

Every family's userdata is held byte for byte to ``tests/testdata``'s
goldens (the JAX package's ``tests/test_userdata_golden.py`` holds its own
to the same files), and the cases of ``tests/test_launchtemplate.py`` run
on the port: content-hash names, ``ensure_all``, eviction and hydration,
the launch path's provenance, and per-family drift. Where a case produces
names, they are held to the JAX package's on a twin provider: the names
are a sha256 over the rendered launch configuration, so equal names mean
equal configurations.
"""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import pytest

from karpenter_tpu_torch.api import (
    Machine,
    ObjectMeta,
    Requirement,
    Requirements,
    Resources,
    Taint,
)
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.objects import NodeTemplate
from karpenter_tpu_torch.cloudprovider import FakeCloudProvider, generate_catalog
from karpenter_tpu_torch.cloudprovider.imagefamily import (
    ClusterInfo,
    ImageResolver,
    get_family,
    is_accelerator,
)
from karpenter_tpu_torch.cloudprovider.launchtemplate import NAME_PREFIX, LaunchTemplateProvider

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
REF, PORT = PACKAGES
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
FAMILIES = ["al2", "ubuntu", "bottlerocket", "custom"]
CUSTOM = "#!/bin/bash\necho custom-part\n"


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(api=imp("api"), objects=imp("api.objects"), taints=imp("api.taints"),
                           cloud=imp("cloudprovider"), family=imp("cloudprovider.imagefamily"),
                           admission=imp("api.admission"))


def context(pkg, custom=None):
    """``tests/test_userdata_golden.py``'s bootstrap context, in ``pkg``."""
    m = pkg_mod(pkg)
    return m.family.BootstrapContext(
        cluster=m.family.ClusterInfo(name="golden-cluster", endpoint="https://golden.local",
                                     ca_bundle="Q0EtQlVORExF", dns_ip="10.0.0.10"),
        kubelet=m.objects.KubeletConfiguration(max_pods=58, cluster_dns=["10.0.0.10"]),
        taints=(m.taints.Taint(key="team", value="ml", effect="NoSchedule"),),
        labels={"team": "ml", "tier": "batch"},
        custom_user_data=custom,
    )


# -- userdata goldens ---------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("custom", [None, CUSTOM], ids=["plain", "custom"])
def test_userdata_matches_golden(family, custom):
    suffix = "_custom" if custom else ""
    with open(os.path.join(TESTDATA, f"userdata_{family}{suffix}.golden")) as f:
        golden = f.read()
    rendered = get_family(family).user_data(context(PORT, custom))
    assert rendered == golden
    ref = pkg_mod(REF).family.get_family(family).user_data(context(REF, custom))
    assert rendered == ref


def test_bottlerocket_custom_merge_preserves_user_keys():
    custom = '[settings.kubernetes]\ncluster-name = "evil"\n[settings.motd]\nbanner = "hi"\n'
    out = get_family("bottlerocket").user_data(context(PORT, custom))
    assert 'cluster-name = "golden-cluster"' in out and 'banner = "hi"' in out


def test_mime_multipart_orders_custom_first():
    out = get_family("al2").user_data(context(PORT, CUSTOM))
    assert out.index("custom-part") < out.index("bootstrap.sh")


def test_families_and_admission_agree_with_reference():
    from karpenter_tpu_torch.api.admission import AdmissionError, validate_node_template
    from karpenter_tpu_torch.cloudprovider.imagefamily import FAMILIES as PORT_FAMILIES

    assert sorted(PORT_FAMILIES) == sorted(pkg_mod(REF).family.FAMILIES)
    for fam in PORT_FAMILIES:
        validate_node_template(NodeTemplate(meta=ObjectMeta(name="t"), image_family=fam))
    with pytest.raises(AdmissionError, match="unknown family"):
        validate_node_template(NodeTemplate(meta=ObjectMeta(name="t"), image_family="windows"))


# -- tests/test_launchtemplate.py ---------------------------------------------


@pytest.fixture
def provider():
    return FakeCloudProvider(catalog=generate_catalog(n_types=20))


@pytest.fixture
def template():
    return NodeTemplate(meta=ObjectMeta(name="default"), image_family="al2",
                        resolved_security_groups=["sg-default", "sg-nodes"])


def machine(provider, template_ref="default", taints=()):
    it = provider.catalog[0]
    return Machine(
        meta=ObjectMeta(name="m1", labels={"team": "web"}),
        provisioner_name="default",
        requirements=Requirements([Requirement.in_values(wk.INSTANCE_TYPE, [it.name])]),
        requests=Resources(cpu="100m"),
        taints=list(taints),
        node_template_ref=template_ref,
    )


def twin_names(family="al2", n_types=5, user_data=None):
    """``ensure_all`` names for one template on twin providers."""
    out = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=20))
        nt = m.objects.NodeTemplate(meta=m.api.ObjectMeta(name="default"), image_family=family,
                                    resolved_security_groups=["sg-default", "sg-nodes"],
                                    user_data=user_data)
        cfgs = provider.launch_template_provider.ensure_all(nt, provider.catalog[:n_types])
        out[pkg] = [(c.name, c.image_id, c.family, c.variant, c.user_data) for c in cfgs]
    return out


@pytest.mark.parametrize("family", ["al2", "ubuntu", "bottlerocket"])
@pytest.mark.parametrize("user_data", [None, CUSTOM], ids=["plain", "custom"])
def test_ensure_all_names_match_reference(family, user_data):
    names = twin_names(family, user_data=user_data)
    assert names[PORT] == names[REF] and names[PORT]


def test_content_hash_dedupe(provider, template):
    lt = provider.launch_template_provider
    cfgs1 = lt.ensure_all(template, provider.catalog[:5])
    cfgs2 = lt.ensure_all(template, provider.catalog[:5])
    assert [c.name for c in cfgs1] == [c.name for c in cfgs2]
    assert all(c.name.startswith(NAME_PREFIX) for c in cfgs1)
    assert len(provider.launch_templates) == len(cfgs1)


def test_input_change_changes_name(provider, template):
    lt = provider.launch_template_provider
    before = {c.name for c in lt.ensure_all(template, provider.catalog[:3])}
    template.user_data = "#!/bin/bash\necho extra"
    after = {c.name for c in lt.ensure_all(template, provider.catalog[:3])}
    assert before.isdisjoint(after)


@pytest.mark.parametrize("family, marker", [
    ("al2", "bootstrap.sh"), ("bottlerocket", "cluster-name"), ("ubuntu", "ubuntu-bootstrap.sh"),
])
def test_userdata_rendered_per_family(provider, family, marker):
    nt = NodeTemplate(meta=ObjectMeta(name=family), image_family=family)
    cfgs = provider.launch_template_provider.ensure_all(nt, provider.catalog[:2])
    assert cfgs and marker in cfgs[0].user_data


def test_custom_family_passthrough(provider):
    nt = NodeTemplate(meta=ObjectMeta(name="c"), image_family="custom",
                      user_data="#!/bin/sh\nmy-bootstrap")
    assert provider.launch_template_provider.ensure_all(nt, provider.catalog[:1]) == []


def test_unknown_family_rejected():
    with pytest.raises(ValueError):
        get_family("windows-2003")


def test_eviction_deletes_provider_side(provider, template):
    now = [0.0]
    lt = LaunchTemplateProvider(store=provider, resolver=ImageResolver(provider), ttl=10.0,
                                clock=lambda: now[0])
    cfgs = lt.ensure_all(template, provider.catalog[:2])
    assert provider.launch_templates
    now[0] = 100.0
    template.user_data = "changed"
    lt.ensure_all(template, provider.catalog[:2])
    for c in cfgs:
        assert c.name not in lt.cached_names() and c.name not in provider.launch_templates


def test_hydration_adopts_existing(provider, template):
    cfgs = provider.launch_template_provider.ensure_all(template, provider.catalog[:2])
    lt2 = LaunchTemplateProvider(store=provider, resolver=ImageResolver(provider))
    created = len(provider.launch_templates)
    cfgs2 = lt2.ensure_all(template, provider.catalog[:2])
    assert {c.name for c in cfgs2} == {c.name for c in cfgs}
    assert len(provider.launch_templates) == created


def test_launch_stamps_config(provider, template):
    provider.node_template_lookup = {"default": template}.get
    m = provider.create(machine(provider))
    inst = provider.instance_for(m)
    assert inst.launch_template.startswith(NAME_PREFIX) and inst.image_family == "al2"
    assert inst.image_id.startswith("img-al2-")
    assert m.meta.annotations[wk.LAUNCH_TEMPLATE_ANNOTATION] == inst.launch_template


def test_no_template_ref_keeps_legacy_image(provider):
    provider.node_template_lookup = {}.get
    inst = provider.instance_for(provider.create(machine(provider, template_ref=None)))
    assert inst.launch_template == "" and inst.image_id == "image-001"


def test_accelerator_variant_selected(template):
    catalog = generate_catalog()
    accel = [it for it in catalog if is_accelerator(it.capacity)]
    assert accel
    provider = FakeCloudProvider(catalog=catalog)
    provider.node_template_lookup = {"default": template}.get
    m = provider.create(Machine(
        meta=ObjectMeta(name="m-acc"), provisioner_name="default",
        requirements=Requirements([Requirement.in_values(wk.INSTANCE_TYPE, [accel[0].name])]),
        requests=Resources(cpu="100m"), node_template_ref="default",
    ))
    inst = provider.instance_for(m)
    assert inst.image_variant == "accelerator" and "accelerator" in inst.image_id


def test_image_rotation_drifts_only_that_family_variant(provider, template):
    provider.node_template_lookup = {"default": template}.get
    m = provider.create(machine(provider))
    assert not provider.is_machine_drifted(m)
    provider.rotate_image("ubuntu", "standard")
    assert not provider.is_machine_drifted(m)
    provider.rotate_image("al2", "accelerator")
    assert not provider.is_machine_drifted(m)
    provider.rotate_image("al2", "standard")
    assert provider.is_machine_drifted(m)


def test_userdata_change_drifts(provider, template):
    provider.node_template_lookup = {"default": template}.get
    m = provider.create(machine(provider))
    assert not provider.is_machine_drifted(m)
    template.user_data = "#!/bin/bash\nnew-generation"
    assert provider.is_machine_drifted(m)


def test_taints_in_userdata_stable_across_drift_checks(provider, template):
    provider.node_template_lookup = {"default": template}.get
    m = provider.create(machine(provider, taints=[Taint(key="team", value="web")]))
    assert not provider.is_machine_drifted(m)


def test_legacy_drift_still_works(provider):
    provider.node_template_lookup = {}.get
    m = provider.create(machine(provider, template_ref=None))
    assert not provider.is_machine_drifted(m)
    provider.rotate_image()
    assert provider.is_machine_drifted(m)


def test_cluster_identity_enters_the_names():
    """``OperatorContext.discover`` hands its ``ClusterInfo`` to the launch
    templates: another cluster name gives other names, in both packages
    alike."""
    from karpenter_tpu_torch.context import OperatorContext
    from karpenter_tpu_torch.api.settings import Settings

    names = []
    for cluster in ("blue", "green"):
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=10))
        OperatorContext.discover(provider=provider, settings=Settings(cluster_name=cluster))
        nt = NodeTemplate(meta=ObjectMeta(name="t"), image_family="al2")
        names.append({c.name for c in provider.launch_template_provider.ensure_all(
            nt, provider.catalog[:2])})
    assert names[0] and names[0].isdisjoint(names[1])
    assert isinstance(provider.launch_template_provider.cluster, ClusterInfo)
