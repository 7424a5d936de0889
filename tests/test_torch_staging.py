"""The port's DeviceStager against the JAX package's, on the CPU.

Both stage the same numpy leaves: the padded problem arrays of a delta
sequence shaped like ``bench.bench_device_staging`` (a deployment-shaped
fleet of 1,000 pods whose churn moves 1% per round through an
``EncodeSession``), prepared by the JAX package's ``TPUSolver._prepare``.
Per round, the two must agree on every leaf's outcome (hit, restage with its
churned row count, full upload) and byte count, the port's tensors must
equal the leaves, and the restaged rows must equal an independent host diff.
Everything here is exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.api import ObjectMeta, Pod, Provisioner, Resources
from karpenter_tpu.cloudprovider import generate_catalog
from karpenter_tpu.solver import EncodeSession, TPUSolver
from karpenter_tpu.solver.jax_solver import PackInputs
from karpenter_tpu.solver.staging import DeviceStager as RefStager
from karpenter_tpu_torch.solver import DeviceStager
from karpenter_tpu_torch.solver import torch_solver as ts


def _delta_rounds(n_pods=1000, churn=0.01, rounds=6, n_types=50):
    """The leaves of the first encode and of each churn round."""
    prov = Provisioner(meta=ObjectMeta(name="default"))
    provs = [(prov, generate_catalog(n_types=n_types))]
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi"]
    n_deploys = 20

    def mkpod(name, shape):
        return Pod(meta=ObjectMeta(name=name),
                   requests=Resources(cpu=cpus[shape % 6], memory=mems[(shape // 2) % 6]))

    per = n_pods // n_deploys + 1
    pods = [mkpod(f"d{shape}-{i}", shape) for shape in range(n_deploys) for i in range(per)][:n_pods]
    session = EncodeSession()
    solver = TPUSolver(portfolio=8, auto_mesh=False, mesh=None)

    def leaves_of(problem):
        inputs, orders, alphas, looks, rsvs, swaps, _, _ = solver._prepare(problem)
        d = {f: np.asarray(getattr(inputs, f)) for f in PackInputs._fields}
        d.update(orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps)
        return d

    out = [leaves_of(session.encode(pods, provs))]
    n_churn = max(int(n_pods * churn) // 2, 1)
    serial = 0
    for r in range(rounds):
        down, up = r % n_deploys, (r + 7) % n_deploys
        removed = [p for p in pods if p.meta.name.startswith(f"d{down}-")][:n_churn]
        added = [mkpod(f"up{serial + i}-d{up}", up) for i in range(n_churn)]
        serial += n_churn
        gone = {p.meta.name for p in removed}
        pods = [p for p in pods if p.meta.name not in gone] + added
        for p in removed:
            session.pod_event("DELETED", p)
        for p in added:
            session.pod_event("ADDED", p)
        out.append(leaves_of(session.encode(pods, provs)))
    return out


@pytest.fixture(scope="module")
def rounds():
    return _delta_rounds()


def _tag(leaves):
    G, R = leaves["demand"].shape
    return ("cell", G, leaves["price"].shape[0], leaves["ex_valid"].shape[0],
            leaves["rel_zone_bits"].shape[0], R, leaves["orders"].shape[0])


def _changed_rows(old, new):
    if old.ndim == 0 or old.shape[0] == 0:
        return 0
    diff = old != new
    return int(diff.sum() if old.ndim == 1 else diff.reshape(old.shape[0], -1).any(axis=1).sum())


def _assert_staged(out, leaves):
    assert set(out) == set(leaves)
    for name, leaf in leaves.items():
        assert out[name].device.type == "cpu"
        assert torch.equal(out[name], torch.from_numpy(np.ascontiguousarray(leaf))), name


def test_delta_rounds_match_reference_stager(rounds):
    ref, port = RefStager(), DeviceStager(device="cpu")
    before = dict(ts.LAUNCHES)
    restaged = 0
    prev = None
    for leaves in rounds:
        ref_out = ref.stage(_tag(leaves), leaves)
        out = port.stage(_tag(leaves), leaves)
        assert port.last_round == ref.last_round
        _assert_staged(out, leaves)
        for name in leaves:
            np.testing.assert_array_equal(np.asarray(ref_out[name]), out[name].numpy())
        if prev is not None:
            # the restaged rows are exactly the churned rows of an
            # independent diff of consecutive rounds
            for name, rows in port.last_round["rows"].items():
                assert rows == _changed_rows(prev[name], leaves[name]), name
            restaged += port.last_round["restage"]
        prev = leaves
    assert restaged > 0 and port.stats == ref.stats
    assert port.hit_rate() == ref.hit_rate() > 0.5
    assert port.resident_bytes() == ref.resident_bytes()
    assert ts.LAUNCHES == before  # CPU tensors take the plain versions


def test_clean_repeat_moves_nothing(rounds):
    port = DeviceStager(device="cpu")
    leaves = rounds[-1]
    port.stage(_tag(leaves), leaves)
    out = port.stage(_tag(leaves), {k: v.copy() for k, v in leaves.items()})
    assert port.last_round["hit"] == len(leaves)
    assert port.last_round["restage"] == port.last_round["full"] == 0
    assert port.last_round["bytes_transferred"] == 0
    _assert_staged(out, leaves)


def test_shape_change_invalidates(rounds):
    ref, port = RefStager(), DeviceStager(device="cpu")
    leaves = rounds[0]
    grown = dict(leaves, count=np.zeros(leaves["count"].shape[0] * 2, np.int32))
    for st in (ref, port):
        st.stage(("cell",), leaves)
        st.stage(("cell",), grown)
    assert port.stats["invalidates"] == ref.stats["invalidates"] == 1
    assert port.last_round == ref.last_round
    assert port.last_round["full"] == len(leaves) and port.last_round["hit"] == 0
    # a dtype change and a changed leaf set invalidate too
    for st in (ref, port):
        st.stage(("cell",), dict(grown, count=grown["count"].astype(np.int64)))
        st.stage(("cell",), {k: v for k, v in grown.items() if k != "swaps"})
    assert port.stats["invalidates"] == ref.stats["invalidates"] == 3
    port.invalidate()
    ref.invalidate("test")
    assert port.stats == ref.stats and port.resident_bytes() == 0


@pytest.mark.parametrize("capacity_mb", [0, 1, 256])
def test_eviction_follows_capacity(rounds, capacity_mb):
    ref, port = RefStager(capacity_mb=capacity_mb), DeviceStager(capacity_mb=capacity_mb, device="cpu")
    for i, leaves in enumerate(rounds * 20):
        for st in (ref, port):
            st.stage(("tag", i % 60), leaves)
    assert list(port._entries) == list(ref._entries)
    assert port.stats == ref.stats
    n = len(port._entries)
    assert {0: n == 1, 1: 1 < n < 60, 256: n == 60}[capacity_mb], n
    assert (port.stats["evicts"] > 0) == (capacity_mb < 256)


def test_patch_rejects_rows_outside_the_resident_leaf(rounds):
    """The scatter kernel trusts its indices, so the stager checks them on
    the host: a churned row past the end of the resident tensor raises and
    leaves the tensor as it was."""
    port = DeviceStager(device="cpu")
    leaves = rounds[0]
    out = port.stage(_tag(leaves), leaves)
    # the tensors do not share the caller's memory
    assert out["count"].data_ptr() != leaves["count"].__array_interface__["data"][0]
    short = out["count"][:-1].clone()
    port._entries[_tag(leaves)].dev["count"] = short
    before = short.clone()
    churned = leaves["count"].copy()
    churned[-1] += 1
    with pytest.raises(ValueError, match="outside the resident leaf"):
        port.stage(_tag(leaves), dict(leaves, count=churned))
    assert torch.equal(short, before)
