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

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import parallel as ref_parallel
from karpenter_tpu.api import ObjectMeta, Pod, Provisioner, Resources
from karpenter_tpu.cloudprovider import generate_catalog
from karpenter_tpu.solver import EncodeSession, TPUSolver
from karpenter_tpu.solver.jax_solver import PackInputs
from karpenter_tpu.solver.staging import DeviceStager as RefStager
from karpenter_tpu_torch import parallel
from karpenter_tpu_torch.solver import DeviceStager, staging
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


#: leaves whose rows a perturbed round bumps: 1-D and N-D, bool, int32 and
#: float32, rows of 1, 4, 12, 16, 64 and 512 bytes
BUMPED = ("demand", "quota", "colocate", "compat", "alloc", "price", "opt_valid", "ex_compat",
          "orders", "alphas", "count", "rel_set")


def _perturbed_rounds(rounds, seed=5):
    """The delta rounds, each followed by one that changes a few rows of
    several leaves at once, at most half of each leaf's rows, so that
    several leaves of one call restage (and restage back the round after)."""
    rng = np.random.default_rng(seed)
    out = []
    for leaves in rounds:
        out.append(leaves)
        bumped = dict(leaves)
        for name in rng.choice(BUMPED, size=int(rng.integers(3, 7)), replace=False):
            a = leaves[name].copy()
            rows = rng.choice(a.shape[0], size=int(rng.integers(1, a.shape[0] // 2 + 1)), replace=False)
            a[rows] = ~a[rows] if a.dtype == np.bool_ else a[rows] + 1
            bumped[name] = a
        out.append(bumped)
    return out


def _mesh_puts(shape):
    """Placements of every leaf by the rule table, on logical CPU shards for
    the port and on the JAX package's CPU devices for the reference."""
    n = shape[0] * shape[1]
    mesh, ref_mesh = parallel.make_mesh2d(shape, devices=["cpu"] * n), ref_parallel.make_mesh2d(shape)
    return (lambda k, v: parallel.device_put(v, parallel.mesh_sharding(mesh, k, v.shape)),
            lambda k, v: jax.device_put(v, ref_parallel.mesh_sharding(ref_mesh, k, v.shape)))


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)], ids=["flat", "mesh2x2"])
def test_multi_leaf_restages_match_reference_stager(rounds, mesh_shape):
    """Rounds in which several leaves of one call restage, flat and placed
    on a 2x2 mesh of logical CPU shards: the port's ``last_round``,
    ``stats`` and staged bytes equal the reference's, and every call's
    patches go as one batch for its one device: a patch for each restaged
    leaf, or for each shard block of it that changed."""
    ref, port = RefStager(), DeviceStager(device="cpu")
    put, ref_put = _mesh_puts(mesh_shape) if mesh_shape else (None, None)
    most = 0
    for leaves in _perturbed_rounds(rounds):
        ref_out = ref.stage(_tag(leaves), leaves, put=ref_put)
        out = port.stage(_tag(leaves), leaves, put=put)
        assert port.last_round == ref.last_round
        restaged = port.last_round["restage"]
        most = max(most, restaged)
        for name, leaf in leaves.items():
            got = out[name].full() if mesh_shape else out[name]
            assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(leaf))), name
            np.testing.assert_array_equal(np.asarray(ref_out[name]), got.numpy())
        patch = port.last_patch
        assert patch["devices"] == (1 if restaged else 0) and patch["launches"] == 0
        if mesh_shape:
            assert patch["entries"] >= restaged
        else:
            assert patch["entries"] == restaged
    assert most >= 4
    assert port.stats == ref.stats and port.stats["restages"] > 0
    assert port.resident_bytes() == ref.resident_bytes()


def test_packed_patch_layout_is_exact():
    """Every patch's indices and rows lie in the packed buffer at 16-byte
    aligned offsets, without overlap, byte for byte: 1-D and N-D leaves of
    int8, bool, int32 and float32, rows of 1, 3, 4, 5, 12 and 20 bytes."""
    rng = np.random.default_rng(2)
    shapes = (((9,), np.int8), ((7, 3), np.int8), ((12, 5), np.bool_), ((5,), np.int32),
              ((6, 3), np.float32), ((8, 5), np.float32), ((4, 1), np.bool_), ((3,), np.float32))
    patches = []
    for shape, dtype in shapes:
        dst = torch.from_numpy((rng.random(shape) * 50).astype(dtype))
        idx = np.sort(rng.choice(shape[0], size=int(rng.integers(1, shape[0] + 1)), replace=False))
        src = np.ascontiguousarray((rng.random((len(idx),) + shape[1:]) * 50).astype(dtype))
        patches.append((dst, idx.astype(np.int64), src))
    offs, total = staging.patch_layout(patches)
    buf = np.full(total, 0xA5, np.uint8)
    staging.pack_patches(patches, offs, buf)
    spans = []
    for (_, idx, src), (io, so) in zip(patches, offs):
        assert io % 16 == 0 and so % 16 == 0
        assert buf[io:io + idx.nbytes].view(np.int64).tolist() == idx.tolist()
        assert buf[so:so + src.nbytes].tobytes() == src.tobytes()
        spans += [(io, io + idx.nbytes), (so, so + src.nbytes)]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= total < spans[-1][1] + 16
    # the plain version of the batch: index_copy_ leaf by leaf
    want = [staging.stage_patch_ref(d.clone(), torch.from_numpy(i), torch.from_numpy(r))
            for d, i, r in patches]
    assert staging.stage_patches(patches) == 0
    for (dst, _, _), w in zip(patches, want):
        assert torch.equal(dst, w)


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
