import numpy as np
import pytest

from portbench import harness
from portbench.builders import deployments

from .conftest import ROOT, TINY

MIXES = [("delta_50k", "churn"), ("cells_500k", "fleet_churn")]


def config(name):
    cfg = harness.load_json(ROOT / "portbench" / "configs" / f"{name}.json")
    cfg.update(TINY[name])
    return cfg


def traffic(name):
    return harness.load_json(ROOT / "portbench" / "traffic" / f"{name}.json")


def play(cfg, mix, seed, rounds=6):
    inp = harness.load_part("builders", cfg["builder"]).Inputs(cfg, seed)
    params = traffic(mix)
    gen = harness.load_part("generators", params["generator"]).Traffic(params, inp)
    return [gen.next_round() for _ in range(rounds)], inp


@pytest.mark.parametrize("cfg,mix", MIXES)
def test_generators_deterministic_by_seed(cfg, mix):
    a, ia = play(config(cfg), mix, 2**31 + 5)
    b, ib = play(config(cfg), mix, 2**31 + 5)
    c, _ = play(config(cfg), mix, 2**33 + 9)
    assert a == b
    assert [ia.counts(k).tolist() for k in range(ia.n_cells)] == \
        [ib.counts(k).tolist() for k in range(ib.n_cells)]
    assert a != c


@pytest.mark.parametrize("cfg,mix", MIXES)
def test_every_seed_makes_the_same_amount_of_work(cfg, mix):
    def sizes(rounds, inp):
        return [sorted((len(rm), len(ad)) for rm, ad in r.values()) for r in rounds]

    assert sizes(*play(config(cfg), mix, 1)) == sizes(*play(config(cfg), mix, 10**10))


def test_churn_never_empties_a_deployment():
    cfg = config("delta_50k")
    rounds, inp = play(cfg, "churn", 3, rounds=90)
    assert all(len(r[0][0]) == len(r[0][1]) for r in rounds)
    assert inp.counts(0).sum() == cfg["n_pods"]
    assert inp.counts(0).min() > 0


@pytest.mark.parametrize("n_types", [20, 60, 400])
def test_catalog_records_are_the_programs_catalog(n_types):
    from karpenter_tpu_torch.cloudprovider import generate_catalog

    from portbench import adapter, catalog

    mine = [adapter.instance_type(r) for r in catalog.catalog(n_types)]
    theirs = generate_catalog(n_types=n_types)
    assert [t.name for t in mine] == [t.name for t in theirs]
    for a, b in zip(mine, theirs):
        assert a.capacity.to_dict() == b.capacity.to_dict()
        assert a.allocatable().to_dict() == b.allocatable().to_dict()
        assert [(o.zone, o.capacity_type, o.price) for o in a.offerings] == \
            [(o.zone, o.capacity_type, o.price) for o in b.offerings]
        assert a.requirements == b.requirements


def test_demand_units():
    assert deployments.milli_cpu("250m") == 250 and deployments.milli_cpu("2") == 2000
    assert deployments.mem_bytes("512Mi") == 512 * 2**20
    assert deployments.mem_bytes("8Gi") == 8 * 2**30
    inp = deployments.Inputs(config("delta_50k"), 0)
    assert np.array_equal(inp.demand[7], [250, 2 * 1024**3, 1])


@pytest.mark.parametrize("cfg,mix,cycle", [("delta_50k", "churn", 30),
                                           ("cells_500k", "fleet_churn", 12)])
def test_seeds_change_the_order_of_rounds_not_the_rounds(cfg, mix, cycle):
    """Over a whole cycle every seed plays the same moves (cell,
    deployment removed from, deployment added to, how many), in another
    order."""
    def moves(seed):
        rounds, inp = play(config(cfg), mix, seed, rounds=cycle)
        out = []
        for r in rounds:
            for c, (removed, added) in r.items():
                out.append((removed[0].rsplit("-d", 1)[1].split("-")[0], added[0][1],
                            len(removed), len(added)))
        return out

    a, b = moves(5), moves(2**40 + 1)
    assert sorted(a) == sorted(b)
    assert a != b
