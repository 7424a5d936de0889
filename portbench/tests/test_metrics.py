import statistics

import numpy as np
import pytest

from portbench import counts, harness, roofline


class FakeRun:
    def __init__(self, spans, pods, costs, lbs, trace=None, shapes=None):
        self.rounds = []
        for i, (s, p, c) in enumerate(zip(spans, pods, costs)):
            r = harness.Round()
            r.span, r.pods, r.cost = s, p, c
            r.counts = [np.array([1])]
            r.shapes = (shapes or [[(12, 2310, 100)]] * len(spans))[i]
            self.rounds.append(r)
        self.lbs = [[lb] for lb in lbs]
        self.window_s = sum(spans)
        self.trace = trace
        self.setup_s = 1.0


def read(name, run):
    return harness.load_metric(name)(run)


def test_rate_is_all_work_over_all_time():
    run = FakeRun([0.1, 0.3, 0.2], [50_000, 50_000, 40_000], [1, 1, 1], [1, 1, 1])
    assert read("pods_per_s", run) == pytest.approx(140_000 / 0.6)


def test_p95_is_over_every_round():
    spans = [0.1] * 95 + [1.0] * 5
    run = FakeRun(spans, [1] * 100, [1] * 100, [1] * 100)
    assert read("round_p95_ms", run) == pytest.approx(float(np.percentile(spans, 95)) * 1e3)
    assert read("round_p95_ms.sharded", run) == read("round_p95_ms", run)


def test_cost_ratio_is_a_ratio_of_sums():
    run = FakeRun([1, 1], [1, 1], [10.0, 30.0], [9.0, 11.0])
    assert read("cost_over_lb", run) == pytest.approx(40.0 / 20.0)
    assert read("cost_over_lb", run) != pytest.approx(statistics.mean([10 / 9, 30 / 11]))


def trace(per_round, kernel_s):
    return {"per_round": per_round, "kernel_s": kernel_s, "busy_s": 0.01, "window_s": 1.0}


@pytest.mark.parametrize("metric,which", [("roofline.k2", 0), ("roofline.chain", 1)])
def test_roofline_counts_work_from_shapes_not_launches(metric, which):
    """The same problems solved with one pass or with three (another slot
    budget, S doubled twice) count the same work."""
    spent = {"k2_scan<true>": 0.002, "k2_prices": 0.0005, "k1_units<3>": 0.0001,
             "k3_pack_epilogue": 0.0001}
    one = [{"k3_pack_epilogue": 1, "k2_scan<true>": 2}] * 2
    three = [{"k3_pack_epilogue": 3, "k2_scan<true>": 6}] * 2
    a = FakeRun([0.1, 0.1], [1, 1], [1, 1], [1, 1], trace(one, spent))
    b = FakeRun([0.1, 0.1], [1, 1], [1, 1], [1, 1], trace(three, spent))
    assert read(metric, a) == read(metric, b)
    least = 2 * counts.chain_least_s(12, 2310, 0, 3, 100)[which]
    names = roofline.K2 if which == 0 else roofline.CHAIN
    time = sum(s for n, s in spent.items() if any(k in n for k in names))
    assert read(metric, a) == pytest.approx(100 * least / time)


def test_roofline_is_silent_without_chains():
    run = FakeRun([0.1], [1], [1], [1], trace([{}], {"k2_scan": 0.001}))
    assert read("roofline.k2", run) is None
    assert read("roofline.chain", FakeRun([0.1], [1], [1], [1])) is None


def test_counts_grow_with_shapes_only():
    assert counts.k2_op_count(12, 2310, 0, 3, 100) < counts.k2_op_count(12, 2310, 0, 3, 200)
    assert counts.bound(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound(0, 67e12) == pytest.approx(1.0)


def test_device_idle_and_share_readers():
    run = FakeRun([0.5, 0.5], [1, 1], [1, 1], [1, 1], trace([{}, {}], {}))
    assert read("device_idle", run) == pytest.approx(99.0)
    run.rounds[0].stats = [{"race_host_s": 0.05, "backend": 2.0, "encode_s": 0.02}]
    run.rounds[1].stats = [{"race_host_s": 0.07, "backend": 1.0, "encode_s": 0.04}]
    assert read("kernel_win_share", run) == pytest.approx(50.0)
    assert read("race_host_ms", run) == pytest.approx(60.0)
    assert read("encode_ms", run) == pytest.approx(30.0)


def test_trace_summary_reads_busy_time_inside_rounds():
    from portbench import trace as tr

    class Ev:
        def __init__(self, name, a, b, dev):
            self.name, self.device_type = name, dev

            class R:
                start, end = a, b
            self.time_range = R

    evs = [Ev("portbench.round", 0, 1000, "DeviceType.CPU"),
           Ev("portbench.solve_pods", 100, 900, "DeviceType.CPU"),
           Ev("portbench.round", 2000, 3000, "DeviceType.CPU"),
           Ev("portbench.round", 0, 1000, "DeviceType.CUDA"),
           Ev("k2_scan", 200, 300, "DeviceType.CUDA"),
           Ev("k3_pack_epilogue", 250, 400, "DeviceType.CUDA"),
           Ev("Memcpy HtoD", 1500, 1600, "DeviceType.CUDA")]
    s = tr.summarize(evs)
    assert s["window_s"] == pytest.approx(2000e-6)
    assert s["busy_s"] == pytest.approx(200e-6)
    assert s["per_round"] == [{"k2_scan": 1, "k3_pack_epilogue": 1}, {}]
    assert dict(s["breakdown"]["idle_gaps"])["solve_pods"] == pytest.approx(600e-6)
