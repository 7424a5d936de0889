"""Each cell driven end to end on the CPU at a tiny size, the chip's look
skipped: the last line must be the contract's."""

import json
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import ROOT, TINY

CELLS = ["delta50k.churn", "cells500k.churn"]


def run(bench, name, traced=False, seconds=0.3):
    spec = next(w for w in bench["workloads"] if w["name"] == name)
    return harness.run_cell(bench, name, 2**31 + 99, seconds, traced, device="cpu",
                            config_override=TINY[spec["config"]])


def well_formed(line: str, bench, name, traced: bool) -> dict:
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    kinds = bench["per_layer" if traced else "end_to_end"]
    names = {m["name"]: m for m in kinds if name in m.get("workloads", [name])}
    for key, m in out["metrics"].items():
        assert key in names and m["unit"] == names[key]["unit"]
        assert isinstance(m["value"], (int, float))
    for key, c in out["checks"].items():
        assert c["value"] <= c["limit"], key
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    return out


@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_a_well_formed_last_line(bench, name):
    out = run(bench, name)
    line = json.dumps(out["result"])
    got = well_formed(line, bench, name, False)
    want = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    assert set(got["metrics"]) == want
    assert out["stderr"][-len(harness.LIMITS):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in got["checks"].items()]


def test_traced_cell_reports_its_layers(bench):
    out = run(bench, "delta50k.churn", traced=True)
    got = well_formed(json.dumps(out["result"]), bench, "delta50k.churn", True)
    assert {"encode_ms", "race_host_ms", "kernel_win_share", "gc_ms"} <= set(got["metrics"])
    assert {"busy_s", "window_s"} <= set(got["device"])
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "delta50k.churn", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
