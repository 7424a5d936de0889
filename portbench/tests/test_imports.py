import subprocess
import sys

from portbench import harness

from .conftest import ROOT


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "karpenter_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in harness.BANNED:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "karpenter_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["jax", "karpenter_tpu"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.adapter, portbench.control, portbench.run\n"
            "import portbench.builders.deployments, portbench.generators.churn\n"
            "import karpenter_tpu_torch.solver, karpenter_tpu_torch.parallel.hostpool\n"
            "from portbench.harness import banned_modules\n"
            "print(banned_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_harness_reads_no_reference_benchmark_files():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "bench.py\"" not in text and "BENCH_" not in text and "import bench" not in text
