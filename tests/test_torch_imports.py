"""The port stands alone: nothing under karpenter_tpu_torch/ (nor the chip
smoke script) imports JAX or the JAX package, and its solver refuses to run
on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "karpenter_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "karpenter_tpu")


def _forbidden(module: str) -> bool:
    # exact names: karpenter_tpu_torch itself must not trip the scan
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_scan_sees_the_whole_port():
    assert "karpenter_tpu_torch/solver/torch_solver.py" in PORT_FILES
    assert "karpenter_tpu_torch/controllers/provisioning.py" in PORT_FILES
    for name in ("deprovisioning", "drift", "garbagecollect", "interruption", "nodetemplate",
                 "metricsscraper/__init__", "metricsscraper/node", "metricsscraper/pod",
                 "metricsscraper/provisioner"):
        assert f"karpenter_tpu_torch/controllers/{name}.py" in PORT_FILES
    for name in ("operator", "__main__", "context", "cloudprovider/imagefamily",
                 "cloudprovider/launchtemplate", "utils/riskcache", "utils/costledger",
                 "utils/runtimehealth", "utils/gctuning", "utils/leaderelection",
                 "utils/httpserver"):
        assert f"karpenter_tpu_torch/{name}.py" in PORT_FILES
    assert len(PORT_FILES) >= 18


def test_scan_matches_names_exactly():
    src = "import jax.numpy\nfrom karpenter_tpu.solver import x\nimport karpenter_tpu_torch\nimport jaxlib_like"
    assert [m for m in imported_modules(src) if _forbidden(m)] == ["jax.numpy", "karpenter_tpu.solver"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    bad = [m for m in imported_modules((ROOT / path).read_text()) if _forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import karpenter_tpu_torch, karpenter_tpu_torch.api, karpenter_tpu_torch.cloudprovider\n"
        "import karpenter_tpu_torch.solver, karpenter_tpu_torch.solver._build, karpenter_tpu_torch.configs\n"
        "import karpenter_tpu_torch.controllers, karpenter_tpu_torch.state, karpenter_tpu_torch.utils\n"
        "import karpenter_tpu_torch.operator, karpenter_tpu_torch.__main__, karpenter_tpu_torch.context\n"
        "import karpenter_tpu_torch.utils.httpserver, karpenter_tpu_torch.utils.leaderelection\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'karpenter_tpu')"
        " or m.startswith(('jax.', 'karpenter_tpu.')))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == ""


def test_torch_solver_defaults_to_the_card():
    from karpenter_tpu_torch.solver import TorchSolver

    if torch.cuda.is_available():
        assert TorchSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSolver()
    assert TorchSolver(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    from karpenter_tpu_torch.solver import torch_solver as ts

    inputs = ts.PackInputs(**{
        f: torch.zeros((2, 3) if f in ("demand", "demand_units", "alloc", "ex_rem") else (2,),
                       dtype=dt)
        for f, dt in ts._FIELD_DTYPES.items()
    })
    with pytest.raises(ValueError):
        ts._check_inputs(inputs, 2)  # quota, compat and ex_compat are not [G, Z], [G, O], [G, E]
