"""A traffic mix with a generator of its own, added as new files and a new
``BENCHMARK.json`` entry alone: a copy of the benchmark runs it with no file
that was there edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from .conftest import ROOT, TINY

GENERATOR = '''
"""Scale-up: each round adds ``add`` pods to one deployment of one cell."""


class Traffic:
    session = True

    def __init__(self, params, inputs):
        self.p, self.inp, self.r = params, inputs, 0

    def next_round(self):
        inp, r = self.inp, self.r
        self.r += 1
        c, d = r % inp.n_cells, r % inp.n_deploys
        added = [(f"c{c}-g{r}-{i}-d{d}", d) for i in range(self.p["add"])]
        inp.live[c][d].extend(name for name, _ in added)
        return {c: ([], added)}

    def apply(self, program, raw):
        return {c: program.churn(c, *ev) for c, ev in raw.items()}

    def solve(self, cell, events):
        return cell.solve_cells(events)
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_generator_runs_from_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "delta50k.grow", "config": "delta_50k",
                               "traffic": "grow", "chips": 1, "why": "scale-ups"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "generators" / "grow.py").write_text(GENERATOR)
    (tmp_path / "portbench" / "traffic" / "grow.json").write_text(json.dumps(
        {"generator": "grow", "add": 40, "warmup_rounds": 1, "rounds_per_s": 10,
         "check_rounds": 2, "trace_rounds": 2}))
    after = digests(tmp_path)
    changed = {k for k in before if after[k] != before[k]}
    assert changed == {Path("BENCHMARK.json")}
    assert set(after) - set(before) == {Path("portbench/generators/grow.py"),
                                        Path("portbench/traffic/grow.json")}
    code = ("import json, sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness\n"
            "assert harness.__file__.startswith(%r)\n"
            "bench = json.load(open(%r))\n"
            "out = harness.run_cell(bench, 'delta50k.grow', 2**31 + 17, 0.3, False, "
            "device='cpu', config_override=%r)\n"
            "print(json.dumps(out['result']))"
            % (str(tmp_path), str(ROOT), str(tmp_path), str(tmp_path / "BENCHMARK.json"),
               TINY["delta_50k"]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                      if "workloads" not in m}
