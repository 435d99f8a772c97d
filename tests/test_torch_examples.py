"""The port's examples and harness entry point on the CPU, each in its own
process: they exit 0 and print their summary lines.  Their policy and AUC
are held against the reference by ``tests/test_torch_bench*.py``; the
examples are not rerun in JAX here."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd=ROOT):
    # one intra-op thread: the suite runs test files in parallel processes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep +
               str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


SUMMARY = re.compile(r"^\s*(full|cpr-mfu) auc=0\.\d{4} pls=0\.\d{4} "
                     r"ovh=\d+\.\d\d% \(save=")
TRADEOFF = re.compile(r"^  PLS=(0\.02|0\.1|0\.2)\s+auc=0\.\d{4} "
                      r"overhead=\d+\.\d\d% measured_pls=0\.\d{4}$")


def test_torch_quickstart_runs_on_the_cpu():
    r = _run([str(ROOT / "examples" / "torch_quickstart.py"), "--device",
              "cpu"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    # the CTR is numpy's draw, which differs between numpy versions
    assert re.fullmatch(r"26 embedding tables, 16787 rows, CTR=0\.\d{3}",
                        lines[0])
    modes = [m.group(1) for m in map(SUMMARY.match, lines) if m]
    assert modes == ["full", "cpr-mfu"]
    assert lines[-1].startswith("CPR keeps the AUC of full recovery")


def test_torch_cpr_tradeoff_runs_on_the_cpu():
    r = _run([str(ROOT / "examples" / "torch_cpr_tradeoff.py"), "--device",
              "cpu"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert sum(line.startswith("  target PLS=") for line in lines) == 4
    assert [m.group(1) for m in map(TRADEOFF.match, lines) if m] == \
        ["0.02", "0.1", "0.2"]


def test_harness_writes_rows_with_the_device(tmp_path):
    r = _run(["-m", "benchmarks_torch.run", "--device", "cpu", "--fast",
              "--only", "fig3,fig13"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = tmp_path / "artifacts" / "bench_torch"
    assert sorted(p.name for p in out.iterdir()) == ["fig13.json",
                                                     "fig3.json"]
    fig3 = json.loads((out / "fig3.json").read_text())
    want = json.loads((ROOT / "artifacts" / "bench" / "fig3.json")
                      .read_text())
    assert fig3 == [{**row, "device": "cpu"} for row in want]
    assert r.stdout.splitlines()[0] == "name,us_per_call,derived"


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="a GPU is present: the default device is valid")
def test_harness_and_examples_refuse_to_run_without_a_gpu(tmp_path):
    for args in (["-m", "benchmarks_torch.run", "--only", "fig3"],
                 [str(ROOT / "examples" / "torch_quickstart.py")]):
        r = _run(args, cwd=tmp_path)
        assert r.returncode != 0
        assert "pass device='cpu'" in r.stderr
