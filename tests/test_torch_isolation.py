"""The port stands alone: no jax, nothing of ``repro`` (nor of the
reference's harness, ``benchmarks``), and the repo's invariant rules hold
over it, checked by the port's own linter (``python -m
repro_torch.analysis``) and equal to the reference's report over it.  The port is ``src/repro_torch/``, its harness
``benchmarks_torch/`` and its examples ``examples/torch_*.py``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
HARNESS = ROOT / "benchmarks_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _modules(root, paths):
    for path in paths:
        parts = list(path.relative_to(root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def _port_modules():
    yield from _modules(PORT.parent, sorted(PORT.rglob("*.py")))
    yield from _modules(ROOT, sorted(HARNESS.glob("*.py")))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT)
    return env


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for m in ("repro_torch.core.emulator", "repro_torch.core.transport",
              "repro_torch.core.sharded_checkpoint",
              "repro_torch.launch.shard_server",
              "repro_torch.analysis.protocol.spec",
              "repro_torch.analysis", "repro_torch.analysis.__main__",
              "repro_torch.analysis.core", "repro_torch.analysis.lockorder",
              "repro_torch.analysis.rules",
              "repro_torch.analysis.rules.durability",
              "repro_torch.analysis.rules.epochs",
              "repro_torch.analysis.rules.exceptions",
              "repro_torch.analysis.rules.locks",
              "repro_torch.analysis.rules.protocol",
              "repro_torch.analysis.rules.timesource",
              "repro_torch.analysis.protocol",
              "repro_torch.analysis.protocol.__main__",
              "repro_torch.analysis.protocol.model",
              "repro_torch.analysis.protocol.fuzz",
              "repro_torch.kernels.row_hash",
              "repro_torch.models.transformer", "repro_torch.models.moe",
              "repro_torch.launch.serve",
              "repro_torch.launch.train", "repro_torch.data.synthetic",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.rglru_scan",
              "repro_torch.sharding.specs", "repro_torch.sharding.ctx",
              "repro_torch.sharding.collectives", "repro_torch.launch.mesh",
              "repro_torch.launch.steps", "repro_torch.launch.roofline",
              "repro_torch.launch.dryrun", "repro_torch.launch.report",
              "benchmarks_torch.run",
              "benchmarks_torch.fig7_overhead",
              "benchmarks_torch.fig14_async_save",
              "benchmarks_torch.fig15_sharded_save",
              "benchmarks_torch.fig16_reshard", "benchmarks_torch.fig17_wire"):
        assert m in mods, m
    examples = [str(p) for p in EXAMPLES]
    assert [p.name for p in EXAMPLES] == [
        "torch_cpr_tradeoff.py", "torch_moe_expert_cpr.py",
        "torch_quickstart.py", "torch_serve.py",
        "torch_train_lm_with_cpr.py"], examples
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"for p in {examples!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_import_of_jax_or_repro_is_written_anywhere():
    files = (sorted(PORT.rglob("*.py")) + sorted(HARNESS.glob("*.py")) +
             EXAMPLES + [ROOT / "chip_smoke.py"])
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert not offenders


def test_invariant_rules_hold_over_the_port():
    """The port's own linter over the port with all seven rules (its
    default root; the protocol rules check the port's transport and shard
    server against the port's spec, and the wire table of
    docs/recovery.md), in a process of its own; its report equals the
    reference's linter pointed at the port, finding for finding."""
    runs = {}
    for tool, args in (("repro_torch.analysis", []),
                       ("repro.analysis", ["--root", str(PORT)])):
        r = subprocess.run(
            [sys.executable, "-m", tool, "--json"] + args, env=_env(),
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        runs[tool] = json.loads(r.stdout)
    port = runs["repro_torch.analysis"]
    assert port["root"] == str(PORT)
    assert port["counts"]["unsuppressed"] == 0
    assert port["counts"]["suppressed"] == port["counts"]["total"] > 0
    assert port == runs["repro.analysis"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[-1] == (
        f"{port['files_scanned']} file(s), {port['counts']['total']} "
        f"finding(s), 0 unsuppressed")
