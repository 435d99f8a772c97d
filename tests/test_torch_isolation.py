"""The port stands alone: no jax, nothing of ``repro``, and the repo's
invariant rules hold over it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for m in ("repro_torch.core.emulator", "repro_torch.core.transport",
              "repro_torch.core.sharded_checkpoint",
              "repro_torch.launch.shard_server",
              "repro_torch.analysis.protocol.spec",
              "repro_torch.kernels.row_hash",
              "repro_torch.models.transformer", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.rglru_scan"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_import_of_jax_or_repro_is_written_anywhere():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    """The stdlib-only linter of the reference, pointed at the port (its
    rules match files by their path under --root, so the protocol rules
    check the port's transport and shard server against the port's copy
    of the spec, and the wire table of docs/recovery.md)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--root", str(PORT),
         "--rule", "durability-ordering", "--rule", "exception-hygiene",
         "--rule", "time-source", "--rule", "lock-discipline",
         "--rule", "protocol-conformance", "--rule", "wire-doc-drift",
         "--rule", "epoch-threading"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 unsuppressed" in r.stdout
