"""What bounds the bf16 attention kernels at head dim 80: each part taken
out in turn.

    PYTHONPATH=src python -m repro_torch.launch.ablate_attention \\
        [--out DIR] [--parts noexp,nosecond,nofirst,noload]

Copies this package's sources into ``DIR/<part>/src`` (default
``build/ablate``) once for each part, with that part of the hd-80 kernels
(``flash_fwd_bf16_hd80``, ``flash_bwd_dkdv_hd80``, ``flash_bwd_dq<80>``)
taken out:

- ``noexp``: the exp2s (each keeps its FMA);
- ``nosecond``: the products on P or dS (P.V; dV and dK; dQ);
- ``nofirst``: the products on Q, K, V, dO (Q.K^T; S^T and dP^T; S and
  dP);
- ``noload``: the producer's copies of K and V (of Q, dO, LSE and D in
  dK/dV): it only signals each stage.

Then it times HuBERT X-Large's (8, 16, 1000, 80) forward and backward in
the untouched package and in each copy, one process a tree, with
``profile_attention_backward.py --dtype bf16 --forward --only hubert``,
and prints each tree's device ms by kernel.  The copies compute wrong
values: only their times mean anything.  A part whose removal leaves a
kernel's time where it was does not bound it.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]          # the tree's src/
PROFILER = Path(__file__).resolve().with_name(
    "profile_attention_backward.py")
FWD = "repro_torch/csrc/flash_attention_bf16.cu"
BWD = "repro_torch/csrc/flash_attention_backward_bf16.cu"
# by part: (file, line as it stands, its replacement); each line must
# appear once (the dK/dV producer's line twice: both kernels')
EDITS = {
    "noexp": [
        (FWD, "        sc[e] = exp2_ftz(fmaf(sc[e], mul, (e & 2) ? -mu1 : -mu0));",
         "        sc[e] = fmaf(sc[e], mul, (e & 2) ? -mu1 : -mu0);"),
        (BWD, "    return exp2_ftz(fmaf(s, scale_log2, -l2));",
         "    return fmaf(s, scale_log2, -l2);")],
    "nosecond": [
        (FWD, "        pv_hd80(acc, pa, sV + (pend >= 0 ? pend : s) * F::kKVBytes);",
         ""),
        (BWD, "        wgmma_a_tile<HD>(acc, da, sK + s * C::kBytes);", ""),
        (BWD, "      wgmma_a_tile<HD>(dva, pa, sdO + s * C::kBytes);", ""),
        (BWD, "      wgmma_a_tile<HD>(dka, da, sQ + s * C::kBytes);", "")],
    "nofirst": [
        (FWD, "      qk_hd80(sc, qf, sK + s * F::kKVBytes);", ""),
        (BWD, "        wgmma_abt<HD>(sc, sQ, sK + s * C::kBytes);", ""),
        (BWD, "        wgmma_abt<HD>(dp, sdO, sV + s * C::kBytes);", ""),
        (BWD, "      wgmma_abt<HD>(sc, sKw, sQ + s * C::kBytes);", ""),
        (BWD, "      wgmma_abt<HD>(dp, sVw, sdO + s * C::kBytes);", "")],
    "noload": [
        (FWD, "        mbar_expect_tx(full + 8 * s, 2 * F::kKVBytes);",
         "        mbar_arrive(full + 8 * s); continue;"),
        (BWD, "        mbar_expect_tx(full + 8 * s, 2 * C::kBytes);",
         "        mbar_arrive(full + 8 * s); continue;"),
        (BWD, "        mbar_expect_tx(full + 8 * s, 2 * C::kBytes + C::kRowStats);",
         "        mbar_arrive(full + 8 * s); continue;")]}


def make_tree(out: Path, part: str) -> Path:
    """``out/part/src``: this package with ``part`` taken out."""
    root = out / part / "src"
    shutil.rmtree(out / part, ignore_errors=True)
    shutil.copytree(SRC / "repro_torch", root / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, line, new in EDITS[part]:
        path = root / name
        text = path.read_text()
        n = text.count(line + "\n")
        if n == 0 or (n > 1 and "kRowStats" not in line):
            raise RuntimeError(f"{part}: {line.strip()!r} appears {n} times "
                               f"in {name}")
        path.write_text(text.replace(line + "\n", new + "\n" if new else ""))
    return root


def profile(tree: Path) -> dict:
    """Each case's device ms by kernel in ``tree``'s package."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = subprocess.run(
        [sys.executable, str(PROFILER), "--dtype", "bf16", "--forward",
         "--only", "hubert"], env=env, capture_output=True, text=True,
        check=True).stdout
    cases = {}
    for line in out.splitlines():
        if line.startswith(("backward", "forward")):
            name, _, rest = line.partition("{")
            res = json.loads("{" + rest)
            cases[name.split()[0]] = {"device_ms": res["device_ms"],
                                      "by_kernel": res["device_ms_by_kernel"]}
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(SRC.parent / "build" / "ablate"))
    ap.add_argument("--parts", default=",".join(EDITS))
    args = ap.parse_args(argv)
    out = Path(args.out)
    parts = args.parts.split(",")
    trees = {"whole": SRC, **{p: make_tree(out, p) for p in parts}}
    # every tree's kernels built at once, one compiler per source each
    builds = [subprocess.Popen(
        [sys.executable, "-c",
         "from repro_torch.kernels import _build; _build.build_all()"],
        env=dict(os.environ, PYTHONPATH=str(tree))) for tree in trees.values()]
    for proc in builds:
        if proc.wait() != 0:
            raise RuntimeError("a tree's kernels did not build")
    for name, tree in trees.items():
        print(name, json.dumps(profile(tree)), flush=True)


if __name__ == "__main__":
    main()
