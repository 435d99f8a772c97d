"""Where the LM training run on the card parts from the CPU's (no figure of
the paper).

``chip_smoke.py`` phase 7 (c) trains the reduced RecurrentGemma-2B in
``cpr-mfu`` (8 steps, batch 4 x 128 tokens, 2 failures) on the card and on
the CPU from the same parameters and holds their losses together.  This
runs that configuration on each device of ``--devices`` and traces every
step: the loss, each gradient leaf, the embedding rows and their Adagrad
accumulators after each save event, the checkpoint image's rows, the rows
each save wrote, and the rows each failure restored.  It prints, per step,
the largest gap of each against the first device's run (relative to the
largest entry of the first run), so a gap that opens at a save or a
restore shows where it opens.  A second CPU thread count
(``cpu:1``) is the witness of what the CPU's own order of float sums does
to the same run; ``cpu@X`` multiplies every entry of every step's
gradient by (1 + X u), u uniform in [-1, 1] from a fixed seed: the
witness of what a disagreement of relative size X in the gradients, as
between the card's kernels and the CPU's plain versions, does to it.

  PYTHONPATH=src python -m benchmarks_torch.lm_train_spread
      [--devices cpu,cuda,cpu:1,cpu@1e-5] [--steps 8] [--mode cpr-mfu]
      [--tracker-backend kernel]

Each entry of ``--devices`` is ``device[:threads][@X]``; the first is the
run the others are held against.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.manager import CPRManager
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as T
from repro_torch.tree import leaves


def leaf_names(tree, prefix=""):
    """Paths of ``tree``'s leaves, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, sub in enumerate(tree)
                for n in leaf_names(sub, f"{prefix}/{i}")]
    return [prefix or "/"]


def _np(t):
    return t.detach().cpu().numpy().copy()


class _Tracing(CPRManager):
    """The manager with a record of every save and restore."""
    log: list = []

    def run_save(self, t_event, tables, accs, tracker_state,
                 trainer_state=None, step=0, pending_indices=None):
        image = self.store.image_tables[0].copy()
        out = super().run_save(t_event, tables, accs, tracker_state,
                               trainer_state, step, pending_indices)
        after = self.store.image_tables[0]
        wrote = np.flatnonzero((after != image).any(-1))
        self.log.append(("save", step, _np(tables[0]), _np(accs[0]),
                         after.copy(), self.store.image_accs[0].copy(),
                         wrote))
        return out

    def on_failure(self, event, tables, accs):
        before = _np(tables[0])
        out = super().on_failure(event, tables, accs)
        moved = np.flatnonzero((_np(tables[0]) != before).any(-1))
        self.log.append(("failure", out[2].get("shards"), _np(tables[0]),
                         _np(accs[0]), moved))
        return out


def trace(cfg, init, device, threads, noise, steps, mode, tracker_backend):
    grads = []
    gen = torch.Generator().manual_seed(1)

    def on_step(i, g):
        for t in leaves(g):
            if noise:
                u = torch.rand(t.shape, generator=gen) * 2 - 1
                t.mul_(1 + noise * u.to(t.device))
        grads.append([_np(t) for t in leaves(g)])

    _Tracing.log = []
    old = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, train_mod, "CPRManager", CPRManager)
            train_mod.CPRManager = _Tracing
            _, hist = train_mod.train(
                cfg, steps=steps, batch=4, seq=128, mode=mode, n_failures=2,
                tracker_backend=tracker_backend, log_every=1, device=device,
                params=init, on_step=on_step)
    finally:
        torch.set_num_threads(old)
    return {"loss": [l for _, l in hist["loss"]], "grads": grads,
            "log": list(_Tracing.log), "report": hist["report"]}


def share(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    top = np.abs(b).max()
    return float(np.abs(a - b).max() / top) if top else float(
        np.abs(a - b).max())


def compare(name, run, base, names):
    print(f"{name} against {base['name']}:")
    for i, (x, y) in enumerate(zip(run["loss"], base["loss"])):
        g = [share(a, b) for a, b in zip(run["grads"][i], base["grads"][i])]
        j = int(np.argmax(g))
        print(f"  step {i}: loss gap {abs(x - y) / abs(y):.2e}, gradients: "
              f"largest leaf gap {g[j]:.2e} ({names[j]})")
    for ev, eb in zip(run["log"], base["log"]):
        if ev[0] != eb[0]:
            print(f"  event order differs: {ev[0]} against {eb[0]}")
            return
        if ev[0] == "save":
            same_rows = np.array_equal(ev[6], eb[6])
            diff = np.setxor1d(ev[6], eb[6])
            print(f"  save at step {ev[1]}: embed {share(ev[2], eb[2]):.2e} "
                  f"acc {share(ev[3], eb[3]):.2e} image {share(ev[4], eb[4]):.2e} "
                  f"image acc {share(ev[5], eb[5]):.2e}; rows written "
                  f"{len(ev[6])} / {len(eb[6])}, same set {same_rows}"
                  + ("" if same_rows else f" (differ: {diff[:16].tolist()})"))
        else:
            same_rows = np.array_equal(ev[4], eb[4])
            print(f"  failure of shards {ev[1]}: embed after restore "
                  f"{share(ev[2], eb[2]):.2e} acc {share(ev[3], eb[3]):.2e}; "
                  f"rows moved {len(ev[4])} / {len(eb[4])}, same set "
                  f"{same_rows}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="cpu,cuda,cpu:1,cpu@1e-5",
                    help="device[:threads][@noise] list; the first is the "
                         "base")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--mode", default="cpr-mfu")
    ap.add_argument("--tracker-backend", default="kernel")
    args = ap.parse_args(argv)
    cfg = get_config("recurrentgemma-2b").reduced()
    init = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = []
    for spec in args.devices.split(","):
        head, _, noise = spec.partition("@")
        dev, _, threads = head.partition(":")
        run = trace(cfg, init, dev, int(threads or 0), float(noise or 0),
                    args.steps, args.mode, args.tracker_backend)
        run["name"] = spec
        runs.append(run)
        print(f"{spec}: losses {', '.join(f'{l:.6f}' for l in run['loss'])}")
    for run in runs[1:]:
        compare(run["name"], run, runs[0], leaf_names(init))


if __name__ == "__main__":
    main()
