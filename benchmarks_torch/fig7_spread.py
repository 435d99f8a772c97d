"""fig7's AUC and eval logloss from run to run (no figure of the paper).

At the harness's size the trained model depends on the order of float
sums: the card's embedding backward adds atomically, in an order that
changes from run to run, and the CPU's sums change with its thread count.
This repeats each fig7 mode (Kaggle, host tracker backend) from one set
of initial parameters, ``--reps`` times on the card and once per CPU
thread count, and prints every run's AUC and eval logloss with the
largest gaps between a card run and the CPU's first: the spread from which
``chip_smoke.py`` phase 5 (b) sets its limits.

  PYTHONPATH=src python -m benchmarks_torch.fig7_spread
      [--modes full,cpr-mfu] [--reps 6] [--threads 8,4,2,1]
      [--max-rows 20000] [--samples 40000] [--batch 512] [--init cpu|card]
      [--trace] [--host-backward]

``--init cpu`` draws ``init_dlrm`` from the CPU's generator at seed 0, as
phase 5 (b) does; ``--init card`` from the card's, as the harness's
``Emulator`` does on the card.  ``--trace`` adds each run's eval logloss
after each of its last 4 steps and, in ``cpr-scar``, counts the restored
rows and the shadow rows that differ from the checkpoint image (0 when
saves and restores are right).  ``--host-backward`` makes the card's runs
take the embedding backward from its plain version on the host, in a
fixed order, instead of the kernel: a diagnostic of where the spread
comes from.  ``--reps 0`` runs on the CPU only.
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from benchmarks_torch import common
from benchmarks_torch.fig7_overhead import MODES
from repro_torch.core import emulator as E
from repro_torch.core.manager import CPRManager
from repro_torch.kernels import embedding_bag, ref
from repro_torch.metrics.classification import log_loss, roc_auc
from repro_torch.models.dlrm import init_dlrm, params_to_numpy
from repro_torch.tree import tree_map


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _rows_differ(a, b) -> int:
    a = np.asarray(a).reshape(len(a), -1)
    return int((a != np.asarray(b).reshape(len(b), -1)).any(-1).sum())


def traced(cfg, ds, trace):
    """Patches that record the eval logloss after every step, and the rows
    of ``cpr-scar``'s restores and shadows that differ from the image."""
    (_, _), (ev0, ev1) = ds.eval_split(0.1)
    labels = np.concatenate([b["label"] for b in ds.batches(4096, ev0, ev1)])
    build, fail, save = (E.Emulator._build_step, CPRManager.on_failure,
                         CPRManager.run_save)

    def build_step(emu):
        step, opt = build(emu)
        batches = [E.D.batch_to(b, emu.device)
                   for b in ds.batches(4096, ev0, ev1)]

        def traced_step(*a):
            out = step(*a)
            with torch.no_grad():
                s = torch.cat([torch.sigmoid(E.D.dlrm_forward(out[0], b, cfg))
                               for b in batches]).cpu().numpy()
            trace["eval_logloss"].append(round(log_loss(labels, s), 4))
            return out
        return traced_step, opt

    def on_failure(mgr, ev, tables, accs):
        out = fail(mgr, ev, tables, accs)
        if mgr.effective_mode not in ("full", "full-fallback"):
            for t in range(len(tables)):
                for j in out[2]["shards"]:
                    lo, hi = mgr.spec.shard_range(t, j)
                    if hi == lo:
                        continue
                    for live, img in ((tables, mgr.store.image_tables),
                                      (accs, mgr.store.image_accs)):
                        trace["restored_rows_not_image"] += _rows_differ(
                            live[t][lo:hi].cpu().numpy(), img[t][lo:hi])
        return out

    def run_save(mgr, t_ev, tables, accs, state, *a, **kw):
        out = save(mgr, t_ev, tables, accs, state, *a, **kw)
        if mgr.mode == "cpr-scar":
            mgr.fence()
            trace["shadow_rows_not_image"] += sum(
                _rows_differ(out[t]["shadow"].cpu().numpy(),
                             mgr.store.image_tables[t])
                for t in mgr.big_tables)
        return out

    stack = contextlib.ExitStack()
    stack.enter_context(patched(E.Emulator, "_build_step", build_step))
    stack.enter_context(patched(CPRManager, "on_failure", on_failure))
    stack.enter_context(patched(CPRManager, "run_save", run_save))
    return stack


def host_backward(g, sparse, rows):
    """The embedding backward by its plain version on the host."""
    grads = ref.embedding_bags_backward(g.cpu(), sparse.cpu(), rows)
    return [x.to(g.device) for x in grads]


def untrained(params, cfg, ds):
    """AUC and eval logloss of the initial parameters: what a run that
    trained nothing would score."""
    p = tree_map(torch.as_tensor, params)
    (_, _), (ev0, ev1) = ds.eval_split(0.1)
    batches = list(ds.batches(4096, ev0, ev1))
    with torch.no_grad():
        s = torch.cat([
            torch.sigmoid(E.D.dlrm_forward(p, E.D.batch_to(b, "cpu"), cfg))
            for b in batches]).numpy()
    y = np.concatenate([b["label"] for b in batches])
    return {"auc": round(roc_auc(y, s), 4),
            "logloss": round(log_loss(y, s), 4)}


def one_run(mode, device, init, cfg, ds, trace_on):
    trace = {"eval_logloss": [], "restored_rows_not_image": 0,
             "shadow_rows_not_image": 0}
    with traced(cfg, ds, trace) if trace_on else contextlib.nullcontext():
        r = common.run_emulation(mode, device=device, init_params=init)
    out = {"auc": round(r.auc, 4), "logloss": round(r.logloss, 4)}
    if trace_on:
        out["eval_logloss_last_4_steps"] = trace["eval_logloss"][-4:]
        if mode == "cpr-scar":
            out["restored_rows_not_image"] = trace["restored_rows_not_image"]
            out["shadow_rows_not_image"] = trace["shadow_rows_not_image"]
    return out


def run(modes=MODES, reps=6, threads=(8, 4, 2, 1), init="cpu",
        trace=False, host_bwd=False):
    cfg, ds = common.get_dataset("kaggle")
    gen = (torch.Generator() if init == "cpu"
           else torch.Generator(device="cuda"))
    params = params_to_numpy(init_dlrm(cfg, gen.manual_seed(0),
                                       "cpu" if init == "cpu" else "cuda"))
    print(json.dumps({"untrained": untrained(params, cfg, ds)}), flush=True)
    n_threads = torch.get_num_threads()
    rows = []
    for mode in modes:
        cpu = []
        for n in threads:
            torch.set_num_threads(n)
            cpu.append(one_run(mode, "cpu", params, cfg, ds, trace))
        torch.set_num_threads(n_threads)
        bwd = (patched(embedding_bag, "backward", host_backward) if host_bwd
               else contextlib.nullcontext())
        with bwd:
            card = [one_run(mode, "cuda", params, cfg, ds, trace)
                    for _ in range(reps)]
        row = {"mode": mode, "config": cfg.name, "init": init,
               "host_backward": host_bwd, "cpu_threads": list(threads),
               "cpu": cpu, "card": card}
        if card and cpu:
            row["max_auc_gap"] = round(max(abs(c["auc"] - cpu[0]["auc"])
                                           for c in card), 4)
            row["max_logloss_gap"] = round(max(
                abs(c["logloss"] - cpu[0]["logloss"]) for c in card), 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--threads", default="8,4,2,1")
    ap.add_argument("--max-rows", type=int, default=common.MAX_ROWS)
    ap.add_argument("--samples", type=int, default=common.NUM_SAMPLES)
    ap.add_argument("--batch", type=int, default=common.BATCH)
    ap.add_argument("--init", default="cpu", choices=("cpu", "card"))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--host-backward", action="store_true")
    args = ap.parse_args(argv)
    if args.reps:
        print(common.device_label("cuda"), flush=True)
    common.MAX_ROWS, common.NUM_SAMPLES, common.BATCH = (
        args.max_rows, args.samples, args.batch)
    common.get_dataset.cache_clear()
    run(modes=args.modes.split(","), reps=args.reps,
        threads=tuple(int(n) for n in args.threads.split(",")),
        init=args.init, trace=args.trace, host_bwd=args.host_backward)


if __name__ == "__main__":
    main()
