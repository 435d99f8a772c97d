"""Emulation framework (paper §5.1): real DLRM training with the failure &
overhead characteristics of the production cluster projected onto simulated
time.

Real computation: the DLRM actually trains on the (synthetic) click log and
the final test AUC is actually measured — failures really revert
embedding-table shards, so accuracy degradation is measured, not modeled.
Simulated time: each optimizer step advances the clock by
``T_total / n_steps``; checkpoint saves and failure handling charge the
overhead ledger per the production-projected ``SystemParams``.

The port of ``repro.core.emulator``.  The train step runs eagerly on the
emulator's device: the embedding lookups go through the ``embedding_bag``
kernel (forward and backward) on CUDA, the optimizer updates the
parameters in place, and the trackers' state stays on the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import trackers as trk
from repro_torch.core.failure import FailureInjector
from repro_torch.core.manager import CPRManager
from repro_torch.core.sharded_checkpoint import load_latest_auto
from repro_torch.metrics.classification import log_loss, roc_auc
from repro_torch.models import dlrm as D
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.tree import leaves, own_copy, tree_map, unflatten


@dataclass
class EmulationResult:
    auc: float
    logloss: float
    final_loss: float
    report: dict
    n_steps: int

    def summary(self):
        o = self.report["overheads"]
        return (f"{self.report['mode']:>9s} auc={self.auc:.4f} "
                f"pls={self.report['measured_pls']:.4f} "
                f"ovh={100 * o['fraction']:.2f}% "
                f"(save={o['save']:.2f}h load={o['load']:.2f}h "
                f"lost={o['lost']:.2f}h res={o['resched']:.2f}h)")


def _trainer(params):
    return {"bottom": params["bottom"], "top": params["top"]}


class Emulator:
    """``init_params`` (optional): the run's initial parameters, as
    tensors or numpy arrays in the reference's layout (e.g. the reference's
    ``init_dlrm`` output), in place of ``init_dlrm`` from ``seed``."""

    def __init__(self, dlrm_cfg, dataset, manager: CPRManager,
                 injector: FailureInjector, batch_size=512, lr=0.02,
                 seed=0, eval_frac=0.1, optimizer=None, device=None,
                 init_params=None):
        self.device = resolve_device(device)
        self.cfg = dlrm_cfg
        self.ds = dataset
        self.mgr = manager
        self.injector = injector
        self.batch_size = batch_size
        self.lr = lr
        self.seed = seed
        self.eval_frac = eval_frac
        # any Optimizer whose state carries row-wise accumulators under
        # state["acc"] (extra top-level entries survive failure restores)
        self.optimizer = optimizer
        self.init_params = init_params
        self.final_ostate = None
        self.step_seconds = []        # host wall time of each train step

    def _initial_params(self):
        if self.init_params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            return D.init_dlrm(self.cfg, gen, self.device)
        return tree_map(lambda a: own_copy(a, self.device), self.init_params)

    def _build_step(self):
        cfg, mgr = self.cfg, self.mgr
        opt = self.optimizer or get_optimizer("rowwise_adagrad", self.lr)
        mode = mgr.mode if mgr.is_priority else None
        big = mgr.big_tables if mgr.is_priority else []
        period = mgr.ssu_period

        def step(params, ostate, tracker, batch):
            flat = leaves(params)
            live = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = D.dlrm_loss(unflatten(params, live), batch, cfg)
            grads = unflatten(params, torch.autograd.grad(loss, live))
            with torch.no_grad():
                updates, ostate = opt.update(grads, ostate, params)
                params = apply_updates(params, updates)
                sparse = batch["sparse"]
                if mode == "cpr-mfu":
                    tracker = {t: trk.mfu_update(tracker[t], sparse[:, t, :])
                               for t in big}
                elif mode == "cpr-ssu":
                    tracker = {t: trk.ssu_update(tracker[t], sparse[:, t, :],
                                                 period,
                                                 backend=mgr.tracker_backend)
                               for t in big}
            return params, ostate, tracker, loss.detach()

        return step, opt

    def run(self, max_steps: Optional[int] = None,
            resume_from: Optional[str] = None,
            on_step: Optional[Callable[[int], None]] = None
            ) -> EmulationResult:
        """``on_step(i)`` (optional) is called after train step ``i`` has
        finished on the device, before that step's saves and failures."""
        cfg, mgr = self.cfg, self.mgr
        params = self._initial_params()
        step_fn, opt = self._build_step()
        ostate = opt.init(params)
        if resume_from:
            # disk-mode full recovery: embedding shards + optimizer rows +
            # the trainer replica come back from the last consistent cycle,
            # whichever store layout (flat or per-shard fleet) wrote it;
            # load_latest_auto resolves the run-versioned CURRENT pointer
            loaded = load_latest_auto(
                resume_from, params["tables"], ostate["acc"]["tables"],
                mgr.spec, trainer_state=_trainer(params))
            r_t, r_a, trainer = loaded.restore_all()
            to_dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            params = {**params, "tables": [to_dev(x) for x in r_t]}
            if trainer is not None:
                params = {**params, **tree_map(to_dev, trainer)}
            ostate = {**ostate,
                      "acc": {**ostate["acc"],
                              "tables": [to_dev(x) for x in r_a]}}
        tracker = mgr.tracker_init(params["tables"])
        mgr.attach_store(params["tables"], ostate["acc"]["tables"],
                         _trainer(params))

        (tr0, tr1), (ev0, ev1) = self.ds.eval_split(self.eval_frac)
        n_train = tr1 - tr0
        n_steps = n_train // self.batch_size
        if max_steps:
            n_steps = min(n_steps, max_steps)
        mgr.set_total_samples(n_steps * self.batch_size)
        dt = mgr.p.T_total / n_steps

        t = 0.0
        loss = torch.zeros(())
        wall0 = time.perf_counter()
        for i, batch in enumerate(self.ds.batches(self.batch_size, tr0, tr1)):
            if i >= n_steps:
                break
            t_step = time.perf_counter()
            params, ostate, tracker, loss = step_fn(
                params, ostate, tracker, D.batch_to(batch, self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.perf_counter() - t_step)
            if on_step is not None:
                on_step(i)
            mgr.samples_seen += self.batch_size
            t_prev, t = t, t + dt
            # sim-hours per wall-second at the steady-state *training* rate:
            # step 0 and time already blocked inside save events are both
            # excluded from the denominator
            if i == 0:
                wall0 = time.perf_counter()
                blocked0 = mgr.ledger.save_blocked_s
            else:
                train_wall = (time.perf_counter() - wall0) - \
                    (mgr.ledger.save_blocked_s - blocked0)
                mgr.wall_time_scale = (t - dt) / max(train_wall, 1e-9)
            for t_ev in mgr.due_saves(t):
                tracker = mgr.run_save(
                    t_ev, params["tables"], ostate["acc"]["tables"], tracker,
                    _trainer(params), step=i)
            for ev in self.injector.between(t_prev, t):
                # partial recovery writes the image rows into the live
                # tables and accumulators in place
                mgr.on_failure(ev, params["tables"], ostate["acc"]["tables"])
        mgr.close()   # drain + stop the async writer thread (if any)
        self.final_ostate = ostate

        # ---- evaluation ----
        scores, labels = [], []
        with torch.no_grad():
            for batch in self.ds.batches(4096, ev0, ev1):
                logits = D.dlrm_forward(params, D.batch_to(batch, self.device),
                                        cfg)
                scores.append(torch.sigmoid(logits).cpu().numpy())
                labels.append(batch["label"])
        y = np.concatenate(labels)
        s = np.concatenate(scores)
        return EmulationResult(
            auc=roc_auc(y, s), logloss=log_loss(y, s),
            final_loss=float(loss), report=mgr.report(), n_steps=n_steps)
