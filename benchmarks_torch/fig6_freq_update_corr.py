"""Paper Fig. 6: correlation between embedding-row access frequency and
accumulated update magnitude (paper reports 0.983 after 4096 iterations).

The port of the reference's jitted SGD loop: autograd of ``dlrm_loss``
(on the card the lookups run through the ``embedding_bags`` kernel,
forward and backward), the port's ``sgd`` and ``mfu_update``.
``init_params`` (reference layout, tensors or numpy) replaces the
parameters drawn from seed 0."""
from __future__ import annotations

import numpy as np
import torch

from benchmarks_torch.common import get_dataset
from repro_torch import resolve_device
from repro_torch.core import trackers as trk
from repro_torch.models import dlrm as D
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.tree import leaves, params_from_jax, unflatten


def run(steps=512, batch=512, device=None, init_params=None):
    dev = resolve_device(device)
    cfg, ds = get_dataset("kaggle")
    if init_params is None:
        params = D.init_dlrm(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    else:
        params = params_from_jax(init_params, dev)
    big = int(np.argmax(cfg.table_sizes))
    table0 = params["tables"][big].detach().cpu().numpy().copy()
    # plain SGD like the MLPerf DLRM reference: accumulated displacement is
    # ~linear in access count (adagrad would equalize step sizes and turn
    # the relationship sub-linear, destroying the *Pearson* correlation)
    opt = get_optimizer("sgd", 0.05)
    ostate = opt.init(params)
    counts = trk.mfu_init(cfg.table_sizes[big], dev)

    for i, b in enumerate(ds.batches(batch, loop=True)):
        if i >= steps:
            break
        b = D.batch_to(b, dev)
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, _ = D.dlrm_loss(unflatten(params, live), b, cfg)
        grads = unflatten(params, torch.autograd.grad(loss, live))
        with torch.no_grad():
            u, ostate = opt.update(grads, ostate, params)
            params = apply_updates(params, u)
            counts = trk.mfu_update(counts, b["sparse"][:, big, :])
    corr = trk.access_update_correlation(counts, params["tables"][big],
                                         table0)
    return [{"figure": "fig6", "table": big,
             "rows": cfg.table_sizes[big], "steps": steps,
             "freq_update_corr": round(corr, 4)}]
