"""CPR over MoE *expert* shards (PyTorch port): the modern analogue of the
paper's Emb PS.

The port of ``examples/moe_expert_cpr.py``.  The router of an MoE sends
Zipf-like traffic to its experts, so MFU counters over *expert hits*
prioritise saving the hot experts, as CPR-MFU does for embedding rows.
This trains a reduced Qwen3-MoE (f32, 4 experts, top 2, head dim 64) with
Adam for 30 steps of batch 4 x 64 tokens, counts the first MoE layer's
router assignments with the MFU tracker after every update, and prints the
hit histogram, the traffic skew and the experts that a partial save at
r = 0.5 would pick.  Weights come from ``init_model`` seeded with 0.  Runs
on ``cuda`` unless ``--device cpu``; on the card its attention runs
through the f32 forward and backward kernels.

  PYTHONPATH=src python examples/torch_moe_expert_cpr.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import trackers as trk
from repro_torch.data.synthetic import TokenDataset
from repro_torch.kernels import LAUNCHES
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.tree import leaves, unflatten

CFG = get_config("qwen3-moe-30b-a3b").reduced()
STEPS, BATCH, SEQ = 30, 4, 64


def router_hits(params, tokens, cfg=CFG):
    """The expert ids (T, top_k) that the first MoE layer's router picks
    for the embedded ``tokens`` (the reference example's count)."""
    x, _ = T.embed_inputs(params, {"tokens": tokens}, cfg)
    stage0 = params["stages"][0]["moe"]
    router = {"router": stage0["router"][0]}
    _, _, top_e = moe_lib.route(router, x.reshape(-1, cfg.d_model), cfg.moe)
    return top_e


def step(params, ostate, counts, tokens, opt, cfg=CFG):
    """One Adam step on ``lm_loss`` (cross-entropy + the MoE aux), then
    the updated router's hits into the MFU counts -> (params (updated in
    place), ostate, counts, loss)."""
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, _ = T.lm_loss(unflatten(params, live), {"tokens": tokens}, cfg)
    loss.backward()
    grads = unflatten(params, [t.grad for t in live])
    with torch.no_grad():
        updates, ostate = opt.update(grads, ostate, params)
        params = apply_updates(params, updates)
        counts = trk.mfu_update(counts, router_hits(params, tokens, cfg))
    return params, ostate, counts, loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    E = CFG.moe.num_experts
    params = T.init_model(CFG, torch.Generator(device=device).manual_seed(0),
                          device)
    opt = get_optimizer("adam", 1e-3)
    ostate = opt.init(params)
    ds = TokenDataset(CFG.vocab_size, num_tokens=200_000, seed=0)
    counts = trk.mfu_init(E, device)
    for i, b in enumerate(ds.batches(BATCH, SEQ, loop=True)):
        if i >= STEPS:
            break
        params, ostate, counts, loss = step(
            params, ostate, counts, torch.from_numpy(b["tokens"]).to(device),
            opt)

    hist = counts.cpu().numpy()
    rn = max(1, int(0.5 * E))
    save_ids, _ = trk.mfu_select(counts, rn)
    print(f"expert hit histogram after {STEPS} steps (E={E}, "
          f"top_k={CFG.moe.top_k}):")
    print("  hits:", hist.tolist())
    print(f"  traffic skew: top expert {hist.max()} vs median "
          f"{int(np.median(hist))}")
    print(f"  CPR-MFU would partial-save experts "
          f"{sorted(save_ids.tolist())} (r=0.5 -> {rn} of {E})")
    print("kernel launches:", {k: n for k, n in LAUNCHES.items() if n})
    print(f"final loss {float(loss):.3f} (device={device})")


if __name__ == "__main__":
    main()
