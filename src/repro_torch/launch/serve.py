"""Batched serving driver: prefill-via-decode + KV-cache generation with
request slotting (a minimal continuous-batching loop) and optional int8 KV.
The port of ``repro.launch.serve``; it runs on the card unless asked for
the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --requests 16 --batch 8 --prompt-len 32 --gen 32 [--int8-kv] \\
      [--no-reduced] [--device cpu]

Requests arrive with different prompt lengths; the scheduler packs up to
``batch`` active sequences, right-aligned to a shared position counter
(prompt tokens are teacher-forced through the decode path), and answers
the next ``batch`` when they finish.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as T


def make_requests(n, max_prompt, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, max_prompt + 1))
            for _ in range(n)]


@torch.no_grad()
def serve(cfg, requests, batch=8, gen=32, greedy=True, seed=0, params=None,
          device=None):
    """Returns (completions, stats).  ``params=None`` draws the port's own
    ``init_model`` from a generator seeded with ``seed``; sampling
    (``greedy=False``) uses a generator seeded the same way.  Nothing is
    recorded for autograd."""
    device = resolve_device(device)
    if params is None:
        params = T.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(seed), device)
    sampler = torch.Generator(device=device).manual_seed(seed)
    max_prompt = max(len(r) for r in requests)
    max_len = max_prompt + gen

    completions = {}
    queue = list(enumerate(requests))
    stats = {"tokens": 0, "steps": 0, "refills": 0}
    t0 = time.monotonic()           # duration timer, not a timestamp
    while queue:
        # ---- pack up to `batch` requests ----
        active = queue[:batch]
        queue = queue[batch:]
        stats["refills"] += 1
        B = len(active)
        state = T.init_decode_state(cfg, B, max_len, torch.float32, device)
        prompts = np.full((B, max_prompt), 0, np.int64)
        for b, (_, r) in enumerate(active):
            prompts[b, max_prompt - len(r):] = r   # right-align
        toks = torch.as_tensor(prompts, device=device)
        out = [[] for _ in range(B)]
        cur = toks[:, 0]
        for i in range(max_len - 1):
            logits, state = T.decode_step(params, state, cur, i, cfg)
            stats["steps"] += 1
            if i + 1 < max_prompt:     # teacher-force remaining prompt
                cur = toks[:, i + 1]
                continue
            if greedy:
                cur = torch.argmax(logits, -1)
            else:
                probs = torch.softmax(logits.float(), -1)
                cur = torch.multinomial(probs, 1, generator=sampler)[:, 0]
            for b, t in enumerate(cur.tolist()):
                out[b].append(t)
                stats["tokens"] += 1
        for b, (rid, _) in enumerate(active):
            completions[rid] = out[b][:gen]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["wall_s"] = time.monotonic() - t0
    stats["tok_per_s"] = stats["tokens"] / max(stats["wall_s"], 1e-9)
    return completions, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only")
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    reqs = make_requests(args.requests, args.prompt_len, cfg.vocab_size)
    done, stats = serve(cfg, reqs, batch=args.batch, gen=args.gen,
                        device=args.device)
    print(f"served {len(done)} requests: {stats['tokens']} tokens in "
          f"{stats['wall_s']:.1f}s -> {stats['tok_per_s']:.1f} tok/s "
          f"({stats['refills']} batch refills, int8_kv={args.int8_kv}, "
          f"device={resolve_device(args.device)})")


if __name__ == "__main__":
    main()
