"""Batched serving example (PyTorch port): prefill + decode with a KV cache.

The port of ``examples/serve.py``.  Loads a reduced config (an arch of the
port with a decode path), prefills a batch of prompts by teacher-forcing
them through ``decode_step``, then decodes N tokens per prompt greedily
with the stacked per-layer caches, reporting tokens/s.  Weights come from
``init_model`` seeded with 0, prompts from numpy seeded with 1.  Runs on
``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve.py --arch gemma2-2b \\
      --tokens 64 [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as T


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic()         # duration timer, not a timestamp


@torch.no_grad()
def generate(cfg, params, prompts, tokens: int, device):
    """Teacher-force ``prompts`` (B, P) through ``decode_step``, then
    decode greedily to position P + tokens - 1.  Returns (the continuation
    ids (B, tokens), the logits each of them was taken from (tokens, B,
    V), prefill seconds, decode seconds)."""
    prompts = torch.as_tensor(prompts, device=device)
    B, P = prompts.shape
    max_len = P + tokens
    state = T.init_decode_state(cfg, B, max_len, torch.float32, device)
    t0 = _clock(device)
    for i in range(P):
        logits, state = T.decode_step(params, state, prompts[:, i], i, cfg)
    t1 = _clock(device)
    tok = torch.argmax(logits, -1)
    out, seen = [tok], [logits]
    for i in range(P, max_len - 1):
        logits, state = T.decode_step(params, state, tok, i, cfg)
        tok = torch.argmax(logits, -1)
        out.append(tok)
        seen.append(logits)
    t2 = _clock(device)
    return torch.stack(out, 1), torch.stack(seen), t1 - t0, t2 - t1


def main(argv=None):
    decoders = [a for a in list_archs() if get_config(a).supports_decode]
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=decoders, default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = T.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    B, P = args.batch, args.prompt_len
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    ids, _, prefill_s, decode_s = generate(cfg, params, prompts, args.tokens,
                                           device)
    print(f"prefill: {P} steps in {prefill_s:.2f}s (incl. the kernels' "
          f"first use)")
    n = ids.numel()
    print(f"decode: {n} tokens in {decode_s:.2f}s -> {n / decode_s:.1f} "
          f"tok/s (batch={B}, arch={cfg.name}, device={device})")
    print("sample continuation ids:", ids[0, :12].tolist())


if __name__ == "__main__":
    main()
