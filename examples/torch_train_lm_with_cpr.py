"""End-to-end driver (PyTorch port): train a ~100M-param transformer LM for
a few hundred steps with CPR checkpointing + partial recovery of the
embedding shards.

The model is ``examples/train_lm_with_cpr.py``'s: a 12-layer gemma2-style
f32 decoder (d=512, ff=2048, 32k vocab, ~92M params, local window 256).
Two failures are injected; CPR-MFU prioritizes saving the most-frequently-
seen token embeddings (Zipf-distributed synthetic corpus).  On the card
its attention runs through the f32 forward and backward kernels.
Checkpoints go under ``--checkpoint-dir`` (a temporary directory by
default).  Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm_with_cpr.py [--steps 200] \\
      [--device cpu] [--checkpoint-dir DIR]
"""
import argparse
import tempfile

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.train import train

CFG_100M = ModelConfig(
    name="lm-100m",
    arch_type="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    block_pattern=(LOCAL_ATTN, ATTN),
    sliding_window=256,
    rope_theta=10000.0,
    act="silu",
    dtype="float32",
    source="gemma2-style demo config (~92M params)",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="cpr-mfu")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the checkpoints go (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(f"params ~= {CFG_100M.param_counts()['total'] / 1e6:.0f}M")
    with tempfile.TemporaryDirectory() as tmp:
        _, hist = train(CFG_100M, steps=args.steps, batch=args.batch,
                        seq=args.seq, mode=args.mode, n_failures=2,
                        checkpoint_dir=args.checkpoint_dir or tmp,
                        device=args.device)
    r = hist["report"]
    print("kernel launches:", {k: n for k, n in LAUNCHES.items() if n})
    print(f"\nmode={r['mode']} effective={r['effective_mode']} "
          f"pls={r['measured_pls']:.4f} "
          f"bytes_written={r['bytes_written'] / 2 ** 20:.1f}MiB")
    print("loss trajectory:", [f"{s}:{l:.3f}" for s, l in hist["loss"]])


if __name__ == "__main__":
    main()
