"""Production-style LM training driver with CPR as a first-class feature
(the port of ``repro.launch.train``).

Trains a transformer LM (any registered arch, at full or reduced scale) on
the synthetic token pipeline, with CPR checkpointing the model-parallel
shard state (token-embedding rows + their optimizer rows: the Emb-PS
analogue) and optionally injecting failures to exercise partial recovery.
It runs on the card unless asked for the CPU; on the card the attention
and RG-LRU layers go through their forward and backward kernels.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --steps 200 --batch 8 --seq 128 --mode cpr-mfu \\
      --failures 2 [--device cpu]

Differences from the reference: the step runs eagerly (the step's
parameters, optimizer state and trackers stay on the device and are
updated in place), failures restore the embedding rows and their
accumulators in place, ``params=`` takes the reference's initial
parameters (numpy arrays in its layout) in place of the port's own draw
from ``seed``, and ``on_step(i, grads)`` (optional) sees each step's
clipped gradient tree.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.core import trackers as trk
from repro_torch.core.failure import FailureInjector
from repro_torch.core.manager import CPRManager
from repro_torch.core.overhead import SystemParams
from repro_torch.core.sharded_checkpoint import load_latest_auto
from repro_torch.data.synthetic import TokenDataset
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.tree import leaves, own_copy, tree_map, unflatten


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def _trainer(params):
    """Everything but the Emb-PS rows: the replica the store keeps whole."""
    return {k: v for k, v in params.items() if k != "embed"}


def _load_image(params, ostate, r_t, r_a, trainer):
    """Copy a full image (numpy: the rows, their accumulators and the
    trainer replica) into ``params`` and ``ostate`` in place."""
    with torch.no_grad():
        dst = [params["embed"], ostate["acc"]["embed"]]
        src = [r_t[0], r_a[0]]
        if trainer is not None:
            dst += leaves(_trainer(params))
            src += leaves(trainer)
        for d, a in zip(dst, src):
            d.copy_(torch.as_tensor(np.asarray(a)))


def train(cfg, steps=200, batch=8, seq=128, lr=0.005, mode="cpr-mfu",
          n_failures=2, fail_fraction=0.25, seed=0, target_pls=0.1,
          checkpoint_dir=None, log_every=20, async_save=False,
          tracker_backend="pallas", sharded_save=False, delta_saves=None,
          n_emb=8, resume=False, writer_procs=False, readmit=False,
          transport=None, shard_addrs=None, heartbeat_interval=None,
          readmit_backoff=0.0, attach=False, resize_at=None, lease_ttl=None,
          parity_group_size=0, hash_backend="host", seg_size=512,
          transport_options=None, device=None, params=None,
          on_step: Optional[Callable[[int, Any], None]] = None):
    """Returns (final_params, history dict).  ``history["step_s"]`` holds
    each step's wall seconds (the device synchronized after the step)."""
    if not cfg.causal or cfg.modality_frontend is not None:
        raise ValueError("the LM driver needs a causal text model")
    device = resolve_device(device)
    if params is None:
        params = T.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(seed), device)
    else:
        params = tree_map(lambda a: own_copy(a, device), params)
    opt = get_optimizer("rowwise_adagrad", lr)
    ostate = opt.init(params)
    ds = TokenDataset(cfg.vocab_size, num_tokens=steps * batch * seq + 1,
                      seed=seed)

    # --- CPR over the Emb-PS analogue: the token-embedding rows ---
    p = SystemParams(T_total=float(steps),
                     T_fail=float(steps) / max(n_failures, 1), N_emb=n_emb)
    mgr = CPRManager(mode, p, (cfg.vocab_size,), target_pls=target_pls,
                     directory=checkpoint_dir, async_save=async_save,
                     tracker_backend=tracker_backend,
                     sharded_save=sharded_save, delta_saves=delta_saves,
                     writer_procs=writer_procs, readmit=readmit,
                     transport=transport, shard_addrs=shard_addrs,
                     heartbeat_interval=heartbeat_interval,
                     readmit_backoff=readmit_backoff, attach=attach,
                     lease_ttl=lease_ttl,
                     parity_group_size=parity_group_size,
                     hash_backend=hash_backend, seg_size=seg_size,
                     transport_options=transport_options, device=device)
    if resume and checkpoint_dir:
        # warm start from the last consistent cycle on disk: embedding rows,
        # their optimizer rows, and the non-embedding trainer tree
        loaded = load_latest_auto(
            checkpoint_dir, [params["embed"]], [ostate["acc"]["embed"]],
            mgr.spec, trainer_state=_trainer(params))
        _load_image(params, ostate, *loaded.restore_all())
        if mgr.sharded_save and getattr(loaded, "spec", None) is not None:
            # the chain may have crossed a live resize: run under the
            # layout it last stamped, not the CLI's --n-emb
            mgr.adopt_layout(loaded.spec)
    tracker = mgr.tracker_init([params["embed"]])
    mgr.attach_store([params["embed"]], [ostate["acc"]["embed"]],
                     _trainer(params))
    if attach and checkpoint_dir and mgr.sharded_save:
        # coordinator failover: the store just took over the previous
        # coordinator's writer fleet at the last stamped cycle; warm the
        # trainer from it (adopted writers serve their reconciled images;
        # a poisoned shard falls back to its stamped disk state)
        _load_image(params, ostate, *mgr.store.restore_all())
        rep = mgr.store.attach_report or {}
        print(f"attached to writer fleet: epoch={mgr.store.epoch} "
              f"cycle={rep.get('cycle')} adopted={rep.get('adopted')} "
              f"respawned={rep.get('respawned')} "
              f"poisoned={rep.get('poisoned')}", flush=True)
    inj = FailureInjector(n_failures, fail_fraction, p.N_emb, p.T_total,
                          seed=seed + 1)
    mgr.set_total_samples(steps * batch)
    is_mfu = mgr.is_priority and mode == "cpr-mfu"
    is_ssu = mgr.is_priority and mode == "cpr-ssu"

    def step_fn(i, params, ostate, tracker, batch):
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, _ = T.lm_loss(unflatten(params, live), batch, cfg)
        loss.backward()
        grads = [t.grad for t in live]
        del live
        with torch.no_grad():
            # f64 sums: the CPU's f32 vector_norm drifts on a leaf of
            # millions of entries, and the clip scales every update
            gnorm = torch.stack([torch.linalg.vector_norm(
                g, dtype=torch.float64) for g in grads])
            gnorm = torch.sqrt(torch.sum(gnorm * gnorm)).float()
            scale = torch.clamp(1.0 / torch.clamp_min(gnorm, 1e-9), max=1.0)
            for g in grads:
                g.mul_(scale)
            grads = unflatten(params, grads)
            if on_step is not None:
                on_step(i, grads)
            updates, ostate = opt.update(grads, ostate, params)
            del grads
            params = apply_updates(params, updates)
            del updates
            if is_mfu:
                tracker = {0: trk.mfu_update(tracker[0], batch["tokens"])}
            elif is_ssu:
                tracker = {0: trk.ssu_update(tracker[0], batch["tokens"],
                                             mgr.ssu_period,
                                             backend=mgr.tracker_backend)}
        return params, ostate, tracker, loss.detach()

    history = {"loss": [], "events": [], "step_s": []}
    t_sim = 0.0
    t0 = time.monotonic()           # duration timer, not a timestamp
    for i, b in enumerate(ds.batches(batch, seq, loop=True)):
        if i >= steps:
            break
        t_step = time.monotonic()
        params, ostate, tracker, loss = step_fn(
            i, params, ostate, tracker,
            {"tokens": torch.from_numpy(b["tokens"]).to(device)})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        history["step_s"].append(time.monotonic() - t_step)
        mgr.samples_seen += batch
        if i == 0:      # step 0 builds the kernels; time the steady rate
            t_steady = time.monotonic()
            blocked0 = mgr.ledger.save_blocked_s
        else:           # exclude time already blocked inside save events
            train_wall = (time.monotonic() - t_steady) - \
                (mgr.ledger.save_blocked_s - blocked0)
            mgr.wall_time_scale = i / max(train_wall, 1e-9)
        t_prev, t_sim = t_sim, t_sim + 1.0
        if resize_at and i in resize_at:
            # live fleet resize under traffic: the reshard overlaps
            # training compute and the trainer joins it at the next save
            # boundary; no restart, at most one boundary's pause
            mgr.resize(resize_at[i], t_event=t_sim, step=i,
                       background=True)
            print(f"step {i:5d} resizing writer fleet -> "
                  f"{resize_at[i]} shards (reshard overlaps training)",
                  flush=True)
            history["events"].append(("resize", i, resize_at[i]))
        for t_ev in mgr.due_saves(t_sim):
            tracker = mgr.run_save(
                t_ev, [params["embed"]], [ostate["acc"]["embed"]], tracker,
                _trainer(params), step=i)
            history["events"].append(("save", i))
        for ev in inj.between(t_prev, t_sim):
            # partial recovery writes the image rows into the live
            # embedding rows and their accumulators in place
            _, _, info = mgr.on_failure(ev, [params["embed"]],
                                        [ostate["acc"]["embed"]])
            history["events"].append(("failure", i, info.get("pls", 0.0)))
        if i % log_every == 0 or i == steps - 1:
            history["loss"].append((i, float(loss)))
            print(f"step {i:5d} loss {float(loss):.4f} "
                  f"({(time.monotonic() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    mgr.fence()   # drain in-flight async saves before reporting
    history["report"] = mgr.report()
    mgr.close()
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--mode", default="cpr-mfu")
    ap.add_argument("--failures", type=int, default=2)
    ap.add_argument("--target-pls", type=float, default=0.1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--async-save", action="store_true",
                    help="background double-buffered checkpoint writer")
    ap.add_argument("--sharded-save", action="store_true",
                    help="one writer + directory per Emb-PS shard with a "
                         "coordinator fence (implies delta saves)")
    ap.add_argument("--no-delta-saves", action="store_true",
                    help="disable row-hash skip of unchanged rows in "
                         "sharded partial saves")
    ap.add_argument("--writer-procs", action="store_true",
                    help="run each shard writer in its own OS process "
                         "(crash-isolated; implies --sharded-save; alias "
                         "for --transport pipe)")
    ap.add_argument("--transport", choices=("inproc", "pipe", "socket"),
                    default=None,
                    help="writer-fleet transport: in-process applier "
                         "threads, per-shard OS processes (shared-memory "
                         "snapshots), or TCP to repro_torch.launch."
                         "shard_server hosts (implies --sharded-save "
                         "unless inproc)")
    ap.add_argument("--shard-servers", default=None,
                    help="comma-separated host:port list, one per shard, "
                         "of externally launched shard_server hosts "
                         "(socket transport; default: auto-spawn local "
                         "loopback servers).  host:port*k assigns k "
                         "consecutive shards to one server and carries "
                         "them multiplexed over a single connection")
    ap.add_argument("--heartbeat-interval", type=float, default=None,
                    help="seconds between proactive writer liveness "
                         "probes (default: only discover dead writers at "
                         "submit/fence time)")
    ap.add_argument("--readmit-backoff", type=float, default=0.0,
                    help="base seconds of exponential re-admission "
                         "back-off for crash-looping shards (0 = retry "
                         "at every boundary)")
    ap.add_argument("--readmit", action="store_true",
                    help="respawn poisoned shard writers at the next cycle "
                         "boundary and reseed them (fresh full of their "
                         "current rows) instead of sticky fail-stop")
    ap.add_argument("--n-emb", type=int, default=8,
                    help="number of Emb-PS shards (N_emb)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the last consistent checkpoint cycle "
                         "from --checkpoint-dir before training")
    ap.add_argument("--attach", action="store_true",
                    help="standby-coordinator failover: take over the "
                         "previous coordinator's writer fleet recorded in "
                         "--checkpoint-dir/COORDINATOR and warm-start the "
                         "trainer from it; implies sharded save")
    ap.add_argument("--resize-at", action="append", default=None,
                    metavar="STEP:N",
                    help="live-resize the writer fleet to N shards at "
                         "training step STEP (repeatable, or one comma-"
                         "separated list; requires --sharded-save)")
    ap.add_argument("--lease-ttl", type=float, default=None,
                    help="coordinator lease TTL in seconds: a standby's "
                         "--attach is refused while the lease is live")
    ap.add_argument("--parity-group-size", type=int, default=0,
                    help="XOR parity group size for the sharded writer "
                         "fleet (0 = off)")
    ap.add_argument("--tracker-backend", choices=("host", "pallas", "kernel"),
                    default="pallas",
                    help="tracker selection: host code, or the tracker "
                         "kernels ('pallas' is the reference's name)")
    ap.add_argument("--hash-backend", choices=("host", "pallas", "kernel"),
                    default="host",
                    help="accepted for the reference's command lines: the "
                         "delta-save row hash runs where the rows lie (the "
                         "row_hash kernel on the card)")
    ap.add_argument("--seg-size", default="512",
                    help="tracker_select segment width (int), or 'auto' to "
                         "pick by measurement at startup")
    ap.add_argument("--codec-level", type=int, default=0,
                    help="zlib level for large socket-transport frames "
                         "(0 = off)")
    ap.add_argument("--mux-group", type=int, default=0,
                    help="multiplex auto-spawned socket writers in groups "
                         "of this many shards per connection/server "
                         "(0 = one connection per shard)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = build_cfg(args)
    resize_at = None
    if args.resize_at:
        resize_at = {}
        for item in args.resize_at:
            for part in item.split(","):
                step_s, n_s = part.split(":")
                resize_at[int(step_s)] = int(n_s)
    shard_addrs = None
    mux = False
    if args.shard_servers:
        shard_addrs = []
        for hp in args.shard_servers.split(","):
            hp, star, mult = hp.partition("*")
            host, port = hp.rsplit(":", 1)
            k = int(mult) if star else 1
            if k > 1:           # k shards ride one multiplexed connection
                mux = True
            shard_addrs.extend([(host, int(port))] * k)
    transport_options = None
    if args.codec_level or mux or args.mux_group:
        transport_options = {}
        if args.codec_level:
            transport_options["codec_level"] = args.codec_level
        if mux:
            transport_options["mux"] = True
        if args.mux_group:
            transport_options["mux_group"] = args.mux_group
    seg_size = "auto" if args.seg_size == "auto" else int(args.seg_size)
    _, hist = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    lr=args.lr, mode=args.mode, n_failures=args.failures,
                    target_pls=args.target_pls,
                    checkpoint_dir=args.checkpoint_dir,
                    async_save=args.async_save,
                    sharded_save=args.sharded_save,
                    delta_saves=(False if args.no_delta_saves else None),
                    n_emb=args.n_emb, resume=args.resume,
                    writer_procs=args.writer_procs, readmit=args.readmit,
                    transport=args.transport, shard_addrs=shard_addrs,
                    heartbeat_interval=args.heartbeat_interval,
                    readmit_backoff=args.readmit_backoff,
                    attach=args.attach, resize_at=resize_at,
                    lease_ttl=args.lease_ttl,
                    parity_group_size=args.parity_group_size,
                    tracker_backend=args.tracker_backend,
                    hash_backend=args.hash_backend, seg_size=seg_size,
                    transport_options=transport_options, device=args.device)
    r = hist["report"]
    o = r["overheads"]
    extra = ""
    if r.get("shard_failures") or r.get("shard_readmissions"):
        extra = (f" shard_failures={r['shard_failures']} "
                 f"readmissions={r['shard_readmissions']}")
    print(f"done: mode={r['mode']} pls={r['measured_pls']:.4f} "
          f"overhead={o['fraction'] * 100:.2f}% "
          f"save_blocked={o['save_blocked_s']:.3f}s "
          f"final_loss={hist['loss'][-1][1]:.4f}{extra}")


if __name__ == "__main__":
    main()
