"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc`` for sm_90a,
   each kernel's registers and spills, and the count of tensor-core
   (HGMMA) instructions in the SASS of the bf16 ``flash_attention`` and
   of its backward (0 fails).
2. Each kernel against its plain PyTorch version at the shapes of the
   DLRM main path (largest Criteo-Kaggle table: N = 10,131,227, d = 16,
   B = 512; ``embedding_bag`` as one table and, the path's own call, over
   all 26 unscaled tables with ``sparse`` (512, 26, 1), one launch each
   way, beside the kernel's own device time from ``torch.profiler``), with
   its time (CUDA events, median of 25 after warm-up), the
   plain version's time, its bound (the bytes this run's inputs need over
   3.35 TB/s, or operations over the f32 peak, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time.
   ``ssu_dedupe_evict`` takes raw candidates (repeats, draw order) and is
   timed without overflow (the path's steady state, the one in the
   kernels line) and with it; the profiler counts its CUDA kernels per
   call (more than 2 in the steady state fails); past one tile (16,384 and
   65,536 candidates, half-full and full reservoir) it must equal its
   plain version under ``torch.equal`` and is timed beside its bound; and
   full-width ``ssu_update(..., backend="kernel")`` calls with 256 and
   16,384 candidates run under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync fails).
   ``tracker_select``'s line adds ``torch.topk`` over the (n_seg, seg)
   view as a yardstick (selection only: no tie order, no clearing).  Both
   tracker kernels also print their time per call over 100 calls back to
   back (CUDA events) and their own device time (profiler).  ``row_hash`` is held
   bit for bit against its plain version on that table (f32 and a bf16
   copy, each with its f32 accumulator), a ragged width (d = 9), no rows
   and zero-byte rows; the number of differing words must be 0.  The
   widened contracts, timed beside their plain versions and equal to
   them: ``tracker_select`` at segments of 65,536 rows (past a team's
   16,384: a block a segment), ``embedding_bags`` over the 26 tables as
   12-byte rows (the element path) and over 130 tables (groups of 64),
   each beside the library calls (``F.embedding_bag`` and
   ``aten.embedding_dense_backward`` over a concatenated copy).
3. The main path: the port's ``Emulator`` trains the unscaled Criteo-Kaggle
   DLRM (26 tables, 33,762,577 rows, d = 16) under 2 injected failures in
   modes ``full``, ``cpr-mfu`` and ``cpr-ssu`` (kernel tracker backend),
   at batch 512, then evaluates: first on the flat store (STEPS_FLAT
   steps), then on the sharded writer fleet (STEPS_FLEET steps; 8 shards,
   ``transport="inproc"``, delta saves with the ``row_hash`` kernel
   ledger).  Launch counts are reset just before each run and read just
   after; every train step launches ``embedding_bag`` once forward and
   once backward (evaluation adds one forward per batch); the priority
   modes must restore from the fleet.
4. The output checked against a reference on a small input: the scaled
   config trained on the card and on the CPU (the CPU path is held against
   the JAX reference by the tests) from the same parameters gives the same
   PLS, overhead charges, bytes written and delta counts, and an AUC
   within 5e-3 — on the flat store, and through the fleet over the pipe
   and the socket transports (``AGREE_SHARDS`` shards, 20 steps of 256
   samples; the card hashes with the kernel, the CPU
   with the host ledger); the fleet's writer alone on the card and on the
   CPU gives the same images, in-place restores, bytes and delta counts
   after a ``save_full`` and a delta ``save_rows``.  A ``cpr-mfu`` run
   with a disk directory through ``pipe`` then reloads with
   ``load_latest_auto`` to its writers' fenced image byte for byte, and
   every pipe writer process reports from inside that it never created a
   CUDA context.  Phase 2 checks the kernels
   alone; this checks what the whole path on the card (trackers, saves,
   the fleet, restores, evaluation) hands back.

5. The port's benchmark harness (``benchmarks_torch``) on the card:
   (a) fig7's Kaggle rows at full Criteo-Kaggle width (33,762,577 rows,
   the published config), all six modes with the kernel tracker backend,
   steps cut to phase 3's STEPS_FLAT; each row with its launches by kernel
   (``embedding_bag`` both ways in every mode, ``tracker_select`` in
   ``cpr-mfu``, ``ssu_dedupe_evict`` in ``cpr-ssu``; none may be 0) and a
   load charge below full recovery's in the partial-recovery modes; (b)
   fig7's ``--fast`` Kaggle rows (scaled), all six modes with the host
   backend, on the card and on the CPU from the same parameters: identical
   policy fields, and for ``full`` and ``cpr-mfu`` AUC and eval logloss
   within ``FIG7_AUC_GAP`` and ``FIG7_LOGLOSS_GAP`` of the CPU's (limits
   set from ``python -m benchmarks_torch.fig7_spread``); (c) ``table1``
   and ``fig14`` at ``--fast`` size (``fig14``'s selection must launch
   ``tracker_select`` and equal the plain version, and its engines' bytes
   agree); (d) the five ``examples/torch_*.py`` as processes on the
   card, started together, each exiting 0 with its summary lines (the LM example at 10
   steps: its f32 attention runs the f32 kernels both ways; the serving
   example decodes 512 tokens of the reduced gemma2-2b; the MoE expert
   example trains the reduced qwen3-moe 30 steps, the f32 kernels both
   ways, 60 launches each).  Rows print with the card's ``nvidia-smi``
   name and power limit.
6. The fleet figures (``benchmarks_torch`` fig15-17) on the card, the
   trainer's tables on the device: (a) fig15 at the published Kaggle
   width (33,762,577 rows, d = 16, 2.30 GB of tables and accumulators),
   8 shards, one event: save events (memory) and delta saves; its
   ``delta_save`` rows must equal the same rows computed on the CPU (the
   plain hash); (b) at ``--fast`` size (26,777 rows), 2 shards: save
   events (memory, disk), the pipe fleet's shm against spool snapshots,
   the socket fleet and its codec row (zlib level 6), the bytes a writer
   crash loses with and without XOR parity, and a re-admission; (c) fig16
   (inproc and pipe, the 2 -> 4 split) and fig17 (2 shards) at ``--fast``
   size, fig17's ``hash_kernel`` at the largest Kaggle table's
   10,131,227 x 16 (the cuts and why: FIG15_FULL); (b) and (c) run in
   processes of their own beside phases that print no time
   (BACKGROUND_FIGURES: fig16 and fig17 beside phase 4, fig15's fleets
   beside 4m, 4h, 4v, 4x and 7 (b, c)), with the same rows, audits and
   probes.  Every audit field must be true and
   ``unchanged_resave_bytes`` 0; the phase
   must launch ``row_hash`` (its count goes in the kernels line as
   ``harness_launches``); no pipe writer or socket server process may
   create a CUDA context (each reports from inside).  The free disk space
   under the temporary directory and the host's available memory are
   printed first, and the phase stops with a plain message if they are
   short.

The LM serving path (RecurrentGemma-2B at full width, the DLRM tensors
freed first):

2b. ``flash_attention`` and ``rglru_scan`` against their plain versions at
   the path's shapes: (2, 10, 4096, 256) bf16 queries over (2, 1, 4096,
   256) keys with window 2048, gemma2's (1, 8, 4096, 256) over (1, 4,
   4096, 256) global with softcap 50, the reduced f32 case, phase 4b's
   f32 prefill shape (2, 10, 2176, 256) over (2, 1, 2176, 256) (the f32
   3xTF32 kernel at full width, beside f32 SDPA with TF32 off), and phase
   3m's bf16 (2, 16, 4096, 128) causal MHA (qwen2-moe-a2.7b's layers),
   phase 3v's (1, 64, 4096, 128) over (1, 8, 4096, 128) causal GQA
   (Qwen2-VL's), and HuBERT's bidirectional head dim 80 over 1,000 frames:
   phase 3h's (8, 16, 1000, 80) bf16 and 4h's (1, 16, 1000, 80) f32,
   and phase 8's gemma2-2b, softcap 50, on its local layers (window
   4,096) and its global ones: a training microbatch (``MESH_MICROBATCH``
   = (4, 4096): (4, 8, 4096, 256) over (4, 4, 4096, 256)) and the prefill
   (2, 8, 4096, 256) over (2, 4, 4096, 256), bf16,
   each with its own device time (profiler); the scan at
   (2, 4096, 2560) f32 and bf16 (bit for bit), with its own device time
   (profiler) and, as a yardstick, one ``torch.add`` over the same
   tensors, which moves the same bytes.  bf16 attention outputs
   must agree within 1e-2 * |plain| + 4e-3 (one bf16 rounding and some),
   and the plain version with its window one key tile (64) short must
   fall outside that limit.  Bounds: the unmasked band's flops over the peak
   of the dtype's arithmetic (bf16 tensor cores; f32: three TF32 products
   a product at the TF32 tensor-core peak, the FMA bound printed beside
   it) or the bytes, whichever is larger; library time:
   ``F.scaled_dot_product_attention`` with the band as its mask where
   there is no softcap.
2c. The backward kernels against their plain backwards at the training
   path's shapes: attention bf16 (8, 10, 512, 256) over (8, 1, 512, 256)
   with window 2,048 (the training run's), (2, 10, 4096, 256) over (2, 1,
   4096, 256) (the window bites), gemma2's (1, 8, 4096, 256) over (1, 4,
   4096, 256) global with softcap 50, f32 (4, 8, 128, 64) over (4, 4,
   128, 64) with window 256 (the LM example's), HuBERT's bidirectional
   head dim 80 at 3h's (8, 16, 1000, 80) bf16 and 4h's (1, 16, 1000, 80)
   f32, phase 8's gemma2-2b training microbatch (4, 8, 4096, 256) over
   (4, 4, 4096, 256) bf16 with softcap 50, local (window 4,096) and
   global, and f32 (1, 10, 2176, 256)
   over (1, 1, 2176, 256) with window 2,048 (the training check 7 (b) at
   full width), within
   ``BWD_TOL`` (|kernel - plain| <= rtol |plain| + atol max|plain|; the
   plain backward with its window one key tile (64) short must fall
   outside it), both with the forward's log-sum-exp handed over (the path
   ``ops`` takes, and the one timed) and without it; two calls must give
   equal gradients (``torch.equal``); the scan's at (8, 512, 2560) and
   (2, 4096, 2560), f32 and bf16, under ``torch.equal``, two calls equal
   (and at ``BWD_SCAN_RAGGED``: odd w, S not a multiple of a tile, a base
   one element past an aligned address).  Each with its
   time (CUDA events, median of 25), its kernels' own device time by
   kernel (profiler), the plain version's time, its bound (2.5 times the
   forward's band flops at the dtype's rate as in 2b, or the bytes; the
   scan: a, h, dh read, da, db written) and the backward of
   ``F.scaled_dot_product_attention`` with the band mask (no softcap) or,
   for the scan, one ``torch.add`` over the same bytes.  Autograd through
   ``ops.flash_attention`` (the forward's log-sum-exp reaching the
   backward) and ``ops.rglru_scan`` on the card gives gradients equal to
   the backward kernels'.
3b. The main path: RecurrentGemma-2B parameters (f32) drawn on the card,
   one prefill ``forward`` over (2, 4096) tokens in bf16, then ``serve()``
   answers 8 requests (prompts up to 64 tokens, batch 4, 32 generated).
   Counts are reset before the forward and read after ``serve()``:
   ``flash_attention`` must have launched 8 times (the local-attention
   layers) and ``rglru_scan`` 18 (the RG-LRU layers).  Then the prefill's
   time (the median of 5 forwards) and a decode step's time at batch 4
   past the window (a full 2,048-slot ring per local layer), the
   workload of ``python -m repro_torch.launch.profile_serve``.
4b. At full width in f32, prefill (``forward``, through both kernels) and
   decode (``decode_step`` teacher-forced over the same 2,176 tokens, past
   the window) give the same logits at every position within 1e-4 of the
   largest logit (the steps past the window are timed); at the reduced
   config, the card and the CPU give the
   same ``forward`` logits within 1e-4 and identical greedy ``serve()``
   completions.

The MoE serving path (Qwen1.5-MoE-A2.7B at full width, the RecurrentGemma
parameters freed first):

3m. The main path: ``qwen2-moe-a2.7b`` parameters (f32, 57.26 GB:
   ``param_counts()``'s 14,315,732,992 and the final norm and shared-expert
   gates it leaves out, 14,315,784,192 as in the reference's tree) drawn
   on the card, one prefill ``forward`` over (2, 4096)
   tokens in bf16 (each MoE layer's capacity and dropped assignments
   probed beside it: C = 682 for T = 8,192, k = 4, E = 60), then
   ``serve()`` answers 8 requests (prompts up to 64 tokens, batch 4, 32
   generated).  Counts are reset before the forward and read after
   ``serve()``: ``flash_attention`` must have launched 24 times (one per
   layer in the prefill; decode attends with the plain ``_sdpa``, as the
   reference does).  Then the prefill's time (the median of
   ``MOE_PREFILL_REPS`` forwards), the ms per decode step at batch 4 and
   the peak memory.
4m. (a) At full width in f32, with the capacity factor E / k (the prefill,
   like decode, drops nothing), prefill and decode teacher-forced over the
   same 256 tokens, every MoE layer's routes probed on both paths: a route
   may differ only within ``ROUTE_TIE`` of a tie between the k-th and
   (k+1)-th router probabilities (every flip printed with its gap), and the
   logits agree within 1e-4 of the largest at every position before the
   first flipped token (a position depends only on the tokens up to it).
   (b) The reduced qwen2-moe and qwen3-moe on the card and the CPU from the
   same parameters: ``forward`` logits within 1e-4 of the largest and
   identical greedy ``serve()`` completions.  The MoE parameters are
   freed before 4h.

The audio encoder and the VLM (HuBERT X-Large, Qwen2-VL):

3h. The main path: ``hubert-xlarge`` at full width and depth (48 layers,
   d 1,280, 16 bidirectional heads of 80, GELU MLP 5,120, LayerNorm; f32
   parameters, the tree's exact count printed, bf16 activations; no token
   embedding) over (8, 1,000) frame embeddings (20 s of
   audio at 20 ms a frame; S is not a multiple of the 64-row tile, so the
   ragged tail runs on the main path): one ``forward``, then
   ``HUBERT_STEPS`` training steps (``lm_loss`` over HuBERT's span mask,
   spans of 10 frames each frame starts with probability 0.08, its
   backward, the port's ``adam``; no remat): the workload of
   ``python -m repro_torch.launch.profile_encoder``.  Counts reset around the forward and
   around the steps: ``flash_attention`` 48 launches a forward, and 48
   each way a step.  Every loss finite, every gradient leaf non-zero, step
   2's loss below step 0's plus 1.  Prints the forward's ms (median of
   ``HUBERT_REPS``), each step's ms and the peak memory.
3v. The main path: ``qwen2-vl-72b`` at full width (d 8,192, 64:8 heads
   of 128, QKV biases, M-RoPE sections (16, 24, 24), MLP 29,568), depth
   cut to ``VLM_LAYERS`` = 4 of 80 (6,002,155,520 parameters by
   ``param_counts()``, and the final norm; 24.0 GB f32), one (1, 4,096)
   prefill in bf16 with 1,024 patch embeddings at positions 16..1,039
   (one 896 x 896 image, a 32 x 32 grid after the 2 x 2 merge) and
   Qwen2-VL's M-RoPE positions (``image_positions``), then ``serve()``
   answers 8 text requests at batch 4 (decode rotates by M-RoPE).
   ``flash_attention`` launches 4 times a prefill.  Prints the prefill's
   ms (median of ``VLM_REPS``), ms per decode step and the peak memory.
4h. (a) One HuBERT layer at full width in f32 over (1, 1,000) frames, the
   same parameters on the card and the CPU: ``lm_loss`` within 1e-5
   relative, every gradient leaf within ``GRAD_AGREE`` of its largest
   entry (the f32 kernels once each way); (b) the reduced
   ``hubert-xlarge`` and a reduced variant at head dim 80 (d 160, 2
   heads), card against CPU: logits within 1e-4 of the largest.
4v. (a) At 3v's width in f32 (the parameters drawn again), prefill
   against teacher-forced decode over ``VLM_AGREE_SEQ`` text tokens
   (``arange`` positions): logits within 1e-4 of the largest at every
   position; (b) the reduced ``qwen2-vl-72b`` on the card and the CPU
   from the same parameters with the image-layout positions: logits
   within 1e-4 of the largest, identical greedy ``serve()`` completions.
   Its parameters are freed before phase 7 (its peak is 60.75 GB).

LM training with CPR over the token rows (RecurrentGemma-2B):

7. (a) The main path: ``launch.train.train`` at full width and depth
   (f32 parameters, bf16 activations), batch 8 x 512, 2 failures of 25 %
   of 8 shards, ``TRAIN_STEPS`` steps a mode, the kernel tracker backend:
   ``full`` and ``cpr-ssu`` on the flat store, ``cpr-mfu`` on the inproc
   fleet with delta saves hashed by ``row_hash``.  Counts reset before
   each mode and read after: every step launches ``flash_attention`` and
   its backward 8 times and ``rglru_scan`` and its backward 18 times;
   ``cpr-mfu`` launches ``tracker_select`` and ``row_hash``, ``cpr-ssu``
   ``ssu_dedupe_evict``.  Every loss finite, every gradient leaf non-zero
   after step 0, partial restores in the priority modes; the steady step
   ms (median of steps 2..), peak memory, save-blocked seconds and the
   report's policy fields print.  (b) One pattern period (RG-LRU, RG-LRU,
   local attention) at full width in f32 over (1, 1,088) tokens, the same
   parameters on the card and the CPU: ``lm_loss`` within 1e-5 relative,
   every gradient leaf within ``GRAD_AGREE`` of its largest entry.  (c)
   The reduced config trained on the card and the CPU from the same
   parameters: identical policy fields, step 0's loss within 1e-5 and
   every loss within ``TRAIN_AGREE`` (its comment says why).

xLSTM-1.3B (42 mLSTM and 6 sLSTM layers at 7:1, d 2,048, 4 heads of 512,
vocab 50,304, untied; its layers launch none of the port's kernels: the
reference's blocks are jnp):

3x. The main path: ``xlstm-1.3b`` at full width and depth (f32
   parameters, the tree's exact count, 1,238,681,936, checked; bf16
   activations), one warm-up and one timed prefill ``forward`` over
   ``XLSTM_PREFILL`` = (2, 4096) tokens, then ``serve()`` answers 8
   requests (prompts up to 64 tokens, batch 4, 32 generated).  Counts
   reset before the prefill and read after ``serve()``: every one 0.
   Prints the prefill's ms, the ms per decode step, the peak memory.
4x. (a) One pattern period (7 mLSTM, 1 sLSTM) at full width in f32 over
   (1, 512) tokens (two mLSTM chunks), the same parameters on the card
   and the CPU: ``lm_loss`` within 1e-5 relative, every gradient leaf
   within ``GRAD_AGREE`` of its largest entry; (b) the reduced config on
   the card: prefill against teacher-forced decode over
   ``XLSTM_AGREE_SEQ`` tokens (the chunkwise forms against the recurrent
   ones) within ``XLSTM_DECODE_TOL`` of the largest logit, then card
   against CPU: ``forward`` within 1e-4, identical greedy ``serve()``
   completions.
7x. The main path: ``launch.train.train`` at full width and depth,
   ``XLSTM_TRAIN_STEPS`` steps a mode, as 7 (a) in ``cpr-ssu`` (flat
   store) and ``cpr-mfu`` (inproc fleet, delta
   saves hashed by ``row_hash``): no attention or scan launch, CPR's
   ``tracker_select``, ``row_hash`` and ``ssu_dedupe_evict`` each
   launched; 7 (a)'s checks and lines.

The mesh layer (gemma2-2b: 26 layers, d 2,304, 8:4 heads of 256, local
window 4,096 and global layers with softcap 50, vocab 256,000 tied):

8. (a) The main path: the reference's production step builders
   (``repro_torch.launch.steps``) on ``launch.mesh.make_host_mesh()`` (a
   world of one over NCCL): ``build_train_step`` (Adam, bf16 forward,
   ``MESH_MICROBATCHES`` = 4 microbatches: its comment says why) through
   ``shard_train_step`` at ``MESH_TRAIN`` = (16, 4096) tokens, pod16x16's
   share of train_4k, ``MESH_TRAIN_STEPS`` steps;
   counts reset before the first step and read after the prefill: every
   microbatch launches ``flash_attention`` and its backward at least once
   a layer.  Then ``build_prefill_step`` through ``shard_prefill_step`` at
   (2, 4096) (``flash_attention`` at least once a layer a call: bf16, head
   dim 256, softcap 50) and ``build_serve_step`` through
   ``shard_serve_step`` at batch 4 for 16 steps, on the host mesh, where
   every shard is the whole; their times print beside those of the
   unsharded steps (``MESH_UNSHARDED_MS``, PERF.md section 6).  Prints ms
   a step, the peak memory, the launches and the collectives (none on one
   rank).
   (b) The reduced gemma2-2b, one f32 step through ``shard_train_step``
   on the card and on the CPU from the same parameters: the loss within
   1e-5 relative, Adam's first moment (0.1 of the gradient) within
   ``GRAD_AGREE`` of its largest; its f32 serve step through
   ``shard_serve_step``, card and CPU from the same state, 16 steps:
   every step's logits within 1e-5 of the largest.
   (d) gemma2-2b x long_500k at full width on the card: batch 1, the whole
   524,288-slot cache filled with random bf16 keys and values (reckoned
   in ``MESH_LONG_MERGE_POS``'s comment), 16 steps through
   ``shard_serve_step`` at positions 524,272-524,287: ms a step, the peak
   memory, finite logits.  Then on one global layer's cache the partial
   attention over each of 256 pieces of 2,048 slots (pod16x16's piece),
   merged by ``merge_pieces`` (what the sharded step's
   ``merge_attention`` does after its all-gather), against the one-piece
   result, both f32: within 1e-5 of the largest at pos 524,287 and at
   196,608, where 159 pieces are empty.  (c) The dry run of gemma2-2b x
   train_4k x pod16x16 (``launch.dryrun``: a fake process group of 256
   ranks, fake CPU tensors, no card visible) in a process of its own,
   started with fig15's fleets beside 4m-7 (b, c), which print no time,
   and joined here, so that no other process shares the host with (a)'s
   timed steps: status ok and
   ``DRYRUN_ARGUMENT_BYTES``, the reference's compiled artifact's; its
   roofline terms are printed as
   model estimates from the data sheet's constants.  The process group is
   destroyed before the last lines.  Phases (a), (d), (b), (c) run in that
   order.

The port's invariant tools (``repro_torch.analysis``) on the card's host:

9. (a) ``run_analysis()`` over the port with all seven rules: 0
   unsuppressed (files, findings and suppressed findings printed).
   (b) The protocol model check (fast scope): the baseline holds every
   invariant, every seeded mutant is caught (``run_check`` returns 0;
   states and counterexample lengths printed).  (c) The lock-order
   sanitizer, installed before the workload builds anything and
   uninstalled in a ``finally``, over the CPR manager on the card
   (``cpr-mfu``, sharded asynchronous saves, the scaled Kaggle config, 2
   injected failures, ``ANALYSIS_STEPS`` steps) and a socket fleet of
   CUDA tables over shard servers on threads, one shard killed and
   re-admitted; run on a thread of its own, a hang past
   ``ANALYSIS_LIMIT_S`` fails the script.  It must track a lock from each
   of ``ANALYSIS_SITES``, leave an acyclic graph (sites and edges
   printed), and see ``tracker_select``, ``row_hash`` and
   ``embedding_bag`` launched inside its window (the card's branches:
   the kernel ledger, the page-locked snapshots).  (d) The spec-derived
   fuzz of the port's shard server, ``FUZZ_FRAMES`` frames, the fleet's
   tables on the card: ``ok``, every frame sent, at least one ``stale``
   reply.  Each part prints its seconds, the phase its total.

Depth cut when phases 3m and 4m arrived, so that the last phase ends by
1,000 s of the 1,200 s limit (PERF.md section 4 gives the runs): uncut
the script ended its last phase at 1,040.9 s; a first round of cuts took
it to 937.3 s on that kind of host and 1,242.1 s on a slower one, so a
second round followed.  First round: phase 7's ``TRAIN_STEPS`` 6 -> 4
(20.9 s saved), phase 4's scaled runs 8,000 -> 5,120 samples (19.6 s),
phase 2b's plain versions timed over 5 calls, not 25 (10.2 s), the LM
example 20 -> 10 steps (7.7 s), ``STEPS_FLAT``/``STEPS_FLEET`` and phase
5 (a) 35 -> 25 steps a mode (about 10 s).  Second round: phase 4's fleets
8 -> ``AGREE_SHARDS`` shards (16.6 s), 7 (b) over ``PERIOD_SEQ`` tokens,
not ``AGREE_SEQ`` (16.6 s): 916.6 s, and 873.5 s and 1,200.9 s on two
more hosts.  Then phase 5 (d)'s examples were started together rather than
one after another (91.3 -> 44.6 s: 46.7 s saved): 867.9 s.  No check was
dropped.

When phases 3h, 4h, 3v and 4v arrived (PERF.md section 4 gives the runs),
phase 6's process fleets (fig15's at --fast size, fig16 and fig17: 107.0,
78.8 and 87.1 s in the last run before them, nearly all of it process
start)
moved into processes of their own beside phases that print no time, and
7 (b, c), which print none, run before 7 (a) beside one of them; no check
was cut.

Phases run in the order 1, 2, 3, 4 (fig16 and fig17 beside it), 2b, 2c,
5, 6 (fig15 at full width), 3b, 4b, 3h, 3v, 3m, 4m, 4h, 4v, 4x, 7 (b, c)
(fig15's fleets and 8 (c)'s dry run beside these six), 7 (a), 3x, 7x, 8,
9.
The script prints its time after every phase.  The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, ...}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the H100 SXM's data-sheet rates (repro_torch.launch.mesh names each
# source): HBM, f32 outside the tensor cores, TF32 and bf16 tensor cores
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as F32_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_OPS_PER_S  # noqa: E402

# f32-accurate products on the tensor cores take three TF32 products each
# (3xTF32, csrc/tf32x3.cuh): the f32 attention kernels' bound
F32_TC_OPS_PER_S = TF32_OPS_PER_S / 3
N_BIG, D, B = 10_131_227, 16, 512
# phase 3's steps a mode (and phase 5 (a)'s): cut from 35 with the MoE
# serving phases' arrival (PERF.md section 4)
STEPS_FLAT = 25
STEPS_FLEET = 25
N_RAGGED = 1_000_003                  # rows of the d = 9 row_hash case
# phase 4's fleets (flat, pipe, socket, the disk round trip): 2 shards, as
# phase 6's process fleets (cut from 8: each pipe writer or socket server
# is a process that takes seconds to start on the card's host)
AGREE_SHARDS = 2
FLEET = {"sharded_save": True, "delta_saves": True, "hash_backend": "kernel",
         "transport": "inproc"}
# the LM serving path (phases 2b-4b): RecurrentGemma-2B at full width; the
# workload of phase 3b is repro_torch.launch.profile_serve's (ARCH,
# PREFILL_SHAPE, PREFILL_REPS, DECODE_*), imported in main()
AGREE_SEQ = 2176             # prefill vs decode: past the window, ring wraps
# phase 8: the mesh layer.  gemma2-2b's production steps at full width and
# depth on the host mesh (NCCL, a world of one) through shard_train_step,
# Adam, bf16 forward, 4 microbatches; then the prefill and serve steps.
# The batch is the per-GPU share of train_4k on pod16x16 (256 sequences
# over 16 data ranks).  The whole model state lives on the one card, so
# it takes 4 microbatches of 4 sequences (peak 68.29 GB) where the
# production mesh's dry run takes 2: with 2 the step ran out of memory,
# with the caching allocator's expandable segments too (79.16 GB
# allocated at the failure; launch/profile_mesh.py, PERF.md section 4)
MESH_ARCH = "gemma2-2b"
MESH_TRAIN = (16, 4096)
MESH_MICROBATCHES = 4
MESH_TRAIN_STEPS = 3
MESH_PREFILL = (2, 4096)
# a microbatch's (batch, tokens): phase 2b's and 2c's gemma2-2b cases
MESH_MICROBATCH = (MESH_TRAIN[0] // MESH_MICROBATCHES, MESH_TRAIN[1])
MESH_SERVE = (4, 16)               # batch, decode steps
# 8 (a)'s prefill (ms of each call) and serve (median ms a step) before
# they went through the sharded step builders (PERF.md section 6)
MESH_UNSHARDED_MS = ("105.1-106.1", "52.63")
MESH_AGREE = (4, 128)              # 8 (b): reduced, f32, card vs CPU
# 8 (b): the reduced serve step, card vs CPU: batch, steps, cache length
MESH_SERVE_AGREE = (4, 16, 128)
# 8 (d): gemma2-2b x long_500k at full width on the one card (batch 1,
# the whole 524,288-slot cache): 13 global layers' K and V at 1.07 GB each
# (27.9 GB), 0.22 GB of local rings, 8.25 GB of f32 parameters, and the
# f32 casts of one layer's K and V (4.3 GB) while it attends.  The merge
# is checked at pos 524,287 (every slot valid) and at 196,608 (159 of the
# 256 pieces empty); the limit is 1e-5 of the largest entry
MESH_LONG_MERGE_POS = (524_287, 196_608)
# 8 (c): the dry run's argument bytes per GPU of gemma2-2b x train_4k on
# pod16x16, from the reference's compiled artifact
# (artifacts/dryrun/gemma2-2b__train_4k__pod16x16.json, memory.argument_bytes)
DRYRUN_ARGUMENT_BYTES = 98_384_900
# phase 9: the port's invariant tools on the card host.  9 (c)'s workload
# is tests/test_torch_lockorder.py's failover manager (the scaled Kaggle
# config, 2 injected failures, ANALYSIS_STEPS steps) on the card, then a
# socket fleet of the scaled config's tables (d = 16) on the card over
# ANALYSIS_SHARDS shard servers on threads; a hang fails the phase after
# ANALYSIS_LIMIT_S seconds.  9 (d) fires FUZZ_FRAMES frames
ANALYSIS_STEPS = 12
ANALYSIS_SHARDS = 2
ANALYSIS_LIMIT_S = 120.0
# the sites 9 (c) must see a lock constructed at, at least one each
ANALYSIS_SITES = ("core/transport.py", "core/sharded_checkpoint.py",
                  "launch/shard_server.py")
FUZZ_FRAMES = 200
# flash_attention cases of phase 2b: name, (B, Hq, Hkv, S, hd), dtype,
# causal, window, softcap, (rtol, atol); the first is the serving path's
# own.  The kernel and the plain version read the same inputs and both sum
# in f32, so bf16 outputs may differ by one rounding (at most 2**-7 of the
# value)
FLASH_CASES = (
    ("recurrentgemma-2b prefill", (2, 10, 1, 4096, 256), torch.bfloat16,
     True, 2048, 0.0, (1e-2, 4e-3)),
    ("gemma2-2b global", (1, 8, 4, 4096, 256), torch.bfloat16, True, 0, 50.0,
     (1e-2, 4e-3)),
    ("recurrentgemma-2b reduced", (2, 4, 1, 128, 64), torch.float32, True, 64,
     0.0, (0.0, 2e-5)),
    # phase 4b's f32 prefill: the 3xTF32 kernel at full width (the card
    # tests' f32 limit)
    ("recurrentgemma-2b f32 (phase 4b)", (2, 10, 1, AGREE_SEQ, 256),
     torch.float32, True, 2048, 0.0, (2e-5, 2e-5)),
    # phase 3m's prefill: every layer of qwen2-moe-a2.7b, head dim 128, MHA
    ("qwen2-moe-a2.7b prefill", (2, 16, 16, 4096, 128), torch.bfloat16, True,
     0, 0.0, (1e-2, 4e-3)),
    # phase 3v's prefill: Qwen2-VL's GQA 64:8 at head dim 128
    ("qwen2-vl-72b prefill", (1, 64, 8, 4096, 128), torch.bfloat16, True, 0,
     0.0, (1e-2, 4e-3)),
    # phase 3h's layers: HuBERT X-Large, bidirectional at head dim 80 over
    # 1,000 frames (a ragged last tile), and phase 4h's f32 layer
    ("hubert-xlarge (phase 3h)", (8, 16, 16, 1000, 80), torch.bfloat16,
     False, 0, 0.0, (1e-2, 4e-3)),
    ("hubert-xlarge f32 (phase 4h)", (1, 16, 16, 1000, 80), torch.float32,
     False, 0, 0.0, (2e-5, 2e-5)),
    # phase 8 (a)'s gemma2-2b: a training microbatch and the prefill, on
    # its local layers (window 4,096) and its global ones, softcap 50
    *((f"gemma2-2b {kind}, {what} (phase 8)",
       (batch, 8, 4, seq, 256), torch.bfloat16, True, window, 50.0,
       (1e-2, 4e-3))
      for what, (batch, seq) in (("training", MESH_MICROBATCH),
                                 ("prefill", MESH_PREFILL))
      for kind, window in (("local", 4096), ("global", 0))))
KEY_TILE = 64                # keys per tile of csrc/flash_attention_bf16.cu
# phase 2c: the backward kernels.  Attention cases: name, (B, Hq, Hkv, S,
# hd), dtype, window, softcap; the first is the training path's own.  The
# kernel and the plain backward read the same q, k, v, output and output
# gradient and both compute in f32, in another order: the limit is
# |kernel - plain| <= rtol * |plain| + atol * max |plain|, by dtype.  f32:
# the order of the f32 sums (1e-4, 1e-5); bf16 adds one rounding of each
# gradient to bf16 (at most 2**-8 of the value, nearest): (1e-2, 5e-3)
BWD_FLASH_CASES = (
    ("recurrentgemma-2b training", (8, 10, 1, 512, 256), torch.bfloat16,
     True, 2048, 0.0),
    ("recurrentgemma-2b, window bites", (2, 10, 1, 4096, 256),
     torch.bfloat16, True, 2048, 0.0),
    ("gemma2-2b global", (1, 8, 4, 4096, 256), torch.bfloat16, True, 0, 50.0),
    ("lm-100m example", (4, 8, 4, 128, 64), torch.float32, True, 256, 0.0),
    # the training check 7 (b) at full width: one local-attention layer of
    # RecurrentGemma-2B in f32 over AGREE_SEQ tokens
    ("recurrentgemma-2b f32 (7 (b))", (1, 10, 1, AGREE_SEQ, 256),
     torch.float32, True, 2048, 0.0),
    # HuBERT X-Large's training step (phase 3h) and 4h (a)'s f32 layer:
    # bidirectional at head dim 80 over 1,000 frames
    ("hubert-xlarge training (phase 3h)", (8, 16, 16, 1000, 80),
     torch.bfloat16, False, 0, 0.0),
    ("hubert-xlarge f32 (phase 4h)", (1, 16, 16, 1000, 80), torch.float32,
     False, 0, 0.0),
    # phase 8 (a)'s gemma2-2b training microbatch, local and global layers
    *((f"gemma2-2b {kind}, training (phase 8)",
       (MESH_MICROBATCH[0], 8, 4, MESH_MICROBATCH[1], 256), torch.bfloat16,
       True, window, 50.0) for kind, window in (("local", 4096),
                                                ("global", 0))))
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 5e-3)}
BWD_KEY_TILE = 64            # keys per dK/dV tile of both backward sources
# the backward's kernels by dtype, as the profiler names them
BWD_KERNELS = {torch.bfloat16: ("flash_bwd_prep", "flash_bwd_dkdv",
                                "flash_bwd_dkdv_sum", "flash_bwd_dq"),
               torch.float32: ("flash_bwd_dq_tf32", "flash_bwd_dkdv_tf32",
                               "flash_bwd_dkdv_sum_tf32")}
BWD_SCAN_SHAPES = ((8, 512, 2560), (2, 4096, 2560))
BWD_SCAN_RAGGED = ((2, 1000, 2555), (8, 1000, 2555))
# phase 7: training RecurrentGemma-2B at full width (batch 8 x 512 tokens,
# 2 failures of 25 % of 8 shards); steps a mode, and steps 2.. are steady
TRAIN_SHAPE = (8, 512)
# cut from 12, then 6: the time limit (PERF.md section 4)
TRAIN_STEPS = 4
# the modes and stores of 7 (a); 7x trains xLSTM in the last two
TRAIN_RUNS = (("full", {}), ("cpr-ssu", {}), ("cpr-mfu", FLEET))
# 7 (b): one pattern period (RG-LRU, RG-LRU, local attention) at full width
# in f32 over PERIOD_SEQ tokens, card against CPU (cut from AGREE_SEQ for
# the time limit: its cost, mostly the CPU's 256,000-word cross-entropy,
# is linear in the tokens; the window no longer bites here, and phase 2c
# holds the f32 backward at AGREE_SEQ with the window biting against its
# plain version).  The loss within 1e-5
# relative, each gradient leaf within GRAD_AGREE of its largest entry: f32
# sums over 2,560-wide rows and a 256,000-word vocabulary in another order
# (cuBLAS and the kernels against the CPU's BLAS and plain versions)
GRAD_AGREE = 1e-4
PERIOD_SEQ = 1088
# 7 (c): the reduced config trained on the card and the CPU.  Step 0's
# loss (no update yet) within 1e-5 relative; every step's within
# TRAIN_AGREE.  Traced step by step (``python -m
# benchmarks_torch.lm_train_spread``, PERF.md section 6) the card reads at
# most 1.9e-6 from the CPU over 8 steps, the same saves and restores; the
# CPU at one thread reads up to 8.2e-6 from itself, and gradients off by
# 1e-5 of their size at every step 4.4e-5
TRAIN_AGREE = 1e-4
SCAN_SHAPE = (2, 4096, 2560)  # the RG-LRU layers' (B, S, width) at prefill
# the MoE serving path (phases 3m-4m): Qwen1.5-MoE-A2.7B at full width
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PREFILL_SHAPE = (2, 4096)
MOE_PREFILL_REPS = 3         # the prefill's time: the median of this many
# 4m (a): prefill against decode over MOE_AGREE_SEQ tokens in f32.  A route
# may differ between the two only where the k-th and (k+1)-th router
# probabilities lie within ROUTE_TIE of each other (f32 sums in another
# order on the two paths); logits agree within 1e-4 of the largest before
# the first token whose route flipped
MOE_AGREE_SEQ = 256
ROUTE_TIE = 1e-5
# the audio encoder (phases 3h-4h): HuBERT X-Large at full width and
# depth, over 20 s of audio at HuBERT's 20 ms frame rate (1,000 frames: a
# ragged last 64-row tile), trained HUBERT_STEPS steps with Adam on
# masked prediction over HuBERT's span mask: the workload of
# repro_torch.launch.profile_encoder (ARCH, BATCH, FRAMES, SPAN,
# SPAN_START, LR, make_batch), imported where it runs
HUBERT_REPS = 3              # the forward's time: the median of this many
HUBERT_STEPS = 3
# the VLM (phases 3v-4v): Qwen2-VL at its full width, depth cut to
# VLM_LAYERS of 80 (72.7 B parameters do not fit one card); one (1, 4,096)
# prefill holding one 896 x 896 image, a 32 x 32 grid of patches after the
# 2 x 2 merge, at positions 16..1,039 (VLM_IMAGE: start, rows, columns)
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 4
VLM_PREFILL = 4096
VLM_IMAGE = (16, 32, 32)
VLM_REPS = 3
VLM_AGREE_SEQ = 256          # 4v (a): prefill vs decode over text tokens
# xLSTM-1.3B (phases 3x, 4x, 7x) at full width and depth: 42 mLSTM and 6
# sLSTM layers; the mLSTM runs in chunks of 256 tokens, the sLSTM one
# token at a time
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PREFILL = (2, 4096)
XLSTM_PERIOD_SEQ = 512       # 4x (a): one pattern period over two chunks
XLSTM_AGREE_SEQ = 512        # 4x (b): prefill vs decode, reduced, f32
XLSTM_DECODE_TOL = 1e-5      # of the largest logit (f32 on both paths)
# 7x's steps a mode: cut from 4 for the time limit (PERF.md section 4)
XLSTM_TRAIN_STEPS = 3
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
# phase 5: the benchmark harness.  fig7's policy fields must be equal on the
# card and the CPU.  At the harness's size (70 steps) the trained model
# depends on the order of float sums (the card's embedding backward adds
# atomically, in a run-dependent order; the CPU's AUC moves with its thread
# count), so in ``full`` and ``cpr-mfu`` the card's AUC and eval logloss
# are held to the CPU's within limits set from that measured spread.  A
# card path that trains wrongly misses them by far more
FIG7_POLICY = ("overhead_frac", "save_h", "load_h", "lost_h", "resched_h",
               "pls", "overhead_reduction_pct")
FIG7_HELD = ("full", "cpr-mfu")
FIG7_AUC_GAP = 3e-2       # measured up to 1.33e-2; untrained 0.34 away
FIG7_LOGLOSS_GAP = 0.2    # measured up to 5.13e-2; untrained 0.23 away
# example -> (a summary line, how many it prints, its arguments); the LM
# example trains its f32 model (the f32 attention kernels, both ways) for
# 10 steps instead of 200 (the time limit: 50 steps took 42.6 s on the
# card, a dozen compressed persists of the whole trainer tree among them;
# cut from 20 with the MoE serving phases' arrival)
EXAMPLE_LINES = {
    "torch_quickstart.py": (r"^\s*(full|cpr-mfu) auc=0\.\d{4} pls=", 2, ()),
    "torch_cpr_tradeoff.py": (r"^  PLS=\S+\s+auc=0\.\d{4} overhead=", 3,
                              ()),
    "torch_train_lm_with_cpr.py": (r"^mode=cpr-mfu effective=cpr-mfu pls=", 1,
                                   ("--steps", "10")),
    # the reduced gemma2-2b decoding 8 x 64 tokens after 32 prompt steps
    "torch_serve.py": (r"^decode: 512 tokens in \d+\.\d+s -> [\d.]+ tok/s ",
                       1, ()),
    # the reduced qwen3-moe (f32, head dim 64, 2 layers) trained 30 steps
    # with Adam: the f32 attention kernels both ways, 2 launches a step each
    "torch_moe_expert_cpr.py": (
        r"^(  CPR-MFU would partial-save experts \[\d, \d\] \(r=0\.5 -> 2 "
        r"of 4\)|kernel launches: \{'flash_attention': 60, "
        r"'flash_attention_backward': 60\})$", 2, ())}
PROBE_ENV = "CHIP_SMOKE_WRITER_PROBE_DIR"
# phase 6: the fleet figures.  Audit fields that must be true in every row
# that has them; the disk and host memory the full-width fig15 needs (two
# compressed 2.3 GB images on disk at once, the sync store, a writer's
# image, the pinned snapshots and the oracle's copies in host memory)
FLEET_AUDITS = ("image_matches_sync", "image_matches_oracle",
                "image_matches_raw", "parity_strictly_below",
                "parity_image_matches_oracle", "readmit_ok",
                "compressed_fewer_bytes", "shm_verified",
                "hash_kernel_exact")
FLEET_DISK_BYTES = 12e9
FLEET_RAM_BYTES = 32e9
# fig15 at the published width: 8 shards, one event (cut from 2: the flat
# store persists 2.3 GB compressed on one core, 110 s an event on the
# card's host), the memory backend only: its disk event (that persist,
# 107.7-134.4 s on the card's hosts) runs at --fast size with the fleets,
# so that the script, LM training included, stays inside its time limit
# on the card's slower hosts.  Every fleet of writer processes (pipe,
# socket, the crash and re-admission drills) takes minutes at that width
# on that host (the socket fleet 108 s for one event, the pipe fleet's
# image fetch alone more than 690 s; PERF.md section 6), so those kinds run
# at --fast size, with 2 shards, as fig16 (one transition of two, inproc
# and pipe) and fig17 (2 shards) do: each spawned writer or server takes
# seconds to start
FIG15_FULL = {"n_shards": (8,), "events": 1, "lost_shards": (8,),
              "kinds": ("save_event", "delta_save"), "backends": ("memory",)}
FIG15_FLEETS = {"n_shards": (2,), "lost_shards": (2,),
                "kinds": ("save_event", "pipe_snapshot_path",
                          "socket_save_event", "socket_wire_bytes",
                          "bytes_lost_at_crash", "readmission")}
FIG16_CUT = {"transitions": ((2, 4),)}
FIG17_CUT = {"n_shards": 2}
# phase 6's process fleets (fig15's at --fast size, fig16, fig17) are
# bound by their processes' start on the card's host: each runs in a
# process of its own (``chip_smoke.py --fleet-figure NAME OUT``) beside
# phases that print no time (fig16 and fig17 beside phase 4, fig15's
# beside 4m, 4h, 4v, 4x and 7 (b, c)), with the same rows, audits and probes
# as before.  name -> (label, harness module, arguments over its --fast
# ones, (pipe writers, socket servers) that must report)
BACKGROUND_FIGURES = {
    "fig15": ("fig15 --fast, 2 shards", "fig15_sharded_save", FIG15_FLEETS,
              (True, True)),
    "fig16": ("fig16 --fast, one transition", "fig16_reshard", FIG16_CUT,
              (True, False)),
    "fig17": (f"fig17 --fast, 2 shards, hash_kernel at {N_BIG:,} rows",
              "fig17_wire", dict(hash_rows=N_BIG, **FIG17_CUT),
              (False, True))}
BACKGROUND = Path(__file__).resolve().parent / "build" / "chip_smoke_bg"


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(rng, n_rows, shape):
    perm = rng.permutation(n_rows)
    ranks = np.minimum(rng.zipf(1.2, size=shape) - 1, n_rows - 1)
    return perm[ranks].astype(np.int32)


def run_ms(fn, n: int = 100) -> float:
    """CUDA-event ms per call over ``n`` calls back to back: the host
    enqueues while the card runs, so a call's host path shows only where
    it is longer than its device work (``time_ms`` times one call, its
    host path before the launch included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_pair_ms(fn_a, fn_b, reps: int = 101, warmup: int = 5):
    """``time_ms`` of two calls taken in turns (a, b, b, a, ...), so that
    host-bound calls meet the same host: the medians of each."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def device_events(fn, reps: int = 10, tries: int = 3):
    """The device-side events (kernels, copies, memsets) of ``reps`` calls
    of ``fn`` under ``torch.profiler``, from the first of up to ``tries``
    profiles that delivered any (a profile now and then delivers none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events
    return []


def device_ms(fn, kernel, reps: int = 10):
    """(the named kernel's, all kernels') device time per call of ``fn``
    under ``torch.profiler``, or (None, None) where the profiler saw no
    device time.  ``kernel``: a name, or a tuple of the names of one
    call's kernels."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    events = device_events(fn, reps)
    own = sum(e.device_time_total for e in events
              if any(n in e.key for n in names))
    every = sum(e.device_time_total for e in events)
    if not every:
        return None, None
    return own / reps / 1e3, every / reps / 1e3


def device_ms_by_kernel(fn, names, reps: int = 10):
    """Device ms per call of ``fn`` by kernel, for each kernel whose
    profiler name holds one of ``names`` (the longest matching name), or
    None where the profiler saw no device time."""
    events = device_events(fn, reps)
    if not events:
        return None
    out = {}
    for e in events:
        hits = [n for n in names if n in e.key]
        if hits:
            name = max(hits, key=len)
            out[name] = out.get(name, 0.0) + e.device_time_total / reps / 1e3
    return {n: round(out[n], 4) for n in names if n in out}


def kernels_per_call(fn, reps: int = 10):
    """Device operations (kernels, copies, memsets) per call of ``fn`` under
    ``torch.profiler``, or None where the profiler saw none."""
    n = sum(e.count for e in device_events(fn, reps))
    return n / reps if n else None


def ssu_update_without_sync(dev, buf, batch: int = B):
    """One ``ssu_update(..., backend="kernel")`` at full width (the largest
    table's reservoir; its column of a (batch, 26, 1) batch, strided as the
    emulator passes it, at period 2: batch / 2 candidates) under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in it fails
    the run."""
    from repro_torch.core import trackers as trk
    from repro_torch.kernels import LAUNCHES
    rng = np.random.default_rng(4)
    sparse = torch.from_numpy(zipf_ids(rng, N_BIG, (batch, 26, 1))).to(dev)
    ids = sparse[:, 0, :]
    state = {"buf": buf, "gen": torch.Generator(device=dev).manual_seed(5)}
    trk.ssu_update(dict(state), ids, 2, backend="kernel")        # warm
    torch.cuda.synchronize()
    before = LAUNCHES["ssu_dedupe_evict"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        new = trk.ssu_update(state, ids, 2, backend="kernel")
    except RuntimeError as e:
        fail(f"ssu_update(backend='kernel') synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = LAUNCHES["ssu_dedupe_evict"] - before
    n_kern = kernels_per_call(
        lambda: trk.ssu_update(dict(state), ids, 2, backend="kernel"))
    ok = bool((new["buf"][1:] >= new["buf"][:-1]).all())
    print(f"ssu_update(backend='kernel') at rn={buf.shape[0]}, ids "
          f"{tuple(ids.shape)}, period 2 ({ids.shape[0] // 2} candidates): "
          f"no host sync (sync debug mode "
          f"'error'); ssu_dedupe_evict launches={launched}; CUDA kernels "
          f"per update={n_kern} (profiler: the draw, the strided copy, the "
          f"kernel); output sorted={ok}")
    if launched != 1 or not ok:
        fail("ssu_update did not go through one ssu_dedupe_evict launch")


def print_embedding_times(name, kernel, library, kernel_name):
    """CUDA-event ms of the wrapper and the library call (in turns, the
    median of 101 each: both are host-bound), beside the kernel's own
    device ms from the profiler: the rest is host latency."""
    ms, lib_ms = time_pair_ms(kernel, library)
    own, every = device_ms(kernel, kernel_name)
    print(f"{name}: ms={ms:.4f} (CUDA events) kernel device ms="
          f"{'not measured' if own is None else f'{own:.4f}'} (profiler; "
          f"all the call's kernels "
          f"{'not measured' if every is None else f'{every:.4f}'}) "
          f"library_ms={lib_ms:.4f}")
    return ms, lib_ms


def embedding_launches():
    """A function giving the (forward, backward) embedding_bag launches
    since this call."""
    from repro_torch.kernels import LAUNCHES
    names = ("embedding_bag", "embedding_bag_backward")
    before = [LAUNCHES[n] for n in names]
    return lambda: tuple(LAUNCHES[n] - b for n, b in zip(names, before))


def phase_embedding_bags(dev, eb, ref, rng, gen):
    """The fused embedding kernels at the main path's shape: the 26
    unscaled Criteo-Kaggle tables (33,762,577 rows, d = 16, f32) and
    ``sparse`` (512, 26, 1) of Zipf ids, one launch each way.  Library
    yardstick: one ``F.embedding_bag`` (one ``embedding_dense_backward``)
    over a concatenated copy of the tables with offset ids, built outside
    the timed region and never used by the port."""
    import torch.nn.functional as F
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    sizes = DLRM_KAGGLE.table_sizes
    T, hot = len(sizes), 1
    tables = [torch.rand((n, D), generator=gen, device=dev) - 0.5
              for n in sizes]
    sparse = torch.from_numpy(np.stack(
        [zipf_ids(rng, n, (B, hot)) for n in sizes], axis=1)).to(dev)
    launches = embedding_launches()
    got = eb.forward(tables, sparse)
    if launches() != (1, 0):
        fail(f"embedding_bag over {T} tables took {launches()} launches")
    want = ref.embedding_bags(tables, sparse)
    err = (got - want).abs().max().item()
    ok = err <= 1e-6 * max(want.abs().max().item(), 1.0)
    print(f"embedding_bag {T} tables {tuple(sparse.shape)} f32: one launch, "
          f"max_abs_err={err:.3e} tol=1e-6 ok={ok}")
    if not ok:
        fail(f"embedding_bag over {T} tables disagrees with its plain version")
    grad_out = torch.randn((B, T, D), generator=gen, device=dev) * 1e-2
    launches = embedding_launches()
    got_g = eb.backward(grad_out, sparse, list(sizes))
    if launches() != (0, 1):
        fail(f"embedding_bag_backward over {T} tables took {launches()} "
             f"launches")
    want_g = ref.embedding_bags_backward(grad_out, sparse, sizes)
    err_g = max((a - b).abs().max().item() for a, b in zip(got_g, want_g))
    scale_g = max(b.abs().max().item() for b in want_g)
    ok = err_g <= 1e-5 * max(scale_g, 1.0)
    print(f"embedding_bag_backward {T} tables: one launch, "
          f"max_abs_err={err_g:.3e} tol=1e-5 (relative to the largest "
          f"gradient) ok={ok}")
    if not ok:
        fail(f"embedding_bag_backward over {T} tables disagrees with its "
             f"plain version")
    del got, want, got_g, want_g

    starts = np.cumsum((0,) + tuple(sizes[:-1]))
    cat = torch.cat(tables)                       # the library's copy
    flat = (sparse.long() + torch.as_tensor(starts, device=dev)[None, :, None]
            ).reshape(-1)
    offsets = torch.arange(0, B * T * hot, hot, device=dev)
    n_rows = sum(sizes)
    rows = {}
    ms, lib_ms = print_embedding_times(
        f"embedding_bag {T} tables", lambda: eb.forward(tables, sparse),
        lambda: F.embedding_bag(flat, cat, offsets, mode="sum"),
        "embedding_bags_fwd")
    t_b, by = bound(B * T * hot * (D * 4 + 4) + B * T * D * 4,
                    ops=B * T * hot * D)
    rows["embedding_bag"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ref.embedding_bags(tables, sparse)),
        bound_ms=t_b, bound_by=by, library_ms=lib_ms)
    ms, lib_ms = print_embedding_times(
        f"embedding_bag_backward {T} tables",
        lambda: eb.backward(grad_out, sparse, sizes),
        lambda: torch.ops.aten.embedding_dense_backward(
            grad_out.reshape(-1, D), flat, n_rows, -1, False),
        "embedding_bags_bwd")
    t_b, by = bound(B * T * (D * 4 + hot * 4) + n_rows * D * 4,
                    ops=B * T * hot * D)
    rows["embedding_bag_backward"] = dict(
        max_abs_err=err_g, ms=ms,
        plain_ms=time_ms(lambda: ref.embedding_bags_backward(
            grad_out, sparse, sizes)),
        bound_ms=t_b, bound_by=by, library_ms=lib_ms)
    del tables, cat
    torch.cuda.empty_cache()
    return rows


def phase_wide_contracts(dev, eb, ts, ref, rng, gen):
    """The kernels' widened contracts at full width, off the main path:
    ``tracker_select`` past a team's ``TEAM_SEG`` rows (the largest
    table's counters in segments of 65,536: a block a segment, selecting
    in device memory), ``embedding_bags`` over the 26 unscaled tables as
    rows of 3 f32 (12-byte rows: the element path) and over 130 tables
    (the 26, five times: groups of 64, three launches each way).  Each
    equals its plain version (``torch.equal``; the backward within 1e-5
    of the largest gradient, atomic adds) and is timed beside it and
    beside the library calls of ``phase_embedding_bags`` over a
    concatenated copy."""
    import torch.nn.functional as F
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    from repro_torch.kernels import LAUNCHES
    seg, k = 65_536, 64
    counts = torch.from_numpy(np.minimum(rng.zipf(1.2, N_BIG) - 1, 1000)
                              .astype(np.int32)).to(dev)
    pend_np = zipf_ids(rng, N_BIG, (2048,))
    pend_np[:64] = -5                       # out of range: match nothing
    pend = torch.from_numpy(pend_np).to(dev)
    got, want = (f(counts, pend, k, seg_size=seg) for f in
                 (ts.tracker_select, ref.tracker_select))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    t_b, _ = bound(N_BIG * 4 * 2 + -(-N_BIG // seg) * k * 4)
    print(f"tracker_select wide path (seg {seg} > TEAM_SEG {ts.TEAM_SEG}, "
          f"{-(-N_BIG // seg)} segments, k={k}, 2048 pending): "
          f"torch.equal={equal} ms="
          f"{time_ms(lambda: ts.tracker_select(counts, pend, k, seg_size=seg)):.4f}"
          f" plain_ms="
          f"{time_ms(lambda: ref.tracker_select(counts, pend, k, seg_size=seg)):.4f}"
          f" bound_ms={t_b:.5f}")
    if not equal:
        fail("tracker_select's wide path disagrees with its plain version")
    del counts, got, want

    sizes = DLRM_KAGGLE.table_sizes
    sparse = torch.from_numpy(np.stack(
        [zipf_ids(rng, n, (B, 1)) for n in sizes], axis=1)).to(dev)
    for name, d, times in (("26 tables, 12-byte rows (element path)", 3, 1),
                           ("130 tables (3 groups)", D, 5)):
        tables = [torch.rand((n, d), generator=gen, device=dev) - 0.5
                  for n in sizes] * times
        sp = sparse.repeat(1, times, 1).contiguous()
        T = len(tables)
        before = (LAUNCHES["embedding_bag"], LAUNCHES["embedding_bag_backward"])
        out = eb.forward(tables, sp)
        grad_out = torch.randn((B, T, d), generator=gen, device=dev) * 1e-2
        grads = eb.backward(grad_out, sp, [t.shape[0] for t in tables])
        launched = (LAUNCHES["embedding_bag"] - before[0],
                    LAUNCHES["embedding_bag_backward"] - before[1])
        equal = torch.equal(out, ref.embedding_bags(tables, sp))
        want = ref.embedding_bags_backward(grad_out, sp,
                                           [t.shape[0] for t in tables])
        err = max((a - b).abs().max().item() for a, b in zip(grads, want))
        scale = max(b.abs().max().item() for b in want)
        ok = equal and err <= 1e-5 * max(scale, 1.0)
        rows = [t.shape[0] for t in tables]
        t_f, _ = bound(B * T * (d * 4 + 4) + B * T * d * 4, ops=B * T * d)
        t_g, _ = bound(B * T * (d * 4 + 4) + sum(rows) * d * 4,
                       ops=B * T * d)
        print(f"embedding_bags {name}, d={d}, sparse {tuple(sp.shape)}: "
              f"bound_ms={t_f:.5f} backward bound_ms={t_g:.5f} (bytes); "
              f"launches (forward, backward)={launched} forward "
              f"torch.equal={equal} backward max_abs_err={err:.3e} "
              f"(tol 1e-5 of the largest gradient) ms="
              f"{time_ms(lambda: eb.forward(tables, sp)):.4f} plain_ms="
              f"{time_ms(lambda: ref.embedding_bags(tables, sp)):.4f} "
              f"backward ms="
              f"{time_ms(lambda: eb.backward(grad_out, sp, rows)):.4f} "
              f"plain_ms="
              f"{time_ms(lambda: ref.embedding_bags_backward(grad_out, sp, rows)):.4f}")
        if not ok or launched != (-(-T // eb.GROUP),) * 2:
            fail(f"embedding_bags over {name} disagrees with its plain "
                 f"version or took {launched} launches")
        del out, grads, want
        # the library yardstick, as phase_embedding_bags: one call over a
        # concatenated copy, built outside the timed region
        starts = np.cumsum([0] + rows[:-1])
        cat = torch.cat(tables)
        flat = (sp.long() + torch.as_tensor(starts, device=dev)[None, :, None]
                ).reshape(-1)
        offsets = torch.arange(0, B * T, 1, device=dev)
        lib_f = time_ms(lambda: F.embedding_bag(flat, cat, offsets,
                                                mode="sum"))
        lib_b = time_ms(lambda: torch.ops.aten.embedding_dense_backward(
            grad_out.reshape(-1, d), flat, sum(rows), -1, False))
        print(f"embedding_bags {name}: library_ms={lib_f:.4f} "
              f"(F.embedding_bag, concatenated) backward library_ms="
              f"{lib_b:.4f} (aten.embedding_dense_backward)")
        del tables, cat, flat
        torch.cuda.empty_cache()


def phase_kernels(dev, eb, ts, sd, ref):
    """Each kernel vs its plain version at the path's shapes."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # ---- embedding_bag, one table (T = 1, the largest): forward (f32,
    # bf16; hot 1 and 3) and backward, against the plain version ----
    table = torch.rand((N_BIG, D), generator=gen, device=dev) - 0.5
    for hot in (1, 3):
        idx = torch.from_numpy(zipf_ids(rng, N_BIG, (B, hot))).to(dev)
        sp = idx[:, None]
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            tab = table.to(dtype)
            got = eb.forward([tab], sp)[:, 0].float()
            want = ref.embedding_bag(tab, idx).float()
            err = (got - want).abs().max().item()
            ok = err <= tol * max(want.abs().max().item(), 1.0)
            print(f"embedding_bag one table hot={hot} {str(dtype)[6:]}: "
                  f"max_abs_err={err:.3e} tol={tol:g} ok={ok}")
            if not ok:
                fail("embedding_bag disagrees with its plain version")
            if hot == 1 and dtype == torch.float32:
                flat = idx.reshape(-1).long()
                offsets = torch.arange(0, B * hot, hot, device=dev)
                print_embedding_times(
                    "embedding_bag one table hot=1 f32",
                    lambda: eb.forward([tab], sp),
                    lambda: F.embedding_bag(flat, tab, offsets, mode="sum"),
                    "embedding_bags_fwd")
        grad_out = (torch.randn((B, 1, D), generator=gen, device=dev) * 1e-2)
        got = eb.backward(grad_out, sp, [N_BIG])[0]
        want = ref.embedding_bag_backward(grad_out[:, 0], idx, N_BIG)
        err = (got - want).abs().max().item()
        # atomic adds land in run-dependent order on repeated (Zipf) ids:
        # f32 rounding of sums of up to B*hot terms
        ok = err <= 1e-5 * max(want.abs().max().item(), 1.0)
        print(f"embedding_bag_backward one table hot={hot}: "
              f"max_abs_err={err:.3e} tol=1e-5 (relative to the largest "
              f"gradient) ok={ok}")
        if not ok:
            fail("embedding_bag backward disagrees with its plain version")
        if hot == 1:
            flat = idx.reshape(-1).long()
            print_embedding_times(
                "embedding_bag_backward one table hot=1",
                lambda: eb.backward(grad_out, sp, [N_BIG]),
                lambda: torch.ops.aten.embedding_dense_backward(
                    grad_out[:, 0], flat, N_BIG, -1, False),
                "embedding_bags_bwd")
    del table, tab
    torch.cuda.empty_cache()
    rows.update(phase_embedding_bags(dev, eb, ref, rng, gen))

    # ---- tracker_select: Zipf-skewed counters (massive ties), seg 512, k 64
    counts = torch.from_numpy(np.minimum(rng.zipf(1.2, N_BIG) - 1, 1000)
                              .astype(np.int32)).to(dev)
    pend_np = zipf_ids(rng, N_BIG, (2048,))
    pend_np[:64] = -5                       # out of range: match nothing
    pend_np[64:128] = N_BIG + 7
    cases = {"no pending": torch.zeros(0, dtype=torch.int32, device=dev),
             "2048 pending": torch.from_numpy(pend_np).to(dev)}
    seg, k = 512, 64
    err = 0
    for name, pend in cases.items():
        ids, nc = ts.tracker_select(counts, pend, k, seg_size=seg)
        rids, rnc = ref.tracker_select(counts, pend, k, seg_size=seg)
        if ids.shape != rids.shape or nc.shape != rnc.shape:
            fail("tracker_select output shapes differ from its plain version")
        diff = max(int((ids.long() - rids.long()).abs().max()),
                   int((nc.long() - rnc.long()).abs().max()))
        err = max(err, diff)
        print(f"tracker_select {name}: max_abs_err={diff} (ids and counts)")
        if diff:
            fail("tracker_select disagrees with its plain version")
    pend = cases["no pending"]            # the emulator's call: counts folded
    n_seg = -(-N_BIG // seg)
    t_b, by = bound(N_BIG * 4 * 2 + n_seg * k * 4)
    rows["tracker_select"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ts.tracker_select(counts, pend, k, seg_size=seg)),
        plain_ms=time_ms(lambda: ref.tracker_select(counts, pend, k,
                                                    seg_size=seg)),
        bound_ms=t_b, bound_by=by, library_ms=None)
    # a yardstick, not the same function (so library_ms stays None):
    # torch.topk over the padded (n_seg, seg) view picks k per segment but
    # promises no tie order and clears nothing
    view = torch.full((n_seg * seg,), -1, dtype=torch.int32, device=dev)
    view[:N_BIG] = counts
    view = view.view(n_seg, seg)
    topk_ms = time_ms(lambda: torch.topk(view, k, dim=1))
    print(f"tracker_select yardstick: torch.topk over the ({n_seg}, {seg}) "
          f"view ms={topk_ms:.4f} (selection only: no tie order, no "
          f"clearing)")

    def select():
        return ts.tracker_select(counts, pend, k, seg_size=seg)

    own, _ = device_ms(select, "tracker_select_kernel")
    print(f"tracker_select ({n_seg}, {seg}) k={k}: ms="
          f"{rows['tracker_select']['ms']:.4f} (CUDA events, one call) "
          f"run_ms={run_ms(select):.4f} (100 calls back to back) kernel "
          f"device ms={'not measured' if own is None else f'{own:.4f}'} "
          f"(profiler) bound_ms={t_b:.5f}; CUDA kernels per call="
          f"{kernels_per_call(select)} (profiler)")
    del counts, view

    # ---- ssu_dedupe_evict: rn = 0.125 * N, nc = 256 ----
    rn, nc = int(0.125 * N_BIG), 256
    EMPTY = ref.EMPTY

    def reservoir(live):
        buf = np.full(rn, EMPTY, np.int32)
        buf[:live] = np.sort(rng.choice(N_BIG, size=live, replace=False))
        return buf

    def candidates(buf, live):
        """Raw, as ``ssu_update`` passes them: Zipf ids in draw order,
        repeats and all, a quarter of them already in the reservoir."""
        c = zipf_ids(rng, N_BIG, (nc,))
        c[: nc // 4] = rng.choice(buf[:live], size=nc // 4)  # already present
        return c

    # The bytes each case needs.  Without overflow the answer is the merge
    # of the lb live reservoir ids with the live candidates, EMPTY-padded:
    # lb*4 + nc*4 read, rn*4 written; the scores are never read.  With
    # overflow the live slots' scores ((lb+lc)*4) are read as well.
    timed, err = {}, 0
    for name, live, tied in (("half full", rn // 2, False),
                             ("full (overflow)", rn, False),
                             ("full (overflow, tied scores)", rn, True)):
        buf_np = reservoir(live)
        cand_np = candidates(buf_np, live)
        lc = np.setdiff1d(cand_np, buf_np).size      # live, deduped
        overflow = live + lc > rn
        nbytes = live * 4 + nc * 4 + rn * 4 + (live + lc) * 4 * overflow
        buf = torch.from_numpy(buf_np).to(dev)
        cand = torch.from_numpy(cand_np).to(dev)
        scores = torch.rand(rn + nc, generator=gen, device=dev)
        if tied:
            scores = torch.floor(scores * 64) / 64
        got = sd.ssu_dedupe_evict(buf, cand, scores)
        want = ref.ssu_dedupe_evict(buf, cand, scores)
        diff = int((got.long() - want.long()).abs().max())
        err = max(err, diff)
        print(f"ssu_dedupe_evict {name}: live={live + lc} rn={rn} "
              f"overflow={overflow} max_abs_err={diff} "
              f"(differing slots: {int((got != want).sum())})")
        if diff:
            fail("ssu_dedupe_evict disagrees with its plain version")
        timed.setdefault(overflow, (buf, cand, scores, nbytes))
    for overflow, (buf, cand, scores, nbytes) in sorted(timed.items()):
        t_b, by = bound(nbytes)
        row = dict(
            max_abs_err=err,
            ms=time_ms(lambda: sd.ssu_dedupe_evict(buf, cand, scores)),
            plain_ms=time_ms(lambda: ref.ssu_dedupe_evict(buf, cand, scores)),
            bound_ms=t_b, bound_by=by, library_ms=None)
        def update():
            return sd.ssu_dedupe_evict(buf, cand, scores)

        n_kern = kernels_per_call(update)
        own, _ = device_ms(update, "ssu_kernel")
        print(f"ssu_dedupe_evict timed, overflow={overflow}: {nbytes} bytes "
              f"needed; ms={row['ms']:.4f} (CUDA events, one call) run_ms="
              f"{run_ms(update):.4f} (100 calls back to back) kernel device "
              f"ms={'not measured' if own is None else f'{own:.4f}'} "
              f"(profiler) plain_ms={row['plain_ms']:.4f} bound_ms="
              f"{t_b:.5f}; CUDA kernels per call={n_kern} (profiler)")
        if n_kern is None:
            fail("the profiler saw no device work in ssu_dedupe_evict")
        if not overflow:                    # the path's steady state
            if n_kern > 2:
                fail(f"ssu_dedupe_evict issued {n_kern} CUDA kernels in the "
                     f"steady state (at most 2)")
            rows["ssu_dedupe_evict"] = row
    # past one tile (TILE = 8,192 candidates), as LM training (8 x 4,096
    # tokens at period 2) or a DLRM batch above 16,384 samples sends them:
    # sorted a tile at a time and ranked across tiles in the same launch
    for n_cand in (2 * sd.TILE, 8 * sd.TILE):
        for name, live in (("half full", rn // 2), ("full (overflow)", rn)):
            buf_np = reservoir(live)
            cand_np = zipf_ids(rng, N_BIG, (n_cand,))
            cand_np[: n_cand // 4] = rng.choice(buf_np[:live], size=n_cand // 4)
            lc = np.setdiff1d(cand_np, buf_np).size
            overflow = live + lc > rn
            nbytes = (live * 4 + n_cand * 4 + rn * 4 +
                      (live + lc) * 4 * overflow)
            buf = torch.from_numpy(buf_np).to(dev)
            cand = torch.from_numpy(cand_np).to(dev)
            scores = torch.rand(rn + n_cand, generator=gen, device=dev)

            def update():
                return sd.ssu_dedupe_evict(buf, cand, scores)

            got = update()
            want = ref.ssu_dedupe_evict(buf, cand, scores)
            equal = torch.equal(got, want)
            t_b, _ = bound(nbytes)
            ms = time_ms(update)
            plain_ms = time_ms(lambda: ref.ssu_dedupe_evict(buf, cand, scores))
            print(f"ssu_dedupe_evict nc={n_cand} ({-(-n_cand // sd.TILE)} "
                  f"tiles) {name}: live={live + lc} rn={rn} "
                  f"overflow={overflow} torch.equal={equal} (differing "
                  f"slots: {int((got != want).sum())}); {nbytes} bytes "
                  f"needed; ms={ms:.4f} (CUDA events, one call) "
                  f"plain_ms={plain_ms:.4f} bound_ms={t_b:.5f}; CUDA kernels "
                  f"per call={kernels_per_call(update)} (profiler)")
            if not equal:
                fail(f"ssu_dedupe_evict with {n_cand} candidates disagrees "
                     f"with its plain version")
    ssu_update_without_sync(dev, timed[False][0])
    ssu_update_without_sync(dev, timed[False][0], batch=4 * sd.TILE)
    del timed, buf, cand, scores
    torch.cuda.empty_cache()
    phase_wide_contracts(dev, eb, ts, ref, np.random.default_rng(5),
                         torch.Generator(device=dev).manual_seed(5))
    for name, r in rows.items():
        print(f"{name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}")
    return rows


def phase_row_hash(dev, rh, ref):
    """``row_hash`` vs its plain version, bit for bit, at the path's
    shapes; timed on the largest table with its f32 accumulator."""
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.rand((N_BIG, D), generator=gen, device=dev) - 0.5
    acc = torch.rand(N_BIG, generator=gen, device=dev)
    cases = {
        "largest table f32": (table, acc),
        "largest table bf16": (table.to(torch.bfloat16), acc),
        "ragged d=9 f32": (torch.rand((N_RAGGED, 9), generator=gen,
                                      device=dev), acc[:N_RAGGED]),
        "no rows": (table[:0], acc[:0]),
        "zero-byte rows": (table[:1000, :0], acc[:1000, None][:, :0]),
    }
    worst = 0
    for name, (values, accs) in cases.items():
        got = rh.row_hash(values, accs)
        want = ref.row_hash(values, accs)
        if got.shape != want.shape or got.dtype != torch.int64:
            fail(f"row_hash {name}: shape/dtype differ from the plain version")
        differing = int((got != want).sum())
        if differing:
            # |a - b| of the uint64 bits, exact in Python integers
            a = got.cpu().numpy().view(np.uint64).astype(object)
            b = want.cpu().numpy().view(np.uint64).astype(object)
            worst = max(worst, max(abs(int(x) - int(y))
                                   for x, y in zip(a, b)))
        print(f"row_hash {name}: rows={values.shape[0]} "
              f"row_bytes={rh.row_bytes(values)}+{rh.row_bytes(accs)} "
              f"differing_words={differing}")
        if differing:
            fail("row_hash disagrees with its plain version")
    del cases
    row_bytes = rh.row_bytes(table) + rh.row_bytes(acc)
    t_b, by = bound(N_BIG * (row_bytes + 8))
    row = dict(max_abs_err=worst,
               ms=time_ms(lambda: rh.row_hash(table, acc)),
               plain_ms=time_ms(lambda: ref.row_hash(table, acc)),
               bound_ms=t_b, bound_by=by, library_ms=None)
    bf = table.to(torch.bfloat16)
    bf_ms = time_ms(lambda: rh.row_hash(bf, acc))
    t_bf, _ = bound(N_BIG * (rh.row_bytes(bf) + 4 + 8))
    print(f"row_hash: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"bound_ms={t_b:.5f} ({by}); bf16 copy ms={bf_ms:.4f} "
          f"bound_ms={t_bf:.5f}")
    return row


def phase_main_path(dev, kernels, cfg, num_samples=40_000):
    """Full-width Criteo-Kaggle emulation in three modes, on the flat
    store and then on the sharded writer fleet."""
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  ShardedCheckpointWriter, SystemParams)
    from repro_torch.data.synthetic import ClickLogDataset
    t0 = time.perf_counter()
    ds = ClickLogDataset(cfg.table_sizes, num_samples=num_samples, seed=3)
    print(f"dataset: {cfg.name}, {cfg.total_emb_rows():,} rows, "
          f"{len(ds):,} samples ({time.perf_counter() - t0:.1f} s)")
    drives = {"full": {"embedding_bag", "embedding_bag_backward"},
              "cpr-mfu": {"embedding_bag", "embedding_bag_backward",
                          "tracker_select"},
              "cpr-ssu": {"embedding_bag", "embedding_bag_backward",
                          "ssu_dedupe_evict"}}
    (_, _), (ev0, ev1) = ds.eval_split(0.1)       # Emulator's eval_frac
    n_eval = sum(1 for _ in ds.batches(4096, ev0, ev1))
    totals = {name: 0 for name in kernels.LAUNCHES}
    for store, fleet, steps in (("flat", {}, STEPS_FLAT),
                                ("fleet", FLEET, STEPS_FLEET)):
        for mode, must in drives.items():
            must = must | ({"row_hash"} if fleet else set())
            p = SystemParams()
            mgr = CPRManager(mode, p, cfg.table_sizes, target_pls=0.1,
                             tracker_backend="kernel", device=dev, **fleet)
            inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
            emu = Emulator(cfg, ds, mgr, inj, batch_size=B, device=dev)
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = emu.run(max_steps=steps)
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            for name, n in counts.items():
                totals[name] += n
            rep = res.report
            steady = statistics.median(emu.step_seconds[5:]) * 1e3
            print(f"[{store}] {res.summary()}")
            print(f"  {store} {mode}: steps={res.n_steps} "
                  f"steady_ms_per_step={steady:.3f} wall_s={wall:.1f} "
                  f"final_loss={res.final_loss:.5f} "
                  f"bytes_written={rep['bytes_written']} "
                  f"save_blocked_s={rep['overheads']['save_blocked_s']:.3f} "
                  f"delta_rows_skipped={rep.get('delta_rows_skipped')} "
                  f"delta_bytes_skipped={rep.get('delta_bytes_skipped')} "
                  f"launches={json.dumps(counts)}")
            missing = [n for n in must if counts[n] == 0]
            if missing:
                fail(f"{store} {mode}: kernels {missing} were never launched")
            # one fused launch each way per train step, one forward per
            # evaluation batch
            per_step = ((counts["embedding_bag"] - n_eval) / res.n_steps,
                        counts["embedding_bag_backward"] / res.n_steps)
            print(f"  {store} {mode}: embedding_bag launches per train step "
                  f"(forward, backward) = {per_step}, plus {n_eval} for "
                  f"evaluation")
            if per_step != (1, 1):
                fail(f"{store} {mode}: embedding_bag launched {per_step} "
                     f"times per train step, not once each way")
            if not math.isfinite(res.final_loss) or not math.isfinite(res.auc):
                fail(f"{store} {mode}: loss or AUC is not finite")
            if fleet and not (rep["sharded_save"] and
                              isinstance(mgr.store, ShardedCheckpointWriter)
                              and rep["hash_backend"] == "kernel"):
                fail(f"fleet {mode}: the run did not go through the fleet")
            if mode != "full":
                restores = [h for h in mgr.history if h["event"] == "failure"]
                if mgr.effective_mode != mode or not restores:
                    fail(f"{store} {mode}: no partial-recovery restore "
                         f"happened")
            del emu, mgr
            torch.cuda.empty_cache()
    return totals


def _pipe_writer_probe(*args):
    """Pipe writer entry point for this run: the transport's own, then a
    report, from inside the writer process, of whether it ever created a
    CUDA context."""
    from repro_torch.core import transport
    try:
        transport._pipe_worker_main(*args)
    finally:
        probe = Path(os.environ[PROBE_ENV]) / f"writer-{os.getpid()}.txt"
        probe.write_text(str(torch.cuda.is_initialized()))


def phase_agreement(dev):
    """The scaled config on the card vs on the CPU, same parameters, on the
    flat store and through the fleet over pipe and socket; then a disk
    round trip of the fleet and the writer processes' CUDA state."""
    from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  SystemParams, load_latest_auto, transport)
    from repro_torch.data.synthetic import ClickLogDataset
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    cfg = scaled(DLRM_KAGGLE, 2000)
    # 20 steps of 256 (cut from 8,000 samples with the MoE serving phases'
    # arrival: the time limit)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=5120, seed=3)
    init = params_to_numpy(init_dlrm(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    (SCRATCH / "probe").mkdir(parents=True)
    os.environ[PROBE_ENV] = str(SCRATCH / "probe")
    transport._pipe_worker_main = _pipe_writer_probe

    def run(device, **kw):
        p = SystemParams(N_emb=AGREE_SHARDS)
        mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                         tracker_backend="kernel", device=device, **kw)
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        res = Emulator(cfg, ds, mgr, inj, batch_size=256, device=device,
                       init_params=init).run()
        return res, mgr

    fleet = {"sharded_save": True, "delta_saves": True}
    for name, kw in (("flat", {}),
                     ("fleet pipe", dict(fleet, transport="pipe")),
                     ("fleet socket", dict(fleet, transport="socket"))):
        t0 = time.perf_counter()
        card, _ = run(dev, **kw, **({"hash_backend": "kernel"} if kw else {}))
        cpu, _ = run("cpu", **kw)            # host ledger on the CPU
        a, b = card.report, cpu.report
        same = all(a["overheads"][k] == b["overheads"][k]
                   for k in ("save", "load", "lost", "resched"))
        for k in ("measured_pls", "bytes_written", "delta_rows_skipped",
                  "delta_bytes_skipped", "dropped_bytes"):
            same &= a.get(k) == b.get(k)
        gap = abs(card.auc - cpu.auc)
        print(f"agreement (scaled, cpr-mfu, {name}): card auc={card.auc:.6f} "
              f"cpu auc={cpu.auc:.6f} gap={gap:.2e} "
              f"bytes_written={a['bytes_written']} "
              f"delta_rows_skipped={a.get('delta_rows_skipped')} "
              f"charges/pls/bytes/deltas identical={same} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not same or gap > 5e-3:
            fail(f"{name}: the card's run disagrees with the CPU path")

    # the fleet's writer on the card (pinned save_full snapshots, device
    # delta skip, in-place restore) against the same writer on the CPU
    from repro_torch.core import EmbShardSpec, ShardedCheckpointWriter
    spec = EmbShardSpec(cfg.table_sizes, 8)
    rng = np.random.default_rng(7)
    tabs = [np.asarray(t) for t in init["tables"]]
    accs = [rng.random(len(t)).astype(np.float32) for t in tabs]
    views = {}
    for device, hb in ((dev, "kernel"), ("cpu", "host")):
        t = [torch.tensor(x, device=device) for x in tabs]
        a = [torch.tensor(x, device=device) for x in accs]
        w = ShardedCheckpointWriter(t, a, spec, hash_backend=hb)
        w.save_full([x + 1 for x in t], [x + 1 for x in a], step=1)
        big = max(range(len(t)), key=lambda i: len(t[i]))
        rows = torch.arange(0, len(t[big]), 3, device=device)
        vals = t[big][rows] + 1                     # equal to the full: skip
        vals[::2] += 1                              # half of them changed
        w.save_rows(big, rows, vals, a[big][rows] + 1, step=2)
        w.fence()
        w.restore_shards(t, a, [1, 5])
        views[str(device)] = ([x.cpu().numpy() for x in t + a],
                              w.restore_all()[:2], w.bytes_written,
                              w.delta_rows_skipped, w.delta_bytes_skipped)
        w.close()
    card, cpu = views[str(dev)], views["cpu"]
    same = (card[2:] == cpu[2:] and
            all(x.tobytes() == y.tobytes() for x, y in zip(card[0], cpu[0]))
            and all(x.tobytes() == y.tobytes() for x, y in
                    zip(card[1][0] + card[1][1], cpu[1][0] + cpu[1][1])))
    print(f"fleet writer (scaled, inproc): card vs CPU images, restores, "
          f"bytes_written={card[2]} delta_rows_skipped={card[3]} "
          f"identical={same}")
    if not same:
        fail("the fleet's writer on the card disagrees with the CPU's")

    # a disk directory through pipe: the reload equals the writers' image
    # at their final fence, byte for byte
    root = str(SCRATCH / "ckpt")
    p = SystemParams(N_emb=AGREE_SHARDS)
    mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                     tracker_backend="kernel", device=dev, directory=root,
                     transport="pipe", hash_backend="kernel", **fleet)
    fenced = {}
    close = mgr.close

    def close_keeping_the_fenced_image():
        mgr.fence()
        fenced["image"] = mgr.store.restore_all()
        close()

    mgr.close = close_keeping_the_fenced_image
    Emulator(cfg, ds, mgr, FailureInjector(2, 0.25, p.N_emb, p.T_total,
                                           seed=11),
             batch_size=256, device=dev, init_params=init).run()
    base_t = [np.asarray(t) for t in init["tables"]]
    base_a = [np.zeros(len(t), np.float32) for t in base_t]
    got_t, got_a, _ = load_latest_auto(root, base_t, base_a,
                                       mgr.spec).restore_all()
    want_t, want_a, _ = fenced["image"]
    same = all(x.tobytes() == y.tobytes() for x, y in
               zip(got_t + got_a, want_t + want_a))
    print(f"disk round trip (scaled, cpr-mfu, pipe, {mgr.store.cycle} "
          f"stamped cycles): reload equals the fenced image byte for "
          f"byte={same}")
    if not same:
        fail("load_latest_auto disagrees with the writers' fenced image")
    probes = sorted((SCRATCH / "probe").glob("writer-*.txt"))
    states = [f.read_text() for f in probes]
    print(f"pipe writer processes: {len(states)} reported; CUDA context "
          f"created in {states.count('True')}")
    if len(states) < 2 * p.N_emb or any(x != "False" for x in states):
        fail("a pipe writer process created a CUDA context (or did not "
             "report)")
    shutil.rmtree(SCRATCH, ignore_errors=True)


def _server_probe(*args):
    """Socket server entry point for this run: the shard server's own,
    beside a thread that reports, from inside the server process, whether
    it ever created a CUDA context.  A server serves until it is killed,
    so the report is rewritten while it serves."""
    from repro_torch.launch import shard_server
    probe = Path(os.environ[PROBE_ENV]) / f"server-{os.getpid()}.txt"

    def report():
        tmp = probe.with_suffix(".tmp")
        while True:                     # replaced whole: never read torn
            tmp.write_text(str(torch.cuda.is_initialized()))
            os.replace(tmp, probe)
            time.sleep(0.05)

    threading.Thread(target=report, daemon=True).start()
    shard_server.spawned_server_main(*args)


def available_ram() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_fleet_figures(dev, kernels, cfg):
    """The port's fleet figures on the card (phase 6)."""
    import tempfile

    from benchmarks_torch import common
    from benchmarks_torch import fig15_sharded_save as fig15
    label = common.device_label(dev)
    tmp = tempfile.gettempdir()
    free, ram = shutil.disk_usage(tmp).free, available_ram()
    print(f"fleet figures: {free / 1e9:.1f} GB free under {tmp}, "
          f"{ram / 1e9:.1f} GB of host memory available")
    if free < FLEET_DISK_BYTES or ram < FLEET_RAM_BYTES:
        fail(f"the fleet figures need {FLEET_DISK_BYTES / 1e9:.0f} GB of "
             f"disk under {tmp} and {FLEET_RAM_BYTES / 1e9:.0f} GB of host "
             f"memory")
    # fig15 at full width (memory, its writers threads); the process
    # fleets run in processes of their own (BACKGROUND_FIGURES)
    name = f"fig15 (full width, {cfg.total_emb_rows():,} rows)"
    kw = dict(FIG15_FULL, max_rows=max(cfg.table_sizes))  # nothing scaled
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = fig15.run(device=dev, **kw)
    for row in rows:
        print(f"{name} {json.dumps({**row, 'device': label})}")
    launches = dict(kernels.LAUNCHES)
    print(f"{name}: launches {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f} s)")
    # the same delta saves on the CPU (the plain hash), from the same
    # numpy draw: equal rows
    t0 = time.perf_counter()
    card = [r for r in rows if r["kind"] == "delta_save"]
    cpu = fig15.run(**dict(kw, kinds=("delta_save",)), device="cpu")
    print(f"{name} delta_save on the CPU {json.dumps(cpu)} equal to the "
          f"card's={card == cpu} ({time.perf_counter() - t0:.1f} s)")
    if card != cpu:
        fail("fig15's full-width delta saves differ between the card and "
             "the CPU")
    common.clear_fleet_state()
    check_fleet_rows(name, rows)
    if launches["row_hash"] == 0:
        fail("the fleet figures never launched row_hash")
    return launches["row_hash"]


def check_fleet_rows(name, rows):
    """Every audit field of a fleet figure's rows true, and an unchanged
    re-save 0 bytes."""
    for row in rows:
        bad = [k for k in FLEET_AUDITS if k in row and row[k] is not True]
        if bad:
            fail(f"{name} {row['kind']}: audit {bad} false on the card")
        if row.get("unchanged_resave_bytes", 0) != 0:
            fail(f"{name}: an unchanged re-save shipped "
                 f"{row['unchanged_resave_bytes']} bytes")


def check_probes(name, states, writers=False, servers=False):
    """The pipe writer and socket server processes' own reports (file name
    -> whether they created a CUDA context): none did, and the kinds
    asked for reported."""
    n_writers = sum(n.startswith("writer-") for n in states)
    n_servers = sum(n.startswith("server-") for n in states)
    cuda = sorted(f"{n}: {v!r}" for n, v in states.items() if v != "False")
    alive = [n for n in states
             if os.path.exists(f"/proc/{n[:-4].split('-')[1]}")]
    print(f"{name}: {n_writers} pipe writer and {n_servers} socket server "
          f"processes reported ({len(alive)} still running); a CUDA context "
          f"in {len(cuda)}")
    if (writers and not n_writers) or (servers and not n_servers) or \
            not states or cuda:
        fail(f"{name}: a fleet process created a CUDA context (or none "
             f"reported): {cuda}")


def fleet_figure_main(name: str, out: str) -> None:
    """``chip_smoke.py --fleet-figure NAME OUT``: one of BACKGROUND_FIGURES
    on the card in this process, its pipe writers and socket servers
    probed as in phase 6; writes its rows, launch counts, probe reports
    and seconds to the JSON file OUT."""
    import importlib
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from benchmarks_torch import common
    from benchmarks_torch import run as harness
    from repro_torch import kernels
    from repro_torch.core import transport
    from repro_torch.launch import shard_server
    _, module, kw, _ = BACKGROUND_FIGURES[name]
    mod = importlib.import_module(f"benchmarks_torch.{module}")
    probes = BACKGROUND / f"probe-{name}"
    shutil.rmtree(probes, ignore_errors=True)
    probes.mkdir(parents=True)
    os.environ[PROBE_ENV] = str(probes)
    transport._pipe_worker_main = _pipe_writer_probe
    shard_server.spawned_server_main = _server_probe
    dev = torch.device("cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = mod.run(device=dev, **dict(harness.FAST_OVERRIDES[name], **kw))
    common.clear_fleet_state()
    Path(out).write_text(json.dumps({
        "rows": rows, "launches": dict(kernels.LAUNCHES),
        "probes": {f.name: f.read_text() for f in probes.glob("*.txt")},
        "seconds": time.perf_counter() - t0,
        "device": common.device_label(dev)}))
    shutil.rmtree(probes, ignore_errors=True)


_BACKGROUND_PROCS = []


def _stop(proc):
    """Ends a background figure process and whatever it started and left
    running (its own process group)."""
    import signal
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _stop_background():
    for proc in _BACKGROUND_PROCS:
        _stop(proc)


def start_fleet_figure(name: str):
    """Starts one of BACKGROUND_FIGURES in a process of its own (a
    session of its own, so that nothing it starts outlives the script)."""
    import atexit
    BACKGROUND.mkdir(parents=True, exist_ok=True)
    out, log = BACKGROUND / f"{name}.json", BACKGROUND / f"{name}.log"
    out.unlink(missing_ok=True)
    if not _BACKGROUND_PROCS:
        atexit.register(_stop_background)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--fleet-figure",
             name, str(out)], stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
    _BACKGROUND_PROCS.append(proc)
    print(f"{BACKGROUND_FIGURES[name][0]}: started in a process of its own")
    return name, proc, out, log, time.perf_counter()


def finish_fleet_figure(handle, timeout: float = 900.0) -> int:
    """Waits for a background figure, prints its rows and launches, checks
    its audits and probes as phase 6 does; returns its row_hash
    launches."""
    name, proc, out, log, t0 = handle
    label = BACKGROUND_FIGURES[name][0]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    _stop(proc)              # and whatever of its group is left
    waited = time.perf_counter() - t0
    if proc.returncode or not out.exists():
        fail(f"{label} failed in its process (exit {proc.returncode}): "
             f"{log.read_text()[-3000:]}")
    res = json.loads(out.read_text())
    for row in res["rows"]:
        print(f"{label} {json.dumps({**row, 'device': res['device']})}")
    print(f"{label}: launches {json.dumps(res['launches'])} "
          f"({res['seconds']:.1f} s in its own process; joined "
          f"{waited:.1f} s after its start)")
    check_fleet_rows(label, res["rows"])
    writers, servers = BACKGROUND_FIGURES[name][3]
    check_probes(label, res["probes"], writers, servers)
    return res["launches"]["row_hash"]


def launches_since(kernels, before):
    return {n: kernels.LAUNCHES[n] - before[n] for n in kernels.LAUNCHES}


def phase_harness(dev, kernels, cfg):
    """The port's benchmark harness on the card (phase 5)."""
    from benchmarks_torch import common
    from benchmarks_torch import fig7_overhead as fig7
    from benchmarks_torch import fig14_async_save as fig14
    from benchmarks_torch import run as harness
    from benchmarks_torch import table1_trackers as table1
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    label = common.device_label(dev)
    emb = {"embedding_bag", "embedding_bag_backward"}
    uses = {"cpr-mfu": {"tracker_select"}, "cpr-ssu": {"ssu_dedupe_evict"}}

    # (a) fig7, Kaggle at full width, every mode on the kernel backend
    t0 = time.perf_counter()
    top = max(cfg.table_sizes)           # a max_rows that scales nothing
    if common.get_dataset("kaggle", 3, top)[0] != cfg:
        fail("the harness does not give the published Kaggle config")
    kernels.reset_launches()
    rows = []
    for mode in fig7.MODES:
        before = dict(kernels.LAUNCHES)
        (row,) = fig7.run(datasets=("kaggle",), modes=(mode,), device=dev,
                          tracker_backend="kernel", max_rows=top,
                          max_steps=STEPS_FLAT)
        counts = launches_since(kernels, before)
        rows.append(row)
        print(f"fig7 (full width, {cfg.total_emb_rows():,} rows, "
              f"{STEPS_FLAT} steps) {json.dumps({**row, 'device': label})}")
        print(f"  launches: {json.dumps(counts)}")
        missing = sorted(n for n in emb | uses.get(mode, set())
                         if counts[n] == 0)
        if missing:
            fail(f"fig7 {mode} at full width never launched {missing}")
        if not math.isfinite(row["auc"]):
            fail(f"fig7 {mode} at full width: AUC is not finite")
        # every failure reloads: everything under full recovery, only the
        # failed shards (a smaller charge) under the partial modes
        full_load = rows[0]["load_h"]
        if not (full_load > 0 and (mode == "full" or
                                   row["load_h"] < full_load)):
            fail(f"fig7 {mode} at full width: load {row['load_h']} h (full: "
                 f"{full_load} h) says the run did not recover as the mode "
                 f"does")
    launches = dict(kernels.LAUNCHES)
    for row in fig7.derived(rows):
        print(f"fig7 (full width) {json.dumps({**row, 'device': label})}")
    print(f"fig7 (full width): launches of the six runs "
          f"{json.dumps(launches)} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # (b) the harness's own size: the card against the CPU, same parameters
    t0 = time.perf_counter()
    small, _ = common.get_dataset("kaggle")
    init = params_to_numpy(init_dlrm(small, torch.Generator().manual_seed(0),
                                     "cpu"))
    rows = {}
    for d in (dev, "cpu"):
        runs = {m: common.run_emulation(m, device=d, init_params=init)
                for m in fig7.MODES}
        rows[d] = [fig7.overhead_row("kaggle", m, r) for m, r in runs.items()]
        rows[d] += fig7.derived(rows[d])
        for row, r in zip(rows[d], runs.values()):
            row["logloss"] = round(r.logloss, 4)
    for a, b in zip(rows[dev], rows["cpu"]):
        same = all(a.get(k) == b.get(k) for k in FIG7_POLICY)
        mode = a["mode"]
        print(f"fig7 --fast ({small.name}) {mode}: card "
              f"{json.dumps({**a, 'device': label})} cpu "
              f"{json.dumps({**b, 'device': 'cpu'})} policy identical={same}")
        if not same:
            fail(f"fig7 {mode}: the card's policy differs from the CPU's")
        if mode in FIG7_HELD:
            gaps = (abs(a["auc"] - b["auc"]), abs(a["logloss"] - b["logloss"]))
            print(f"  auc gap {gaps[0]:.4f} (limit {FIG7_AUC_GAP}), eval "
                  f"logloss gap {gaps[1]:.4f} (limit {FIG7_LOGLOSS_GAP})")
            if gaps[0] > FIG7_AUC_GAP or gaps[1] > FIG7_LOGLOSS_GAP:
                fail(f"fig7 {mode}: the card's model differs from the CPU's")
    print(f"fig7 --fast card vs CPU: {time.perf_counter() - t0:.1f} s")

    # (c) table1 and fig14 at --fast size
    for name, mod in (("table1", table1), ("fig14", fig14)):
        t0 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        try:
            out = mod.run(device=dev, **harness.FAST_OVERRIDES.get(name, {}))
        except AssertionError as e:
            fail(f"{name}: an audit failed on the card: {e!r}")
        for row in out:
            print(f"{name} {json.dumps({**row, 'device': label})}")
        counts = launches_since(kernels, before)
        print(f"{name}: launches {json.dumps(counts)} "
              f"({time.perf_counter() - t0:.1f} s)")
        if name == "fig14" and (
                not all(r["matches_numpy_ref"] for r in out
                        if r["kind"] == "tracker_select")
                or counts["tracker_select"] == 0):
            fail("fig14: the card's segment-wise selection did not run "
                 "through tracker_select or disagrees with its plain version")

    # (d) the examples
    run_examples()


def run_examples():
    """Phase 5 (d): the examples, each a process of its own on the card,
    all started together: a process's time is mostly its start and set-up
    (one after another the five took 91.3 s, PERF.md section 4).  Output
    goes to files, read once every process has ended; none outlives the
    call."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    logs = SCRATCH / "examples"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    t0 = time.perf_counter()
    procs, ends = {}, {}
    try:
        for script, (_, _, args) in EXAMPLE_LINES.items():
            with open(logs / f"{script}.out", "w") as out, \
                    open(logs / f"{script}.err", "w") as err:
                procs[script] = subprocess.Popen(
                    [sys.executable, str(root / "examples" / script), *args],
                    env=env, stdout=out, stderr=err, text=True)
        for script, proc in procs.items():
            proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
            ends[script] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for script, (mark, n_lines, _) in EXAMPLE_LINES.items():
        stdout = (logs / f"{script}.out").read_text()
        code = procs[script].returncode
        print(f"examples/{script} (exit {code}, ended by {ends[script]:.1f} "
              f"s after the {len(procs)} started):")
        print("\n".join(f"  {line}" for line in stdout.splitlines()))
        if code:
            fail(f"examples/{script} failed: "
                 f"{(logs / f'{script}.err').read_text()[-2000:]}")
        summary = [line for line in stdout.splitlines()
                   if re.match(mark, line)]
        if len(summary) != n_lines:
            fail(f"examples/{script} printed {len(summary)} summary lines, "
                 f"not {n_lines}")
    shutil.rmtree(logs, ignore_errors=True)


def band_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, queries right-aligned to the KV
    tail: the work a kernel that skips masked tiles must still do."""
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    j = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= (i - j) < window
    return int(keep.sum())


def band_mask(S, causal, window, dev):
    """The (S, S) mask of the band (None where every key is seen), for
    ``F.scaled_dot_product_attention``."""
    if not causal and not window:
        return None
    i = torch.arange(S, device=dev)
    return ((i[None, :] <= i[:, None]) | (not causal)) & (
        i[:, None] - i[None, :] < (window or S + 1))


def phase_lm_kernels(dev, ops, ref):
    """``flash_attention`` and ``rglru_scan`` against their plain versions
    at the serving path's shapes (phase 2b)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    for name, (B, Hq, Hkv, S, hd), dtype, causal, window, cap, (rtol, atol) \
            in FLASH_CASES:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=cap)

        def plain():
            return ref.flash_attention(qt, kt, vt, causal, window, cap)

        want = plain().transpose(1, 2).float()

        def excess(got):
            """max |got - want| and its largest ratio to the limit."""
            diff = (got.float() - want).abs()
            return (diff.max().item(),
                    (diff / (rtol * want.abs() + atol)).max().item())

        err, ratio = excess(kernel())
        # what a kernel whose window edge sat one key tile off would read
        # (the plain version with the window one tile shorter): the limit
        # must reject it
        off = (excess(ref.flash_attention(qt, kt, vt, causal,
                                          window - KEY_TILE,
                                          cap).transpose(1, 2))
               if window else None)
        pairs = B * Hq * band_pairs(S, S, causal, window)
        rate = (BF16_OPS_PER_S if dtype == torch.bfloat16
                else F32_TC_OPS_PER_S)
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        t_b, by = bound(nbytes, ops=4 * hd * pairs, ops_per_s=rate)
        fma = ("" if dtype == torch.bfloat16 else " (f32 FMA bound "
               f"{bound(nbytes, ops=4 * hd * pairs)[0]:.5f})")
        library = None
        if not cap:         # one PyTorch call computes the same function
            band = band_mask(S, causal, window, dev)
            library = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True))
        # the plain versions take 10-210 ms a call: 5 calls, as in 2c
        row = dict(max_abs_err=err, ms=time_ms(kernel),
                   plain_ms=time_ms(plain, reps=5, warmup=1), bound_ms=t_b,
                   bound_by=by, library_ms=library)
        own, _ = device_ms(kernel, "flash_fwd")
        ok = ratio <= 1.0
        print(f"flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(dtype)[6:]} causal={causal} window={window} softcap={cap} "
              f"pairs={pairs} max_abs_err={err:.3e} limit |err| <= "
              f"{rtol:g}*|plain| + {atol:g} (largest share of it "
              f"{ratio:.3f}) ok={ok} ms={row['ms']:.4f} kernel device ms="
              f"{'not measured' if own is None else f'{own:.4f}'} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={t_b:.5f} ({by}"
              f"{'' if dtype == torch.bfloat16 else ', 3xTF32'}){fma} "
              f"library_ms={library}")
        if off is not None:
            print(f"  window one key tile ({KEY_TILE}) short would read: "
                  f"max_abs_err={off[0]:.3e}, {off[1]:.1f} times the limit")
            if off[1] <= 1.0:
                fail(f"the flash_attention {name} limit would not see a "
                     f"window one tile off")
        if not ok:
            fail(f"flash_attention {name} disagrees with its plain version")
        rows.setdefault("flash_attention", row)    # the serving path's case
        del q, k, v, qt, kt, vt, want

    for dtype in (torch.float32, torch.bfloat16):
        a = torch.sigmoid(torch.randn(SCAN_SHAPE, generator=gen,
                                      device=dev)).to(dtype)
        b = (torch.randn(SCAN_SHAPE, generator=gen, device=dev) * 0.1
             ).to(dtype)
        got, want = ops.rglru_scan(a, b), ref.rglru_scan(a, b)
        err = (got.float() - want.float()).abs().max().item()
        t_b, by = bound(3 * a.numel() * a.element_size(), ops=2 * a.numel())
        row = dict(max_abs_err=err,
                   ms=time_ms(lambda: ops.rglru_scan(a, b)),
                   plain_ms=time_ms(lambda: ref.rglru_scan(a, b), reps=5,
                                    warmup=1),
                   bound_ms=t_b, bound_by=by, library_ms=None)
        own, _ = device_ms(lambda: ops.rglru_scan(a, b), "rglru_scan_kernel")
        # a yardstick, not the same function: one elementwise pass that
        # moves the same bytes (reads a and b, writes one output)
        h = torch.empty_like(a)
        add_ms = time_ms(lambda: torch.add(a, b, out=h))
        print(f"rglru_scan {tuple(a.shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} (bit-exact expected) "
              f"differing={int((got != want).sum())} ms={row['ms']:.4f} "
              f"(CUDA events, one call) kernel device ms="
              f"{'not measured' if own is None else f'{own:.4f}'} "
              f"(profiler) plain_ms={row['plain_ms']:.4f} bound_ms="
              f"{t_b:.5f} ({by}) library_ms=None (no PyTorch call scans a "
              f"recurrence); yardstick torch.add(a, b) over the same "
              f"tensors ms={add_ms:.4f}")
        if not torch.equal(got, want):
            fail("rglru_scan disagrees with its plain version")
        rows.setdefault("rglru_scan", row)         # f32, as the path runs it
    torch.cuda.empty_cache()
    return rows


@torch.no_grad()
def launches_per_forward(cfg):
    """The port's kernel launches in one forward over ``cfg``'s layers:
    attention, local and MoE layers launch ``flash_attention``, RG-LRU
    layers ``rglru_scan``, xLSTM layers neither."""
    from repro_torch.models.transformer import ATTENTION_KINDS
    kinds = cfg.layer_kinds
    return {"flash_attention": sum(k in ATTENTION_KINDS for k in kinds),
            "rglru_scan": sum(k == "rglru" for k in kinds)}


def phase_serving(dev, kernels, cfg):
    """The serving path at full width (phase 3b): one prefill ``forward``
    over ``PREFILL_SHAPE`` tokens, then ``serve()`` answers 8 requests;
    then the prefill's time over more forwards and a decode step's time at
    a context past the window (``profile_serve``'s workload)."""
    from repro_torch.launch import profile_serve as P
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    arch = cfg.name
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"{arch}: {n_params:,} parameters, f32 ({n_params * 4 / 1e9:.2f} "
          f"GB) on the card, {cfg.dtype} activations "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    gen = torch.Generator(device=dev).manual_seed(1)
    want = launches_per_forward(cfg)
    toks = torch.randint(0, cfg.vocab_size, P.PREFILL_SHAPE, generator=gen,
                         device=dev)
    T.forward(params, {"tokens": toks[:, :256]}, cfg)      # warm-up
    reqs = make_requests(8, 64, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def prefill():
        t0 = time.perf_counter()
        logits, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    kernels.reset_launches()
    prefill_s, logits = prefill()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    done, stats = serve(cfg, reqs, batch=4, gen=32, params=params, device=dev)
    counts = dict(kernels.LAUNCHES)

    times = [prefill_s] + [prefill()[0] for _ in range(P.PREFILL_REPS - 1)]
    prefill_s = statistics.median(times)
    decode = P.decode_past_window(params, cfg, dev, gen)
    step_s = []
    for i in range(P.DECODE_WARMUP + P.DECODE_STEPS):
        t0 = time.perf_counter()
        decode(i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_ms = statistics.median(step_s[P.DECODE_WARMUP:]) * 1e3

    n_tok = P.PREFILL_SHAPE[0] * P.PREFILL_SHAPE[1]
    print(f"prefill {arch} {P.PREFILL_SHAPE}: median of {P.PREFILL_REPS} "
          f"forwards {prefill_s * 1e3:.1f} ms (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{n_tok / prefill_s:.0f} tokens/s, logits {shape} finite="
          f"{finite}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"serve {arch}: {len(done)} requests (prompts "
          f"{min(map(len, reqs))}..{max(map(len, reqs))} tokens, so a "
          f"cache of {max(map(len, reqs)) + 32} slots), batch 4, gen 32: "
          f"{stats['tokens']} tokens in "
          f"{stats['wall_s']:.2f} s -> {stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.2f} ms per decode step "
          f"({stats['steps']} steps, {stats['refills']} refills)")
    print(f"decode past the window {arch}: batch {P.DECODE_BATCH}, f32 "
          f"state with a full {cfg.sliding_window}-slot ring per local "
          f"layer, {cfg.dtype} activations: median {step_ms:.2f} ms per "
          f"step over {P.DECODE_STEPS} steps (each synchronized), "
          f"{P.DECODE_BATCH / step_ms * 1e3:.1f} tokens/s")
    print(f"launches (prefill + serve): {json.dumps(counts)}")
    if shape != (*P.PREFILL_SHAPE, cfg.vocab_size) or not finite:
        fail("prefill logits have the wrong shape or are not finite")
    if sorted(done) != list(range(8)) or any(
            len(c) != 32 or not all(0 <= t < cfg.vocab_size for t in c)
            for c in done.values()):
        fail("serve() did not answer every request with 32 tokens")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{name} launched {counts[name]} times in the serving path, "
                 f"not {n}")
    return params, counts


@torch.no_grad()
def phase_lm_agreement(dev, params, cfg, small):
    """Prefill against decode at full width in f32 over AGREE_SEQ tokens,
    then the ``small`` config on the card against the CPU (phase 4b)."""
    import dataclasses

    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import transformer as T
    arch = cfg.name
    cfg = dataclasses.replace(cfg, dtype="float32")
    S = AGREE_SEQ
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device=dev)
    t0 = time.perf_counter()
    before = LAUNCHES["flash_attention"]
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    f32_launches = LAUNCHES["flash_attention"] - before
    state = T.init_decode_state(cfg, 2, S, torch.float32, dev)
    err = torch.zeros((), device=dev)
    W = cfg.sliding_window
    for i in range(S):
        if i == W:              # time the steps past the window
            torch.cuda.synchronize()
            t_past = time.perf_counter()
        logits, state = T.decode_step(params, state, toks[:, i], i, cfg)
        err = torch.maximum(err, (logits - full[:, i]).abs().max())
    torch.cuda.synchronize()
    past_ms = (time.perf_counter() - t_past) / (S - W) * 1e3
    scale = full.abs().max().item()
    err = err.item()
    # f32 throughout; the two paths sum in different orders (flash tiles
    # and the scan kernel against the ring cache and the one-step
    # recurrence), so they agree to f32 rounding, well inside 1e-4 of the
    # largest logit
    ok = err <= 1e-4 * scale
    print(f"prefill vs decode ({arch}, f32, (2, {S}) tokens): "
          f"max_abs_err={err:.3e} over every position, max |logit|="
          f"{scale:.4f}, tol=1e-4*max|logit| ok={ok} "
          f"({time.perf_counter() - t0:.1f} s); decode steps past the "
          f"window (positions {W}..{S - 1}, batch 2, f32 activations): "
          f"{past_ms:.2f} ms per step, not synchronized per step; f32 "
          f"flash_attention launches in the prefill: {f32_launches}")
    if not ok:
        fail("prefill and decode disagree at full width")
    del full, state
    torch.cuda.empty_cache()
    reduced_agreement(dev, small)


@torch.no_grad()
def reduced_agreement(dev, cfg):
    """A reduced (f32) config on the card and the CPU from the same
    parameters: ``forward`` logits within 1e-4 and identical greedy
    ``serve()`` completions."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    got, _ = T.forward(card, {"tokens": toks.to(dev)}, cfg)
    want, _ = T.forward(cpu, {"tokens": toks}, cfg)
    err = (got.cpu() - want).abs().max().item()
    reqs = make_requests(8, 24, cfg.vocab_size, seed=0)
    a, _ = serve(cfg, reqs, batch=4, gen=16, params=card, device=dev)
    b, _ = serve(cfg, reqs, batch=4, gen=16, params=cpu, device="cpu")
    # f32 sums in another order on the card (cuBLAS, the kernels)
    ok = err <= 1e-4 and a == b
    print(f"agreement ({cfg.name}, f32): card vs CPU forward "
          f"max_abs_err={err:.3e} tol=1e-4; serve() greedy completions of 8 "
          f"requests identical={a == b} ok={ok}")
    if not ok:
        fail("the reduced model on the card disagrees with the CPU path")


@contextlib.contextmanager
def moe_inputs(fn):
    """While open, every MoE layer that ``models.transformer`` runs first
    hands its parameters, its input (B, S, d) and its config to ``fn`` (a
    probe beside the layer's own work, which it leaves unchanged)."""
    from repro_torch.models import transformer as T
    inner = T.moe_lib.apply_moe

    def probed(p, x, moe_cfg, capacity=None):
        fn(p, x, moe_cfg)
        return inner(p, x, moe_cfg, capacity)

    T.moe_lib.apply_moe = probed
    try:
        yield
    finally:
        T.moe_lib.apply_moe = inner


@torch.no_grad()
def phase_moe_serving(dev, kernels, cfg):
    """The MoE serving path at full width (phase 3m): one prefill
    ``forward`` over ``MOE_PREFILL_SHAPE`` tokens (each MoE layer's
    capacity and dropped assignments probed beside it), then ``serve()``
    answers 8 requests; then the prefill's time over more forwards."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    arch = cfg.name
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"{arch}: {n_params:,} parameters, f32 ({n_params * 4 / 1e9:.2f} "
          f"GB) on the card, {cfg.dtype} activations "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    # ``param_counts()`` (the reference's) leaves out the final norm and
    # each layer's shared-expert gate, d values each; the trees of both
    # packages hold them
    want = cfg.param_counts()["total"] + cfg.d_model * (1 + cfg.num_layers)
    if n_params != want:
        fail(f"{arch} drew {n_params:,} parameters, not {want:,} (the "
             f"config's {cfg.param_counts()['total']:,} and the norm and "
             f"gates it leaves out)")
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, MOE_PREFILL_SHAPE, generator=gen,
                         device=dev)
    T.forward(params, {"tokens": toks[:, :256]}, cfg)      # warm-up
    reqs = make_requests(8, 64, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plans = []

    def count_drops(p, x, m):
        B, S, d = x.shape
        C = M.expert_capacity(m, B * S, S)
        _, slot = M.dispatch(M.route(p, x.reshape(B * S, d), m)[2], C,
                             m.num_experts)
        plans.append((C, (slot == m.num_experts * C).sum()))

    kernels.reset_launches()
    with moe_inputs(count_drops):
        logits, _ = T.forward(params, {"tokens": toks}, cfg)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    done, stats = serve(cfg, reqs, batch=4, gen=32, params=params, device=dev)
    counts = dict(kernels.LAUNCHES)

    def prefill():
        t0 = time.perf_counter()
        T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = [prefill() for _ in range(MOE_PREFILL_REPS)]
    prefill_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    n_tok = MOE_PREFILL_SHAPE[0] * MOE_PREFILL_SHAPE[1]
    m = cfg.moe
    caps = sorted({C for C, _ in plans})
    dropped = [int(n) for _, n in plans]
    print(f"prefill {arch} {MOE_PREFILL_SHAPE}: median of "
          f"{MOE_PREFILL_REPS} forwards {prefill_s * 1e3:.1f} ms (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{n_tok / prefill_s:.0f} tokens/s, logits {shape} finite="
          f"{finite}, peak memory {peak / 1e9:.2f} GB")
    print(f"MoE dispatch at the prefill: T = {n_tok}, k = {m.top_k}, E = "
          f"{m.num_experts}, capacity {caps} per expert, dropped "
          f"assignments by layer {dropped} (of {n_tok * m.top_k} each; "
          f"{sum(dropped)} in all)")
    print(f"serve {arch}: {len(done)} requests (prompts "
          f"{min(map(len, reqs))}..{max(map(len, reqs))} tokens), batch 4, "
          f"gen 32: {stats['tokens']} tokens in {stats['wall_s']:.2f} s -> "
          f"{stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.2f} ms per decode step "
          f"at batch 4 ({stats['steps']} steps, {stats['refills']} refills; "
          f"f32 state, {cfg.dtype} activations)")
    print(f"launches (prefill + serve): {json.dumps(counts)}")
    if shape != (*MOE_PREFILL_SHAPE, cfg.vocab_size) or not finite:
        fail("the MoE prefill's logits have the wrong shape or are not "
             "finite")
    if len(plans) != cfg.num_layers or caps != [
            M.expert_capacity(m, n_tok, MOE_PREFILL_SHAPE[1])]:
        fail(f"the MoE prefill ran {len(plans)} MoE layers at capacities "
             f"{caps}")
    if sorted(done) != list(range(8)) or any(
            len(c) != 32 or not all(0 <= t < cfg.vocab_size for t in c)
            for c in done.values()):
        fail("serve() did not answer every request with 32 tokens")
    if counts["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {counts['flash_attention']} times "
             f"in the MoE serving path, not {cfg.num_layers}")
    return params, counts


@torch.no_grad()
def phase_moe_agreement(dev, params, cfg):
    """(a) Prefill against decode at full width in f32 over MOE_AGREE_SEQ
    tokens, at a capacity that drops nothing, every MoE layer's routes
    probed on both paths; (b) the reduced qwen2-moe and qwen3-moe on the
    card against the CPU (phase 4m)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    m = cfg.moe
    k = m.top_k
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / k))
    S, L = MOE_AGREE_SEQ, cfg.num_layers
    if M.expert_capacity(cfg.moe, S, S) < S:
        fail("4m (a): the prefill's capacity would drop assignments")
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev)
    routes = []

    def record(p, x, moe_cfg):
        probs, _, top_e = M.route(p, x.reshape(-1, x.shape[-1]), moe_cfg)
        routes.append((probs, top_e))

    t0 = time.perf_counter()
    with moe_inputs(record):
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        pre_p = torch.stack([p for p, _ in routes])          # (L, S, E)
        pre_e = torch.stack([e for _, e in routes])          # (L, S, k)
        routes.clear()
        state = T.init_decode_state(cfg, 1, S, torch.float32, dev)
        dec = torch.stack([T.decode_step(params, state, toks[:, i], i,
                                         cfg)[0][0] for i in range(S)])
    # decode's probes come in step-major order: (S, L) -> (L, S)
    dec_p = torch.stack([p[0] for p, _ in routes]).reshape(S, L, -1)
    dec_e = torch.stack([e[0] for _, e in routes]).reshape(S, L, k)
    dec_p, dec_e = dec_p.transpose(0, 1), dec_e.transpose(0, 1)
    flipped = ~(pre_e.sort(-1).values == dec_e.sort(-1).values).all(-1)

    def gap(p):             # the k-th probability less the (k+1)-th
        top = p.sort(-1, descending=True).values
        return top[..., k - 1] - top[..., k]

    flips = flipped.nonzero().tolist()
    first = min((pos for _, pos in flips), default=S)
    scale = full[0].abs().max().item()
    err = ((full[0, :first] - dec[:first]).abs().max().item()
           if first else float("inf"))
    gaps = [(layer, pos, gap(pre_p[layer, pos]).item(),
             gap(dec_p[layer, pos]).item()) for layer, pos in flips]
    for layer, pos, g_pre, g_dec in gaps:
        print(f"  route flip: layer {layer}, token {pos}: prefill experts "
              f"{sorted(pre_e[layer, pos].tolist())}, decode "
              f"{sorted(dec_e[layer, pos].tolist())}; k-th - (k+1)-th "
              f"probability gap {g_pre:.3e} (prefill), {g_dec:.3e} (decode)")
    ties_ok = all(g <= ROUTE_TIE for _, _, g, _ in gaps)
    ok = ties_ok and err <= 1e-4 * scale
    print(f"prefill vs decode ({cfg.name}, f32, capacity factor "
          f"{cfg.moe.capacity_factor:g}, (1, {S}) tokens): {len(flips)} "
          f"route flips of {L * S} (layer, token) routes (each within "
          f"{ROUTE_TIE:g} of a tie: {ties_ok}); smallest prefill gap "
          f"{gap(pre_p).min().item():.3e}; max_abs_err={err:.3e} over the "
          f"{first} positions before the first flip, max |logit|="
          f"{scale:.4f}, tol=1e-4*max|logit| ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("the MoE prefill and decode disagree at full width")
    del full, state, dec, routes
    torch.cuda.empty_cache()

    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
        small = get_config(arch).reduced()
        cpu = T.init_model(small, torch.Generator().manual_seed(0), "cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, small.vocab_size, (2, 128)))
        got, _ = T.forward(card, {"tokens": toks.to(dev)}, small)
        want, _ = T.forward(cpu, {"tokens": toks}, small)
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        reqs = make_requests(8, 24, small.vocab_size, seed=0)
        a, _ = serve(small, reqs, batch=4, gen=16, params=card, device=dev)
        b, _ = serve(small, reqs, batch=4, gen=16, params=cpu, device="cpu")
        # f32 sums in another order on the card (cuBLAS, the kernels)
        ok = err <= 1e-4 * scale and a == b
        print(f"agreement ({small.name}, f32): card vs CPU forward "
              f"max_abs_err={err:.3e} tol=1e-4*max|logit| ({scale:.4f}); "
              f"serve() greedy completions of 8 requests identical={a == b} "
              f"ok={ok}")
        if not ok:
            fail(f"the reduced {arch} on the card disagrees with the CPU "
                 f"path")


def hubert_param_count(cfg) -> int:
    """The tree's parameters: ``param_counts()`` (the reference's) counts a
    token embedding HuBERT does not have and 2 d of norms a layer, where
    its LayerNorms hold 4 d, and leaves out the final norm's 2 d."""
    d = cfg.d_model
    return (cfg.param_counts()["total"] - cfg.vocab_size * d
            + 2 * d * cfg.num_layers + 2 * d)


def phase_hubert(dev, kernels, cfg):
    """The audio encoder at full width and depth (phase 3h): one
    ``forward`` over (8, 1000) frames, then HUBERT_STEPS training steps
    (masked prediction, its backward, Adam); then the forward's time over
    more forwards."""
    from repro_torch.launch import profile_encoder as P
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam, apply_updates
    from repro_torch.tree import leaves, unflatten
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"{cfg.name}: {n_params:,} parameters, f32 "
          f"({n_params * 4 / 1e9:.2f} GB) on the card, {cfg.dtype} "
          f"activations, no token embedding "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    if n_params != hubert_param_count(cfg):
        fail(f"{cfg.name} drew {n_params:,} parameters, not "
             f"{hubert_param_count(cfg):,}")
    B, S = P.BATCH, P.FRAMES
    batch = P.make_batch(cfg, B, S, 1, dev)
    with torch.no_grad():
        T.forward(params, {"embeds": batch["embeds"][:, :128]}, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def forward():
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = T.forward(params, {"embeds": batch["embeds"]}, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    kernels.reset_launches()
    fwd_s, logits = forward()
    fwd_counts = dict(kernels.LAUNCHES)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    opt = adam(P.LR)
    state = opt.init(params)
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    losses, step_s, zero = [], [], []
    kernels.reset_launches()
    for i in range(HUBERT_STEPS):
        t0 = time.perf_counter()
        loss, _ = T.lm_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, flat)
        if i == 0:
            zero = [n for n, g in enumerate(grads) if not bool((g != 0).any())]
        updates, state = opt.update(unflatten(params, grads), state, params)
        apply_updates(params, updates)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
        del loss, grads, updates
    train_counts = dict(kernels.LAUNCHES)
    for t in flat:
        t.requires_grad_(False)
    times = [fwd_s] + [forward()[0] for _ in range(HUBERT_REPS - 1)]
    peak = torch.cuda.max_memory_allocated()
    n_masked = int(batch["target_mask"].sum())
    print(f"forward {cfg.name} ({B}, {S}) frames: median of {HUBERT_REPS} "
          f"forwards {statistics.median(times) * 1e3:.1f} ms (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), logits {shape} "
          f"finite={finite}")
    print(f"train {cfg.name} ({B}, {S}) frames, masked prediction over "
          f"{n_masked} of {B * S} frames (spans of {P.SPAN}, start "
          f"probability {P.SPAN_START}), Adam lr {P.LR:g}, no remat: "
          f"losses {', '.join(f'{l:.4f}' for l in losses)}; ms per step "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)} (median of steps "
          f"1..: {statistics.median(step_s[1:]) * 1e3:.1f}); peak memory "
          f"{peak / 1e9:.2f} GB")
    print(f"launches: forward {json.dumps(fwd_counts)}; "
          f"{HUBERT_STEPS} steps {json.dumps(train_counts)}")
    if shape != (B, S, cfg.vocab_size) or not finite:
        fail("the HuBERT forward's logits have the wrong shape or are not "
             "finite")
    if not all(map(math.isfinite, losses)):
        fail(f"HuBERT training: a loss is not finite: {losses}")
    if zero:
        fail(f"HuBERT training: gradient leaves {zero} are zero")
    if not losses[2] < losses[0] + 1:
        fail(f"HuBERT training: step 2's loss {losses[2]} is not below step "
             f"0's plus 1")
    L = cfg.num_layers
    if fwd_counts["flash_attention"] != L:
        fail(f"flash_attention launched {fwd_counts['flash_attention']} "
             f"times in a HuBERT forward, not {L}")
    for name in ("flash_attention", "flash_attention_backward"):
        if train_counts[name] != L * HUBERT_STEPS:
            fail(f"{name} launched {train_counts[name]} times in "
                 f"{HUBERT_STEPS} HuBERT steps, not {L} a step")
    del params, state, flat, batch
    torch.cuda.empty_cache()
    return {n: fwd_counts[n] + train_counts[n] for n in fwd_counts}


def phase_hubert_agreement(dev, kernels, cfg):
    """(a) One HuBERT layer at full width in f32 over (1, 1,000) frames,
    the same parameters on the card and the CPU: ``lm_loss`` within 1e-5
    relative, every gradient leaf within GRAD_AGREE of its largest entry;
    (b) the reduced ``hubert-xlarge`` and a reduced variant at head dim 80
    on the card against the CPU: logits within 1e-4 of the largest (phase
    4h)."""
    import dataclasses

    from repro_torch.launch import profile_encoder as P
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map, unflatten
    t0 = time.perf_counter()
    one = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    cpu = T.init_model(one, torch.Generator().manual_seed(0), "cpu")
    batch = P.make_batch(one, 1, P.FRAMES, 7, "cpu")
    out = {}
    before = dict(kernels.LAUNCHES)
    for d in (dev, "cpu"):
        params = cpu if d == "cpu" else tree_map(lambda t: t.to(dev), cpu)
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, _ = T.lm_loss(unflatten(params, live),
                            {k: v.to(d) for k, v in batch.items()}, one)
        loss.backward()
        if d == dev:
            f32 = {n: kernels.LAUNCHES[n] - before[n] for n in
                   ("flash_attention", "flash_attention_backward")}
        out[str(d)] = (loss.item(), [t.grad.cpu() for t in live])
        del params, live, loss
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    shares = [((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(gg, gc)]
    ok = (abs(lg - lc) <= 1e-5 * abs(lc) and max(shares) <= GRAD_AGREE
          and all(n == 1 for n in f32.values()))
    print(f"gradients at full width ({one.name}, 1 layer, f32, (1, "
          f"{P.FRAMES}) frames, bidirectional, head dim "
          f"{one.head_dim}): loss card {lg:.6f} cpu {lc:.6f} (tol 1e-5 "
          f"relative); {len(gg)} leaves, largest |card - cpu| / max|cpu| "
          f"{max(shares):.3e} (limit {GRAD_AGREE:g}; by leaf "
          f"{', '.join(f'{x:.1e}' for x in shares)}); f32 attention "
          f"launches on the card {json.dumps(f32)} ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("HuBERT's full-width layer on the card disagrees with the CPU")
    del out, gg, gc, cpu

    for name, changes in (("reduced", {}),
                          ("head dim 80", {"d_model": 160, "num_heads": 2,
                                           "num_kv_heads": 2,
                                           "head_dim": 80})):
        small = dataclasses.replace(cfg.reduced(), **changes)
        cpu = T.init_model(small, torch.Generator().manual_seed(0), "cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        x = P.make_batch(small, 2, 200, 8, "cpu")["embeds"]
        with torch.no_grad():
            got, _ = T.forward(card, {"embeds": x.to(dev)}, small)
            want, _ = T.forward(cpu, {"embeds": x}, small)
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= 1e-4 * scale
        print(f"agreement ({small.name}, {name}, head dim {small.head_dim}, "
              f"f32, (2, 200) frames): card vs CPU forward max_abs_err="
              f"{err:.3e} tol=1e-4*max|logit| ({scale:.4f}) ok={ok}")
        if not ok:
            fail(f"the {name} HuBERT on the card disagrees with the CPU path")
    torch.cuda.empty_cache()


def image_positions(S, start, rows, cols):
    """Qwen2-VL's (3, S) M-RoPE positions (numpy): text before the image
    at t = h = w = its index; the image's rows x cols patches at t = start,
    h = start + row, w = start + column; text after it from the largest
    position + 1."""
    n = rows * cols
    pos = np.empty((3, S), np.int64)
    pos[:, :start] = np.arange(start)
    r, c = np.divmod(np.arange(n), cols)
    pos[:, start:start + n] = start
    pos[1, start:start + n] += r
    pos[2, start:start + n] += c
    pos[:, start + n:] = pos[:, :start + n].max() + 1 + np.arange(
        S - start - n)
    return pos


def vlm_batch(cfg, B, S, image, seed, dev):
    """Tokens, one image's patch embeddings at its place and the
    image-layout positions, from a seed."""
    start, rows, cols = image
    n = rows * cols
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(image_positions(S, *image))
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S))).to(dev),
            "patch_embeds": torch.from_numpy(rng.normal(
                size=(B, n, cfg.d_model)).astype(np.float32)).to(dev),
            "patch_positions": torch.arange(start, start + n,
                                            device=dev).expand(B, n),
            "positions": pos[:, None].expand(3, B, S).to(dev)}


@torch.no_grad()
def phase_vlm_serving(dev, kernels, cfg):
    """Qwen2-VL at full width, VLM_LAYERS deep (phase 3v): one prefill
    ``forward`` over VLM_PREFILL tokens holding one image's patch
    embeddings, with the image-layout M-RoPE positions; then ``serve()``
    answers 8 text requests (decode rotates by M-RoPE); then the
    prefill's time over more forwards."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    # param_counts() leaves out the final norm's d
    want = cfg.param_counts()["total"] + cfg.d_model
    print(f"{cfg.name} cut to {cfg.num_layers} layers: {n_params:,} "
          f"parameters, f32 ({n_params * 4 / 1e9:.2f} GB) on the card, "
          f"{cfg.dtype} activations ({time.perf_counter() - t0:.1f} s to "
          f"draw)")
    if n_params != want:
        fail(f"{cfg.name} drew {n_params:,} parameters, not {want:,}")
    batch = vlm_batch(cfg, 1, VLM_PREFILL, VLM_IMAGE, 1, dev)
    T.forward(params, {"tokens": batch["tokens"][:, :256]}, cfg)  # warm-up
    reqs = make_requests(8, 64, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def prefill():
        t0 = time.perf_counter()
        logits, _ = T.forward(params, batch, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    kernels.reset_launches()
    prefill_s, logits = prefill()
    pre_counts = dict(kernels.LAUNCHES)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    done, stats = serve(cfg, reqs, batch=4, gen=32, params=params, device=dev)
    counts = dict(kernels.LAUNCHES)
    times = [prefill_s] + [prefill()[0] for _ in range(VLM_REPS - 1)]
    peak = torch.cuda.max_memory_allocated()
    start, rows, cols = VLM_IMAGE
    print(f"prefill {cfg.name} (1, {VLM_PREFILL}) with {rows * cols} patch "
          f"embeddings at {start}..{start + rows * cols - 1} ({rows} x "
          f"{cols} grid, M-RoPE t/h/w positions): median of {VLM_REPS} "
          f"forwards {statistics.median(times) * 1e3:.1f} ms (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), logits {shape} "
          f"finite={finite}, peak memory {peak / 1e9:.2f} GB")
    print(f"serve {cfg.name}: {len(done)} requests (prompts "
          f"{min(map(len, reqs))}..{max(map(len, reqs))} tokens), batch 4, "
          f"gen 32: {stats['tokens']} tokens in {stats['wall_s']:.2f} s -> "
          f"{stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.2f} ms per decode step "
          f"at batch 4 ({stats['steps']} steps, {stats['refills']} refills; "
          f"f32 state, {cfg.dtype} activations)")
    print(f"launches (prefill + serve): {json.dumps(counts)}")
    if shape != (1, VLM_PREFILL, cfg.vocab_size) or not finite:
        fail("the Qwen2-VL prefill's logits have the wrong shape or are not "
             "finite")
    if sorted(done) != list(range(8)) or any(
            len(c) != 32 or not all(0 <= t < cfg.vocab_size for t in c)
            for c in done.values()):
        fail("serve() did not answer every request with 32 tokens")
    if pre_counts["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {pre_counts['flash_attention']} "
             f"times in the Qwen2-VL prefill, not {cfg.num_layers}")
    return params, counts


@torch.no_grad()
def phase_vlm_agreement(dev, params, cfg):
    """(a) Prefill against teacher-forced decode at full width in f32 over
    VLM_AGREE_SEQ text tokens (``arange`` positions); (b) the reduced
    Qwen2-VL on the card and the CPU from the same parameters with the
    image-layout positions, and greedy ``serve()`` (phase 4v)."""
    import dataclasses

    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    f32 = dataclasses.replace(cfg, dtype="float32")
    S = VLM_AGREE_SEQ
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, f32.vocab_size, (1, S), generator=gen, device=dev)
    full, _ = T.forward(params, {"tokens": toks}, f32)
    state = T.init_decode_state(f32, 1, S, torch.float32, dev)
    err = torch.zeros((), device=dev)
    for i in range(S):
        logits, state = T.decode_step(params, state, toks[:, i], i, f32)
        err = torch.maximum(err, (logits[0] - full[0, i]).abs().max())
    scale = full.abs().max().item()
    err = err.item()
    ok = err <= 1e-4 * scale
    print(f"prefill vs decode ({cfg.name} cut to {cfg.num_layers} layers, "
          f"f32, (1, {S}) text tokens, M-RoPE on arange positions): "
          f"max_abs_err={err:.3e} over every position, max |logit|="
          f"{scale:.4f}, tol=1e-4*max|logit| ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("the Qwen2-VL prefill and decode disagree at full width")
    del full, state
    torch.cuda.empty_cache()

    small = cfg.reduced()
    cpu = T.init_model(small, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    batch = vlm_batch(small, 2, 128, (16, 8, 8), 9, "cpu")
    got, _ = T.forward(card, {k: v.to(dev) for k, v in batch.items()}, small)
    want, _ = T.forward(cpu, batch, small)
    err = (got.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    reqs = make_requests(8, 24, small.vocab_size, seed=0)
    a, _ = serve(small, reqs, batch=4, gen=16, params=card, device=dev)
    b, _ = serve(small, reqs, batch=4, gen=16, params=cpu, device="cpu")
    ok = err <= 1e-4 * scale and a == b
    print(f"agreement ({small.name}, f32, (2, 128) tokens with 64 patches "
          f"and image-layout positions): card vs CPU forward max_abs_err="
          f"{err:.3e} tol=1e-4*max|logit| ({scale:.4f}); serve() greedy "
          f"completions of 8 requests identical={a == b} ok={ok}")
    if not ok:
        fail("the reduced Qwen2-VL on the card disagrees with the CPU path")


def xlstm_param_count(cfg) -> int:
    """Parameters in an xLSTM tree: per mLSTM layer q, k, v, output-gate
    and output projections, the input and forget gates' (d, H) weights and
    biases and its norm; per sLSTM layer four gate projections, their
    block-diagonal recurrent weights and biases, the output projection and
    its norm; the embedding, the untied head and the final norm."""
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    per = {"mlstm": 5 * d * d + 2 * d * H + 2 * H + d,
           "slstm": 5 * d * d + 4 * H * hd * hd + 4 * d + d}
    return sum(per[k] for k in cfg.layer_kinds) + 2 * cfg.vocab_size * d + d


@torch.no_grad()
def phase_xlstm_serving(dev, kernels, cfg):
    """xLSTM's serving path at full width and depth (phase 3x): one
    warm-up, one timed prefill ``forward`` over ``XLSTM_PREFILL`` tokens,
    then ``serve()`` answers 8 requests at batch 4."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    arch = cfg.name
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"{arch}: {n_params:,} parameters, f32 ({n_params * 4 / 1e9:.2f} "
          f"GB) on the card, {cfg.dtype} activations "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    if n_params != xlstm_param_count(cfg):
        fail(f"{arch} drew {n_params:,} parameters, not "
             f"{xlstm_param_count(cfg):,}")
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, XLSTM_PREFILL, generator=gen,
                         device=dev)
    t0 = time.perf_counter()
    T.forward(params, {"tokens": toks[:, :256]}, cfg)      # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reqs = make_requests(8, 64, cfg.vocab_size, seed=0)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, _ = T.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    done, stats = serve(cfg, reqs, batch=4, gen=32, params=params, device=dev)
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_tok = XLSTM_PREFILL[0] * XLSTM_PREFILL[1]
    print(f"prefill {arch} {XLSTM_PREFILL}: {prefill_s * 1e3:.1f} ms (one "
          f"forward after a (2, 256) warm-up of {warm_s * 1e3:.1f} ms), "
          f"{n_tok / prefill_s:.0f} tokens/s, logits {shape} finite="
          f"{finite}")
    print(f"serve {arch}: {len(done)} requests (prompts "
          f"{min(map(len, reqs))}..{max(map(len, reqs))} tokens), batch 4, "
          f"gen 32: {stats['tokens']} tokens in {stats['wall_s']:.2f} s -> "
          f"{stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.2f} ms per decode step "
          f"at batch 4 ({stats['steps']} steps, {stats['refills']} refills; "
          f"f32 state, {cfg.dtype} activations); peak memory (prefill and "
          f"serve) {peak / 1e9:.2f} GB")
    print(f"launches (prefill + serve): {json.dumps(counts)}")
    if shape != (*XLSTM_PREFILL, cfg.vocab_size) or not finite:
        fail("the xLSTM prefill's logits have the wrong shape or are not "
             "finite")
    if sorted(done) != list(range(8)) or any(
            len(c) != 32 or not all(0 <= t < cfg.vocab_size for t in c)
            for c in done.values()):
        fail("serve() did not answer every request with 32 tokens")
    if any(counts.values()):
        fail("the xLSTM serving path launched one of the port's kernels; "
             "its layers have none")
    del params
    torch.cuda.empty_cache()
    return counts


@torch.no_grad()
def xlstm_decode_agreement(dev, cfg, S):
    """Prefill against decode teacher-forced over (2, S) tokens, the
    config in f32 on the card: logits within ``XLSTM_DECODE_TOL`` of the
    largest at every position."""
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device=dev)
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, 2, S, torch.float32, dev)
    err = torch.zeros((), device=dev)
    for i in range(S):
        logits, state = T.decode_step(params, state, toks[:, i], i, cfg)
        err = torch.maximum(err, (logits - full[:, i]).abs().max())
    scale = full.abs().max().item()
    err = err.item()
    ok = err <= XLSTM_DECODE_TOL * scale
    print(f"prefill vs decode ({cfg.name}, f32, (2, {S}) tokens, chunks of "
          f"256 against the recurrent forms): max_abs_err={err:.3e} over "
          f"every position, max |logit|={scale:.4f}, "
          f"tol={XLSTM_DECODE_TOL:g}*max|logit| ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("xLSTM's prefill and decode disagree on the card")


def phase_xlstm_agreement(dev, kernels, cfg):
    """Phase 4x: (a) one pattern period (7 mLSTM, 1 sLSTM) at full width
    in f32, card against CPU; (b) the reduced config's prefill against
    its decode on the card, then card against CPU (forward, ``serve()``).
    It prints no time, so it runs beside a background figure."""
    period_agreement(dev, kernels, cfg, XLSTM_PERIOD_SEQ)
    small = cfg.reduced()
    xlstm_decode_agreement(dev, small, XLSTM_AGREE_SEQ)
    reduced_agreement(dev, small)
    torch.cuda.empty_cache()


def bwd_excess(got, want, rtol, atol):
    """max |got - want| and its largest ratio to the limit rtol * |want| +
    atol * max |want|, over the gradients ``got`` and ``want``."""
    err = ratio = 0.0
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs()
        limit = rtol * b.float().abs() + atol * b.float().abs().max()
        err = max(err, diff.max().item())
        ratio = max(ratio, (diff / limit).max().item())
    return err, ratio


def phase_lm_backward(dev, ops, ref):
    """The backward kernels against their plain backwards at the training
    path's shapes, and autograd through ``ops`` on the card equal to them
    (phase 2c)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    for name, (B, Hq, Hkv, S, hd), dtype, causal, window, cap in \
            BWD_FLASH_CASES:
        q, k, v, do = (torch.randn((B, S, h, hd), generator=gen, device=dev)
                       .to(dtype) for h in (Hq, Hkv, Hkv, Hq))
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        out, lse = fa.flash_attention(qt, kt, vt, causal, window, cap,
                                      return_lse=True)

        def kernel(lse=lse):
            return fa.flash_attention_backward(qt, kt, vt, out, dot, causal,
                                               window, cap, lse=lse)

        def plain(w=window):
            return ref.flash_attention_backward(qt, kt, vt, out, dot, causal,
                                                w, cap)

        got, want = kernel(), plain()
        rtol, atol = BWD_TOL[dtype]
        err, ratio = bwd_excess(got, want, rtol, atol)
        # run to run: the same gradients bit for bit
        same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
        # without the forward's LSE the call forms it itself
        err_nolse, ratio_nolse = bwd_excess(kernel(None), want, rtol, atol)
        del got
        off = None
        if window and window < S:
            # the plain backward with its window one key tile short: what
            # a kernel whose band edge sat one tile off would give
            off = bwd_excess(plain(window - BWD_KEY_TILE), want, rtol, atol)
        del want
        pairs = B * Hq * band_pairs(S, S, causal, window)
        rate = (BF16_OPS_PER_S if dtype == torch.bfloat16
                else F32_TC_OPS_PER_S)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
        t_b, by = bound(nbytes, ops=2.5 * 4 * hd * pairs, ops_per_s=rate)
        fma = ("" if dtype == torch.bfloat16 else " (f32 FMA bound "
               f"{bound(nbytes, ops=2.5 * 4 * hd * pairs)[0]:.5f})")
        library = None
        if not cap:   # one PyTorch call's backward computes the same thing
            band = band_mask(S, causal, window, dev)
            lq, lk, lv = (x.detach().requires_grad_(True)
                          for x in (qt, kt, vt))
            lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=band,
                                                enable_gqa=True)
            library = time_ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), dot, retain_graph=True))
            del lo, lq, lk, lv, band
        by_kernel = device_ms_by_kernel(kernel, BWD_KERNELS[dtype])
        own = sum(by_kernel.values()) if by_kernel else None
        row = dict(max_abs_err=err, ms=time_ms(kernel),
                   plain_ms=time_ms(plain, reps=5, warmup=1), bound_ms=t_b,
                   bound_by=by, library_ms=library)
        ok = ratio <= 1.0 and ratio_nolse <= 1.0
        print(f"flash_attention_backward {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} {str(dtype)[6:]} causal={causal} "
              f"window={window} "
              f"softcap={cap} pairs={pairs} max_abs_err={err:.3e} limit "
              f"|err| <= {rtol:g}*|plain| + {atol:g}*max|plain| (largest "
              f"share of it {ratio:.3f}; without the forward's LSE "
              f"{err_nolse:.3e}, {ratio_nolse:.3f}) ok={ok} two calls "
              f"equal={same} ms={row['ms']:.4f} (CUDA events, the "
              f"forward's LSE given) kernel device ms="
              f"{'not measured' if own is None else f'{own:.4f}'} "
              f"(profiler, its kernels: {json.dumps(by_kernel)}) plain_ms="
              f"{row['plain_ms']:.4f} bound_ms={t_b:.5f} ({by}"
              f"{'' if dtype == torch.bfloat16 else ', 3xTF32'}){fma} "
              f"library_ms={library} (the backward of "
              f"F.scaled_dot_product_attention, band mask)")
        if off is not None:
            print(f"  window one key tile ({BWD_KEY_TILE}) short would read: "
                  f"max_abs_err={off[0]:.3e}, {off[1]:.1f} times the limit")
            if off[1] <= 1.0:
                fail(f"the flash_attention_backward {name} limit would not "
                     f"see a window one tile off")
        if not ok:
            fail(f"flash_attention_backward {name} disagrees with its plain "
                 f"version")
        if not same:
            fail(f"flash_attention_backward {name} gives other gradients "
                 f"in a second call")
        if name == BWD_FLASH_CASES[0][0]:
            rows["flash_attention_backward"] = row
            # autograd through ops on the card gives the kernel's gradients
            live = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = ops.flash_attention(*live, causal=causal, window=window,
                                    softcap=cap)
            auto = torch.autograd.grad(o, live, do)
            lt = [x.detach().transpose(1, 2) for x in live]
            _, lse_live = fa.flash_attention(*lt, causal, window, cap,
                                             return_lse=True)
            mine = fa.flash_attention_backward(
                *lt, o.detach().transpose(1, 2), dot, causal, window, cap,
                lse=lse_live)
            same = o.grad_fn is not None and all(
                torch.equal(a, b.transpose(1, 2)) for a, b in zip(auto, mine))
            print(f"  autograd through ops.flash_attention on the card: "
                  f"gradients equal to the backward kernel's with the "
                  f"forward's LSE={same}")
            if not same:
                fail("ops.flash_attention's gradient on the card is not the "
                     "backward kernel's")
            del live, o, auto, mine, lt, lse_live
        del q, k, v, do, qt, kt, vt, dot, out, lse
        torch.cuda.empty_cache()

    for shape in BWD_SCAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                              ).to(dtype)
            b = (torch.randn(shape, generator=gen, device=dev) * 0.1
                 ).to(dtype)
            dh = torch.randn(shape, generator=gen, device=dev).to(dtype)
            h = ops.rglru_scan(a, b)
            got = rg.rglru_scan_backward(a, h, dh)
            want = ref.rglru_scan_backward(a, h, dh)
            equal = all(torch.equal(x, y) for x, y in zip(got, want))
            again = all(torch.equal(x, y) for x, y in
                        zip(got, rg.rglru_scan_backward(a, h, dh)))
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, want))
            nbytes = 5 * a.numel() * a.element_size()
            t_b, by = bound(nbytes, ops=3 * a.numel())
            own, _ = device_ms(lambda: rg.rglru_scan_backward(a, h, dh),
                               "rglru_scan_bwd")
            # a yardstick, not the same function: one elementwise add over
            # the same bytes (two inputs read, one output written)
            n = nbytes // (3 * a.element_size())
            x, y, z = (torch.empty(n, dtype=dtype, device=dev)
                       for _ in range(3))
            add_ms = time_ms(lambda: torch.add(x, y, out=z))
            row = dict(max_abs_err=err,
                       ms=time_ms(lambda: rg.rglru_scan_backward(a, h, dh)),
                       plain_ms=time_ms(
                           lambda: ref.rglru_scan_backward(a, h, dh),
                           reps=5, warmup=1),
                       bound_ms=t_b, bound_by=by, library_ms=None)
            print(f"rglru_scan_backward {shape} {str(dtype)[6:]}: "
                  f"torch.equal={equal} max_abs_err={err:.3e} "
                  f"ms={row['ms']:.4f} (CUDA events) kernel device ms="
                  f"{'not measured' if own is None else f'{own:.4f}'} "
                  f"(profiler) plain_ms={row['plain_ms']:.4f} bound_ms="
                  f"{t_b:.5f} ({by}) library_ms=None (no PyTorch call); "
                  f"yardstick torch.add over the same bytes ms={add_ms:.4f}; "
                  f"two calls equal={again}")
            if not equal:
                fail("rglru_scan_backward disagrees with its plain version")
            if not again:
                fail("rglru_scan_backward differs from call to call")
            if shape == BWD_SCAN_SHAPES[0] and dtype == torch.float32:
                rows["rglru_scan_backward"] = row
                la, lb = (t.detach().requires_grad_(True) for t in (a, b))
                lh = ops.rglru_scan(la, lb)
                auto = torch.autograd.grad(lh, (la, lb), dh)
                mine = rg.rglru_scan_backward(a, lh.detach(), dh)
                same = lh.grad_fn is not None and all(
                    torch.equal(p, r) for p, r in zip(auto, mine))
                print(f"  autograd through ops.rglru_scan on the card: "
                      f"gradients equal to the backward kernel's={same}")
                if not same:
                    fail("ops.rglru_scan's gradient on the card is not the "
                         "backward kernel's")
                del la, lb, lh, auto, mine
            del a, b, dh, h, got, want, x, y, z
    # the ragged edges: odd w (4-byte copies in f32, element loads in
    # bf16), S not a multiple of either tile, a base one element past an
    # aligned address, both tile layouts (40 and 160 channels a block)
    for shape in BWD_SCAN_RAGGED:
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.sigmoid(torch.randn(n + 1, generator=gen, device=dev)
                              ).to(dtype)[1:].view(shape)
            h, dh = (torch.randn(n + 1, generator=gen, device=dev).to(
                dtype)[1:].view(shape) for _ in range(2))
            got = rg.rglru_scan_backward(a, h, dh)
            equal = all(torch.equal(x, y) for x, y in
                        zip(got, ref.rglru_scan_backward(a, h, dh)))
            again = all(torch.equal(x, y) for x, y in
                        zip(got, rg.rglru_scan_backward(a, h, dh)))
            print(f"rglru_scan_backward ragged {shape} {str(dtype)[6:]}, "
                  f"base {a.data_ptr() % 16} bytes past 16: torch.equal="
                  f"{equal}, two calls equal={again}")
            if not (equal and again):
                fail(f"rglru_scan_backward at the ragged {shape} "
                     f"{str(dtype)[6:]}: equal={equal}, two calls "
                     f"equal={again}")
            del a, h, dh, got
    torch.cuda.empty_cache()
    return rows


def _train_report_line(rep):
    """The report's policy fields, for printing."""
    keys = ("mode", "effective_mode", "T_save", "save_interval",
            "expected_pls", "measured_pls", "n_failures", "bytes_written",
            "tracker_backend", "hash_backend", "sharded_save")
    out = {k: rep[k] for k in keys}
    out["overheads"] = rep["overheads"]
    for k in ("delta_rows_skipped", "delta_bytes_skipped"):
        if k in rep:
            out[k] = rep[k]
    return json.dumps(out)


def phase_training(dev, kernels, cfg, runs=TRAIN_RUNS, steps=TRAIN_STEPS):
    """LM training with CPR over the token rows (phase 7 (a), and 7x for
    xLSTM): the main path at full width in each of ``runs``' modes."""
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves
    per_step = launches_per_forward(cfg)
    per_step["flash_attention_backward"] = per_step["flash_attention"]
    per_step["rglru_scan_backward"] = per_step["rglru_scan"]
    uses = {"cpr-mfu": ("tracker_select", "row_hash"),
            "cpr-ssu": ("ssu_dedupe_evict",)}
    totals = {name: 0 for name in kernels.LAUNCHES}
    batch, seq = TRAIN_SHAPE
    for mode, store in runs:
        t0 = time.perf_counter()
        zero = []

        def check_grads(i, grads):
            if i == 1:    # after step 0: every leaf must have a gradient
                zero.extend(n for n, g in enumerate(leaves(grads))
                            if not bool((g != 0).any()))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        # (the trained parameters are dropped at once: 10.6 GB for
        # RecurrentGemma-2B)
        hist = train(cfg, steps=steps, batch=batch, seq=seq,
                     mode=mode, n_failures=2, fail_fraction=0.25,
                     tracker_backend="kernel", log_every=1, device=dev,
                     on_step=check_grads, **store)[1]
        counts = dict(kernels.LAUNCHES)
        for name, n in counts.items():
            totals[name] += n
        rep = hist["report"]
        losses = [l for _, l in hist["loss"]]
        steady = statistics.median(hist["step_s"][2:]) * 1e3
        where = "fleet (inproc, delta saves)" if store else "flat store"
        print(f"train {cfg.name} {mode} on the {where}: batch {batch} x "
              f"{seq} tokens, {steps} steps, steady_ms_per_step="
              f"{steady:.1f} (median of steps 2..{steps - 1}; each: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in hist['step_s'])}) "
              f"peak_memory_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"save_blocked_s={rep['overheads']['save_blocked_s']:.3f} "
              f"wall_s={time.perf_counter() - t0:.1f}")
        print(f"  losses: {', '.join(f'{l:.4f}' for l in losses)}")
        print(f"  report: {_train_report_line(rep)}")
        print(f"  launches: {json.dumps(counts)}")
        for name, n in per_step.items():
            if counts[name] != n * steps:
                fail(f"train {mode}: {name} launched {counts[name]} times, "
                     f"not {n} a step")
        missing = [n for n in uses.get(mode, ()) if counts[n] == 0]
        if missing:
            fail(f"train {mode}: {missing} never launched")
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"train {mode}: a loss is not finite")
        if zero:
            fail(f"train {mode}: gradient leaves {zero} are zero after "
                 f"step 0 (a dropped gradient)")
        if mode != "full" and not (
                rep["effective_mode"] == mode and rep["measured_pls"] > 0
                and any(e[0] == "failure" for e in hist["events"])):
            fail(f"train {mode}: no partial-recovery restore happened")
        if store and not (rep["sharded_save"]
                          and rep["hash_backend"] == "kernel"):
            fail(f"train {mode}: the run did not go through the fleet")
        del hist
    print(f"train {cfg.name}: launches of the {len(runs)} runs "
          f"{json.dumps(totals)}")
    torch.cuda.empty_cache()
    return totals


def period_agreement(dev, kernels, cfg, seq):
    """One pattern period of ``cfg`` at full width in f32 over (1, seq)
    tokens, the same parameters on the card and the CPU: ``lm_loss``
    within 1e-5 relative, every gradient leaf within ``GRAD_AGREE`` of its
    largest entry."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map, unflatten
    t0 = time.perf_counter()
    one = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern),
                              dtype="float32")
    cpu = T.init_model(one, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, one.vocab_size, (1, seq)))
    out = {}
    before = dict(kernels.LAUNCHES)
    for d in (dev, "cpu"):
        params = cpu if d == "cpu" else tree_map(lambda t: t.to(dev), cpu)
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, _ = T.lm_loss(unflatten(params, live), {"tokens": toks.to(d)},
                            one)
        loss.backward()
        if d == dev:
            f32 = {n: kernels.LAUNCHES[n] - before[n] for n in
                   ("flash_attention", "flash_attention_backward")}
        out[str(d)] = (loss.item(), [t.grad.cpu() for t in live])
        del params, live, loss
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    shares = [((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(gg, gc)]
    ok = abs(lg - lc) <= 1e-5 * abs(lc) and max(shares) <= GRAD_AGREE
    print(f"gradients at full width ({one.name}, {one.num_layers} layers "
          f"{one.block_pattern}, f32, (1, {seq}) tokens): loss card "
          f"{lg:.6f} cpu {lc:.6f} (tol 1e-5 relative); {len(gg)} leaves, "
          f"largest |card - cpu| / max|cpu| {max(shares):.3e} (limit "
          f"{GRAD_AGREE:g}; by leaf {', '.join(f'{x:.1e}' for x in shares)}) "
          f"ok={ok} ({time.perf_counter() - t0:.1f} s); f32 attention "
          f"launches on the card: {json.dumps(f32)}")
    if not ok:
        fail("full-width gradients on the card disagree with the CPU's")
    del out, gg, gc, cpu
    torch.cuda.empty_cache()


def phase_training_agreement(dev, kernels, cfg):
    """Phase 7 (b): one pattern period's loss and gradients at full width,
    card against CPU; (c) the reduced config's training run, card against
    CPU.  They print no time, so they run before (a), beside a
    background figure."""
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T
    period_agreement(dev, kernels, cfg, PERIOD_SEQ)

    # (c) the reduced config trained on the card and on the CPU
    t0 = time.perf_counter()
    small = cfg.reduced()
    init = T.init_model(small, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for d in (dev, "cpu"):
        _, runs[str(d)] = train(small, steps=8, batch=4, seq=128,
                                mode="cpr-mfu", n_failures=2,
                                tracker_backend="kernel", log_every=1,
                                device=d, params=init)
    a, b = runs[str(dev)], runs["cpu"]
    keys = ("measured_pls", "n_failures", "T_save", "effective_mode",
            "expected_pls", "save_interval", "pls_by_shard", "bytes_written")
    same = all(a["report"][k] == b["report"][k] for k in keys) and all(
        a["report"]["overheads"][k] == b["report"]["overheads"][k]
        for k in ("save", "load", "lost", "resched"))
    gaps = [abs(x - y) / abs(y) for (_, x), (_, y) in
            zip(a["loss"], b["loss"])]
    gap = max(gaps)
    ok = same and gaps[0] <= 1e-5 and gap <= TRAIN_AGREE
    print(f"train {small.name} cpr-mfu, card vs CPU, same parameters: policy "
          f"identical={same}; losses card "
          f"{', '.join(f'{l:.5f}' for _, l in a['loss'])} cpu "
          f"{', '.join(f'{l:.5f}' for _, l in b['loss'])}; relative gaps "
          f"{', '.join(f'{g:.1e}' for g in gaps)} (step 0 limit 1e-5, "
          f"every step {TRAIN_AGREE:g}) ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("the reduced model's training on the card disagrees with the "
             "CPU's")


def start_mesh_dryrun():
    """8 (c) in a process of its own, with no card visible: the port's
    dry run of gemma2-2b x train_4k on pod16x16 (a fake process group of
    256 ranks, fake CPU tensors)."""
    import atexit
    BACKGROUND.mkdir(parents=True, exist_ok=True)
    out, log = BACKGROUND / "dryrun_torch", BACKGROUND / "dryrun.log"
    shutil.rmtree(out, ignore_errors=True)
    if not _BACKGROUND_PROCS:
        atexit.register(_stop_background)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(root / "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             MESH_ARCH, "--shape", "train_4k", "--out", str(out)],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=root,
            start_new_session=True)
    _BACKGROUND_PROCS.append(proc)
    return proc, out / f"{MESH_ARCH}__train_4k__pod16x16.json", log


def finish_mesh_dryrun(handle, timeout: float = 300.0):
    """Waits for 8 (c), prints its record's memory and roofline terms and
    checks ``argument_bytes`` against the reference's artifact."""
    proc, out, log = handle
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    _stop(proc)
    if proc.returncode or not out.exists():
        fail(f"the dry run failed (exit {proc.returncode}): "
             f"{log.read_text()[-3000:]}")
    rec = json.loads(out.read_text())
    mem = rec["memory"]
    print(f"mesh 8 (c): dry run {rec['arch']} x {rec['shape']} x "
          f"{rec['mesh']}: status={rec['status']} microbatches="
          f"{rec['microbatches']} trace_s={rec['trace_s']} wall_s="
          f"{rec['wall_s']} (joined after {time.perf_counter() - t0:.1f} s "
          f"of waiting) memory {json.dumps(mem)}")
    print(f"mesh 8 (c): collectives over the full-depth step (bytes a rank "
          f"receives) {json.dumps(rec['collectives_full'])}")
    print(f"mesh 8 (c): roofline terms, model estimates from the H100 data "
          f"sheet's constants {json.dumps(rec['chip'])}, not measurements: "
          f"{json.dumps(rec['roofline'])}")
    if rec["status"] != "ok" or \
            mem["argument_bytes"] != DRYRUN_ARGUMENT_BYTES:
        fail(f"the dry run's argument bytes {mem['argument_bytes']} are not "
             f"the reference's {DRYRUN_ARGUMENT_BYTES}")


def mesh_agreement(dev, mesh):
    """8 (b): the reduced gemma2-2b, one f32 train step (4 microbatches)
    through ``shard_train_step`` on the card and on the CPU from the same
    parameters and batch: the loss within 1e-5 relative, Adam's first
    moment (0.1 of the gradient, read before the update moves anything)
    within ``GRAD_AGREE`` of its largest entry, leaf by leaf.  Then its f32
    serve step through ``shard_serve_step`` on the card and on the CPU from
    the same state, ``MESH_SERVE_AGREE`` steps: the logits of every step
    within 1e-5 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.sharding import specs as S
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(MESH_ARCH).reduced()
    fn, _, _, p_sp, o_sp = ST.build_train_step(
        cfg, mesh, bf16_forward=False, microbatches=MESH_MICROBATCHES)
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, MESH_AGREE, dtype=np.int32))
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda t: t.to(d, copy=True), cpu)
        batch = {"tokens": toks.to(d)}
        step = ST.shard_train_step(fn, mesh, p_sp, o_sp,
                                   S.lm_input_specs(batch, mesh))
        _, opt, met = step(params, get_optimizer("adam", 3e-4).init(params),
                           batch)
        out[where] = (float(met["loss"]), [m.cpu() for m in leaves(opt["m"])])
    (l_card, m_card), (l_cpu, m_cpu) = out["card"], out["cpu"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(m_card, m_cpu))
    ok = loss_err <= 1e-5 and worst <= GRAD_AGREE
    print(f"mesh 8 (b): {cfg.name} f32 train step ({MESH_AGREE[0]} x "
          f"{MESH_AGREE[1]} tokens, {MESH_MICROBATCHES} microbatches) card "
          f"vs CPU: loss {l_card:.7f} vs {l_cpu:.7f} rel_err={loss_err:.3e} "
          f"tol=1e-5; Adam's first moment, worst leaf {worst:.3e} of its "
          f"largest, tol={GRAD_AGREE:g}; ok={ok}")
    if not ok:
        fail("the sharded train step on the card disagrees with the CPU")

    fn, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
    SB, steps, W = MESH_SERVE_AGREE
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (steps, SB), dtype=np.int32))
    state = T.init_decode_state(cfg, SB, W, device="cpu")
    s_sp = S.decode_state_specs(state, cfg, mesh, SB)
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda t: t.to(d, copy=True), cpu)
        st = tree_map(lambda t: t.to(d, copy=True), state)
        step = ST.shard_serve_step(fn, mesh, p_sp, s_sp)
        with torch.no_grad():
            out[where] = [step(params, st, toks[pos].to(d), pos)[0].cpu()
                          for pos in range(steps)]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(out["card"], out["cpu"]))
    ok = worst <= 1e-5
    print(f"mesh 8 (b): {cfg.name} f32 sharded serve step, batch {SB}, "
          f"{steps} steps, cache {W}: card vs CPU logits, worst step "
          f"{worst:.3e} of its largest, tol=1e-5; ok={ok}")
    if not ok:
        fail("the sharded serve step on the card disagrees with the CPU")


def mesh_long(dev, mesh, params, cfg):
    """8 (d): ``cfg`` (gemma2-2b at full width) serving long_500k on the
    one card through ``shard_serve_step`` (``profile_mesh.serve_long``: the
    whole cache, random bf16 keys and values, 16 steps at its last
    positions), then the attention merge at the production mesh's piece
    size (``profile_mesh.merge_check``) on one global layer's cache."""
    from repro_torch.launch.profile_mesh import (LONG_STEPS, MERGE_PIECES,
                                                 merge_check, serve_long)
    t0 = time.perf_counter()
    ms, peak, finite, state = serve_long(cfg, mesh, params, dev)
    glob = state["stages"][1]                 # (LOCAL_ATTN, ATTN)
    k, v = glob["k"][0], glob["v"][0]
    print(f"mesh 8 (d): {cfg.name} long_500k serve step, batch 1, the whole "
          f"{k.shape[1]:,}-slot cache on the card ({k.numel() * 2 * 2 / 1e9:.2f}"
          f" GB of K and V a global layer): {LONG_STEPS} steps, ms a step "
          f"median {statistics.median(ms[1:]):.2f} (each "
          f"{', '.join(f'{t:.1f}' for t in ms)}); peak_memory_GB="
          f"{peak / 1e9:.2f}; finite={finite}")
    if not finite:
        fail("mesh 8 (d): the long_500k serve step's logits are not finite")
    q = torch.randn((1, 1, cfg.num_heads, cfg.head_dim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    dtype=torch.float32).to(k.dtype)
    for pos in MESH_LONG_MERGE_POS:
        err, empty = merge_check(cfg, k, v, q, pos)
        ok = err <= 1e-5 and (pos < k.shape[1] - 1 or empty == 0) and \
            (pos == k.shape[1] - 1 or empty > MERGE_PIECES // 2)
        print(f"mesh 8 (d): merge of {MERGE_PIECES} pieces of "
              f"{k.shape[1] // MERGE_PIECES:,} slots at pos {pos:,} ({empty} "
              f"empty) against one piece, f32: {err:.3e} of the largest, "
              f"tol=1e-5; ok={ok}")
        if not ok:
            fail("mesh 8 (d): the merged attention disagrees with the whole")
    del state, k, v, glob
    print(f"mesh 8 (d): {time.perf_counter() - t0:.1f} s")




def phase_mesh(dev, kernels, dry):
    """The mesh layer (phase 8): gemma2-2b's production steps at full width
    and depth on the host mesh (a), the reduced model card vs CPU (b), and
    (c) the production-mesh dry run ``dry`` (``start_mesh_dryrun``, started
    beside phases that print no time) joined and checked."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import specs as S
    from repro_torch.tree import leaves
    torch.cuda.empty_cache()
    mesh = M.make_host_mesh()
    print(f"mesh 8: host mesh {mesh} over process group backend "
          f"{dist.get_backend()}, world {dist.get_world_size()}")
    cfg = get_config(MESH_ARCH)
    B, Sq = MESH_TRAIN
    fn, p_st, _, p_sp, o_sp = ST.build_train_step(
        cfg, mesh, optimizer="adam", bf16_forward=True,
        microbatches=MESH_MICROBATCHES)
    n = sum(t.numel() for t in leaves(p_st))
    # f32 masters, Adam's m and v, the gradients (and the update's new m,
    # v and updates while the old ones live), the bf16 copy
    print(f"mesh 8 (a): {cfg.name} {n:,} parameters; reckoned: f32 "
          f"parameters + m + v + gradients {16 * n / 1e9:.1f} GB, the "
          f"update's new m, v and updates {12 * n / 1e9:.1f} GB more, the "
          f"bf16 copy {2 * n / 1e9:.1f} GB; of {M.hbm_bytes(dev) / 1e9:.1f} "
          f"GB")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_model(cfg, gen, dev)
    opt = get_optimizer("adam", 3e-4).init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, Sq), device=dev,
                                     generator=gen, dtype=torch.int32)}
    b_sp = S.lm_input_specs(batch, mesh)
    params = S.shard_tree(params, p_sp, mesh)    # a world of one: views
    opt = S.shard_tree(opt, o_sp, mesh)
    step = ST.shard_train_step(fn, mesh, p_sp, o_sp, b_sp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    coll.reset_counts()
    times, losses = [], []
    for _ in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))     # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"mesh 8 (a): train step {B} x {Sq} tokens, "
          f"{MESH_MICROBATCHES} microbatches, Adam, bf16 forward: ms a step "
          f"{', '.join(f'{t:.1f}' for t in times)} (the first with warm-up);"
          f" peak_memory_GB={peak:.2f}; losses "
          f"{', '.join(f'{l:.4f}' for l in losses)}")
    print(f"mesh 8 (a): launches {json.dumps(counts)}; collectives "
          f"{json.dumps(coll.counts())}")
    if not all(map(math.isfinite, losses)):
        fail("mesh 8 (a): a loss is not finite")
    least = cfg.num_layers * MESH_MICROBATCHES * MESH_TRAIN_STEPS
    for name in ("flash_attention", "flash_attention_backward"):
        if counts[name] < least:
            fail(f"mesh 8 (a): {name} launched {counts[name]} times, fewer "
                 f"than {least} ({cfg.num_layers} a microbatch)")
    del opt, met
    torch.cuda.empty_cache()

    prefill, _, p_sp = ST.build_prefill_step(cfg, mesh)
    PB, PS = MESH_PREFILL
    toks = {"tokens": batch["tokens"][:PB, :PS]}
    prefill = ST.shard_prefill_step(prefill, mesh, p_sp,
                                    S.lm_input_specs(toks, mesh))
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        prefill(params, toks)                 # warm-up
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits = prefill(params, toks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    pre = launches_since(kernels, before)
    ok = bool(torch.isfinite(logits).all()) and \
        logits.shape == (PB, PS, cfg.vocab_size)
    print(f"mesh 8 (a): sharded prefill step {PB} x {PS}: ms "
          f"{', '.join(f'{t:.1f}' for t in ms)} (unsharded: "
          f"{MESH_UNSHARDED_MS[0]}) peak_memory_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} logits "
          f"{tuple(logits.shape)} finite={ok}; flash_attention launches "
          f"{pre['flash_attention']} over 4 calls")
    if not ok:
        fail("mesh 8 (a): the prefill's logits are not finite")
    if pre["flash_attention"] < 4 * cfg.num_layers:
        fail(f"mesh 8 (a): the prefill launched flash_attention "
             f"{pre['flash_attention']} times in 4 calls, fewer than once "
             f"a layer")
    for name in ("flash_attention", "flash_attention_backward"):
        counts[name] += pre[name]
    del logits

    serve, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
    SB, steps = MESH_SERVE
    state = T.init_decode_state(cfg, SB, Sq, device=dev)
    serve = ST.shard_serve_step(serve, mesh, p_sp, S.decode_state_specs(
        state, cfg, mesh, SB))
    tok = batch["tokens"][:SB, 0]
    ms = []
    with torch.no_grad():
        for pos in range(steps):
            t0 = time.perf_counter()
            logits, state = serve(params, state, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    ok = bool(torch.isfinite(logits).all())
    print(f"mesh 8 (a): sharded serve step batch {SB}, {steps} steps: ms a "
          f"step median {statistics.median(ms[1:]):.2f} (unsharded: "
          f"{MESH_UNSHARDED_MS[1]}) (each "
          f"{', '.join(f'{t:.1f}' for t in ms)}) finite={ok}")
    if not ok:
        fail("mesh 8 (a): the serve step's logits are not finite")
    del state, logits, batch
    torch.cuda.empty_cache()

    mesh_long(dev, mesh, params, cfg)
    del params
    torch.cuda.empty_cache()

    mesh_agreement(dev, mesh)
    finish_mesh_dryrun(dry)
    dist.destroy_process_group()
    return {name: counts[name] for name in
            ("flash_attention", "flash_attention_backward")}


def _analysis_workload(dev, root):
    """9 (c)'s workload, run on a thread of its own: the CPR manager's
    sharded, asynchronous fleet on the card under injected failures (the
    tracker kernel's backend), then a socket fleet of CUDA tables over
    shard servers on threads, one shard killed and re-admitted.  Raises
    on a failed check, for the main thread to report."""
    from repro_torch import core as C
    from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
    from repro_torch.data.synthetic import ClickLogDataset
    from repro_torch.launch import shard_server
    cfg = scaled(DLRM_KAGGLE, max_rows=2000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=4000, seed=3)
    p = C.SystemParams()
    mgr = C.CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                       sharded_save=True, async_save=True,
                       tracker_backend="kernel",
                       directory=str(root / "manager"), device=dev)
    C.Emulator(cfg, ds, mgr, C.FailureInjector(2, 0.25, p.N_emb, p.T_total,
                                               seed=11),
               batch_size=256, device=dev).run(max_steps=ANALYSIS_STEPS)
    failures = sum(h["event"] == "failure" for h in mgr.history)
    if not failures:
        raise RuntimeError("the manager saw no failure")

    ready, addr = threading.Event(), {}

    def bound(h, port):
        addr["hp"] = (h, port)
        ready.set()

    threading.Thread(target=shard_server.serve, args=("127.0.0.1", 0, bound),
                     name="chip-smoke-shard-server", daemon=True).start()
    if not ready.wait(10.0):
        raise RuntimeError("the shard server did not bind")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = [torch.randn(n, cfg.emb_dim, generator=gen, device=dev)
              for n in cfg.table_sizes]
    accs = [torch.rand(n, generator=gen, device=dev)
            for n in cfg.table_sizes]
    spec = C.EmbShardSpec(cfg.table_sizes, ANALYSIS_SHARDS)
    fleet = C.ShardedCheckpointWriter(
        tables, accs, spec, directory=str(root / "socket"), backend="socket",
        addresses=[addr["hp"]] * ANALYSIS_SHARDS, delta_saves=True,
        drain_timeout=30.0)
    fleet.save_full([t + 1 for t in tables], [a + 1 for a in accs], step=1)
    fleet.fence()
    fleet.kill_shard(1)
    fleet.save_full([t + 2 for t in tables], [a + 2 for a in accs], step=2)
    try:
        fleet.fence()
    except C.ShardSaveError as e:
        refused = sorted(e.shard_errors)
    else:
        refused = []
    if refused != [1]:
        raise RuntimeError(f"the fence after the kill refused shards "
                           f"{refused}, not [1]")
    back = fleet.readmit([t + 2 for t in tables], [a + 2 for a in accs],
                         step=3)
    fleet.fence()
    got, _, _ = fleet.restore_all()
    fleet.close()
    same = all(np.array_equal(g, (t + 2).cpu().numpy())
               for g, t in zip(got, tables))
    print(f"analysis 9 (c): manager cpr-mfu, {ANALYSIS_STEPS} steps, "
          f"{failures} failure(s); socket fleet of {len(tables)} tables on "
          f"{dev} over {ANALYSIS_SHARDS} shard servers on threads: shard 1 "
          f"killed, re-admitted {back}, image equal after the re-admission="
          f"{same}")
    if back != [1] or not same:
        raise RuntimeError("the socket fleet's re-admission failed")


def phase_analysis(dev, kernels):
    """The port's invariant tools on the card host (phase 9)."""
    from repro_torch.analysis import CHECKERS, run_analysis
    from repro_torch.analysis.lockorder import LockOrderSanitizer
    from repro_torch.analysis.protocol import model
    from repro_torch.analysis.protocol.fuzz import run_fuzz
    shutil.rmtree(SCRATCH / "analysis", ignore_errors=True)
    (SCRATCH / "analysis").mkdir(parents=True)
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    report = run_analysis()
    counts = report.to_json()["counts"]
    print(f"analysis 9 (a): {len(CHECKERS)} rules over {report.root}: "
          f"{report.files_scanned} file(s), {counts['total']} finding(s), "
          f"{counts['suppressed']} suppressed, {counts['unsuppressed']} "
          f"unsuppressed ({time.perf_counter() - t0:.2f} s)")
    if len(CHECKERS) != 7 or not report.ok:
        fail("analysis 9 (a): the port's rules do not hold over the port:\n"
             + "\n".join(f.render() for f in report.unsuppressed))

    t0 = time.perf_counter()
    base = model.explore(model.FAST)
    caught = {name: model.explore(model.FAST, mutant=name)
              for name in sorted(model.MUTANTS)}
    rc = model.run_check(fast=True, quiet=True)
    print(f"analysis 9 (b): model check (fast): baseline {base.states} "
          f"states / {base.transitions} transitions, violation "
          f"{base.violation}; mutants caught: "
          + ", ".join(f"{n} [{r.violation.invariant if r.violation else None}"
                      f", trace {len(r.trace)}]" for n, r in caught.items())
          + f"; run_check {rc} ({time.perf_counter() - t0:.2f} s)")
    if rc != 0 or base.violation is not None or not all(
            r.violation is not None for r in caught.values()):
        fail("analysis 9 (b): the model check failed")

    # installed before the workload builds anything, so every lock the
    # port's source constructs in it is tracked
    t0 = time.perf_counter()
    san = LockOrderSanitizer()
    sites = set()
    wrap = san.wrap

    def recording(inner, site):
        sites.add(site)
        return wrap(inner, site)

    san.wrap = recording
    kernels.reset_launches()
    errors = []

    def work():
        try:
            _analysis_workload(dev, SCRATCH / "analysis")
        except BaseException as e:   # reported by the main thread below
            errors.append(e)
            raise

    san.install()
    try:
        worker = threading.Thread(target=work, name="chip-smoke-analysis",
                                  daemon=True)
        worker.start()
        worker.join(ANALYSIS_LIMIT_S)
    finally:
        san.uninstall()
    launches = dict(kernels.LAUNCHES)
    if worker.is_alive():
        print(f"chip_smoke: analysis 9 (c): the workload did not end within "
              f"{ANALYSIS_LIMIT_S:.0f} s", file=sys.stderr, flush=True)
        sys.stdout.flush()
        _stop_background()
        os._exit(1)             # the hung thread would block a normal exit
    if errors:
        fail(f"analysis 9 (c): the workload failed: {errors[0]!r}")
    edges = san.edges()
    cycle = san.find_cycle()
    print(f"analysis 9 (c): {san.tracked_constructions} tracked "
          f"construction(s) at {len(sites)} site(s): {sorted(sites)}")
    print(f"analysis 9 (c): {len(edges)} ordered edge(s): "
          + "; ".join(f"{a} -> {b} ({th})" for (a, b), th in
                      sorted(edges.items()))
          + f"; cycle {cycle}; launches {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.2f} s)")
    missing = [s for s in ANALYSIS_SITES
               if not any(x.startswith(s + ":") for x in sites)]
    if missing:
        fail(f"analysis 9 (c): no lock tracked from {missing}")
    if cycle is not None:
        fail(f"analysis 9 (c): lock-order cycle {cycle}")
    for name in ("tracker_select", "row_hash", "embedding_bag"):
        if launches[name] == 0:
            fail(f"analysis 9 (c): {name} was not launched under the "
                 f"sanitizer")

    t0 = time.perf_counter()
    stats = run_fuzz(frames=FUZZ_FRAMES, seed=0,
                     root=str(SCRATCH / "analysis" / "fuzz"), device=dev)
    print(f"analysis 9 (d): fuzz of the port's shard server, the fleet's "
          f"tables on {dev}: {json.dumps(stats)} "
          f"({time.perf_counter() - t0:.2f} s)")
    if not stats["ok"] or stats["frames"] < FUZZ_FRAMES or \
            stats["replies"].get("stale", 0) < 1:
        fail("analysis 9 (d): the fuzz's stats fall short")
    shutil.rmtree(SCRATCH / "analysis", ignore_errors=True)
    print(f"analysis 9: {time.perf_counter() - t_phase:.2f} s")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    t_start = time.perf_counter()
    from repro_torch import kernels, resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import row_hash as rh
    from repro_torch.kernels import ssu_dedupe as sd
    from repro_torch.kernels import tracker_select as ts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    out_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {out_dir}")
    for log in sorted(out_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")
    for name in ("flash_attention_bf16", "flash_attention_backward_bf16"):
        lib = out_dir / f"lib{name}.so"
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(lib)], capture_output=True, text=True, check=True).stdout
        n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
        print(f"  {lib.name}: {n_hgmma} HGMMA (wgmma) instructions in its "
              f"SASS")
        if not n_hgmma:
            fail(f"the {name} kernels have no tensor-core instructions")

    def phase_done(name):
        print(f"phase {name} done at {time.perf_counter() - t_start:.1f} s")

    rows = phase_kernels(dev, eb, ts, sd, ref)
    rows["row_hash"] = phase_row_hash(dev, rh, ref)
    phase_done("2")
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    launches = phase_main_path(dev, kernels, DLRM_KAGGLE)
    phase_done("3")
    # beside phase 4, which prints no time
    background = [start_fleet_figure(n) for n in ("fig16", "fig17")]
    phase_agreement(dev)
    torch.cuda.empty_cache()
    harness_hashes = sum(finish_fleet_figure(h) for h in background)
    phase_done("4")
    # the LM kernels' checks and one-call times before the harness and the
    # fleets (phases 5-6), whose processes and threads leave the host
    # busier: late in the script a one-call time read up to 0.05 ms more
    # host path (PERF.md section 6, PR 21)
    print(f"python threads alive: {threading.active_count()}")
    rows.update(phase_lm_kernels(dev, ops, ref))
    phase_done("2b")
    rows.update(phase_lm_backward(dev, ops, ref))
    phase_done("2c")
    phase_harness(dev, kernels, DLRM_KAGGLE)
    torch.cuda.empty_cache()
    phase_done("5")
    harness_hashes += phase_fleet_figures(dev, kernels, DLRM_KAGGLE)
    torch.cuda.empty_cache()
    phase_done("6")
    print(f"python threads alive: {threading.active_count()}")

    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import ARCH
    from repro_torch.models import transformer as T
    lm = get_config(ARCH)
    params, lm_launches = phase_serving(dev, kernels, lm)
    phase_done("3b")
    phase_lm_agreement(dev, params, lm, lm.reduced())
    del params
    torch.cuda.empty_cache()
    phase_done("4b")
    from repro_torch.launch.profile_encoder import ARCH as HUBERT_ARCH
    hubert = get_config(HUBERT_ARCH)
    hubert_launches = phase_hubert(dev, kernels, hubert)
    phase_done("3h")
    vlm = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    params, vlm_launches = phase_vlm_serving(dev, kernels, vlm)
    del params                  # 4v draws them again, after the MoE's
    torch.cuda.empty_cache()
    phase_done("3v")
    moe = get_config(MOE_ARCH)
    params, moe_launches = phase_moe_serving(dev, kernels, moe)
    phase_done("3m")
    # beside 4m, 4h, 4v, 4x and 7 (b, c), which print no time; so is
    # 8 (c), the production mesh's dry run, which phase 8 joins
    fig15 = start_fleet_figure("fig15")
    dry = start_mesh_dryrun()
    phase_moe_agreement(dev, params, moe)
    del params
    torch.cuda.empty_cache()
    phase_done("4m")
    phase_hubert_agreement(dev, kernels, hubert)
    phase_done("4h")
    params = T.init_model(vlm, torch.Generator(device=dev).manual_seed(0),
                          dev)
    phase_vlm_agreement(dev, params, vlm)
    del params                  # phase 7's peak is 60.75 GB
    torch.cuda.empty_cache()
    phase_done("4v")
    xlstm = get_config(XLSTM_ARCH)
    phase_xlstm_agreement(dev, kernels, xlstm)
    phase_done("4x")
    phase_training_agreement(dev, kernels, lm)
    phase_done("7 (b, c)")
    harness_hashes += finish_fleet_figure(fig15)
    phase_done("6 (fig15's fleets)")
    train_launches = phase_training(dev, kernels, lm)
    phase_done("7")
    xlstm_launches = phase_xlstm_serving(dev, kernels, xlstm)
    phase_done("3x")
    xlstm_train_launches = phase_training(dev, kernels, xlstm,
                                          runs=TRAIN_RUNS[1:],
                                          steps=XLSTM_TRAIN_STEPS)
    phase_done("7x")
    mesh_launches = phase_mesh(dev, kernels, dry)
    phase_done("8")
    analysis_launches = phase_analysis(dev, kernels)
    phase_done("9")
    # launches on the main paths: the DLRM's (phase 3), serving's (3b, 3m,
    # 3v, 3x), the audio encoder's (3h), training's (7 (a), 7x), the mesh
    # layer's steps (8 (a)) and the sanitized fleet's (9 (c)), each counted
    # from 0 around its run
    for counts in (lm_launches, moe_launches, vlm_launches, hubert_launches,
                   train_launches, xlstm_launches, xlstm_train_launches,
                   mesh_launches, analysis_launches):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    sources = {"embedding_bag": "embedding_bag.cu",
               "embedding_bag_backward": "embedding_bag.cu",
               "tracker_select": "tracker_select.cu",
               "ssu_dedupe_evict": "ssu_dedupe.cu",
               "row_hash": "row_hash.cu",
               "flash_attention": "flash_attention_bf16.cu",
               "flash_attention_backward": "flash_attention_backward_bf16.cu",
               "rglru_scan": "rglru_scan.cu",
               "rglru_scan_backward": "rglru_scan_backward.cu"}
    replaces = {"embedding_bag": "src/repro/kernels/embedding_bag.py:44",
                "embedding_bag_backward": "src/repro/models/dlrm.py:82",
                "tracker_select": "src/repro/kernels/tracker_select.py:112",
                "ssu_dedupe_evict": "src/repro/kernels/ssu_dedupe.py:59",
                "row_hash": "src/repro/kernels/row_hash.py:71",
                "flash_attention": "src/repro/kernels/flash_attention.py:90",
                "flash_attention_backward": "src/repro/models/layers.py:221",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:53",
                "rglru_scan_backward": "src/repro/models/rglru.py:64"}
    rows["row_hash"]["harness_launches"] = harness_hashes
    line = [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{sources[name]}",
             "replaces": replaces[name], "launches": launches[name],
             **rows[name]} for name in sources]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-figure"]:
        fleet_figure_main(*sys.argv[2:4])
    else:
        main()
