#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no result line, non-zero exit):

1. build  -- compile the Z-order matmul kernel (K1: its wide, thin and
   wmma/fma sources, one nvcc each), the flash-attention kernel (K2), the
   split-KV decode-attention kernel (D1) and the routed MoE experts kernel
   (M1) from their ``csrc/``, all at once, and print ptxas's registers and
   spills.
2. kernel -- K1 against its plain version on the card at every (M, K, N)
   Llama-3.2-1B's serving path gives it (M in 4, 8, 64, 256), ragged shapes
   and shapes on both sides of each route threshold (m = 16 | 17,
   ``THIN_MAX_M`` | + 1), fp32 (1e-4 relative) and bf16 (2e-2 relative):
   each shape's route is logged and must be the one meant for it (wide,
   thin, wmma or fma), both tile orders and a second launch must agree
   bitwise.  Then K1's time per bf16 shape beside its bound, the plain
   version's time and ``torch.matmul``'s (the yardstick, which the port
   never calls), and the thin and wide routes (both wide tiles) side by
   side at M = 64-256, the measurement that sets ``THIN_MAX_M``.  Times
   are CUDA-event times of CUDA-graph replays, cycling through enough
   copies of the weight matrix that it comes from device memory, not L2,
   as in decoding.  Last, K1 reading an operand stored transposed at the
   shapes the paths give it (``LAYOUT_ROWS``): the unembedding of Llama's
   tied head (Bᵀ, fp32 out) at a batch-4 decode step and the 8 x 256
   training forward, the training backward's dA (Bᵀ) and dB (Aᵀ) at each
   layer product at 2048 tokens: each within ``ROW_TOL`` of the plain
   version on the same views, the same storage read as row-major landing
   outside it, and timed beside its bound, the plain version and the
   library call (``torch.mm(..., out_dtype=float32)`` for fp32 out, and for
   the unembedding also the upcast and fp32 ``torch.matmul`` it replaced;
   ``torch.matmul`` on the same views for bf16 out).
3. model  -- a full-width, 2-layer Llama-3.2-1B in fp32: prefill + one
   decode step on the card through K1 and on the CPU through the plain
   version with the same weights; logits agree to 1e-3 relative.
4. serve  -- the full Llama-3.2-1B (16 layers, bf16, random weights from a
   seeded generator) behind ``Server``: warmup over buckets (4,16) and
   (8,32), each bucket run eagerly once and its prefill and decode step
   captured as CUDA graphs; then ``generate`` on 4 variable-length prompts
   with 16 new tokens, twice, by graph replays, with identical tokens,
   each run replaying K1 exactly 113 x 16 times (7 projections x 16
   layers and the unembedding per forward, 1 prefill + 15 decode steps;
   counted as replays x
   each graph's launches at capture), all on the thin route; the eager
   path (``runtime.serve.decode_loop`` on the same bucket-padded batch)
   gives the same tokens bitwise.
   Prints TTFT, p50/p99 per-token latency and tokens/s for both, and the
   device time of one prefill and one decode step (CUDA-graph replays).
   K1's count on this main path runs from 0 before the server is built.
   So does D1's: one launch a layer in each eager decode step (``d1_per_step``;
   none for MLA), none in a one-pass prefill, none from Python in a
   replayed run; and M1's (``m1_per_forward``): one launch set an MoE layer
   and dispatch slice in each eager bf16 prefill and decode step (none for
   a dense model), none from Python in a replayed run.
5. flash-kernel -- K2 against its plain version on the card on each of
   its three routes (``FLASH_CHECKS``): head dims 16-128 (Llama's 64,
   zamba2's 80, danube's 120, 128), GQA groups 1, 2 and 4, ragged S_q and
   S_kv, S_q > S_kv with a window (rows that see no key output 0), windows
   64, 200, 4032 and 4096, head slices of a fused tensor and the (BH, S, D)
   entry, and one K/V head broadcast to two (a head stride of 0, which TMA
   cannot read, so the mma route takes it); fp32 on the fma route, bf16 on
   the route ``kernel.route`` picks (wgmma for D >= 64 where TMA reads the
   tensors, mma otherwise) and, where that is wgmma, on the mma
   route too; each case's route is asserted and the wgmma route rerun
   bitwise.  Then K2 at the long-prefill shapes (S = 32768, danube's
   D = 120 with a 4096 window and Llama's D = 64 causal), bf16: both bf16
   routes held against the plain version (run head by head: all heads'
   scores at once would take 137 GB) and timed in turns beside the bound,
   the exp floor, the plain version's time and
   ``F.scaled_dot_product_attention``'s (the yardstick, with its backend
   named; the port never calls it).  Also K1 at the 7 projections of a
   danube layer at M = 32768 (the wide route): held against its plain
   version and timed beside ``torch.matmul``, its bound and the wide
   route's other tile (128 x 128).  Every kernel check holds each
   output row (the last dim) to a relative L2 error: ``ROW_TOL``.
6. long-prefill -- full-width h2o-danube-3-4b (24 layers, bf16, random
   weights from a seeded generator) with ``attn_impl="flash"``: ``forward``
   and ``loss`` on 32768 tokens, 24 K2 and 169 K1 launches per forward,
   every K2 launch on the wgmma route and every K1 launch on the wide route;
   logits of shape (1, 32768, 32000), finite, and within
   ``PREFILL_LOGITS_TOL`` of the same forward through the plain attention
   (``attn_impl="xla"``), while two wrong attention cores (the window
   ignored; the window one 64-key tile short) must land outside it; a
   every distinct K1 call of the forward (the unembedding's, 32768 x 3840
   x 32000 into fp32, among them) within ``ROW_TOL`` of the plain version
   at its own shape, blocks and layouts; a 2-layer full-width fp32 danube
   at S = 8192 within 1e-4 of the xla route; the forward's device time,
   K1's and K2's share and prefill tokens/s.
7. plan-sweep -- the plan engine (``repro_torch.plan``): every strategy
   pinned through ``symmetric_matmul``, staged and overlapped where the
   lowering has both, on single-controller meshes whose ranks are threads
   of this process on the one card (``PLAN_SWEEP_CELLS``: cannon, summa,
   ring_ag, ring_rs on 2x2; the rings on 4; cannon25d, pod25d and fattree
   on 2x2x2; the pod25d slab on 2), at danube's gate/up product
   (``PLAN_SWEEP_SHAPE``, bf16).  Each output row within ``PLAN_ROW_TOL`` of
   K1 alone on the same operands, every rank's product on the K1 route
   ``kernel.route`` names for its shape; two wrong programs (Cannon without
   its B skew, ring_ag writing each chunk to the wrong row slot) must land
   outside the limit.  Device ms by CUDA events against K1 alone, the
   operands' scatter alone, and the plan's cost words beside the bytes the
   collectives copied, which the untimed check run accounts for through
   the plan's trace (``repro_torch.verify``): for ppermute and all_gather
   the copied bytes must equal the trace's words times the element size
   each call carried, phase by phase (placement skew, movement, gather);
   psum is printed in both conventions (the copies into each rank, the
   trace's ring all-reduce), with no limit.  Each rank runs on its own
   compute and copy streams.  Each cell is also captured in a CUDA graph
   (the rank streams its branches) and replayed: the replay's bits equal
   the eager run's, and its device time (the least of 3 replays) puts each
   staged and overlapped twin side by side without the host's barriers.
   Each cell whose body defers its ppermutes is bitwise the same body with
   each done moved right after its start (patched here only) and, for
   cannon and cannon25d, the staged body.  Those cells and the staged
   cannon on 2x2 are profiled once, ``HIDE_PRODUCTS`` products queued
   behind ``HIDE_SLEEP_S`` of device sleep so the host's barriers are off
   the device's timeline: each cell's hidden share, the share of each rank's
   prefetch-copy device time that lies under a K1 kernel of the same rank.
   cannon+ov's must be above 0, and above a control whose dones follow
   their starts at once.
8. planned-serve -- phase 4's workload through ``Server(mesh=2x2)``, each
   bucket's steps captured with the rank streams as the graphs' branches
   and replayed: identical tokens across two runs and
   to the eager planned path on the same padded batch (bitwise), the planned
   prefill's last-token logits within ``PLANNED_LOGITS_TOL`` per row of
   ``mesh=None`` (a ring_rs reducing the wrong way round must land
   outside), token agreement with ``mesh=None`` printed, the strategies
   taken, K1 launches by route, TTFT, p50/p99, tokens/s for both, and one
   decode step's device time by CUDA events, planned and not, and as a
   captured planned step, printed beside this script's earlier reading
   with every rank on one stream.  A failed capture fails the run.
9. planned-prefill -- phase 6's danube forward at S = 32768 on the 2x2
   mesh: all 168 products planned, the strategy counts, K1 launches all
   wide and K2's 24 all wgmma; logits within ``PREFILL_LOGITS_TOL`` per row
   of the unplanned forward, with Cannon without its B skew and the
   wrong-way ring_rs (each in every product of its strategy) outside;
   device ms against the unplanned forward and against the planned forward
   with every rank on the caller's stream (patched here only), in turns.
10. conformance -- the conformance checker (``repro_torch.verify``) over
   the executed schedules, every leg fatal: ``run_matrix`` on the card
   (every catalog cell up to 16 ranks, square, ragged and batched, fp32
   and bf16, staged and overlapped), every row ok; every plan phases 7-9
   left in the plan cache (the sweep's, Llama's on 2x2, danube's on 2x2)
   passes ``check(plan, measure=True)``; one planned Llama decode step and
   one planned danube forward at S = 32768 under ``intercept()`` execute
   exactly the summed traces of the plans they ran; a swapped movement
   permutation is caught statically and, executed on the card, at the
   interceptor, and so is Cannon without its B skew.  Seconds per leg
   and K1's launches by route.  Only this phase and phase 7's untimed
   check run go through the interceptor; no timed run does.

11. calibrate + tune -- ``python -m repro_torch.launch.perf_probe`` (its
   ``main``) on a 2x2 rank-thread mesh: ring ppermutes per axis and a
   local copy fitted to α–β, K1's peak at 8192^3 bf16, and the K1
   autotune over Llama's serving shapes (unplanned decode and prefill, and
   each planned product's per-rank block product on 2x2), every compiled
   block shape x both orders, each candidate's first call held against
   the plain version, a winner kept only if it beats the default blocks by
   more than the timing noise; the profile (platform and device kind the
   card's, links labelled as device copies between rank threads) and the
   table (keyed by the card's name) saved to ``chiprun_out/``; each
   winner's blocks, order, route and time beside ``default_blocks``' at
   the same shape; ``Server(mesh=2x2, tuning=tuner)`` captured, its tokens
   identical across two runs and to the eager tuned planned path
   (bitwise); every K1 call of that eager run at its own shape, blocks
   and order (each a tuned plan's) within ``ROW_TOL`` of the plain
   version; its prefill and every decode step's logits, fed the same
   tokens, within ``PLANNED_LOGITS_TOL`` per row of the untuned planned
   path's; and ``build_plan(profile=)``'s strategy at Llama's and danube's
   shapes beside the TPU constants' picks.
12. obs + drift -- ``check_drift(device=cuda)`` with phase 11's profile as
   the stored one: on each of the 7 drift cells the obs, interceptor and
   trace multisets are equal, and no ranking or tuning flip; then, under
   ``obs.observe()``, one ``generate`` of phase 4's workload (its warmup
   included) and one planned bf16 product per drift cell, each cell's obs
   multiset equal to its trace; the Perfetto trace and the metrics
   snapshot written to ``chiprun_out/``.
13. profiler -- one unplanned and one planned (2x2) danube forward at
   S = 32768 under ``torch.profiler`` (no timed window is profiled):
   device time by kernel name into K1, K2 and the rest, the rest named by
   its top kernels and operators, the unembedding (one K1 launch, read
   through a ``record_function`` range; no ``aten::mm``), and the planned
   forward's accumulate chain (fp32 zero, fp32 add, cast) and device copies
   beside the unplanned forward's; both traces saved gzipped to
   ``chiprun_out/``; then the unembedding of 32768 hidden states alone
   through K1 and as the upcast and fp32 ``torch.matmul`` it replaced.
14. train -- the training path, every leg fatal: (a) K1's registered op
   (``torch.ops.repro_torch.zorder_matmul``, differentiable) at each of
   Llama's 7 projections at 2048 tokens,
   bf16: the forward, dA = dC B^T and dB = A^T dC held per row to the
   plain version on the same CUDA tensors (``ROW_TOL``), every launch on
   the wide route, each product timed on the operands the path gives it
   (the backward's Bᵀ and Aᵀ are views, read in place) beside the plain
   version, ``torch.matmul`` and its bound;
   (b) one fp32 step of a 2-layer full-width Llama on the card and on the
   CPU, the same weights and batch: the loss and every master leaf's
   gradient within ``TRAIN_GRAD_TOL`` (relative L2), every projection's
   gradient non-zero, while a control whose products detach K1's output
   lands outside the limit and the trainer refuses it; (c) the main path:
   ``python -m repro_torch.launch.train --arch llama3.2-1b --steps 10
   --batch 8 --seq 256 --ckpt <dir>`` (its ``main``), full width, bf16,
   each step after the first a replay of one CUDA graph of the whole step
   (``runtime.train.StaticStep``): the logged loss falls, K1 launches 337
   wide counted on the host for the eager first step and for the capture
   each (counts from 0 just before) and 337 for each of the 9 replays by
   the trainer's ``graph_report()``, the capture's seconds, a replay's
   host and device ms, the peak memory and the checkpoints' size; then the
   same run with ``--eager``: each step's loss within ``TRAIN_GRAD_TOL`` of
   the captured run's and its learning rate bitwise, 337 a step; then the
   same step timed eager (CUDA events: loss and gradients, optimizer; host
   clock; tokens/s) and replayed (CUDA events and host clock around each
   replay), and an eager step profiled (K1's device time beside its bound,
   the unembedding's K1 launch and its backward's two fp32 ``aten::mm``,
   the step's only ones); (d) the reference's ``train_4k`` cell cut to one
   sequence of 4096 tokens, ``remat="full"``: 3 steps captured and 3
   eager, finite and falling losses, 449 wide K1 launches a step (the
   layers' forward recomputed), the runs held to each other as in (c),
   peak memory; (e) the smoke Llama with a failure injected, captured: one
   restart and one capture (the restore writes into the donated state),
   a falling loss, the state right after the restore equal bit for bit to
   its checkpoint file; and the same run eager, held to it as in (c).
15. zoo-serve -- the MoE and MLA decoders, every leg fatal, each model
   freed before the next: (a) a full-width, 2-layer fp32 deepseek-moe-16b
   (its dense first layer and one MoE layer of all 64 experts) and
   minicpm3-4b (two MLA layers), prefill + one decode step on the card
   through K1 and on the CPU through the plain version, the same weights,
   logits within ``MODEL_TOL``; (b) the full deepseek-moe-16b (28 layers,
   bf16, random weights from a seeded generator) and (c) the full
   minicpm3-4b (62 layers) behind ``Server``, run as phase 4 runs Llama:
   tokens identical across two runs, a request served alone as in the
   batch, bitwise the eager path's on the same bucket-padded batch, K1
   replayed 7 x 28 + 1 = 197 and 7 x 62 + 1 = 435 times a forward (q, k,
   v, o or MLA's wq_a, wq_b, wkv_a, wo; the dense MLP or the shared
   experts; the unembedding), all thin; TTFT, p50 / p99, tokens/s, a step's device time by graph replay,
   peak memory; every distinct K1 call (shape, blocks, order, types) of
   one eager prefill and decode step at each bucket (M = 4, 8, 64, 256;
   thin and wide) against the plain version on fresh seeded operands
   within ``ROW_TOL``, and the batch-4 decode step's K1 calls timed beside
   ``torch.matmul``, the plain version and their bound (phase 2's way);
   the decode step's weight-read bound, deepseek's expert
   products alone (``moe.expert_ffn`` over the 27 MoE layers' weights,
   CUDA events) beside their bound, and one eager decode step profiled
   (K1 and the rest by kernel name, the unembedding's K1 launch; no
   ``aten::mm``).  The dense route's expert products are timed for the
   record: the served steps run the routed kernel M1 (phase 23), and
   MLA's cached path multiplies ``wkv_b`` in einsums, outside K1.
16. families -- the recurrent and encoder-decoder families, every leg
   fatal, each model freed before the next: (a) zamba2-2.7b (6 Mamba
   layers and the shared block), xlstm-350m (one mmm-s group) and
   seamless-m4t-medium (1 encoder + 1 decoder layer) at full width in
   fp32, card vs CPU, the same weights: the uncached forward's, the
   teacher-forced prefill's and one decode step's logits within
   ``MODEL_TOL``, K1 all fma; (b) the full zamba2-2.7b (54 layers) and
   xlstm-350m (24) behind ``Server``, run as phase 4 runs Llama (the
   prefill is one decode step a prompt token, captured whole): tokens
   bitwise equal across runs, alone and eager, K1 181 and 79 a step all
   thin, and measured as phase 15 measures the zoo (every distinct K1 call
   vs the plain version, the decode step's K1 timed beside ``torch.matmul``
   and its bound, the weight and state bound, a profiled step); (c) the
   full seamless-m4t-medium: ``encode`` of a seeded (4, 1024, 1024)
   source with K2 non-causal, ``prefill_cross``, 16 greedy steps; the xla
   route fed the same tokens within ``PREFILL_LOGITS_TOL`` per row, another
   source changes the tokens, K2 at the encoder's shape and every distinct
   K1 call vs the plain version; (d) the full zamba2 forward at 8192 tokens
   (``attn_impl="flash"``): K1 181 wide, K2 9 wgmma at head dim 80, within
   ``PREFILL_LOGITS_TOL`` of the xla route, profiled into K1, K2 and the
   SSD chunk scan, K2 at that shape vs its plain version and SDPA.
17. zoo-train -- every family trained, every leg fatal, each model freed
   before the next: (a) phase 14b's fp32 step, card vs CPU with the
   detached control, for zamba2-2.7b (6 Mamba layers and the shared
   block), xlstm-350m (mmm-s), deepseek-moe-16b (its dense layer and one
   MoE layer of all 64 experts), minicpm3-4b (2 MLA layers) and
   seamless-m4t-medium (1 + 1 layers, a seeded source), each under its
   config's remat policy; (b) one bf16 step of full-width zamba2 at 12
   layers, 2 x 512 tokens, under "none", "full" and "dots": K1 121, 145
   and 121 launches ("dots" recomputes no product; the unembedding's fp32
   backward runs outside K1), "dots" gradients
   within ``ROW_TOL`` of "none"'s, each mode's peak memory ("dots" below
   "none"); (c) the main path of this phase: ``launch.train.main(["--arch",
   "zamba2-2.7b", "--steps", "10", "--batch", "2", "--seq", "512"])``, full
   width and depth, bf16, ``remat="dots"``, captured (phase 14c's way):
   every logged loss finite, the last below the first, K1 541 a step all
   wide (counted on the host for the eager first step and the capture,
   counts from 0 just before; by ``graph_report()`` for each replay), a
   replay's host and device ms, the capture's seconds, peak memory; then
   its first ``ZOO_EAGER_STEPS`` steps with ``--eager``, each step's loss
   within ``TRAIN_GRAD_TOL`` of the captured run's and its learning rate
   bitwise, timed (host clock, CUDA events: loss and gradients vs
   optimizer, tokens/s), profiled (K1, the SSD scan's forward, the
   unembedding's K1 launch and its backward's two fp32 ``aten::mm``), and
   its K1 calls held against the plain version and timed beside
   ``torch.matmul`` and their bound; (d) the same for ``--arch xlstm-350m
   --steps 10 --batch 8 --seq 256`` (235 a step); (e) deepseek-moe-16b cut
   to 4 layers (its dense layer and 3 MoE layers) through ``Trainer.fit``,
   10 steps of 4 x 256, ``"dots"``, measured as (c) (85 a step).
18. sharded-train -- training on a mesh of rank threads on the card, every
   leg fatal: (a) one fp32 step of a full-width, 2-layer Llama-3.2-1B on
   the (data 2, model 2) mesh (``Trainer(mesh=)``'s step: every projection
   and both of its gradients a planned product, 3 x 14; the unembedding
   and its gradients K1 outside the plan engine) against
   ``mesh=None`` on the card, each master leaf's gradient within
   ``SHARD_GRAD_TOL`` (relative L2), while a planned backward that drops
   one product's dB lands outside it; (b) the main path of this phase:
   ``launch.train.main([..., "--tp", "2", "--ranks", "4"])``, the full
   Llama-3.2-1B, bf16 with fp32 masters placed by ``param_shardings``, 3
   steps of 8 x 256, captured: one CUDA graph of the whole step whose
   branches are the rank streams of every planned product, the backward's
   on autograd's device thread too (counts from 0 just before: the eager
   first step and the capture counted on the host, twice a step's, the
   replays by ``graph_report()``); the same through ``--eager`` for 2
   steps, each step's loss within ``SHARD_LOSS_GAP`` of the captured run's
   and its learning rate bitwise; and 3 captured steps through the
   launcher without a mesh: each step's loss within ``SHARD_LOSS_GAP``;
   in the eager run 336 planned products a step (112 forward, 224 in the
   planned backward) by strategy, no K1 product outside the rank threads
   but the unembedding's, once a step (never planned; Llama's remat
   "none" recomputes nothing), K1 launches a step by route; each rank's
   state bytes equal to what ``param_shardings`` predicts and the distinct
   blocks' to the unplaced state's; a replay's host and device ms, the
   capture's seconds, the eager step's, tokens/s and peak memory beside
   ``mesh=None``'s, and one step's per-rank K1 calls held against the
   plain version and timed beside ``torch.matmul`` and their bound; (c)
   elastic: 2 full-width layers, 2 steps on (pod 2, data
   1, model 2) with a checkpoint, a failure injected, the pod dropped
   (``shrink_after_failure``), the checkpoint re-placed onto (data 1,
   model 2) (``replace_state``), 2 more steps: the four losses within
   ``SHARD_LOSS_GAP`` of 4 unbroken steps without a mesh; (d)
   ``compress_tree_psum`` over 4 rank threads on (a)'s model's gradient
   leaves, each rank's from its own batch: the bytes ``_collectives.stats``
   counts against an fp32 psum's, the mean's error after 1 and 8 rounds
   (error feedback), each rank's error-fed stream within the reference
   test's bound scaled to the leaf's gradient scale.
19. roofline -- the cost counter (``repro_torch.roofline``) against the
   card, every leg fatal: (a) Llama-3.2-1B's decode step in the (4, 16)
   bucket as phase 4 captures it, Llama-3.2-1B's 8 x 256 training step
   (``lower_cell(mesh=None)``, the ``train_4k`` cell cut as phase 14 cuts
   it) and h2o-danube-3-4b's 32768-token ``flash`` forward, each counted on
   fake CUDA tensors (K1's, K2's and D1's launch counters unmoved) and run
   once for real with every K1 and K2 launch's shape logged (the decode
   step's D1 ops counted equal to its launches, one a layer): the counted K1
   FLOPs equal Σ 2mnk of the launched shapes and K2's equal
   ``flash_bound``'s count, exactly, and each step's counted bound over the
   device time phases 4, 14 and 6 measured (phase 14's: a replay of the
   captured training step) is at most ``ROOF_FRACTION_MAX``; no
   ``aten::mm`` in the decode step or the
   forward and two in the training step (the unembedding's fp32
   backward), and no copy of the LM head in the decode step or the
   forward; (b) the dry run's argument bytes within
   ``ARG_BYTES_TOL`` of the allocator's once the real state is built, its
   peak over one real step's ``max_memory_allocated`` within
   ``PEAK_BAND``; (c) ``python -m repro_torch.launch.perf_probe --arch
   xlstm-350m --shape decode_32k --mesh single`` in a subprocess (the
   (16, 16) production mesh on fake CUDA tensors), started before phase
   15 to run beside phases 15-18 (host work only), its JSON read; (d)
   ``check(plan, hlo=True)`` over phase 10's catalog on card rank threads.
20. big -- the configs that fill one card, every leg fatal, each model
   freed before the next, after ``memory_allocated()`` is back under
   ``BIG_BASE_MAX``: for granite-20b (52 layers, MQA 48/1), chameleon-34b
   (48 layers, d_model 8192) and qwen3-moe-30b-a3b (48 layers of 128
   experts top-8, no shared experts: 4 K1 products a layer), (a) the
   batch-4 decode step counted on fake CUDA tensors before anything is
   allocated: its predicted peak (arguments + the counter's live peak)
   must fit in what ``mem_get_info`` says is free, and one real eager
   step's peak lands within ``PEAK_BAND`` of it; (b) phase 15's check, two
   full-width fp32 layers card vs CPU; (c) the full model in bf16 behind
   ``Server``, only bucket (4,16) warmed and captured, run and measured as
   phase 15 runs the zoo (tokens bitwise equal across graph replays, the
   eager path and a request served alone; K1 ``k1_per_step`` x forwards,
   all thin; every distinct K1 call vs the plain version, the decode
   step's K1 timed beside ``torch.matmul`` and its bound, the weight-read
   bound, qwen3's 128 experts' products alone, a profiled step); (d)
   granite-20b's ``flash`` forward over 32768 tokens, its peak predicted
   and held as in (a): K2 52 times on the wgmma route (a group of 48
   query heads over one K/V head) and K1 365 times on the wide route,
   logits finite and within ``PREFILL_LOGITS_TOL`` per row of the ``xla``
   route (compared from each forward's final hidden states, unembedded
   2048 rows at a time: one full logits tensor is 6 GiB), while the same
   forward with K2 run non-causally lands outside; every distinct K1 call
   of the forward, the unembedding's among them, within ``ROW_TOL`` of the
   plain version at its own shape, blocks and layouts; the forward's time,
   tokens/s, a profiled forward split into K1 (the unembedding's launch
   apart; no ``aten::mm``), K2 and the rest, and K1
   alone at the layer's 7 products at M = 32768 beside ``torch.matmul``;
   (e) K2 alone at the three head layouts (48/1, 64/8, 32/4, D 128, causal,
   S = 8192), held row by row to its plain version, timed beside SDPA and
   the plain version.
21. examples -- the reference's examples through their port
   (``repro_torch.examples``), each ``main`` in this process on the card,
   K1's launches counted by route around each: (a) the quickstart, its
   solver numbers the reference quickstart's and K1 at 256^3 on the fma
   (fp32) and wide (bf16) routes within ``TOL`` per row; (b) the
   distributed demo in bf16 and fp32 (Cannon, staged and overlapped SUMMA
   on a 4x4 torus of 16 rank threads, the 2.5D split on 2x2x2, the ring
   all-gather matmul on 8): the fp32 run's collective bytes per rank by
   kind are the reference demo's, the bf16 run's half of each kind but the
   fp32 all-reduce, every row within ``ROW_TOL`` of the fp32 product, 16
   distinct rank threads, each bf16 product's device ms; (c)
   ``serve_batched`` on the 2x2 mesh and with ``--no-mesh``: bucket 4x16
   served from its graphs, the planned run's serve-window hit rate 1.0, the
   planned logits along its tokens within ``PLANNED_LOGITS_TOL`` per row of
   ``mesh=None``'s; (d) ``train_lm --preset 100m`` (12 layers, d_model 768,
   vocab 32768), 60 steps at 8 x 256, captured, a failure injected at step
   30: one restart, one capture, the loss falling, and each step's loss and
   learning rate held to an uninterrupted run fed the same batches; (e) K1
   bf16 with its tile table in Z-order and row-major at 2048^3 (all in the
   L2), 8192^3 and 16384^3, outputs bitwise equal, CUDA-graph replays timed
   in turns with ``torch.matmul`` beside ``bound``, and the reference's
   Sec. 4.3 LRU model rows
   (a 16^3 grid, caches of 48, 192, 768 blocks) printed beside.
22. decode-kernel -- the split-KV decode-attention kernel (D1) at the
   serving cells' decode steps (``DECODE_CELLS``: h2o-danube-3-4b's 64 rows
   of 8 x 4 heads, D 120, and deepseek-moe-16b's 16 x 1, D 128, over 850
   slots, each on its own ``split_plan``), every layer its own cache: the
   step at ``pos`` 512 with no padding, at ``pos`` 680 with the serving
   mix's left padding (``decode_offsets``), a rolling window cache and
   non-causal (S,) key positions, each within ``DECODE_RTOL`` /
   ``DECODE_ATOL`` of the plain version (``_sdpa``, fp32 probabilities)
   and rerun bitwise, one launch a call; then a decode step's layers by
   CUDA-graph replays, in turns: the kernel, its bound (``decode_cost``:
   the valid slots' K and V once), the plain version and
   ``F.scaled_dot_product_attention`` with the boolean mask and
   ``enable_gqa`` (the library call).

23. moe-kernel -- the routed MoE experts kernel (M1) at the MoE serving
   cells' decode steps (``MOE_CELLS``: deepseek-moe-16b's 27 MoE layers
   and DeepSeek-V2-Lite's 26, 64 rows, top-6 of 64 experts, d 2048, ff
   1408, each cell's own gate normalisation) and at one prefill slice
   (``MOE_PREFILL``: 64 x 512 tokens in groups of 256, capacity 32, a few
   layers), every layer its own weights and router: layer 0 against the
   plain version within ``ROW_TOL`` and rerun bitwise; then CUDA-graph
   replays over the layers, in turns: the kernel alone, the routed layer
   (routing, pair list, kernel), the dense route's layer (``plain_ms``),
   and batched cuBLAS on the experts' gathered rows (``library_ms``, timed
   only), beside the bound (the chosen experts' weights once at decode;
   the kept pairs' operations in the prefill).

On one card the collectives are device copies between the ranks'
streams (a ppermute's is a ``cudaMemcpyAsync`` on the receiver's copy
stream), so an overlapped body's prefetch can run under its rank's K1; no
number of phases 7-9 or 11 is a link's.

Then a ``{"kernels": [...]}`` line (each kernel's entry with its launches
per route on each path, graph replays counted apart), the card's name and
power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.  The
full measurements go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import gzip
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import store as train_store  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.zorder import (block_reuse_distance_traffic, ideal_traffic,  # noqa: E402
                                     rowmajor_schedule, zorder_schedule)
from repro_torch.data.pipeline import (DataConfig, batch_iterator, device_put_batch,  # noqa: E402
                                       synth_batch)
from repro_torch.device import param_device  # noqa: E402
from repro_torch.dist import Mesh, _collectives, symmetric_matmul  # noqa: E402
from repro_torch.dist import cannon as cannon_mod  # noqa: E402
from repro_torch.dist.local import local_matmul  # noqa: E402
from repro_torch.examples import distributed_matmul as ex_distributed  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import serve_batched as ex_serve  # noqa: E402
from repro_torch.examples import train_lm as ex_train  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as kdec  # noqa: E402
from repro_torch.kernels.moe_experts import kernel as kmoe  # noqa: E402
from repro_torch.kernels.moe_experts import plain as moe_plain  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, mha  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402
from repro_torch.kernels.matmul import _build, kernel as k1  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_ref  # noqa: E402
from repro_torch.layers import attention as attention_layer  # noqa: E402
from repro_torch.layers import mamba2 as mamba2_layer  # noqa: E402
from repro_torch.layers.embed import padded_vocab, unembed  # noqa: E402
from repro_torch.layers import moe as moe_layer  # noqa: E402
from repro_torch.models import lm as decoder_lm  # noqa: E402
from repro_torch.models.lm import cross_entropy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.launch import perf_probe  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.obs import calibrate  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.plan import build_plan, execute_plan, planned_matmuls, plan_cache  # noqa: E402
from repro_torch.runtime.serve import (ServeConfig, batch_requests, decode_loop,  # noqa: E402
                                       planned_scope, token_loop)
from repro_torch.runtime.serve import decode_step as serve_step  # noqa: E402
from repro_torch.runtime.serve import prefill as serve_prefill  # noqa: E402
from repro_torch.runtime.train import StaticStep, TrainConfig, Trainer  # noqa: E402
from repro_torch.serve import Server, as_bucket, route as serve_route  # noqa: E402
from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID  # noqa: E402
from repro_torch.verify import (ConformanceError, check, check_capture,  # noqa: E402
                                compare_records, intercept, measure_plan, run_matrix,
                                trace_plan)
from repro_torch.verify.conformance import CASES, _overlap_modes, matrix_cells  # noqa: E402
from repro_torch.tune import (Tuner, candidate_route, default_candidate, load_table,  # noqa: E402
                              time_candidate)
from repro_torch.verify.drift import DRIFT_CELLS, check_drift  # noqa: E402
from repro_torch.verify.interceptor import phase_bytes  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402
from repro_torch.models.sharding_rules import param_shardings  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.plan.lower_dist import block_slices  # noqa: E402
from repro_torch.runtime import elastic, sharding  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.roofline import analysis as roof_analysis, hlo_stats  # noqa: E402
from repro_torch.roofline.hlo_stats import attention_pairs  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

# the module, not the function ``repro_torch.plan.lower_dist`` of its name
lower_dist_mod = importlib.import_module("repro_torch.plan.lower_dist")
plan_ir = importlib.import_module("repro_torch.plan.ir")

# H100 SXM published peaks (NVIDIA data sheet, dense), from their one home
# in the port: memory 3.35 TB/s, bf16 tensor cores 989 TFLOP/s, fp32 outside
# the tensor cores 67 TFLOP/s.
PEAK_BYTES_S = roof_analysis.HBM_BW
PEAK_FLOPS = roof_analysis.PEAK_FLOPS
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Per-row checks (``row_err``): the worst output row's relative L2 error.
# bf16: each side rounds its output to bf16 (2^-9 relative at most), and K2
# also rounds P to bf16 for its PV product (2^-9 of each probability), so a
# sound kernel reads a few 1e-3; a row that loses one 64-key tile of 4096
# moves by about sqrt(64 / 4096) ~ 0.1, ten times the limit.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MODEL_TOL = 1e-3
MS = (4, 8, 64, 256)
# (K, N) of the 7 projections of a Llama-3.2-1B layer: q, k, v, o, gate, up, down
LAYER_KN = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048)]
MAIN_SHAPES = [(m, k, n) for m in MS for (k, n) in sorted(set(LAYER_KN))]
# K1 on operands stored transposed, at the paths' shapes (phase 2's layout
# rows; what, (M, K, N), A stored transposed, B stored transposed, output
# type, the layer product's (K, N)): the unembedding of Llama-3.2-1B's tied
# head (B the .t() of the (vocab, d_model) table, fp32 logits) at a batch-4
# decode step and at the 8 x 256-token training forward; that training
# step's backward, dA = dC Bᵀ (B stored transposed) and dB = Aᵀ dC (A
# stored transposed), at each distinct layer product, 2048 tokens, bf16.
LLAMA_VOCAB = 128256
LAYOUT_ROWS = ([("unembed decode", (4, 2048, LLAMA_VOCAB), False, True, torch.float32, None),
                ("unembed train forward", (2048, 2048, LLAMA_VOCAB), False, True, torch.float32,
                 None)]
               + [("dA", (2048, n, k), False, True, torch.bfloat16, (k, n))
                  for (k, n) in sorted(set(LAYER_KN))]
               + [("dB", (k, 2048, n), True, False, torch.bfloat16, (k, n))
                  for (k, n) in sorted(set(LAYER_KN))])
RAGGED = [(200, 300, 260), (8, 16, 8), (17, 300, 70), (1, 7, 3)]
# Both sides of each bf16 route threshold, and danube's n = 960 and K = 10240
THRESHOLD_SHAPES = [(16, 2048, 512), (17, 2048, 512), (k1.THIN_MAX_M, 2048, 512),
                    (k1.THIN_MAX_M + 1, 2048, 512), (64, 10240, 960), (300, 3840, 960)]
# The thin and wide routes side by side at these M (Llama's layer shapes)
CROSSOVER_MS = (64, 128, 192, 256)
CROSSOVER_BLOCKS = {"thin": (64, 64, 64), "wide": (128, 256, 64), "wide128": (128, 128, 64)}
L2_BYTES = 50 * 2 ** 20
SERVE_NEW = 16
SERVE_MAX_SEQ = 64    # the serving caches' slots
SERVE_BUCKETS = [(4, 16), (8, 32)]
# K2 checks, (B, S_q, S_kv, H_q, H_kv, D, window, layout), all causal:
# Llama; danube with the window active; the reference's unaligned case;
# below the reference's _MIN_SEQ (D 16, mma); a 200-key window (D 32, mma);
# zamba2's D = 80 with GQA group 1; D = 128 with a 4032 window; S_q > S_kv
# with a window (the last rows see no key); head slices of one fused
# (B, S, H_q + 2 H_kv, D) tensor; the (BH, S, D) entry ``flash_attention``
FLASH_CHECKS = [(1, 4096, 4096, 32, 8, 64, 0, "bshd"), (1, 8192, 8192, 32, 8, 120, 4096, "bshd"),
                (2, 300, 512, 4, 2, 120, 0, "bshd"), (2, 200, 200, 4, 1, 16, 64, "bshd"),
                (1, 384, 384, 2, 2, 32, 200, "bshd"), (2, 1000, 1000, 8, 8, 80, 200, "bshd"),
                (1, 4500, 4500, 8, 2, 128, 4032, "bshd"), (1, 700, 300, 4, 1, 120, 64, "bshd"),
                (2, 384, 384, 8, 2, 120, 200, "slice"), (1, 520, 700, 8, 2, 64, 200, "heads"),
                (1, 600, 600, 8, 2, 120, 200, "expand")]
# K2 at the long-prefill path's shapes: danube (the path) and Llama
FLASH_TIMED = {"danube": (1, 32768, 32768, 32, 8, 120, 4096),
               "llama": (1, 32768, 32768, 32, 8, 64, 0)}
# The special-function units' exp2 rate: 16 a clock per SM (Hopper), at the
# card's maximum SM clock as nvidia-smi reports it.
EXP2_PER_CLOCK_PER_SM = 16
PREFILL_ARCH = "h2o-danube-3-4b"
PREFILL_S = 32768
FP32_CHECK_S = 8192
FP32_CHECK_LAYERS = 2
FP32_CHECK_TOL = 1e-4
# Full-width bf16 flash vs xla forward, worst logits row (``row_err``):
# the routes differ only in the attention core (K2 rounds P to bf16 for its
# PV product, the xla route keeps P in fp32), and each of 24 layers
# re-rounds the bf16 residual stream.  The limit sits between the sound
# route's reading (a few 1e-2 on an H100) and those of two wrong attention
# cores run beside it (``PREFILL_CONTROLS``, several 1e-1), which must land
# outside it.  The loss is printed, not held: with random weights it stays
# near ln(vocab) whatever attention does.
PREFILL_LOGITS_TOL = 1e-1
# window of each wrong core: 0 ignores the window, 4096 - 64 drops the
# oldest 64-key tile of every full window
PREFILL_CONTROLS = {"window ignored": 0, "window one tile short": 4096 - 64}
# Plan engine (phases 7-9).  The sweep's product: danube's gate/up
# projection at M = 8192 (a quarter of the long prefill's rows), bf16.
PLAN_SWEEP_SHAPE = (8192, 3840, 10240)
# (mesh sizes, axis names, strategy, overlap): every strategy, staged and
# overlapped where ``overlap_capability`` allows
PLAN_SWEEP_CELLS = [
    ((2, 2), ("x", "y"), "cannon", False), ((2, 2), ("x", "y"), "cannon", True),
    ((2, 2), ("x", "y"), "summa", False), ((2, 2), ("x", "y"), "summa", True),
    ((2, 2), ("x", "y"), "ring_ag", None), ((2, 2), ("x", "y"), "ring_rs", None),
    ((4,), ("t",), "ring_ag", None), ((4,), ("t",), "ring_rs", None),
    ((2, 2, 2), ("pod", "x", "y"), "cannon25d", False),
    ((2, 2, 2), ("pod", "x", "y"), "cannon25d", True),
    ((2, 2, 2), ("pod", "x", "y"), "pod25d", False),
    ((2, 2, 2), ("pod", "x", "y"), "pod25d", True),
    ((2, 2, 2), ("tree", "x", "y"), "fattree", None),
    ((2,), ("pod",), "pod25d", None),
]
# A planned product against K1 alone: the same bf16 operands, fp32
# accumulation either way, but the contraction summed in other pieces (a
# rank's block, the ring's partials) before one bf16 rounding, so rows read
# a few 1e-3 at most; a wrong program moves a whole block of every row
# (about 0.5 or more), far outside.
PLAN_ROW_TOL = 1e-2
# Planned serving (16 bf16 layers) against mesh=None, worst last-token
# logits row: each projection's output may differ from the unplanned one
# by a bf16 rounding (other summation pieces), and 16 layers carry that
# through the residual stream; the limit is the long prefill's, and a
# ring_rs reducing the wrong way round must land outside it.
PLANNED_LOGITS_TOL = 1e-1
PLANNED_MESH = ((2, 2), ("x", "y"))
# K1 launches per planned product on the 2x2 mesh, by strategy (ranks x
# block products per rank)
LAUNCHES_PER_PRODUCT_2X2 = {"cannon": 4 * 2, "summa": 4, "summa+ov": 4 * 2,
                            "ring_ag": 4 * 4, "ring_rs": 4}
# Phase 7's hidden shares: each deferred cell (and the staged cannon, and
# cannon+ov with each done moved right after its start) profiled once,
# HIDE_PRODUCTS products queued behind this much device sleep (longer than
# the host takes to queue them), so the host's barriers are off the
# device's timeline (the work then runs as a graph replay runs it)
HIDE_SLEEP_S = 0.25
HIDE_PRODUCTS = 4     # products a profile queues behind the sleep, one after another
# This script's readings on an NVIDIA H100 80GB HBM3 at 700 W when every
# rank still launched on the caller's one stream; phases 8 and 11 print them
# beside this run's
ONE_STREAM = {"planned_step_replay_ms": 16.20, "planned_p50_ms": 19.21,
              "probe_alpha_us": (790.0, 1250.0)}
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# Calibration and tuning (phase 11): timed reps per probe and per candidate
CALIBRATE_REPS = 5
TUNE_REPS = 5
# (K, N) of the 4 distinct projections of a danube layer: q/o, k/v, gate/up, down
DANUBE_KN = [(3840, 3840), (3840, 960), (3840, 10240), (10240, 3840)]
# obs + drift (phase 12): one planned bf16 product per drift cell at this
# (M, K, N), under tracing
OBS_PRODUCT = (1024, 1024, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def _bound(cost, dtype: torch.dtype):
    t_bytes = cost.bytes / PEAK_BYTES_S
    t_ops = cost.flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(m: int, k: int, n: int, dtype: torch.dtype, out_dtype: torch.dtype = None):
    """(ms, "bytes" | "operations"): each input read once, the output
    written once, at the memory rate; or the FLOPs at the type's peak
    (K1's count, ``hlo_stats.matmul_cost``)."""
    return _bound(hlo_stats.matmul_cost(m, k, n, dtype, out_dtype), dtype)


def row_err(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Each row's (last dim's) relative L2 error ||out - ref|| / ||ref||:
    the worst (``row_rel``) and mean over rows, and the largest absolute
    error.  A row that is 0 in both reads 0.  Chunked, so a (32768, 32000)
    pair needs no fp32 copy of its own size."""
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    step = max(1, 2 ** 26 // o.shape[1])
    rels, absmax = [], []
    for i in range(0, o.shape[0], step):
        rf = r[i:i + step].float()
        d = o[i:i + step].float() - rf
        rels.append(d.norm(dim=1) / rf.norm(dim=1).clamp_min(1e-30))
        absmax.append(d.abs().max())
    rel = torch.cat(rels)
    return {"row_rel": rel.max().item(), "row_rel_mean": rel.mean().item(),
            "max_abs_err": torch.stack(absmax).max().item(),
            "finite": bool(torch.isfinite(out).all())}


def capturing(graph) -> "torch.cuda.graph":
    """``torch.cuda.graph(graph)`` with its capture stream given K1's
    split-K counters first (``k1.prepare_capture_stream``), as the port's
    own capture sites do."""
    capture = torch.cuda.graph(graph)
    k1.prepare_capture_stream(capture.capture_stream)
    torch.cuda.synchronize()
    return capture


def graph_ms(fn, calls) -> float:
    """Mean device ms per call: capture ``calls`` (a list of argument
    tuples) in one CUDA graph, replay once to warm, time a second replay
    with CUDA events."""
    for args in calls[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        for args in calls:
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / len(calls)


def phase_build() -> dict:
    """Build K1, K2, the decode-attention kernel and the MoE kernel at once (one nvcc per
    source file, all in parallel), load them, print ptxas's registers and
    spills per kernel instance."""
    t0 = time.perf_counter()
    mods = {"zorder_matmul": _build, "flash_attention": k2, "decode_attention": kdec,
            "moe_experts": kmoe}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(m.build) for name, m in mods.items()}
        paths = {name: f.result() for name, f in futs.items()}
    for m in mods.values():
        m.load()
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    for name, path in paths.items():
        ptxas = path.with_suffix(".log").read_text()
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
        out[name] = {"library": path.name, "ptxas": ptxas}
    log(f"[build] {', '.join(p.name for p in paths.values())} ready in {secs:.1f}s")
    return out


def meant_route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The route a product of fresh (16-byte aligned) tensors is meant to
    take: fp32 the fma kernel; bf16 with k and n multiples of 8 the thin
    route up to ``THIN_MAX_M`` rows and the wide route above; other bf16
    the wmma kernel."""
    if dtype == torch.float32:
        return "fma"
    if k == 0 or k % 8 or n % 8:
        return "wmma"
    return "thin" if m <= k1.THIN_MAX_M else "wide"


def routes_moved(before: dict) -> dict:
    return {r: v - before[r] for r, v in k1.launches_by_route.items() if v != before[r]}


def phase_kernel(dev: torch.device, gen: torch.Generator) -> dict:
    checks, timings = [], []
    worst_main_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (m, k, n) in MAIN_SHAPES + RAGGED + THRESHOLD_SHAPES:
            a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
            before = dict(k1.launches_by_route)
            z = matmul(a, b, order="zorder")
            moved = routes_moved(before)
            r = matmul(a, b, order="rowmajor")
            again = matmul(a, b, order="zorder")
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            want = meant_route(m, k, n, dtype)
            if moved != {want: 1}:
                raise AssertionError(f"{(m, k, n)} {dtype} launched {moved}, meant for {want}")
            if not torch.equal(z, r):
                raise AssertionError(f"orders disagree at {(m, k, n)} {dtype}")
            if not torch.equal(z, again):
                raise AssertionError(f"two launches disagree at {(m, k, n)} {dtype}")
            diff = (z.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            ok = rel < TOL[dtype] and bool(torch.isfinite(z).all())
            checks.append({"shape": [m, k, n], "dtype": str(dtype), "route": want,
                           "max_abs_err": diff, "rel_err": rel, "ok": ok})
            log(f"[kernel] {str(dtype)[6:]:8s} {m:4d}x{k:5d}x{n:5d} {want:4s} "
                f"max_abs_err={diff:.3e} rel={rel:.3e} orders and reruns bitwise equal "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"{(m, k, n)} {dtype}: rel {rel} >= {TOL[dtype]}")
            if dtype == torch.bfloat16 and (m, k, n) in MAIN_SHAPES:
                worst_main_abs = max(worst_main_abs, diff)
    for (m, k, n) in MAIN_SHAPES:
        a, calls = _decode_operands(dev, gen, m, k, n)
        t = {}
        # in turns: kernel, library, plain, plain, library, kernel
        for name in ("ms", "library_ms", "plain_ms", "plain_ms", "library_ms", "ms"):
            fn = {"ms": matmul, "library_ms": torch.matmul, "plain_ms": matmul_ref}[name]
            t.setdefault(name, []).append(graph_ms(fn, calls))
        bms, by = bound(m, k, n, torch.bfloat16)
        row = {"shape": [m, k, n], "dtype": "bfloat16", "route": meant_route(m, k, n, a.dtype),
               "weight_copies": len(calls), **{key: min(v) for key, v in t.items()}, "runs": t,
               "bound_ms": bms, "bound_by": by}
        row["bound_share"] = bms / row["ms"]
        timings.append(row)
        log(f"[kernel-time] bf16 {m:4d}x{k:5d}x{n:5d} K1 ({row['route']}) "
            f"{row['ms'] * 1e3:8.2f}us bound {bms * 1e3:7.2f}us ({by}, {row['bound_share']:.1%}) "
            f"torch.matmul {row['library_ms'] * 1e3:8.2f}us plain {row['plain_ms'] * 1e3:8.2f}us")
        del a, calls
    crossover = crossover_times(dev, gen)
    layouts = layout_rows(dev, gen)
    torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "crossover": crossover, "layouts": layouts,
            "worst_main_abs_err": max(worst_main_abs, layouts["worst_abs_err"])}


def _stored_operand(gen, dev, rows: int, cols: int, transposed: bool, scale: float = 1.0,
                    dtype: torch.dtype = torch.bfloat16):
    """A (rows, cols) operand from a seeded generator: row-major, or the
    ``.t()`` of a row-major (cols, rows) tensor."""
    shape = (cols, rows) if transposed else (rows, cols)
    t = (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return t.t() if transposed else t


def layout_rows(dev: torch.device, gen: torch.Generator) -> dict:
    """K1 reading an operand stored transposed (``LAYOUT_ROWS``), at the
    shapes the paths launch: per row the route meant for it (one launch),
    the output within ``ROW_TOL`` of the plain version on the same views,
    a control that reads the same storage as row-major operands (the same
    route and blocks) and must land outside it, and the time of K1, the plain
    version and the library call (``_library_mm``; for the unembedding also
    the upcast and fp32 ``torch.matmul`` the port ran before), beside the
    bound (CUDA-graph replays, cycling through enough copies of the
    transposed operand that it comes from device memory)."""
    rows, worst_abs = [], 0.0
    for what, (m, k, n), a_t, b_t, od, layer_kn in LAYOUT_ROWS:
        copies = max(1, math.ceil(3 * L2_BYTES / ((m if a_t else n) * k * 2)))
        if a_t:   # the transposed operand is A: cycle through copies of it
            b = _stored_operand(gen, dev, k, n, b_t, 1 / math.sqrt(k))
            calls = [(_stored_operand(gen, dev, m, k, True), b) for _ in range(copies)]
        else:
            a = _stored_operand(gen, dev, m, k, False)
            calls = [(a, _stored_operand(gen, dev, k, n, b_t, 1 / math.sqrt(k)))
                     for _ in range(copies)]
        x, y = calls[0]
        want = meant_route(m, k, n, torch.bfloat16)
        before = dict(k1.launches_by_route)
        out = matmul(x, y, out_dtype=od)
        moved = routes_moved(before)
        ref = matmul_ref(x, y, od)
        blocks = k1.default_blocks(m, n, k, torch.bfloat16, True, a_t, b_t)
        before = dict(k1.launches_by_route)
        # the same storage viewed as row-major operands of the same shapes
        wrong = matmul(x.t().view(m, k) if a_t else x, y.t().view(k, n) if b_t else y,
                       block_m=blocks[0], block_n=blocks[1], block_k=blocks[2], out_dtype=od)
        control_moved = routes_moved(before)
        torch.cuda.synchronize()
        if moved != {want: 1} or control_moved != {want: 1}:
            raise AssertionError(f"{what} {(m, k, n)} launched {moved}, its control "
                                 f"{control_moved}, both meant for {want}")
        e, control = row_err(out, ref), row_err(wrong, ref)
        del out, ref, wrong
        tol = ROW_TOL[od]
        label = f"{what} {m}x{k}x{n} A{'ᵀ' if a_t else ''} B{'ᵀ' if b_t else ''} -> {str(od)[6:]}"
        log(f"[kernel-layout] {label} {want}: worst row rel {e['row_rel']:.3e}, read as "
            f"row-major {control['row_rel']:.3e} (limit {tol:g})")
        if not e["finite"] or not e["row_rel"] < tol:
            raise AssertionError(f"K1 {label} disagrees with its plain version: {e}")
        _check_control("kernel-layout", f"{label} read as row-major", control, tol)
        worst_abs = max(worst_abs, e["max_abs_err"])
        fns = {"ms": lambda p, q: matmul(p, q, out_dtype=od),
               "plain_ms": lambda p, q: matmul_ref(p, q, od)}
        lib = _library_mm(od)
        if lib is not None:
            fns["library_ms"] = lib
        if what.startswith("unembed"):
            fns["upcast_ms"] = _upcast_mm
        others = list(fns)[1:]
        t = {}
        for name in ("ms", *others, *reversed(others), "ms"):   # in turns
            t.setdefault(name, []).append(graph_ms(fns[name], calls))
        bms, by = bound(m, k, n, torch.bfloat16, od)
        row = {"what": what, "shape": [m, k, n], "a_t": a_t, "b_t": b_t,
               "out_dtype": str(od)[6:], "layer_kn": layer_kn, "route": want,
               "copies": copies, "library_ms": None, **{key: min(v) for key, v in t.items()},
               "runs": t, "bound_ms": bms, "bound_by": by, "row_rel": e["row_rel"],
               "max_abs_err": e["max_abs_err"], "control_row_rel": control["row_rel"]}
        row["bound_share"] = bms / row["ms"]
        rows.append(row)
        log(f"[kernel-layout-time] {label} K1 ({want}) {row['ms'] * 1e3:.2f}us, bound "
            f"{bms * 1e3:.2f}us ({by}, {row['bound_share']:.1%}), library "
            + ("not measured" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f}us")
            + f", plain {row['plain_ms'] * 1e3:.2f}us"
            + (f", upcast + fp32 torch.matmul {row['upcast_ms'] * 1e3:.2f}us"
               if "upcast_ms" in row else ""))
        del calls, x, y
    torch.cuda.empty_cache()
    # one layer of a training step's backward at 2048 tokens: its 7
    # products' dA and dB (the shapes repeat: q / o, k / v, gate / up)
    per_layer = {what: {key: sum(next(r[key] for r in rows
                                      if r["what"] == what and r["layer_kn"] == kn)
                                 for kn in LAYER_KN)
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
                 for what in ("dA", "dB")}
    return {"rows": rows, "backward_per_layer": per_layer, "worst_abs_err": worst_abs}


def _library_mm(out_dtype: torch.dtype, dtype: torch.dtype = torch.bfloat16):
    """The one PyTorch call computing K1's function on the same operands:
    ``torch.matmul`` where the output keeps the operands' type,
    ``torch.mm(..., out_dtype=float32)`` for bf16 operands into fp32 (None
    where this PyTorch lacks it)."""
    if out_dtype == dtype:
        return torch.matmul
    try:
        probe = torch.ones(8, 8, dtype=torch.bfloat16, device="cuda")
        torch.mm(probe, probe, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as err:
        log(f"[kernel-layout] torch.mm(..., out_dtype=float32) unavailable: {err}")
        return None
    return lambda p, q: torch.mm(p, q, out_dtype=torch.float32)


def _upcast_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands into fp32 logits the way the port's unembedding once
    computed them: both cast up, one fp32 ``torch.matmul``."""
    return torch.matmul(a.float(), b.float())


def _decode_operands(dev, gen, m, k, n, b_t: bool = False):
    """A (m, k) activation and enough (k, n) weight copies (each stored
    transposed where ``b_t``) that cycling through them reads the weights
    from device memory, not L2: one where a weight alone is three times
    L2 (an LM head)."""
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    copies = max(1, math.ceil(3 * L2_BYTES / (k * n * 2)))
    bs = [_stored_operand(gen, dev, k, n, b_t, 1 / math.sqrt(k)) for _ in range(copies)]
    return a, [(a, b) for b in bs]


def crossover_times(dev: torch.device, gen: torch.Generator) -> dict:
    """The thin route and both wide tiles on the same products, in turns, at
    Llama's layer shapes for each M in ``CROSSOVER_MS``: where the wide
    route overtakes the thin one sets ``THIN_MAX_M``."""
    rows, per_layer = [], {}
    for m in CROSSOVER_MS:
        by_kn = {}
        for (k, n) in sorted(set(LAYER_KN)):
            _, calls = _decode_operands(dev, gen, m, k, n)
            t = {}
            for name in ("thin", "wide", "wide128", "wide128", "wide", "thin"):
                bm, bn, bk = CROSSOVER_BLOCKS[name]

                def fn(a, b, bm=bm, bn=bn, bk=bk):
                    return matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                t.setdefault(name, []).append(graph_ms(fn, calls))
            row = {"shape": [m, k, n], **{name: min(v) for name, v in t.items()},
                   "bound_ms": bound(m, k, n, torch.bfloat16)[0]}
            rows.append(row)
            by_kn[(k, n)] = row
            del calls
        per_layer[m] = {name: sum(by_kn[kn][name] for kn in LAYER_KN)
                        for name in (*CROSSOVER_BLOCKS, "bound_ms")}
        log(f"[kernel-crossover] M={m:3d}, one Llama layer (7 products): " + ", ".join(
            f"{name} {v * 1e3:.2f}us" for name, v in per_layer[m].items()))
    return {"rows": rows, "per_layer": per_layer, "thin_max_m": k1.THIN_MAX_M}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_model(dev: torch.device, arch: str = "llama3.2-1b", tag: str = "model") -> dict:
    """A full-width, 2-layer fp32 ``arch``: prefill + one decode step on the
    card through K1 and on the CPU through the plain version, the same
    weights; logits within ``MODEL_TOL``, ``k1_per_step`` K1 launches a
    step, all on the fma route."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    cpu = torch.device("cpu")
    cpu_params = _to(params, cpu)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, 16)))
    offsets = torch.tensor([0, 5])          # row 1 is left-padded by 5 slots
    out = {}
    for name, p, d in (("card", params, dev), ("cpu", cpu_params, cpu)):
        cache = model.init_cache(2, 32, d)
        k1.reset_launches()
        with torch.no_grad():
            pre, cache = model.prefill(p, cache, tokens.to(d), offsets.to(d))
            nxt = pre.argmax(-1) if name == "card" else out["card"][2]
            dec, _ = model.decode_step(p, cache, nxt.to(d)[:, None], 16, offsets.to(d))
        out[name] = (pre.cpu(), dec.cpu(), nxt.cpu(), k1.launches,
                     _nonzero(k1.launches_by_route))
    v = cfg.vocab_size
    errs = {}
    for i, what in ((0, "prefill"), (1, "decode")):
        g, c = out["card"][i][:, :v], out["cpu"][i][:, :v]
        if not (torch.isfinite(g).all() and g.shape == c.shape == (2, v)):
            raise AssertionError(f"{what} logits malformed: {tuple(g.shape)}")
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
    launches = out["card"][3]
    log(f"[{tag}] {cfg.name} 2-layer full-width fp32: prefill rel_err={errs['prefill']:.3e} "
        f"decode rel_err={errs['decode']:.3e} K1 launches on card={launches} "
        f"(plain version on the cpu: {out['cpu'][3]} launches)")
    if out["card"][4] != {"fma": 2 * k1_per_step(cfg)} or out["cpu"][3] != 0:
        raise AssertionError(f"expected {2 * k1_per_step(cfg)} K1 launches on the card, all "
                             f"fma, 0 on the cpu; got {out['card'][4]}, {out['cpu'][3]}")
    if max(errs.values()) >= MODEL_TOL:
        raise AssertionError(f"card and cpu logits disagree: {errs}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return {"rel_err": errs, "launches": launches}


def _run_row(tag: str, rep: int, vocab: int, *, bucket, graphs: bool, routes: dict,
             counted: dict, taken: dict, ttft_s: float, steps_s, wall_s: float,
             new_tokens: list) -> dict:
    """One served run's row (K1 launches by route, planned products by
    strategy, TTFT, p50 / p99, tokens/s, the new tokens), logged; every
    token must be in the vocabulary."""
    steps_s = np.asarray(steps_s)
    p50, p99 = (float(np.percentile(steps_s, q) * 1e3) for q in (50, 99))
    tps = sum(len(t) for t in new_tokens) / wall_s
    log(f"[{tag}] run {rep} ({'graph replays' if graphs else 'eager'}): bucket "
        f"{bucket} ttft {ttft_s * 1e3:.2f}ms p50 {p50:.3f}ms p99 {p99:.3f}ms {tps:.1f} tok/s; "
        f"K1 {routes}" + (f"; products {taken}" if taken else ""))
    for toks in new_tokens:
        if len(toks) != SERVE_NEW or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"malformed tokens {toks}")
    return {"bucket": bucket, "graphs": graphs, "launches": sum(routes.values()),
            "routes": routes, "counted": counted, "strategies": taken,
            "ttft_ms": ttft_s * 1e3, "p50_ms": p50, "p99_ms": p99, "tokens_per_s": tps,
            "wall_s": wall_s, "tokens": new_tokens}


def served_runs(server, prompts, reps: int, tag: str, vocab: int) -> list:
    """``reps`` runs of ``server.generate(prompts)``: per run the K1 launches
    by route (counted for an eager run, replays x each graph's capture for
    a captured one), the planned products by strategy, TTFT, p50 / p99 and
    tokens/s; every token in the vocabulary."""
    runs = []
    for rep in range(reps):
        k1.reset_launches()
        kdec.reset_launches()
        kmoe.reset_launches()
        replayed = dict(server.cache_report()["kernels"]["zorder_matmul"]["replayed_by_route"])
        before = dict(server.plan_report()["strategies"])
        res = server.generate(prompts)
        counted = _nonzero(k1.launches_by_route)
        now = server.cache_report()["kernels"]["zorder_matmul"]["replayed_by_route"]
        routes = {r: counted.get(r, 0) + now.get(r, 0) - replayed.get(r, 0)
                  for r in sorted(set(counted) | set(now))}
        after = server.plan_report()["strategies"]
        taken = {st: v - before.get(st, 0) for st, v in after.items() if v != before.get(st, 0)}
        runs.append(_run_row(tag, rep, vocab, bucket=res.bucket, graphs=res.graphs,
                             routes=_nonzero(routes), counted=counted, taken=taken,
                             ttft_s=res.ttft_s, steps_s=res.step_latencies_s,
                             wall_s=res.wall_s, new_tokens=res.new_tokens))
        runs[-1]["d1_launches"] = kdec.launches
        runs[-1]["m1_launches"] = kmoe.launches
    return runs


def eager_runs(model, params, sc, prompts, reps: int, tag: str, *, mesh=None, tuning=None,
               logits: list = None) -> list:
    """``reps`` runs of the eager path a captured ``Server`` is held to:
    ``runtime.serve.decode_loop`` on the batch the server routes
    ``prompts`` to (``batch_requests(prompts + dummies, pad_to=bucket.seq)``),
    in a fresh cache, under ``planned_scope(mesh, tuning=)``, timed as
    ``Server.generate`` times its runs.  Rows as ``served_runs``', each
    with the full (B, S + new) token array; ``logits`` (a list) collects
    the last run's prefill and decode-step logits."""
    dev = param_device(params)
    bucket = serve_route(len(prompts), max(len(p) for p in prompts),
                         [as_bucket(b) for b in SERVE_BUCKETS])
    dummies = [[DUMMY_TOKEN]] * (bucket.batch - len(prompts))
    batch, lens = batch_requests(list(prompts) + dummies, PAD_ID, pad_to=bucket.seq)
    sp = batch.shape[1]

    def mark():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    runs = []
    for rep in range(reps):
        k1.reset_launches()
        kdec.reset_launches()
        kmoe.reset_launches()
        before = lower_dist_mod.executions_snapshot()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(batch, dtype=torch.int64, device=dev)
        offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=dev)
        cache = model.init_cache(bucket.batch, sc.max_seq, dev)
        with torch.no_grad(), planned_scope(mesh, None, tuning):
            if logits is None:
                full, marks = decode_loop(model, params, cache, tokens, offsets, sc, None,
                                          on_token=mark)
            else:
                logits.clear()

                def keep(out):
                    logits.append(out)
                    return out

                full, marks = token_loop(
                    model, cache, tokens, sc, None,
                    prefill=lambda: keep(model.prefill(params, cache, tokens, offsets)[0]),
                    step=lambda cur, pos: keep(
                        model.decode_step(params, cache, cur, pos, offsets)[0]),
                    on_token=mark)
        wall = time.perf_counter() - t0
        counted = _nonzero(k1.launches_by_route)
        after = lower_dist_mod.executions_snapshot()
        taken = {st: v - before.get(st, 0) for st, v in after.items() if v != before.get(st, 0)}
        new = [full[i, sp - int(lens[i]):].tolist()[int(lens[i]):] for i in range(len(prompts))]
        row = _run_row(tag, rep, model.cfg.vocab_size, bucket=bucket.label, graphs=False,
                       routes=counted, counted=counted, taken=taken, ttft_s=marks[0] - t0,
                       steps_s=np.diff(np.asarray(marks)), wall_s=wall, new_tokens=new)
        row["full"] = full.tolist()
        row["d1_launches"] = kdec.launches
        row["m1_launches"] = kmoe.launches
        runs.append(row)
    return runs


def _decoder_products(cfg, attention: int) -> int:
    """K1 products of one decoder forward with ``attention`` products an
    attention layer: 3 more a dense MLP or shared experts (none for routed
    experts alone, which run as einsums)."""
    dense = cfg.first_dense_layers if cfg.num_experts else cfg.num_layers
    shared = 3 if cfg.num_shared_experts else 0
    return attention * cfg.num_layers + 3 * dense + shared * (cfg.num_layers - dense)


# K1 launches of the unembedding a forward: one product, never planned
UNEMBED_LAUNCHES = 1


def layer_products(cfg, cached: bool = True) -> int:
    """K1 products of one forward's layers, the unembedding's apart.
    ``cached``, a one-pass prefill or a decode step: a decoder layer 4
    attention products (q, k, v, o; MLA's cached wq_a, wq_b, wkv_a, wo)
    and 3 more for a dense MLP or shared experts (deepseek-moe 7 a layer,
    qwen3-moe 4); zamba2 2 a Mamba layer (in_proj, out_proj) and 8 a shared
    block (shared_in, q, k, v, o, gate, up, down); xLSTM 4 an mLSTM block,
    1 an sLSTM block; the encoder-decoder's decode step 9 a decoder layer
    (self q, k, v, o; cross q and o over the cached K/V; the MLP's 3).
    Uncached, a training step's forward: MLA 5 attention products a layer
    (``wkv_b`` too); the recurrent families as cached; the encoder-decoder
    7 an encoder layer, 11 a decoder layer (cross q, k, v and o over the
    encoder output)."""
    if cfg.family == "hybrid":
        return 2 * cfg.num_layers + 8 * (cfg.num_layers // cfg.shared_attn_every)
    if cfg.family == "ssm":
        n_m = sum(1 for b in cfg.block_pattern if b == "mlstm")
        groups = cfg.num_layers // len(cfg.block_pattern)
        return groups * (4 * n_m + len(cfg.block_pattern) - n_m)
    if cfg.family == "audio":
        return 9 * cfg.dec_layers if cached else 7 * cfg.enc_layers + 11 * cfg.dec_layers
    return _decoder_products(cfg, 5 if cfg.attn_type == "mla" and not cached else 4)


def k1_per_step(cfg) -> int:
    """K1 launches of one forward step (a one-pass prefill or a decode
    step): its layers' (``layer_products``) and the unembedding's."""
    return layer_products(cfg) + UNEMBED_LAUNCHES


def train_products(cfg) -> int:
    """K1 products of one uncached forward, a training step's forward: its
    layers' (``layer_products(cached=False)``) and the unembedding's.
    Every product has a dA and a dB through K1 too, but for the
    unembedding's in a bf16 model (``train_step_launches``)."""
    return layer_products(cfg, cached=False) + UNEMBED_LAUNCHES


def train_step_launches(cfg, dtype: torch.dtype = torch.bfloat16) -> int:
    """K1 launches of one training step without recompute: each forward
    product's, its dA's and its dB's; in a bf16 model the unembedding's
    backward (its fp32 cotangent, ``ops._backward``) launches none."""
    unembed = UNEMBED_LAUNCHES * (1 if dtype == torch.bfloat16 else 3)
    return 3 * layer_products(cfg, cached=False) + unembed


def d1_per_step(cfg) -> int:
    """Launches of the decode-attention kernel (D1) in one bf16 decode step
    of a model ``phase_serve`` serves: one a call of ``chunked_attention``
    with one query per row, so one a GQA layer, one a shared block of
    zamba2; none for xLSTM, and none for MLA, whose cached path runs its
    own latent einsums."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers if cfg.family != "ssm" and cfg.attn_type == "gqa" else 0


def m1_per_forward(cfg, tokens: int) -> int:
    """Launch sets of the MoE kernel (M1) in one bf16 forward of ``tokens``
    tokens (batch x length) of a model ``phase_serve`` serves: one an MoE
    layer and dispatch slice (``moe.DISPATCH_TOKENS``), none for a model
    without experts."""
    if not cfg.num_experts:
        return 0
    return (cfg.num_layers - cfg.first_dense_layers) * -(-tokens // moe_layer.DISPATCH_TOKENS)


def prefill_steps(model, seq: int) -> int:
    """Forward steps of a prefill of ``seq`` tokens: one pass where the
    model has ``prefill``, else one decode step a token (teacher forcing)."""
    return 1 if hasattr(model, "prefill") else seq


def path_counts(path: dict, runs: list) -> None:
    """Add the runs' counted K1 launches (none for graph replays) to the
    count the main path's warmup and captures left, and fail if the path
    launched K1 no time."""
    for r in runs:
        path["launches"] += sum(r["counted"].values())
        for route, v in r["counted"].items():
            path["routes"][route] = path["routes"].get(route, 0) + v
    if not path["launches"]:
        raise AssertionError("the main path launched K1 no time")


def phase_serve(dev: torch.device, arch: str = "llama3.2-1b", tag: str = "serve",
                measure=None, warm=None, fit=None) -> dict:
    """Phase 4 (Llama-3.2-1B; phases 15 and 20 the zoo's models): ``arch`` at
    full width and depth behind ``Server``, each warmed bucket's steps
    (``warm``, default all) captured as CUDA graphs and replayed, against
    the eager path on the same bucket-padded batch: identical tokens.
    ``fit(model, params)`` runs right after the init, before the server
    is built, and ``measure(model, params)`` before the model is freed;
    their results are kept as ``"fit"`` and ``"measured"``."""
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated(dev)
    fitted = None if fit is None else fit(model, params)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=SERVE_MAX_SEQ)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 9, 12, 16)]
    per_forward = k1_per_step(cfg)
    bucket = serve_route(len(prompts), max(len(p) for p in prompts),
                         [as_bucket(b) for b in SERVE_BUCKETS])
    seq = bucket.seq
    forwards = prefill_steps(model, seq) + SERVE_NEW - 1
    want = per_forward * forwards
    d1_step = d1_per_step(cfg)
    token_prefill = prefill_steps(model, seq) > 1     # one decode step a prompt token
    # the main path: counts from 0 before the server is built, read after its runs
    m1_step = m1_per_forward(cfg, bucket.batch)
    k1.reset_launches()
    kdec.reset_launches()
    kmoe.reset_launches()
    server = Server(model, params, sc, buckets=SERVE_BUCKETS)
    warm = server.warmup(warm)
    path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route),
            "d1_launches": kdec.launches, "m1_launches": kmoe.launches}
    if m1_step and (not path["m1_launches"] or path["m1_launches"] % m1_step) or (
            not m1_step and path["m1_launches"]):
        raise AssertionError(f"warmup and captures launched the MoE kernel "
                             f"{path['m1_launches']} times, not a multiple of {m1_step} a step")
    if d1_step and (not path["d1_launches"] or path["d1_launches"] % d1_step) or (
            not d1_step and path["d1_launches"]):
        raise AssertionError(f"warmup and captures launched the decode kernel "
                             f"{path['d1_launches']} times, not a multiple of {d1_step} a step")
    log(f"[{tag}] {cfg.name}: {n_params / 1e9:.3f}B params bf16 in {init_s:.1f}s; warmup "
        + ", ".join(f"{k} {v['warm_s']:.2f}s + {v['graphs']} graphs captured in "
                    f"{v['capture_s']:.2f}s" for k, v in warm.items())
        + f"; K1 counted in warmup and captures {path['routes']}")
    runs = served_runs(server, prompts, 2, tag, cfg.vocab_size)
    path_counts(path, runs)
    for r in runs:
        if not r["graphs"] or r["counted"] or r["routes"] != {"thin": want}:
            raise AssertionError(f"a captured run launched {r['routes']} (counted from Python "
                                 f"{r['counted']}), want {want} on the thin route by graph "
                                 f"replays ({per_forward} per forward x {forwards} forwards)")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two generate runs with the same seed disagree")
    alone = server.generate([prompts[2]])
    if alone.new_tokens[0] != runs[0]["tokens"][2]:
        raise AssertionError("a request served alone decodes differently from "
                             "the same request in a batch")
    eager = eager_runs(model, params, sc, prompts, 1, tag)
    for r in runs:
        if r["d1_launches"] or r["m1_launches"]:
            raise AssertionError(f"a captured run launched the decode kernel "
                                 f"{r['d1_launches']} times and the MoE kernel "
                                 f"{r['m1_launches']} times from Python")
    for r in eager:
        if r["graphs"] or r["routes"] != {"thin": want} or r["counted"] != r["routes"]:
            raise AssertionError(f"an eager run launched {r['routes']}, want {want} thin")
        if r["d1_launches"] != d1_step * (forwards if token_prefill else SERVE_NEW - 1):
            raise AssertionError(f"an eager run launched the decode kernel {r['d1_launches']} "
                                 f"times, want {d1_step} a one-token step")
        m1_want = m1_step * (SERVE_NEW - 1) + m1_per_forward(cfg, bucket.batch * seq)
        if r["m1_launches"] != m1_want:
            raise AssertionError(f"an eager run launched the MoE kernel {r['m1_launches']} "
                                 f"times, want {m1_want}: {m1_step} a decode step and one an "
                                 f"MoE layer and slice in the prefill")
        if r["tokens"] != runs[0]["tokens"]:
            raise AssertionError("the captured steps' tokens differ from the eager path's")
    path["report"] = server.cache_report()
    log(f"[{tag}] tokens bitwise equal: graph replays, eager, a request served alone; "
        f"req0 tokens {runs[0]['tokens'][0][:8]}...; K1 on the main path: counted "
        f"{path['launches']} (warmup and captures), replayed "
        f"{path['report']['kernels']['zorder_matmul']['replayed']} "
        f"{path['report']['kernels']['zorder_matmul']['replayed_by_route']}")
    device_ms = step_device_ms(model, params, dev, SERVE_BUCKETS[0])
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}
               for name, rs in (("graphs", runs), ("eager", eager))}
    log(f"[{tag}] device time per step (CUDA-graph replay, bucket 4x16): prefill "
        f"{device_ms['prefill']:.3f}ms, decode {device_ms['decode']:.3f}ms; decode p50 on the "
        f"host clock: graph replays {summary['graphs']['p50_ms']:.3f}ms, eager "
        f"{summary['eager']['p50_ms']:.3f}ms; K1 per step by route: {device_ms['routes']}")
    for step, r in device_ms["routes"].items():
        n = per_forward * (prefill_steps(model, SERVE_BUCKETS[0][1]) if step == "prefill" else 1)
        if r != {"thin": n}:
            raise AssertionError(f"one {step} step launched K1 {r}, want {n} thin")
    d1_prefill = d1_step * SERVE_BUCKETS[0][1] if token_prefill else 0
    if device_ms["d1_launches"] != {"prefill": d1_prefill, "decode": d1_step}:
        raise AssertionError(f"the bucket's steps launched the decode kernel "
                             f"{device_ms['d1_launches']}, want {d1_prefill} in the prefill "
                             f"and {d1_step} in a decode step")
    log(f"[{tag}] decode kernel (D1): {d1_step} launches a decode step, {d1_prefill} in the "
        f"bucket's prefill; "
        f"{path['d1_launches']} in warmup and captures, "
        f"{eager[0]['d1_launches']} per eager generate, 0 from Python per replayed generate")
    m1_prefill = m1_per_forward(cfg, SERVE_BUCKETS[0][0] * SERVE_BUCKETS[0][1])
    m1_decode = m1_per_forward(cfg, SERVE_BUCKETS[0][0])
    if device_ms["m1_launches"] != {"prefill": m1_prefill, "decode": m1_decode}:
        raise AssertionError(f"the bucket's steps launched the MoE kernel "
                             f"{device_ms['m1_launches']}, want {m1_prefill} in the prefill "
                             f"and {m1_decode} in a decode step")
    log(f"[{tag}] MoE kernel (M1): {m1_decode} launch sets a decode step, {m1_prefill} in the "
        f"bucket's prefill; {path['m1_launches']} in warmup and captures, "
        f"{eager[0]['m1_launches']} per eager generate, 0 from Python per replayed generate")
    measured = None if measure is None else measure(model, params)
    peak = max(init_peak, torch.cuda.max_memory_allocated(dev)) / 2 ** 30
    log(f"[{tag}] peak memory allocated {peak:.2f} GiB")
    del server, params
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "warmup": warm, "runs": runs,
            "eager_runs": eager, "summary": summary, "path": path,
            "launches_per_generate": want, "forwards_per_generate": forwards,
            "step_device_ms": device_ms,
            "peak_gib": peak, "fit": fitted, "measured": measured}


def step_device_ms(model, params, dev: torch.device, bucket) -> dict:
    """Device time of one prefill and one decode step at a bucket's shape:
    each captured in a CUDA graph and replayed, so host dispatch is out of
    the measurement (the eager step's host-clock time keeps it in)."""
    batch, seq = bucket
    cache = model.init_cache(batch, 64, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(batch, seq)))
    tokens = tokens.to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    steps = {"prefill": lambda: serve_prefill(model, params, cache, tokens, offsets),
             "decode": lambda: serve_step(model, params, cache, tokens[:, -1:], seq, offsets)}
    out = {"routes": {}, "d1_launches": {}, "m1_launches": {}}
    with torch.no_grad():
        for name, step in steps.items():
            k1.reset_launches()
            kdec.reset_launches()
            kmoe.reset_launches()
            step()
            out["routes"][name] = {r: v for r, v in k1.launches_by_route.items() if v}
            out["d1_launches"][name] = kdec.launches
            out["m1_launches"][name] = kmoe.launches
            out[name] = graph_ms(step, [()])
    return out


def event_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device ms per call of ``fn()``: one warm call (unless ``fn``
    just ran: ``warm=False``), then ``reps`` calls between two CUDA
    events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound(b, sq, skv, hq, hkv, d, window, dtype=torch.bfloat16, causal=True):
    """(ms, "bytes" | "operations"): Q, K, V and O moved once at the memory
    rate, or 4 D flops per unmasked pair and query head at the type's peak
    (K2's count, ``hlo_stats.flash_cost``)."""
    return _bound(hlo_stats.flash_cost(b, sq, skv, hq, hkv, d, causal, window, dtype), dtype)


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def exp_floor_ms(b, sq, skv, hq, window, dev: torch.device, causal: bool = True) -> float:
    """One exp2 per unmasked (query, key) pair and query head on the
    special-function units, at ``EXP2_PER_CLOCK_PER_SM`` a clock on every SM
    at the maximum SM clock.  Printed beside the bound, which it does not
    change."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = EXP2_PER_CLOCK_PER_SM * sms * max_sm_clock_hz()
    return b * hq * attention_pairs(sq, skv, causal, window) / rate * 1e3


def key_tiles(sq, skv, window) -> dict:
    """The 128 x 128 tiles the wgmma route visits per (batch, head), and
    how many of them compare positions (``kernel.kv_tiles``)."""
    tiles = [t for q0 in range(0, sq, k2.BLOCK_M)
             for t in k2.kv_tiles(q0, sq, skv, True, window)]
    return {"tiles": len(tiles), "masked": sum(m for _, m in tiles)}


def _qkv(gen, dev, dtype, b, sq, skv, hq, hkv, d):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _heads(x):  # (B, S, H, D) -> (B*H, S, D)
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])


def _bshd(x):  # (BH, S, D) -> a (1, S, BH, D) view
    return x.unsqueeze(0).transpose(1, 2)


def sdpa_yardstick(q, k, v, window: int, causal: bool = True):
    """``F.scaled_dot_product_attention`` on the same inputs, KV heads
    expanded for it beforehand: (callable, backend name).  Causal or not,
    without a window it takes the flash backend; a window needs a mask,
    which only the memory-efficient backend takes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    if window == 0:
        backend, kw = SDPBackend.FLASH_ATTENTION, {"is_causal": causal}
    else:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        backend, kw = SDPBackend.EFFICIENT_ATTENTION, {
            "attn_mask": (j <= i) & (j > i - window)}

    def run():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return run, backend.name


def _flash_case(gen, dev, dtype, case):
    """q, k, v of one ``FLASH_CHECKS`` case and ``run(route)``: the case's
    entry point with the route ``kernel.route`` picks (None) or a forced
    one, returning (B*H_q, S_q, D)."""
    b, sq, skv, hq, hkv, d, window, layout = case
    if layout == "slice":   # head slices of one fused tensor (S_q = S_kv)
        fused = torch.randn((b, sq, hq + 2 * hkv, d), generator=gen, device=dev).to(dtype)
        q, k, v = fused[:, :, :hq], fused[:, :, hq:hq + hkv], fused[:, :, hq + hkv:]
    elif layout == "expand":  # one K/V head broadcast (head stride 0) to H_kv heads
        q, k, v = _qkv(gen, dev, dtype, b, sq, skv, hq, 1, d)
        k, v = k.expand(b, skv, hkv, d), v.expand(b, skv, hkv, d)
    else:
        q, k, v = _qkv(gen, dev, dtype, b, sq, skv, hq, hkv, d)
    if layout == "heads":   # the reference's (BH, S, D) layout, viewed in place
        qh, kh, vh = _heads(q), _heads(k), _heads(v)

        def run(route=None):
            if route is None:
                return k2.flash_attention(qh, kh, vh, causal=True, window=window)
            return _heads(k2.flash_attention_bshd(_bshd(qh), _bshd(kh), _bshd(vh),
                                                  window=window, route=route))
    else:
        def run(route=None):
            if route is None:
                return _heads(mha(q, k, v, causal=True, window=window))
            return _heads(k2.flash_attention_bshd(q, k, v, window=window, route=route))
    return q, k, v, run


def phase_flash_kernel(dev: torch.device, gen: torch.Generator) -> dict:
    checks, timings = [], {}
    worst_bf16_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CHECKS:
            b, sq, skv, hq, hkv, d, window, layout = case
            q, k, v, run = _flash_case(gen, dev, dtype, case)
            ref = attention_ref(_heads(q), _heads(k), _heads(v), causal=True, window=window)
            auto = k2.route(d, dtype, k2.aligned(q, k, v))
            if layout == "expand" and auto == "wgmma":   # TMA takes no stride of 0
                raise AssertionError(f"K2 {list(case)}: a broadcast head routed to wgmma")
            for forced in (None, "mma") if auto == "wgmma" else (None,):
                want = forced or auto
                k2.reset_launches()
                out = run(forced)
                again = run(forced) if want == "wgmma" else out
                torch.cuda.synchronize()
                moved = {r: n for r, n in k2.launches_by_route.items() if n}
                if moved != {want: 2 if want == "wgmma" else 1}:
                    raise AssertionError(f"K2 {list(case)} {dtype} launched {moved}, "
                                         f"meant for {want}")
                if not torch.equal(out, again):
                    raise AssertionError(f"two wgmma launches disagree at {list(case)}")
                e = _check_rows("flash-kernel", f"K2 {str(dtype)[6:]} {want:5s} {list(case)}",
                                out, ref, ROW_TOL[dtype])
                checks.append({"shape": list(case), "dtype": str(dtype), "route": want,
                               "rerun_bitwise_equal": want == "wgmma", **e})
                if dtype == torch.bfloat16:
                    worst_bf16_abs = max(worst_bf16_abs, e["max_abs_err"])
                del out, again
            del q, k, v, run, ref
            torch.cuda.empty_cache()
    for name, (b, sq, skv, hq, hkv, d, window) in FLASH_TIMED.items():
        q, k, v = _qkv(gen, dev, torch.bfloat16, b, sq, skv, hq, hkv, d)
        sdpa, backend = sdpa_yardstick(q, k, v, window)
        qh, kh, vh = _heads(q), _heads(k), _heads(v)
        g = hq // hkv
        kept = {}

        def kern():   # the path's call: mha, which takes the wgmma route
            kept["out"] = mha(q, k, v, causal=True, window=window)

        def mma():
            kept["mma"] = k2.flash_attention_bshd(q, k, v, window=window, route="mma")

        def plain():  # head by head (B = 1): one head's (S, S) scores at a time
            kept["ref"] = [attention_ref(qh[h:h + 1], kh[h // g:h // g + 1],
                                         vh[h // g:h // g + 1], causal=True, window=window)
                           for h in range(qh.shape[0])]

        k2.reset_launches()
        kern()
        if {r: n for r, n in k2.launches_by_route.items() if n} != {"wgmma": 1}:
            raise AssertionError(f"{name}: mha took {k2.launches_by_route}, not wgmma")
        t = {}
        # in turns: wgmma, mma, library, plain, library, mma, wgmma
        for key in ("ms", "mma_ms", "library_ms", "plain_ms", "library_ms", "mma_ms", "ms"):
            fn = {"ms": kern, "mma_ms": mma, "library_ms": sdpa, "plain_ms": plain}[key]
            t.setdefault(key, []).append(event_ms(fn, 1 if key == "plain_ms" else 5))
        ref = torch.cat(kept["ref"])
        shape = [b, sq, skv, hq, hkv, d, window]
        e = _check_rows("flash-kernel", f"K2 bfloat16 wgmma {name} {shape}",
                        _heads(kept["out"]), ref, ROW_TOL[torch.bfloat16])
        e_mma = _check_rows("flash-kernel", f"K2 bfloat16 mma   {name} {shape}",
                            _heads(kept["mma"]), ref, ROW_TOL[torch.bfloat16])
        worst_bf16_abs = max(worst_bf16_abs, e["max_abs_err"], e_mma["max_abs_err"])
        del kept, ref
        bms, by = flash_bound(b, sq, skv, hq, hkv, d, window)
        row = {"shape": shape, "dtype": "bfloat16", "route": "wgmma",
               **{key: min(v) for key, v in t.items()}, "runs": t, "check": e,
               "check_mma": e_mma, "bound_ms": bms, "bound_by": by,
               "exp_floor_ms": exp_floor_ms(b, sq, skv, hq, window, dev),
               "sdpa_backend": backend, "pairs_per_head": attention_pairs(sq, skv, True, window),
               **key_tiles(sq, skv, window)}
        row["bound_share"] = bms / row["ms"]
        row["tflops"] = 4.0 * d * b * hq * row["pairs_per_head"] / row["ms"] / 1e9
        timings[name] = row
        log(f"[flash-time] {name} {shape} K2 wgmma {row['ms']:.3f}ms ({row['tflops']:.0f} "
            f"TFLOP/s on unmasked pairs) mma {row['mma_ms']:.3f}ms bound {bms:.3f}ms ({by}, "
            f"{row['bound_share']:.1%}) exp floor (at {EXP2_PER_CLOCK_PER_SM} exp2/clock/SM) "
            f"{row['exp_floor_ms']:.3f}ms "
            f"sdpa[{backend}] {row['library_ms']:.3f}ms plain (head by head, full S) "
            f"{row['plain_ms']:.3f}ms; {row['tiles']} tiles of 128x128 per head, "
            f"{row['masked']} masked")
        del q, k, v, qh, kh, vh, sdpa
        torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "worst_bf16_abs_err": worst_bf16_abs,
            "projections": projection_times(dev, gen)}


def _check_rows(phase: str, what: str, out: torch.Tensor, ref: torch.Tensor,
                tol: float) -> dict:
    """``row_err`` of a kernel's output against its plain version's, logged;
    raises unless finite and every row within ``tol``."""
    e = row_err(out, ref)
    ok = e["finite"] and e["row_rel"] < tol
    log(f"[{phase}] {what} worst row rel={e['row_rel']:.3e} (mean {e['row_rel_mean']:.3e}, "
        f"limit {tol:g}) max_abs_err={e['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: {e}")
    return e


def projection_times(dev: torch.device, gen: torch.Generator, arch: str = PREFILL_ARCH,
                     m: int = PREFILL_S) -> list:
    """K1, ``torch.matmul`` and K1's plain version at the 7 projections of
    one layer of ``arch`` (danube's by default) at M = ``m`` rows (bf16),
    each beside its bound; K1's output held against its plain version's
    per row."""
    cfg = get_config(arch)
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    kn = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd), (d, cfg.num_kv_heads * hd),
          (cfg.num_heads * hd, d), (d, ff), (d, ff), (ff, d)]
    rows = []
    for (k, n) in kn:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        kept = {}

        def kern():
            kept["out"] = matmul(a, b)

        def plain():
            kept["ref"] = matmul_ref(a, b)

        def wide128():
            kept["w128"] = matmul(a, b, block_m=128, block_n=128, block_k=64)

        t = {}
        before = dict(k1.launches_by_route)
        kern()
        if routes_moved(before) != {"wide": 1}:
            raise AssertionError(f"{m}x{k}x{n} took {routes_moved(before)}, not wide")
        for key in ("ms", "wide128_ms", "library_ms", "plain_ms", "library_ms", "wide128_ms",
                    "ms"):
            fn = {"ms": kern, "wide128_ms": wide128, "library_ms": lambda: torch.matmul(a, b),
                  "plain_ms": plain}[key]
            t.setdefault(key, []).append(event_ms(fn, 3))
        e = _check_rows("k1-prefill", f"K1 bfloat16 {m}x{k}x{n}", kept["out"],
                        kept["ref"], ROW_TOL[torch.bfloat16])
        e["tiles_bitwise_equal"] = bool(torch.equal(kept["out"], kept["w128"]))
        del kept
        bms, by = bound(m, k, n, torch.bfloat16)
        row = {"shape": [m, k, n], **{key: min(v) for key, v in t.items()},
               "bound_ms": bms, "bound_by": by, "check": e}
        rows.append(row)
        log(f"[k1-prefill] {m}x{k}x{n} K1 wide {row['ms']:.3f}ms "
            f"({2.0 * m * k * n / row['ms'] / 1e9:.0f} TFLOP/s; 128x128 tile "
            f"{row['wide128_ms']:.3f}ms, bitwise equal {e['tiles_bitwise_equal']}) "
            f"torch.matmul {row['library_ms']:.3f}ms "
            f"plain {row['plain_ms']:.3f}ms bound {bms:.3f}ms ({by})")
        del a, b
    torch.cuda.empty_cache()
    return rows


def phase_long_prefill(dev: torch.device, flash: dict) -> dict:
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full((1, 1), -100, device=dev)], dim=1)
    want = {"K2": cfg.num_layers, "K1": train_products(cfg)}
    with torch.no_grad():
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        with k1_calls() as calls:
            logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = {"K2": k2.launches, "K1": k1.launches}
        by_route = {r: v for r, v in k1.launches_by_route.items() if v}
        k2_routes = {r: v for r, v in k2.launches_by_route.items() if v}
        log(f"[long-prefill] {cfg.name} bf16 S={PREFILL_S}: forward launched K2 "
            f"{got['K2']}x, K1 {got['K1']}x (want {want}); first call {first_s:.2f}s "
            f"with set-up; K2 by route {k2_routes}, K1 by route {by_route}")
        if (got != want or by_route != {"wide": want["K1"]}
                or k2_routes != {"wgmma": want["K2"]}):
            raise AssertionError(f"launches {got} (K2 {k2_routes}, K1 {by_route}), want "
                                 f"{want}, K2 all wgmma, K1 all wide")
        if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"logits malformed: {tuple(logits.shape)}")
        k1.reset_launches()
        k2.reset_launches()
        loss, parts = model.loss(params, {"tokens": tokens, "labels": labels})
        loss = loss.item()
        if (k2.launches, k1.launches) != (want["K2"], want["K1"]) or not math.isfinite(loss):
            raise AssertionError(f"loss: launches K2 {k2.launches} K1 {k1.launches}, "
                                 f"loss {loss}")
        fwd_ms = event_ms(lambda: model.forward(params, tokens), 2)
        xlogits, _ = xla.forward(params, tokens)
        xloss = cross_entropy(xlogits, labels).item()
        routes = {"flash": {**row_err(logits, xlogits), "loss": loss}}
        del logits
        for what, window in PREFILL_CONTROLS.items():
            wrong = build_model(dataclasses.replace(cfg, window=window))
            clogits, _ = wrong.forward(params, tokens)
            routes[what] = {**row_err(clogits, xlogits),
                            "loss": cross_entropy(clogits, labels).item()}
            del clogits
        del xlogits
    torch.cuda.empty_cache()
    for what, e in routes.items():
        log(f"[long-prefill] {what} vs xla: logits worst row rel {e['row_rel']:.3e} "
            f"(mean {e['row_rel_mean']:.3e}), loss {e['loss']:.6f} against {xloss:.6f} "
            f"(|diff| {abs(e['loss'] - xloss):.3e}); limit {PREFILL_LOGITS_TOL:g}")
    rel = routes["flash"]["row_rel"]
    if not routes["flash"]["finite"] or rel >= PREFILL_LOGITS_TOL:
        raise AssertionError(f"flash and xla routes disagree: {routes['flash']}")
    for what in PREFILL_CONTROLS:
        if routes[what]["row_rel"] < PREFILL_LOGITS_TOL:
            raise AssertionError(f"the limit {PREFILL_LOGITS_TOL} cannot tell the xla route "
                                 f"from a wrong attention core ({what}): {routes[what]}")
    k2_ms = cfg.num_layers * flash["timings"]["danube"]["ms"]
    k2_mma_ms = cfg.num_layers * flash["timings"]["danube"]["mma_ms"]
    k1_fwd = {key: cfg.num_layers * sum(r[key] for r in flash["projections"])
              for key in ("ms", "wide128_ms", "library_ms", "plain_ms", "bound_ms")}
    k1_ms = k1_fwd["ms"]
    tok_s = PREFILL_S / (fwd_ms / 1e3)
    log(f"[long-prefill] forward device time {fwd_ms:.1f}ms ({tok_s:.0f} prefill tokens/s); "
        f"K1 {k1_ms:.1f}ms ({k1_ms / fwd_ms:.1%}), K2 {k2_ms:.1f}ms ({k2_ms / fwd_ms:.1%}), "
        f"rest {fwd_ms - k1_ms - k2_ms:.1f}ms; K2's {want['K2']} launches on the mma route "
        f"{k2_mma_ms:.1f}ms; K1's {want['K1']} products: 128x128 tile "
        f"{k1_fwd['wide128_ms']:.1f}ms, torch.matmul "
        f"{k1_fwd['library_ms']:.1f}ms, plain {k1_fwd['plain_ms']:.1f}ms, "
        f"bound {k1_fwd['bound_ms']:.1f}ms")
    del params
    torch.cuda.empty_cache()
    checked = check_k1_calls(calls, dev, head_n=padded_vocab(cfg.vocab_size))
    log(f"[long-prefill] K1's {checked['calls']} calls ({len(checked['distinct'])} distinct, "
        f"the unembedding's among them) each within ROW_TOL of the plain version at its own "
        f"shape, blocks and layouts (worst row rel {checked['worst_row_rel']:.3e})")
    fp32 = fp32_check(dev)
    return {"launches": want, "k1_routes": by_route, "k2_routes": k2_routes,
            "k1_check": checked,
            "first_forward_s": first_s, "loss": loss, "xla_loss": xloss,
            "ce": parts["ce"].item(), "logits_rel_err": rel, "routes": routes,
            "forward_ms": fwd_ms,
            "tokens_per_s": tok_s, "k1_ms": k1_ms, "k1_per_forward": k1_fwd, "k2_ms": k2_ms,
            "k2_mma_ms": k2_mma_ms,
            "fp32": fp32,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def fp32_check(dev: torch.device) -> dict:
    """2-layer full-width fp32 danube at S = 8192 (past the 4096 window):
    the flash route against the xla route on the card, within 1e-4."""
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), num_layers=FP32_CHECK_LAYERS,
                              dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, FP32_CHECK_S)))
    tokens = tokens.to(dev)
    with torch.no_grad():
        k2.reset_launches()
        flash_logits, _ = model.forward(params, tokens)
        launches = k2.launches_by_route["fma"]
        xla_logits, _ = xla.forward(params, tokens)
        e = row_err(flash_logits, xla_logits)
    rel = e["row_rel"]
    log(f"[long-prefill] {FP32_CHECK_LAYERS}-layer fp32 S={FP32_CHECK_S}: flash vs xla "
        f"logits worst row rel {rel:.3e} (mean {e['row_rel_mean']:.3e}, limit "
        f"{FP32_CHECK_TOL:g}); K2 launches {launches}")
    if launches != FP32_CHECK_LAYERS or not e["finite"] or rel >= FP32_CHECK_TOL:
        raise AssertionError(f"fp32 flash route: launches {launches}, {e}")
    del params, flash_logits, xla_logits
    torch.cuda.empty_cache()
    return {"rel_err": rel, "launches": launches}


# -- the plan engine (phases 7-9) ------------------------------------------------


def _wrong_ring_ag(x, w, axis, *, out_dtype=None, local_fn=None):
    """``ring_ag_matmul`` writing each resident chunk to the wrong row slot
    (``idx + s`` where the origin is ``idx - s``): a control."""
    local_fn = local_fn or local_matmul
    n, idx = _collectives.axis_size(axis), _collectives.axis_index(axis)
    chunk = x.shape[-2]
    out = torch.zeros(n * chunk, w.shape[-1], dtype=out_dtype, device=x.device)
    perm = [(d, (d + 1) % n) for d in range(n)]
    cur = x
    for step in range(n):
        nxt = _collectives.ppermute(cur, axis, perm) if step < n - 1 else None
        src = (idx + step) % n
        out[src * chunk:(src + 1) * chunk] = local_fn(cur, w, out_dtype=out_dtype)
        cur = nxt
    return out


def _wrong_ring_rs(y, w, axis, *, out_dtype=None, local_fn=None):
    """``ring_rs_matmul`` passing its partial sums the wrong way round the
    ring (-1 hops under the +1 chain's chunk order): a control."""
    local_fn = local_fn or local_matmul
    n, idx = _collectives.axis_size(axis), _collectives.axis_index(axis)
    partial = local_fn(y, w, out_dtype=torch.float32)
    chunk = partial.shape[-2] // n
    perm = [(d, (d - 1) % n) for d in range(n)]
    acc = None
    for step in range(n):
        c = (idx + n - 1 - step) % n
        mine = partial[c * chunk:(c + 1) * chunk]
        acc = mine if acc is None else acc + mine
        if step < n - 1:
            acc = _collectives.ppermute(acc, axis, perm)
    return acc.to(out_dtype)


def _drop_b_skew(body_fn):
    return lambda prog, *a, **kw: body_fn(dataclasses.replace(prog, skew_b=()), *a, **kw)


PLAN_CONTROLS = {
    "cannon without B skew": lambda: [
        mock.patch.object(lower_dist_mod, "torus_program_body",
                          _drop_b_skew(lower_dist_mod.torus_program_body)),
        mock.patch.object(lower_dist_mod, "torus_program_body_overlapped",
                          _drop_b_skew(lower_dist_mod.torus_program_body_overlapped))],
    "ring_ag wrong slot": lambda: [
        mock.patch.object(lower_dist_mod, "ring_ag_matmul", _wrong_ring_ag)],
    "ring_rs wrong way": lambda: [
        mock.patch.object(lower_dist_mod, "ring_rs_matmul", _wrong_ring_rs)],
}


CONTROL_OF = {"cannon": "cannon without B skew", "ring_ag": "ring_ag wrong slot",
              "ring_rs": "ring_rs wrong way"}


@contextlib.contextmanager
def wrong_program(what: str):
    """Within the scope every product of one strategy runs a wrong program
    (``PLAN_CONTROLS``); compiled lowerings are dropped on entry and exit."""
    lower_dist_mod._lower_dist_cached.cache_clear()
    try:
        with contextlib.ExitStack() as stack:
            for patch in PLAN_CONTROLS[what]():
                stack.enter_context(patch)
            yield
    finally:
        lower_dist_mod._lower_dist_cached.cache_clear()


def _nonzero(counts: dict) -> dict:
    return {r: v for r, v in counts.items() if v}


def _check_control(phase: str, what: str, e: dict, tol: float) -> None:
    log(f"[{phase}] control {what}: worst row rel={e['row_rel']:.3e} (must be >= {tol:g})")
    if e["row_rel"] < tol:
        raise AssertionError(f"the limit {tol} cannot tell a wrong program ({what}): {e}")


def account_bytes(label: str, cap, copied: dict, ranks: int) -> dict:
    """Phase 7's copied bytes through the trace of the one plan executed:
    the executed collectives must be the trace's multiset, and for ppermute
    and all_gather the bytes ``_collectives.stats`` counted must equal the
    trace's words times the element size each call carried, phase by phase
    (placement skew, movement, collection restore, gather).  psum is given
    in both conventions with no limit: the thread communicator copies
    g - 1 shards into each rank, the trace prices a ring all-reduce."""
    if len(cap.lowered_plans) != 1:
        raise AssertionError(f"{label}: {len(cap.lowered_plans)} plans lowered, want 1")
    tr = trace_plan(cap.lowered_plans[0])
    compare_records(tr.records, cap.records)
    by_phase = phase_bytes(tr, cap)
    words: dict = {}
    for r in tr.records:
        words[r.kind, r.phase] = words.get((r.kind, r.phase), 0.0) + r.words_total(tr.mesh_size)
    for kind in ("ppermute", "all_gather"):
        want = sum(v for (kd, _), v in by_phase.items() if kd == kind)
        if copied[kind]["bytes"] != want:
            raise AssertionError(f"{label}: {kind} copied {copied[kind]['bytes']} bytes, the "
                                 f"trace's words x element sizes give {want}: {by_phase}")
    psum_ring = sum(v for (kd, _), v in by_phase.items() if kd == "psum")
    return {
        "by_phase": {f"{kd} {ph}": {"mb_per_rank": v / ranks / 1e6,
                                    "words_per_rank": words[kd, ph] / ranks,
                                    "itemsize": v / words[kd, ph]}
                     for (kd, ph), v in by_phase.items() if kd != "psum"},
        "psum": {"copied_mb_per_rank": copied["psum"]["bytes"] / ranks / 1e6,
                 "ring_mb_per_rank": psum_ring / ranks / 1e6} if psum_ring else None,
    }


@contextlib.contextmanager
def done_at_start():
    """Each deferred ppermute finished right after its start (patched here
    only): the overlapped bodies' blocking twin, and the control of the
    hidden share."""
    start, done = _collectives.ppermute_start, _collectives.ppermute_done
    with mock.patch.object(_collectives, "ppermute_start",
                           lambda x, axis_name, perm: done(start(x, axis_name, perm))), \
            mock.patch.object(_collectives, "ppermute_done", lambda finished: finished):
        yield


@contextlib.contextmanager
def counted_dones():
    """Within the scope, count the deferred ppermutes finished."""
    done, count = _collectives.ppermute_done, [0]

    def counting(started):
        count[0] += 1
        return done(started)

    with mock.patch.object(_collectives, "ppermute_done", counting):
        yield count


@contextlib.contextmanager
def copy_log(step_perms):
    """Within the scope, every rank's ppermute copy (``RankStreams.copy_in``,
    the only work of the copy streams) is logged in its copy stream's
    order, keyed by the stream's handle, as a prefetch or not: a prefetch
    is a deferred ppermute's copy, or one of the staged Cannon body's A/B
    step permutes (``step_perms``), the copies its overlapped twin
    defers."""
    log_by_stream: dict = {}
    flag = threading.local()
    start, permute, copy_in = (_collectives.ppermute_start, cannon_mod._permute,
                               _collectives.RankStreams.copy_in)

    def flagged(fn, x, axes, perm):
        flag.on = True
        try:
            return fn(x, axes, perm)
        finally:
            flag.on = False

    def logged_copy_in(self, *args):
        log_by_stream.setdefault(self.copy.cuda_stream, []).append(
            bool(getattr(flag, "on", False)))
        return copy_in(self, *args)

    def step_permute(x, axes, perm):
        if perm is not None and tuple(map(tuple, perm)) in step_perms:
            return flagged(permute, x, axes, perm)
        return permute(x, axes, perm)

    with mock.patch.object(_collectives, "ppermute_start",
                           lambda x, axes, perm: flagged(start, x, axes, perm)), \
            mock.patch.object(cannon_mod, "_permute", step_permute), \
            mock.patch.object(_collectives.RankStreams, "copy_in", logged_copy_in):
        yield log_by_stream


def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(span, union) -> float:
    a, b = span
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def hidden_shares(events: list, log_by_stream: dict, ranks: int) -> dict:
    """From a chrome trace's events: each rank's prefetch copies against
    the K1 kernels of the same rank.  A rank is a (compute stream, copy
    stream) pair: K1 runs on compute streams only, and a copy stream is
    paired, by a vote of its memcpys, with the compute stream of the next K1
    launch the copy's host thread made (a thread runs one rank a product,
    and a rank launches K1 after each of its copies).  A copy
    stream's memcpys, in stream order, are told apart by ``copy_log``'s
    flags, whose key (a stream handle) the trace does not carry: they are
    matched by their issue order.  ``hidden``: the share of the prefetch
    copies' device time that lies under a K1 kernel of the same rank;
    ``under_any_k1``: under any rank's."""
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    k1, copies = [], []
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr not in runtime or "dur" not in e:
            continue
        host = runtime[corr]
        row = (float(host["ts"]), host["tid"], e["args"].get("stream"),
               (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if e.get("cat") == "kernel" and any(x in e["name"] for x in K1_KERNELS):
            k1.append(row)
        elif e.get("cat") == "gpu_memcpy":
            copies.append(row)
    compute = {r[2] for r in k1}
    if len(compute) != ranks:
        raise AssertionError(f"the trace shows K1 on {len(compute)} streams, want one per "
                             f"rank ({ranks})")
    k1_by_tid: dict = {}
    for r in k1:
        k1_by_tid.setdefault(r[1], []).append(r)
    votes: dict = {}
    by_copy_stream: dict = {}
    for r in copies:
        if r[2] in compute or r[1] not in k1_by_tid:
            continue     # a compute stream's memcpy, or not a rank thread's
        later = [k for k in k1_by_tid[r[1]] if k[0] >= r[0]] or k1_by_tid[r[1]]
        near = min(later, key=lambda k: abs(k[0] - r[0]))
        votes.setdefault(r[2], Counter())[near[2]] += 1
        by_copy_stream.setdefault(r[2], []).append(r[3])
    patterns: dict = {}
    for flags in log_by_stream.values():
        patterns.setdefault(len(flags), set()).add(tuple(flags))
    k1_union = {s: _union(r[3] for r in k1 if r[2] == s) for s in compute}
    all_k1 = _union(r[3] for r in k1)
    hidden = total = under_any = 0.0
    counted = 0
    for stream, spans in by_copy_stream.items():
        pats = patterns.get(len(spans), set())
        if len(pats) != 1:
            raise AssertionError(f"copy stream {stream}'s {len(spans)} memcpys match no one "
                                 f"logged issue order: {log_by_stream}")
        own = k1_union[votes[stream].most_common(1)[0][0]]
        for span, pre in zip(sorted(spans), next(iter(pats))):
            if pre:
                counted += 1
                total += span[1] - span[0]
                hidden += _covered(span, own)
                under_any += _covered(span, all_k1)
    if not counted:
        raise AssertionError("the trace shows no prefetch copy")
    return {"hidden": hidden / total, "under_any_k1": under_any / total,
            "prefetch_copies": counted, "prefetch_copy_us": total, "hidden_us": hidden}


def profile_hidden(planned, plan, label: str) -> dict:
    """``HIDE_PRODUCTS`` products queued behind ``HIDE_SLEEP_S`` of device
    sleep, under ``torch.profiler``: the hidden share of their prefetch
    copies
    (``hidden_shares``); the trace saved gzipped to ``chiprun_out/``."""
    from torch.profiler import ProfilerActivity, profile

    steps = set()
    if plan.torus is not None:
        steps = {tuple(map(tuple, p)) for p in (plan.torus.step_a, plan.torus.step_b) if p}
    planned()
    torch.cuda.synchronize()
    with copy_log(steps) as logged, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(HIDE_SLEEP_S * max_sm_clock_hz()))
        for _ in range(HIDE_PRODUCTS):
            planned()
        torch.cuda.synchronize()
    os.makedirs(OUT_DIR, exist_ok=True)
    raw = os.path.join(OUT_DIR, f"profile_hidden_{re.sub(r'[^a-z0-9]+', '_', label)}.json")
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        events = json.load(f)["traceEvents"]
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(raw)
    out = hidden_shares(events, logged, plan.mesh.size)
    out["trace"] = os.path.relpath(raw + ".gz", ROOT)
    return out


def captured_product(planned, reps: int = 3) -> tuple:
    """(output, device ms): ``planned()`` captured in a CUDA graph (its rank
    streams the graph's branches), replayed once to warm, then ``reps``
    replays each timed by CUDA events (the least); the output is the
    graph's, after the replays."""
    planned()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        out = planned()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    out = out.clone()
    del graph
    return out, best


def bitwise_twins(label: str, planned, out: torch.Tensor, deferred: bool, staged) -> list:
    """Hold an overlapped cell's output to its twins, bit for bit: the same
    body with each done right after its start (where the body defers its
    ppermutes) and, for a pure reorder (cannon, cannon25d), the staged
    body's output (``staged``); the twins it equals."""
    twins = []
    if deferred:
        with done_at_start():
            twin = planned()
        if not torch.equal(twin, out):
            raise AssertionError(f"{label}: the deferred ppermutes changed the output's bits "
                                 f"against the same body finishing each at once")
        twins.append("the body with each done right after its start")
        del twin
    if staged is not None:
        if not torch.equal(staged, out):
            raise AssertionError(f"{label}: the output's bits differ from the staged twin's")
        twins.append("the staged body")
    return twins


def check_hidden(label: str, row: dict) -> None:
    """cannon+ov must hide part of its prefetch copies under its own
    rank's K1, and the control (each done right after its start) less."""
    got, control = row["hidden"]["hidden"], row["hidden_control"]["hidden"]
    if not got > 0 or not control < got:
        raise AssertionError(f"{label}: hidden share {got:.4f}, control {control:.4f}: the "
                             f"prefetch copies do not run under the rank's K1")


def phase_plan_sweep(dev: torch.device, gen: torch.Generator) -> dict:
    m, k, n = PLAN_SWEEP_SHAPE
    bf16 = torch.bfloat16
    a = torch.randn(m, k, generator=gen, device=dev).to(bf16)
    b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(bf16)
    ref = matmul(a, b)
    k1_ms = event_ms(lambda: matmul(a, b), 5)
    log(f"[plan-sweep] {m}x{k}x{n} bf16: K1 alone {k1_ms:.3f}ms "
        f"(route {k1.route(m, n, k, bf16)})")
    meshes, rows, staged_outs = {}, [], {}
    for sizes, names, strategy, overlap in PLAN_SWEEP_CELLS:
        if (sizes, names) not in meshes:
            meshes[sizes, names] = Mesh(sizes, names, device=dev)
        mesh = meshes[sizes, names]
        plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, overlap=overlap,
                          a_dtype=bf16, b_dtype=bf16)
        label = f"{strategy}{'+ov' if plan.overlap else ''} on {'x'.join(map(str, sizes))}"

        def planned(mesh=mesh, strategy=strategy, overlap=overlap):
            return symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)

        # the check run (untimed) reads each collective call's element size
        # at the seam, to account for the copied bytes through the trace
        _collectives.reset_stats()
        with k1.trace_launches() as trace, intercept() as cap, counted_dones() as dones:
            out = planned()
            torch.cuda.synchronize()
        deferred = dones[0] > 0
        copied = {kind: dict(v) for kind, v in _collectives.stats.items()}
        accounted = account_bytes(label, cap, copied, mesh.size)
        routes = {}
        for (pm, pn, pk, r) in trace:
            if r != k1.route(pm, pn, pk, bf16):
                raise AssertionError(f"{label}: a {pm}x{pk}x{pn} block product took {r}, "
                                     f"not {k1.route(pm, pn, pk, bf16)}")
            routes[r] = routes.get(r, 0) + 1
        e = _check_rows("plan-sweep", f"{label} vs K1 alone", out, ref, PLAN_ROW_TOL)
        twins = bitwise_twins(label, planned, out, deferred, staged_outs.get((sizes, strategy)))
        if strategy in ("cannon", "cannon25d") and not plan.overlap:
            staged_outs[sizes, strategy] = out
        graph_out, graph_ms = captured_product(planned)
        if not torch.equal(graph_out, out):
            raise AssertionError(f"{label}: the captured product's replay differs from the "
                                 f"eager run's bits")
        del out, graph_out
        _, in_specs, _ = lower_dist_mod.rule(plan)

        def scatter(mesh=mesh, in_specs=in_specs):
            return [lower_dist_mod.scatter(x, spec, mesh) for x, spec in zip((a, b), in_specs)]

        t = {}
        for key in ("ms", "scatter_ms", "scatter_ms", "ms"):
            t.setdefault(key, []).append(event_ms({"ms": planned, "scatter_ms": scatter}[key], 3))
        t0 = time.perf_counter()
        planned()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        moved = sum(v["bytes"] for v in copied.values()) / mesh.size
        row = {"mesh": list(sizes), "axes": list(names), "strategy": strategy,
               "overlap": plan.overlap, "grid": list(plan.grid), "pad_a": list(plan.pad_a),
               "pad_b": list(plan.pad_b), "k1_launches": len(trace), "k1_routes": routes,
               "block_shapes": sorted({tuple(x[:3]) for x in trace}), "check": e,
               "ms": min(t["ms"]), "scatter_ms": min(t["scatter_ms"]), "runs": t,
               "host_ms": host_ms, "k1_alone_ms": k1_ms,
               "cost": {"comm_bytes_per_rank": plan.cost.comm_bytes, "msgs": plan.cost.msgs,
                        "compute_s": plan.cost.compute_s, "comm_s": plan.cost.comm_s},
               "copied_bytes_per_rank": moved, "collectives": copied, "accounted": accounted,
               "deferred_dones": dones[0], "graph_ms": graph_ms, "bitwise_twins": twins}
        if deferred or (strategy == "cannon" and sizes == (2, 2)):
            row["hidden"] = profile_hidden(planned, plan, label)
            if deferred and strategy == "cannon" and sizes == (2, 2):
                with done_at_start():
                    row["hidden_control"] = profile_hidden(planned, plan, label + " control")
                check_hidden(label, row)
        rows.append(row)
        log(f"[plan-sweep] {label:22s} {row['ms']:8.3f}ms eager, {graph_ms:.3f}ms captured "
            f"(K1 alone {k1_ms:.3f}, scatter of "
            f"both operands {row['scatter_ms']:.3f}, host {host_ms:.1f}ms); K1 {len(trace)} "
            f"launches {routes}; cost words {plan.cost.comm_bytes / 1e6:.2f} MB/rank in "
            f"{plan.cost.msgs} msgs, copied {moved / 1e6:.2f} MB/rank "
            + ", ".join(f"{kd} {v['calls']}x" for kd, v in copied.items() if v["calls"]))
        parts = [f"{key} {v['mb_per_rank']:.2f} ({v['words_per_rank'] / 1e6:.2f}M words x "
                 f"{v['itemsize']:g} B)" for key, v in accounted["by_phase"].items()]
        if accounted["psum"]:
            parts.append(f"psum copied {accounted['psum']['copied_mb_per_rank']:.2f} (g - 1 "
                         f"shards into each rank) vs {accounted['psum']['ring_mb_per_rank']:.2f} "
                         f"(the trace's ring all-reduce, 2 (g - 1) shards per group), no limit")
        log(f"[plan-sweep] {'':22s} copied bytes by phase, trace words x the element size "
            f"each call carried (MB/rank): " + "; ".join(parts))
        if twins:
            log(f"[plan-sweep] {'':22s} bitwise equal to " + ", ".join(twins)
                + f" ({dones[0]} deferred ppermutes finished)")
        for key in ("hidden", "hidden_control"):
            if key in row:
                h = row[key]
                log(f"[plan-sweep] {'':22s} {'control (each done right after its start)' if key == 'hidden_control' else 'profiled'}: "
                    f"hidden share {h['hidden']:.3f} of {h['prefetch_copies']} prefetch "
                    f"copies' {h['prefetch_copy_us']:.1f}us under the same rank's K1 "
                    f"({h['under_any_k1']:.3f} under any rank's)")
    del staged_outs
    pairs = {}
    for r in rows:
        pairs.setdefault((tuple(r["mesh"]), r["strategy"]), {})[r["overlap"]] = r
    twin_ms = {f"{st} on {'x'.join(map(str, sz))}": {
        "staged_graph_ms": v[False]["graph_ms"], "overlapped_graph_ms": v[True]["graph_ms"],
        "staged_eager_ms": v[False]["ms"], "overlapped_eager_ms": v[True]["ms"]}
        for (sz, st), v in pairs.items() if set(v) == {False, True}}
    for key, v in twin_ms.items():
        log(f"[plan-sweep] twins {key}: captured staged {v['staged_graph_ms']:.3f}ms, "
            f"overlapped {v['overlapped_graph_ms']:.3f}ms "
            f"({v['overlapped_graph_ms'] / v['staged_graph_ms']:.2f}x); eager "
            f"{v['staged_eager_ms']:.3f} / {v['overlapped_eager_ms']:.3f}ms")
    controls = {}
    for what, (sizes, names), strategy in (
            ("cannon without B skew", ((2, 2), ("x", "y")), "cannon"),
            ("ring_ag wrong slot", ((4,), ("t",)), "ring_ag")):
        with wrong_program(what):
            out = symmetric_matmul(a, b, mesh=meshes[sizes, names], strategy=strategy)
        controls[what] = row_err(out, ref)
        _check_control("plan-sweep", what, controls[what], PLAN_ROW_TOL)
        del out
    for mesh in meshes.values():
        mesh.close()
    del a, b, ref
    torch.cuda.empty_cache()
    return {"shape": [m, k, n], "k1_alone_ms": k1_ms, "cells": rows, "controls": controls,
            "twins": twin_ms, "k1_launches": sum(r["k1_launches"] for r in rows)}


def phase_planned_serve(dev: torch.device) -> dict:
    """Phase 8: phase 4's workload through ``Server(mesh=2x2)``, captured
    per bucket (the rank streams the graphs' branches) and replayed,
    against the eager planned path on the same bucket-padded batch:
    identical tokens; a failed capture fails the run."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=SERVE_MAX_SEQ)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    local = Server(model, params, sc, buckets=SERVE_BUCKETS)
    local.warmup()
    local_tokens = local.generate(prompts).new_tokens
    products = 7 * cfg.num_layers * SERVE_NEW
    k1.reset_launches()
    server = Server(model, params, sc, mesh=mesh, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    log(f"[planned-serve] mesh {dict(mesh.shape)} warmup " + ", ".join(
        f"{k} {v['warm_s']:.2f}s + {v['graphs']} graphs captured in {v['capture_s']:.2f}s"
        for k, v in warm.items()) + f"; K1 counted in warmup and captures {path['routes']}")
    runs = served_runs(server, prompts, 2, "planned-serve", cfg.vocab_size)
    path_counts(path, runs)
    for r in runs:
        if (not r["graphs"] or r["counted"] or sum(r["strategies"].values()) != products
                or set(r["routes"]) != {"thin"}):
            raise AssertionError(f"a captured planned run served {r['strategies']} products "
                                 f"({r['routes']}, counted from Python {r['counted']}), want "
                                 f"{products} by graph replays, all K1 launches thin")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two planned generate runs disagree")
    eager = eager_runs(model, params, sc, prompts, 1, "planned-serve", mesh=mesh)
    for r in eager:
        if (r["graphs"] or sum(r["strategies"].values()) != products
                or set(r["routes"]) != {"thin"} or r["counted"] != r["routes"]):
            raise AssertionError(f"an eager planned run served {r['strategies']} ({r['routes']})")
        if r["tokens"] != runs[0]["tokens"]:
            raise AssertionError("the captured planned steps' tokens differ from the eager "
                                 "planned path's")
    agree = sum(x == y for p, r in zip(runs[0]["tokens"], local_tokens) for x, y in zip(p, r))
    path["report"] = server.cache_report()
    log(f"[planned-serve] tokens bitwise equal across the two captured runs and the eager "
        f"planned run; {agree} of {len(prompts) * SERVE_NEW} agree with mesh=None (printed, "
        f"not held); graphs {path['report']['graphs']}")
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}
               for name, rs in (("graphs", runs), ("eager", eager))}
    # the planned prefill's last-token logits against mesh=None's
    batch, lens = batch_requests(prompts, pad_to=SERVE_BUCKETS[0][1])
    tokens = torch.as_tensor(batch, dtype=torch.int64, device=dev)
    offsets = torch.as_tensor(batch.shape[1] - lens, dtype=torch.int64, device=dev)

    def prefill():
        return model.prefill(params, model.init_cache(len(prompts), 64, dev), tokens, offsets)[0]

    with torch.no_grad():
        ref = prefill()
        lower_dist_mod.reset_executions()
        with planned_matmuls(mesh):
            got = prefill()
        prefill_plans = lower_dist_mod.executions_snapshot()
        e = _check_rows("planned-serve", f"planned prefill logits ({prefill_plans}) vs "
                        f"mesh=None", got, ref, PLANNED_LOGITS_TOL)
        # the wrong program replaces the strategy the prefill ran most
        wrong = "ring_rs wrong way" if prefill_plans.get("ring_rs+ov", 0) >= \
            prefill_plans.get("ring_ag+ov", 0) else "ring_ag wrong slot"
        with wrong_program(wrong), planned_matmuls(mesh):
            control = row_err(prefill(), ref)
        _check_control("planned-serve", wrong, control, PLANNED_LOGITS_TOL)
        step_ms = planned_step_ms(model, params, mesh, dev)
    log(f"[planned-serve] decode step device time (CUDA events, eager, bucket 4x16): planned "
        f"{step_ms['planned_ms']:.3f}ms, mesh=None {step_ms['local_ms']:.3f}ms; CUDA graph of "
        f"a planned decode step (its rank streams the graph's branches) replays in "
        f"{step_ms['graph']['replay_ms']:.3f}ms (every rank on one stream: "
        f"{ONE_STREAM['planned_step_replay_ms']}ms); captured p50 "
        f"{summary['graphs']['p50_ms']:.2f}ms (one stream: {ONE_STREAM['planned_p50_ms']}ms)")
    mesh.close()
    del server, local, params
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.shape), "warmup": warm, "runs": runs, "eager_runs": eager,
            "summary": summary, "path": path, "agree_with_local": agree,
            "local_tokens": local_tokens, "prefill_logits": e, "prefill_plans": prefill_plans,
            "control": {wrong: control},
            "step": step_ms}


def planned_step_ms(model, params, mesh, dev: torch.device) -> dict:
    """One decode step at the (4, 16) bucket, eager, by CUDA events:
    mesh=None and planned in turns; then the planned step captured in a
    CUDA graph (each rank's compute and copy streams forked from the
    capturing stream and joined back: the graph's branches) and one replay
    timed."""
    batch, seq = SERVE_BUCKETS[0]
    cache = model.init_cache(batch, 64, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(batch, 1))).to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)

    def local():
        return model.decode_step(params, cache, tokens, seq, offsets)

    def planned():
        with planned_matmuls(mesh):
            return model.decode_step(params, cache, tokens, seq, offsets)

    t, last = {}, None
    for key in ("local_ms", "planned_ms", "planned_ms", "local_ms"):
        t.setdefault(key, []).append(event_ms({"local_ms": local, "planned_ms": planned}[key], 1,
                                              warm=key != last))
        last = key
    out = {key: min(v) for key, v in t.items()}
    out["runs"] = t
    # a failed capture raises here and fails the run
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        planned()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    out["graph"] = {"captured": True, "replay_ms": start.elapsed_time(end)}
    del graph
    # the card is still sound after the capture
    x = torch.randn(64, 256, device=dev).to(torch.bfloat16)
    w = torch.randn(256, 128, device=dev).to(torch.bfloat16)
    if row_err(matmul(x, w), matmul_ref(x, w))["row_rel"] >= ROW_TOL[torch.bfloat16]:
        raise AssertionError("K1 disagrees with its plain version after the graph capture")
    torch.cuda.synchronize()
    return out


def phase_planned_prefill(dev: torch.device) -> dict:
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    products = 7 * cfg.num_layers

    def planned():
        with planned_matmuls(mesh):
            return model.forward(params, tokens)[0]

    with torch.no_grad():
        ref, _ = model.forward(params, tokens)
        lower_dist_mod.reset_executions()
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        logits = planned()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        plans = lower_dist_mod.executions_snapshot()
        k1_routes, k2_routes = _nonzero(k1.launches_by_route), _nonzero(k2.launches_by_route)
        want_k1 = UNEMBED_LAUNCHES + sum(v * LAUNCHES_PER_PRODUCT_2X2.get(
            s, LAUNCHES_PER_PRODUCT_2X2.get(s.split("+")[0], 0)) for s, v in plans.items())
        log(f"[planned-prefill] {cfg.name} bf16 S={PREFILL_S} on mesh {dict(mesh.shape)}: "
            f"products {plans}; K1 {k1.launches}x {k1_routes} (want {want_k1}), K2 "
            f"{k2.launches}x {k2_routes}; first call {first_s:.2f}s")
        if (sum(plans.values()) != products or k1.launches != want_k1
                or set(k1_routes) != {"wide"} or k2_routes != {"wgmma": cfg.num_layers}):
            raise AssertionError(f"planned forward: products {plans} (want {products}), K1 "
                                 f"{k1_routes} (want {want_k1} wide), K2 {k2_routes}")
        if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size):
            raise AssertionError(f"logits malformed: {tuple(logits.shape)}")
        e = _check_rows("planned-prefill", "planned logits vs the unplanned forward", logits,
                        ref, PREFILL_LOGITS_TOL)
        del logits
        controls = {}
        # a wrong program for each strategy the forward ran (at S = 32768 on
        # 2x2: Cannon and ring_rs)
        for what in [CONTROL_OF[s.split("+")[0]] for s in plans if s.split("+")[0] in CONTROL_OF]:
            with wrong_program(what):
                controls[what] = row_err(planned(), ref)
            _check_control("planned-prefill", what, controls[what], PREFILL_LOGITS_TOL)
        if not controls:
            raise AssertionError(f"no wrong program covers the strategies taken: {plans}")
        del ref
        torch.cuda.empty_cache()

        def local():
            return model.forward(params, tokens)[0]

        def one_stream():
            # every rank on the caller's stream, as before rank streams
            # (patched here only): the control of the rank streams' time
            with mock.patch.object(mesh, "_rank_streams", lambda: [None] * mesh.size):
                return planned()

        t, last = {}, None
        fns = {"local_ms": local, "planned_ms": planned, "one_stream_ms": one_stream}
        for key in ("local_ms", "planned_ms", "one_stream_ms", "one_stream_ms", "planned_ms",
                    "local_ms"):
            t.setdefault(key, []).append(event_ms(fns[key], 1, warm=key != last))
            last = key
    out = {key: min(v) for key, v in t.items()}
    log(f"[planned-prefill] forward device time (CUDA events): planned {out['planned_ms']:.1f}ms "
        f"({PREFILL_S / out['planned_ms'] * 1e3:.0f} prefill tokens/s; every rank on the "
        f"caller's stream {out['one_stream_ms']:.1f}ms), unplanned "
        f"{out['local_ms']:.1f}ms ({PREFILL_S / out['local_ms'] * 1e3:.0f}); runs {t}")
    mesh.close()
    del params
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.shape), "plans": plans, "k1_launches": want_k1,
            "k1_routes": k1_routes, "k2_routes": k2_routes, "first_forward_s": first_s,
            "logits": e, "controls": controls, **out, "runs": t,
            "tokens_per_s": PREFILL_S / out["planned_ms"] * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


# -- conformance (phase 10) ---------------------------------------------------------


def _plan_label(plan) -> str:
    return (f"{plan.strategy}{'+ov' if plan.overlap else ''} on "
            f"{'x'.join(str(plan.mesh.shape[a]) for a in plan.mesh.axis_names)} "
            f"({plan.m}x{plan.k}x{plan.n} {str(plan.out_dtype).replace('torch.', '')})")


def _expect_caught(what: str, leg: str, fn) -> str:
    """Run a control that must fail conformance at ``leg``."""
    try:
        fn()
    except ConformanceError as e:
        if not str(e).startswith(f"[{leg}]"):
            raise AssertionError(f"{what} was caught by another leg than {leg}: {e}") from e
        log(f"[conformance] control {what}: caught, {str(e)[:160]}")
        return str(e)
    raise AssertionError(f"{what} was not caught at the {leg} leg")


def live_decode_step(dev: torch.device, mesh) -> dict:
    """One planned decode step of phase 8's workload (full Llama-3.2-1B,
    bucket 4x16) under ``intercept()``."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch, seq = SERVE_BUCKETS[0]
    cache = model.init_cache(batch, 64, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(batch, 1))).to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    with torch.no_grad(), intercept() as cap, planned_matmuls(mesh):
        logits = model.decode_step(params, cache, tokens, seq, offsets)[0]
        torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the planned decode step's logits are not finite")
    del params, cache, logits
    return {"plans": len(cap.lowered_plans), "records_by_kind": check_capture(cap),
            "products": 7 * cfg.num_layers}


def live_prefill(dev: torch.device, mesh) -> dict:
    """One planned danube forward of phase 9's workload (S = 32768, 2x2)
    under ``intercept()``."""
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    with torch.no_grad(), intercept() as cap, planned_matmuls(mesh):
        logits = model.forward(params, tokens)[0]
        torch.cuda.synchronize()
    if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the planned forward's logits are malformed: {tuple(logits.shape)}")
    del params, logits
    torch.cuda.empty_cache()
    return {"plans": len(cap.lowered_plans), "records_by_kind": check_capture(cap),
            "products": 7 * cfg.num_layers}


def phase_conformance(dev: torch.device) -> dict:
    """Phase 10: the port's conformance checker over the executed schedules
    (``repro_torch.verify``); every leg fatal."""
    # the plans phases 7-9 built, before the matrix adds its own
    built = [p for p in plan_cache.plans() if isinstance(p.mesh, Mesh) and p.mesh.size > 1]
    k1.reset_launches()
    seconds, out = {}, {}

    t0 = time.perf_counter()
    rows = run_matrix(measure=True, device=dev)
    seconds["matrix"] = time.perf_counter() - t0
    bad = [r for r in rows if not r["ok"]]
    per_strategy: dict = {}
    for r in rows:
        per_strategy[r["strategy"]] = per_strategy.get(r["strategy"], 0) + 1
    log(f"[conformance] run_matrix on {torch.cuda.get_device_name(0)}: {len(rows)} rows "
        f"(every catalog cell up to 16 ranks x {len(CASES)} cases x fp32, bf16 x staged, "
        f"overlapped) by strategy {per_strategy}, {len(rows) - len(bad)} ok, "
        f"{seconds['matrix']:.1f}s")
    want = sum(len(CASES) * 2 * len(_overlap_modes(st, shape))
               for st, shape, _ in matrix_cells(16))
    if bad or len(rows) != want:
        raise AssertionError(f"{len(bad)} of {len(rows)} matrix rows fail (want {want} "
                             f"rows): {bad[:5]}")
    out["matrix"] = {"rows": len(rows), "by_strategy": per_strategy}

    t0 = time.perf_counter()
    origins = {"sweep": 0, "llama": 0, "danube": 0}
    checked = []
    for plan in built:
        origin = ("sweep" if (plan.m, plan.k, plan.n) == PLAN_SWEEP_SHAPE
                  else "danube" if plan.m == PREFILL_S else "llama")
        origins[origin] += 1
        rep = check(plan, measure=True)
        checked.append({"plan": _plan_label(plan), "origin": origin,
                        "words_per_node": rep.words_per_node,
                        "peak_node_words": rep.peak_node_words, "itt_bound": rep.itt_bound})
    seconds["full_width"] = time.perf_counter() - t0
    log(f"[conformance] full width: {len(checked)} plans of phases 7-9 pass "
        f"check(measure=True) ({origins}), {seconds['full_width']:.1f}s")
    swept = {(tuple(p.mesh.shape.items()), p.strategy) for p in built
             if (p.m, p.k, p.n) == PLAN_SWEEP_SHAPE}
    missing = [c for c in PLAN_SWEEP_CELLS if (tuple(zip(c[1], c[0])), c[2]) not in swept]
    if missing or not origins["llama"] or origins["danube"] != 4:
        raise AssertionError(f"phases 7-9 should have left every sweep cell's plan (missing "
                             f"{missing}), Llama's and danube's 4 in the plan cache: {origins}")
    out["full_width"] = {"plans": checked, "by_origin": origins}

    t0 = time.perf_counter()
    mesh = Mesh(*PLANNED_MESH, device=dev)
    live = {"decode_step": live_decode_step(dev, mesh), "prefill": live_prefill(dev, mesh)}
    mesh.close()
    seconds["live"] = time.perf_counter() - t0
    for what, r in live.items():
        log(f"[conformance] live {what}: {r['plans']} planned products, executed records per "
            f"kind {r['records_by_kind']} = the summed traces")
        if r["plans"] != r["products"]:
            raise AssertionError(f"live {what}: {r['plans']} products, want {r['products']}")
    out["live"] = live

    t0 = time.perf_counter()
    cannon = next(p for p in built if p.strategy == "cannon" and not p.overlap
                  and (p.m, p.k, p.n) == PLAN_SWEEP_SHAPE)
    pairs = list(cannon.torus.step_a)
    pairs[0], pairs[1] = (pairs[0][0], pairs[1][1]), (pairs[1][0], pairs[0][1])
    mutated = dataclasses.replace(cannon, torus=dataclasses.replace(cannon.torus,
                                                                    step_a=tuple(pairs)))
    controls = {"wrong permutation, static": _expect_caught(
        "wrong permutation (static)", "structure", lambda: check(mutated))}
    executed = measure_plan(mutated)
    controls["wrong permutation, executed"] = _expect_caught(
        "wrong permutation (executed on the card)", "interceptor",
        lambda: compare_records(trace_plan(cannon).records, executed.records))

    def no_b_skew():
        with wrong_program("cannon without B skew"):
            check(cannon, measure=True)

    controls["cannon without B skew"] = _expect_caught("cannon without B skew", "interceptor",
                                                       no_b_skew)
    seconds["controls"] = time.perf_counter() - t0
    for m in {id(p.mesh): p.mesh for p in built}.values():   # measuring restarted them
        m.close()
    routes = _nonzero(k1.launches_by_route)
    log(f"[conformance] K1 launches in this phase: {k1.launches} {routes}; seconds per leg "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    return {**out, "controls": controls, "seconds": seconds, "k1_launches": k1.launches,
            "k1_routes": routes}


# -- calibrate + tune (phase 11) ------------------------------------------------------


def llama_tune_shapes(mesh) -> tuple:
    """The (m, n, k) products K1 runs serving Llama-3.2-1B in the serving
    buckets: unplanned (decode M = batch, prefill M = batch x seq, each of
    the 4 distinct projections) and each planned product's per-rank block
    product on ``mesh`` (``plan.ir._local_kernel_shape``)."""
    unplanned, per_rank = [], {}
    for b, seq in SERVE_BUCKETS:
        for m in (b, b * seq):
            for (k, n) in sorted(set(LAYER_KN)):
                unplanned.append((m, n, k))
                plan = build_plan(m, n, k, mesh=mesh, a_dtype=torch.bfloat16,
                                  b_dtype=torch.bfloat16)
                per_rank[(m, n, k)] = (plan.strategy + ("+ov" if plan.overlap else ""),
                                       plan_ir._local_kernel_shape(plan.strategy, plan.grid,
                                                                   m, n, k, mesh.size))
    return unplanned, per_rank


def phase_calibrate(dev: torch.device) -> dict:
    """Phase 11: ``perf_probe`` on a 2x2 rank-thread mesh (links, K1's
    peak) with the K1 autotune over Llama's serving shapes, the profile and
    table saved; each winner beside K1's default blocks; planned serving
    with the tuner; ``build_plan(profile=)`` against the TPU constants."""
    os.makedirs(OUT_DIR, exist_ok=True)
    name = torch.cuda.get_device_name(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    unplanned, per_rank = llama_tune_shapes(mesh)
    shapes = sorted(set(unplanned) | {v[1] for v in per_rank.values()})
    prof_path = os.path.join(OUT_DIR, "machine_profile.json")
    table_path = os.path.join(OUT_DIR, "tuning_table.json")
    k1.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # it prints the whole profile
        perf_probe.main(["--device", "cuda", "--mesh-shape", "2x2",
                         "--reps", str(CALIBRATE_REPS), "--profile-out", prof_path,
                         "--tune", "--tune-shapes", ",".join(f"{m}x{n}x{k}" for m, n, k in shapes),
                         "--tune-reps", str(TUNE_REPS), "--tune-candidates", "0",
                         "--tune-dtype", "bfloat16", "--tune-out", table_path])
    probe_s = time.perf_counter() - t0
    profile = obs.load_profile(prof_path)
    table = load_table(table_path)
    if (profile.platform != "cuda" or profile.device_kind != name
            or "rank threads" not in profile.link_medium or table.device_kind != name
            or profile.tuning is None or profile.tuning.entries != table.entries):
        raise AssertionError(f"the profile or table is not the card's: {profile.to_json()}")
    links = {n: {"alpha_us": p.alpha_s * 1e6, "bw_gb_s": p.bw_bytes_per_s / 1e9}
             for n, p in profile.links}
    peak_n = calibrate.PEAK_N["cuda"]
    log(f"[calibrate] perf_probe on {name}, mesh 2x2 ({profile.link_medium}), "
        f"{probe_s:.1f}s: peak {profile.peak_flops / 1e12:.1f} TFLOP/s (K1 at {peak_n}^3 bf16, "
        f"{k1.route(peak_n, peak_n, peak_n, torch.bfloat16)} route); "
        f"links " + ", ".join(f"{n} alpha {v['alpha_us']:.1f}us bw {v['bw_gb_s']:.1f}GB/s"
                               for n, v in links.items())
        + f" (every rank on one stream: alpha {ONE_STREAM['probe_alpha_us'][0]:.0f}-"
          f"{ONE_STREAM['probe_alpha_us'][1]:.0f}us, the host barrier)")
    winners = []
    for key, e in table.entries:
        dtype, bm, bn, bk = key
        cand = (e.block_m, e.block_n, e.block_k, e.order)
        default = default_candidate(bm, bn, bk, dtype)
        default_s = time_candidate(bm, bn, bk, dtype, default, reps=TUNE_REPS, device=dev)
        row = {"bucket": [bm, bn, bk], "dtype": dtype, "blocks": list(cand[:3]),
               "order": e.order, "route": candidate_route(cand, dtype), "us": e.seconds * 1e6,
               "default_blocks": list(default[:3]),
               "default_route": candidate_route(default, dtype), "default_us": default_s * 1e6}
        winners.append(row)
        log(f"[tune] bucket {bm}x{bn}x{bk} {dtype}: {e.label} ({row['route']}) "
            f"{row['us']:.2f}us; default {'x'.join(map(str, default[:3]))}/zorder "
            f"({row['default_route']}) {row['default_us']:.2f}us")
    # K1 launched by the probe's peak, the search and the default timings
    tune_launches = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    tuned_serve = tuned_planned_serve(dev, mesh, table)
    picks = strategy_picks(mesh, profile)
    mesh.close()
    torch.cuda.empty_cache()
    return {"profile": profile.to_json(), "links": links, "probe_s": probe_s,
            "shapes": {"unplanned": unplanned,
                       "per_rank": {"x".join(map(str, k)): v for k, v in per_rank.items()}},
            "winners": winners, "tuned_serve": tuned_serve, "strategy_picks": picks,
            "k1_launches": tune_launches["launches"], "k1_routes": tune_launches["routes"],
            "profile_path": prof_path, "table_path": table_path}


@contextlib.contextmanager
def k1_calls():
    """Within the scope, list each K1 call ``ops.matmul`` makes (from every
    rank thread) as (m, n, k, blocks, order, dtype, out dtype, A stored
    transposed, B stored transposed)."""
    ops = importlib.import_module("repro_torch.kernels.matmul.ops")
    real = ops._run
    calls = []

    def recording(a, b, blocks, order, out_dtype):
        calls.append((a.shape[0], b.shape[1], a.shape[1], tuple(blocks), order, a.dtype,
                      out_dtype, ops.layout(a), ops.layout(b)))
        return real(a, b, blocks, order, out_dtype)

    with mock.patch.object(ops, "_run", recording):
        yield calls


def check_k1_calls(calls: list, dev: torch.device, tuned_plans=None, head_n=None) -> dict:
    """Every distinct K1 call of a run (as ``k1_calls`` lists them): K1
    with the call's own shape, blocks, order, types and layouts must agree
    with its plain version within ``ROW_TOL`` on fresh seeded operands.
    With ``tuned_plans``, its blocks and order must also be a tuned plan's,
    but for the unembedding's (``head_n`` columns, fp32 out: never
    planned, its default blocks)."""
    tilings = None if tuned_plans is None else {
        ((p.tiling.block_m, p.tiling.block_n, p.tiling.block_k), p.tiling.order)
        for p in tuned_plans}
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, worst_abs, rows = 0.0, 0.0, []
    for (m, n, k, blocks, order, dt, out_dtype, a_t, b_t), count in sorted(
            Counter(calls).items(), key=str):
        unembed = n == head_n and out_dtype == torch.float32
        if unembed and blocks != k1.default_blocks(m, n, k, dt, True, a_t, b_t):
            raise AssertionError(f"the unembedding called K1 at {m}x{n}x{k} with {blocks}")
        if tilings is not None and not unembed and (blocks, order) not in tilings:
            raise AssertionError(f"a tuned run called K1 at {m}x{n}x{k} with {blocks}/{order}, "
                                 f"which no tuned plan names ({sorted(tilings)})")
        a = _stored_operand(gen, dev, m, k, a_t, dtype=dt)
        b = _stored_operand(gen, dev, k, n, b_t, 1 / math.sqrt(k), dtype=dt)
        got = matmul(a, b, block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
                     order=order, out_dtype=out_dtype)
        e = row_err(got, matmul_ref(a, b, out_dtype))
        if not e["finite"] or not e["row_rel"] < min(ROW_TOL[dt], ROW_TOL[out_dtype]):
            raise AssertionError(f"K1 with {blocks}/{order} at {m}x{n}x{k} {dt} disagrees with "
                                 f"its plain version: {e}")
        worst, worst_abs = max(worst, e["row_rel"]), max(worst_abs, e["max_abs_err"])
        rows.append({"shape": [m, n, k], "blocks": list(blocks), "order": order,
                     "a_t": a_t, "b_t": b_t,
                     "route": k1.ROUTE_OF[dt, blocks], "dtype": str(dt).replace("torch.", ""),
                     "out_dtype": str(out_dtype).replace("torch.", ""), "calls": count,
                     "row_rel": e["row_rel"], "max_abs_err": e["max_abs_err"]})
    return {"distinct": rows, "calls": len(calls), "worst_row_rel": worst,
            "worst_abs_err": worst_abs}


def forced_logits(model, params, dev, full: list, sp: int, offsets, mesh, tuning) -> list:
    """The prefill's and every decode step's logits of the planned path
    (``tuning=`` or not) fed the token array ``full`` (B, S + new)."""
    full = torch.as_tensor(full, dtype=torch.int64, device=dev)
    cache = model.init_cache(full.shape[0], 64, dev)
    with torch.no_grad(), planned_scope(mesh, None, tuning):
        out = [model.prefill(params, cache, full[:, :sp], offsets)[0]]
        for t in range(sp, full.shape[1] - 1):
            pos = torch.full((), t, dtype=torch.int64, device=dev)
            out.append(model.decode_step(params, cache, full[:, t:t + 1], pos, offsets)[0])
    return out


def tuned_planned_serve(dev: torch.device, mesh, table) -> dict:
    """Phase 4's workload through ``Server(mesh=2x2, tuning=tuner)``:
    captured, identical tokens across two runs and to the eager tuned
    planned path (bitwise); every K1 call of that eager run held to the
    plain version at its shape, blocks and order; the tuner's serve
    window; and the tuned prefill and decode-step logits, fed the same
    tokens, against the untuned planned ones."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=SERVE_MAX_SEQ)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    tuner = Tuner(table=table, reps=TUNE_REPS, device=dev)
    server = Server(model, params, sc, mesh=mesh, tuning=tuner, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    runs = served_runs(server, prompts, 2, "tuned-serve", cfg.vocab_size)
    if runs[0]["tokens"] != runs[1]["tokens"] or not all(r["graphs"] for r in runs):
        raise AssertionError("two tuned planned runs disagree (or were not replayed)")
    tuned_plans = [p for p in plan_cache.plans() if p.mesh is mesh and p.tiling.tuned]
    if not tuned_plans:
        raise AssertionError("no plan on the mesh took tuned blocks")
    tuned_logits: list = []
    with k1_calls() as calls:
        eager = eager_runs(model, params, sc, prompts, 1, "tuned-serve", mesh=mesh,
                           tuning=tuner, logits=tuned_logits)
    if eager[0]["tokens"] != runs[0]["tokens"]:
        raise AssertionError("the captured tuned planned steps' tokens differ from the eager "
                             "tuned planned path's")
    checked = check_k1_calls(calls, dev, tuned_plans, padded_vocab(cfg.vocab_size))
    log(f"[tuned-serve] tokens bitwise equal across the two captured runs and the eager tuned "
        f"run; its {checked['calls']} K1 calls, {len(checked['distinct'])} distinct (shape, "
        f"blocks, order, out type), each a tuned plan's and within ROW_TOL of the plain "
        f"version at its own shape (worst row rel {checked['worst_row_rel']:.3e}): " + ", ".join(
            f"{'x'.join(map(str, r['shape']))} {'x'.join(map(str, r['blocks']))}/{r['order']} "
            f"{r['route']} x{r['calls']}" for r in checked["distinct"]))
    # the untuned planned path fed the eager tuned run's tokens, step by step
    full = eager[0]["full"]
    sp = len(full[0]) - SERVE_NEW
    batch, lens = batch_requests(list(prompts) + [[DUMMY_TOKEN]] * (len(full) - len(prompts)),
                                 PAD_ID, pad_to=sp)
    offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=dev)
    untuned = forced_logits(model, params, dev, full, sp, offsets, mesh, None)
    if not len(untuned) == len(tuned_logits) == SERVE_NEW:
        raise AssertionError(f"{len(untuned)} untuned and {len(tuned_logits)} tuned steps")
    steps = []
    for i, (got, ref) in enumerate(zip(tuned_logits, untuned)):
        e = row_err(got, ref)
        steps.append(e)
        if not (e["finite"] and e["row_rel"] < PLANNED_LOGITS_TOL):
            raise AssertionError(f"tuned planned {'prefill' if i == 0 else f'decode step {i}'} "
                                 f"logits vs untuned planned: {e} (limit {PLANNED_LOGITS_TOL})")
    log(f"[tuned-serve] tuned vs untuned planned logits fed the same tokens, prefill + "
        f"{len(steps) - 1} decode steps: worst row rel {max(e['row_rel'] for e in steps):.3e} "
        f"(prefill {steps[0]['row_rel']:.3e}; limit {PLANNED_LOGITS_TOL:g})")
    rep = server.cache_report()["tuning"]
    moved = [{"bucket": list(key[1:]), "blocks": [e.block_m, e.block_n, e.block_k],
              "order": e.order, "route": candidate_route((e.block_m, e.block_n, e.block_k),
                                                         key[0]), "us": e.seconds * 1e6}
             for key, e in tuner.table().entries
             if (e.block_m, e.block_n, e.block_k, e.order) != default_candidate(*key[1:], key[0])]
    log(f"[tuned-serve] the tuner's {rep['entries']} buckets, {len(moved)} away from K1's "
        f"default blocks: " + ", ".join(
            f"{'x'.join(map(str, r['bucket']))} {'x'.join(map(str, r['blocks']))}/{r['order']} "
            f"({r['route']}) {r['us']:.2f}us" for r in moved))
    log(f"[tuned-serve] {len(tuned_plans)} tuned plans on the mesh "
        f"({sorted({p.tiling.block_m for p in tuned_plans})} block_m, orders "
        f"{sorted({p.tiling.order for p in tuned_plans})}); tuner {rep}")
    del server, params, tuned_logits, untuned
    torch.cuda.empty_cache()
    return {"warmup": warm, "runs": runs, "eager_runs": eager, "k1_calls": checked,
            "logits_per_step": steps, "tuning": rep, "tuned_plans": len(tuned_plans),
            "away_from_default": moved,
            "summary": {key: float(np.median([r[key] for r in runs]))
                        for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}}


def strategy_picks(mesh, profile) -> list:
    """``build_plan``'s strategy at Llama's serving shapes and danube's long
    prefill on 2x2: the reference's TPU constants beside the card's
    profile (links and K1's peak measured here, its tuning table)."""
    rows = []
    for arch, kns, ms in (("llama3.2-1b", sorted(set(LAYER_KN)), (4, 64)),
                          (PREFILL_ARCH, DANUBE_KN, (PREFILL_S,))):
        for m in ms:
            for (k, n) in kns:
                kw = dict(mesh=mesh, a_dtype=torch.bfloat16, b_dtype=torch.bfloat16,
                          use_cache=False)
                picks = {}
                for label, prof in (("tpu_constants", None), ("h100_profile", profile)):
                    p = build_plan(m, n, k, profile=prof, **kw)
                    picks[label] = p.strategy + ("+ov" if p.overlap else "")
                rows.append({"arch": arch, "shape": [m, k, n], **picks})
    for r in rows:
        log(f"[calibrate] {r['arch']} {r['shape'][0]}x{r['shape'][1]}x{r['shape'][2]} on 2x2: "
            f"TPU constants {r['tpu_constants']}, H100 profile {r['h100_profile']}")
    return rows


# -- obs + drift (phase 12) -----------------------------------------------------------


def phase_obs_drift(dev: torch.device, profile_path: str) -> dict:
    """Phase 12: ``check_drift`` on the card (every drift cell's obs,
    interceptor and trace multisets equal; phase 11's profile as the
    stored one), then one ``generate`` of phase 4's workload and one
    planned product per drift cell under ``obs.observe()``, written out as
    a Perfetto trace and a metrics snapshot."""
    t0 = time.perf_counter()
    drift = check_drift(profile_path=profile_path, device=dev)
    drift_s = time.perf_counter() - t0
    for c in drift["cells"]:
        log(f"[drift] {c['strategy']} on {c['mesh']}: {c['collectives']} collectives, "
            f"obs == interceptor == trace: {c['ok']} {c['error']}")
    for r in drift["ranking"]:
        log(f"[drift] ranking {r['shape']}: stored {r['stored_top']}, fresh {r['fresh_top']}, "
            f"margin {r['margin']:.3f}, flipped {r['flipped']}")
    for r in drift["tuning"]:
        log(f"[drift] tuning {r['bucket']} {r['dtype']}: stored {r['stored']}, fresh "
            f"{r['fresh']}, margin {r['margin']:.3f}, flipped {r['flipped']}")
    if len(drift["cells"]) != len(DRIFT_CELLS) or not drift["ok"]:
        raise AssertionError(f"check_drift on the card is not ok: {drift['cells']} "
                             f"{drift['ranking']} {drift['tuning']}")
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=SERVE_MAX_SEQ)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    m, k, n = OBS_PRODUCT
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    ref = matmul(a, b)
    products = {}
    obs.reset_metrics()
    with torch.no_grad(), obs.observe() as rec:
        server = Server(model, params, sc, buckets=SERVE_BUCKETS)
        server.warmup()
        res = server.generate(prompts)
        for strategy, shape, names in DRIFT_CELLS:
            mesh = Mesh(shape, names, device=dev)
            plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, a_dtype=torch.bfloat16,
                              b_dtype=torch.bfloat16)
            out = execute_plan(plan, a, b)
            torch.cuda.synchronize()
            mesh.close()
            got = obs.collective_multiset(rec, strategy=strategy)
            want = Counter(r.key for r in trace_plan(plan).records)
            e = row_err(out, ref)
            products[strategy] = {"mesh": list(shape), "collectives": sum(got.values()),
                                  "row_rel": e["row_rel"], "obs_equals_trace": got == want}
            if got != want or e["row_rel"] >= PLAN_ROW_TOL:
                raise AssertionError(f"{strategy} under tracing: obs multiset {sorted(got)[:3]} "
                                     f"vs trace {sorted(want)[:3]}, row rel {e['row_rel']}")
    trace_path = obs.write_trace(os.path.join(OUT_DIR, "obs_trace.json"), rec)
    metrics_path = obs.write_metrics(os.path.join(OUT_DIR, "obs_metrics.json"), rec)
    snap = obs.metrics_snapshot(rec)
    spans = snap["spans"]
    met = snap["metrics"]
    log(f"[obs] traced: generate bucket {res.bucket} ({'graph replays' if res.graphs else 'eager'}) "
        f"and {len(products)} planned products {products}; spans {spans}; "
        f"serve.ttft_us {met.get('serve.ttft_us')}; kernel.matmul.us "
        f"{met.get('kernel.matmul.us')}; wrote {trace_path}, {metrics_path}")
    want_spans = ("serve.warmup", "serve.prefill", "serve.decode_step", "kernel.matmul",
                  "plan.build", "plan.execute", "dist.prefetch")
    missing = [s for s in want_spans if not spans.get(s)]
    if missing or not met.get("serve.requests{bucket=4x16}"):
        raise AssertionError(f"the traced run lacks spans {missing} or serve counters: {met}")
    del server, params
    torch.cuda.empty_cache()
    return {"drift": drift, "drift_s": drift_s, "products": products, "spans": spans,
            "metrics": met, "trace": os.path.relpath(trace_path, ROOT),
            "metrics_file": os.path.relpath(metrics_path, ROOT)}


# -- torch.profiler (phase 13) -----------------------------------------------------------

K1_KERNELS = ("zorder_matmul",)
# K1's instances with an fp32 output (the kernel's name ends ``..., float>(...)``):
# in an unplanned bf16 run only the unembedding's launch has one
K1_FP32_OUT = re.compile(r",\s*float>\(")
# the model modules whose forward and steps call ``layers.embed.unembed``
UNEMBED_MODULES = ("repro_torch.models.lm", "repro_torch.models.hybrid",
                   "repro_torch.models.xlstm_model", "repro_torch.models.encdec")
K2_KERNELS = ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")
# the planned forward's accumulate chain, by kernel name: Cannon's fp32
# accumulator zeroed, K1's fp32 outputs added (ring_rs's partial sums too),
# the sum cast to bf16 (PyTorch's bf16 copy kernel, or a copy that loads or
# stores with a cast); and the device-to-device copies (scatter, gather)
CHAIN_KERNELS = {"zero fp32": ("FillFunctor<float>",), "add fp32": ("CUDAFunctor_add<float>",),
                 "cast": ("bfloat16_copy_kernel", "WithCast"),
                 "device copies": ("Memcpy DtoD",)}


# host events torch's own processing leaves out (``_filter_name``)
PROFILE_SKIPPED = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                   "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                   "aten::is_leaf", "aten::output_nr", "aten::_version"}


def profile_totals(prof) -> tuple:
    """What ``prof.key_averages()`` gives ``profile_split``, read from the
    profiler's raw events, without the objects ``key_averages()`` builds
    first (about a minute of host work a 10^5 host operators): by name,
    the device kernels' time (us) and launches; each host operator's own
    kernels' time and its calls; each ``record_function`` range's calls and
    device time, host side (the kernels of the operators inside it) and
    device side (its span).  As in torch's processing, a kernel belongs to
    the host operator its correlation id links it to, host events nest by
    time on their thread, and an event alone inside one of its own name is
    not counted apart from it."""
    from torch.autograd import DeviceType

    kernels, counts, own = Counter(), Counter(), Counter()
    spans: dict = {}
    calls = Counter()   # (name, range?) -> host events, the nested duplicates left out
    host = []           # sync host events: (thread, start, end, correlation id, name, range?)
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    for e in results.events():
        name = e.name()
        if name in PROFILE_SKIPPED or getattr(e, "is_hidden_event", lambda: False)():
            continue
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        ranged = e.is_user_annotation()
        linked = e.linked_correlation_id()
        if e.device_type() == DeviceType.CPU:
            if is_async:
                calls[name, ranged] += 1
            else:
                host.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                             e.correlation_id() if linked == 0 else -1, name, ranged))
            continue
        # in us from the trace's start, rounded as torch's processing rounds them
        us = 0.0 if is_async else (e.end_ns() - t0) / 1e3 - (e.start_ns() - t0) / 1e3
        if ranged:
            span = spans.setdefault(name, [0.0, 0])
            span[0] += us
            span[1] += 1
        else:
            kernels[name] += us
            counts[name] += 1
        if linked > 0:
            own[linked] += us
    host.sort(key=lambda h: (h[0], h[1], -h[2]))
    groups = [list(g) for _, g in itertools.groupby(range(len(host)), key=lambda i: host[i][0])]

    def nested():
        """(event, the events around it, innermost last), thread by thread."""
        for group in groups:
            stack = []
            for i in group:
                start, end = host[i][1], host[i][2]
                while stack and (start >= host[stack[-1]][2] or end > host[stack[-1]][2]):
                    stack.pop()
                yield i, stack
                stack.append(i)

    parent, children = [-1] * len(host), [0] * len(host)
    for i, stack in nested():
        if stack:
            parent[i] = stack[-1]
            children[stack[-1]] += 1
    # torch's tree drops an event alone inside one of its own name, its
    # kernels lifted into the outer one in place of the outer one's own
    dup = [p >= 0 and children[p] == 1 and host[p][4] == host[i][4]
           for i, p in enumerate(parent)]
    lifted = [False] * len(host)
    for i, d in enumerate(dup):
        if d:
            lifted[parent[i]] = True
    ops, inside = Counter(), Counter()
    for i, stack in nested():
        _, _, _, corr, name, ranged = host[i]
        us = own.get(corr, 0.0) if corr > 0 and not lifted[i] else 0.0
        if not us:
            continue
        for j in stack:
            if host[j][5] and not dup[j]:
                inside[host[j][4]] += us
        if ranged and not dup[i]:
            inside[name] += us
        elif not ranged and "::" in name:
            ops[name] += us
    for i, (_, _, _, _, name, ranged) in enumerate(host):
        if not dup[i]:
            calls[name, ranged] += 1
    ranges = {}
    for (name, ranged), n in calls.items():
        if ranged:
            ranges.setdefault(name, {})["cpu"] = {"ms": inside[name] / 1e3, "count": n}
    for name, (us, n) in spans.items():
        ranges.setdefault(name, {})["device"] = {"ms": us / 1e3, "count": n}
    ops = Counter({k: v for k, v in ops.items() if v})
    return (Counter({k: v for k, v in kernels.items() if v}),
            Counter({k: counts[k] for k, v in kernels.items() if v}),
            ops, Counter({k: calls[k, False] for k in ops}), ranges)


def profile_split(prof) -> dict:
    """Device time of one profiled forward by kernel name: K1, K2, the
    rest named by its top kernels and top operators, and the accumulate
    chain's kernels (``CHAIN_KERNELS``)."""
    kernels, counts, ops, op_calls, ranges = profile_totals(prof)
    total = sum(kernels.values())
    k1_us = sum(v for key, v in kernels.items() if any(s in key for s in K1_KERNELS))
    k2_us = sum(v for key, v in kernels.items() if any(s in key for s in K2_KERNELS))
    rest = Counter({key: v for key, v in kernels.items()
                    if not any(s in key for s in K1_KERNELS + K2_KERNELS)})
    chain = {cat: {"ms": sum(v for key, v in kernels.items() if any(s in key for s in subs)) / 1e3,
                   "launches": sum(c for key, c in counts.items() if any(s in key for s in subs))}
             for cat, subs in CHAIN_KERNELS.items()}
    return {"device_ms": total / 1e3, "k1_ms": k1_us / 1e3, "k2_ms": k2_us / 1e3,
            "rest_ms": (total - k1_us - k2_us) / 1e3,
            "k1_launches": sum(c for key, c in counts.items() if any(s in key for s in K1_KERNELS)),
            "rest_top_kernels": [{"kernel": key[:160], "ms": v / 1e3, "launches": counts[key]}
                                 for key, v in rest.most_common(8)],
            "top_operators": [{"op": key, "ms": v / 1e3} for key, v in ops.most_common(8)],
            "mm_ms": ops["aten::mm"] / 1e3, "mm_calls": op_calls["aten::mm"],
            "unembed_ms": ranges.get("unembed", {}).get("device", {}).get("ms", 0.0),
            "unembed_calls": ranges.get("unembed", {}).get("cpu", {}).get("count", 0),
            "k1_fp32_out_ms": sum(v for key, v in kernels.items() if k1_fp32_out(key)) / 1e3,
            "k1_fp32_out_launches": sum(c for key, c in counts.items() if k1_fp32_out(key)),
            "chain": chain, "ranges": ranges}


def k1_fp32_out(kernel_name: str) -> bool:
    return any(s in kernel_name for s in K1_KERNELS) and bool(K1_FP32_OUT.search(kernel_name))


def unembed_seen(split: dict, mm_calls: int = 0) -> bool:
    """Whether an unplanned bf16 run's profile shows one unembedding, its
    one K1 launch with an fp32 output (with device time) and ``mm_calls``
    ``aten::mm`` (none in a forward or a serving step, the backward's two
    in a training step)."""
    return (split["unembed_calls"] == 1 and split["k1_fp32_out_launches"] == 1
            and split["k1_fp32_out_ms"] > 0 and split["mm_calls"] == mm_calls)


@contextlib.contextmanager
def unembed_ranges():
    """Within the scope every model's unembedding runs inside a
    ``record_function("unembed")`` range, so a profile (``profile_split``)
    counts its calls and reads the device span of its kernels (its K1
    launch, the padded columns' fill)."""
    from torch.profiler import record_function

    with contextlib.ExitStack() as stack:
        for name in UNEMBED_MODULES:
            mod = importlib.import_module(name)

            def ranged(p, x, vocab, real=mod.unembed):
                with record_function("unembed"):
                    return real(p, x, vocab)
            stack.enter_context(mock.patch.object(mod, "unembed", ranged))
        yield


def phase_profiler(dev: torch.device) -> dict:
    """Phase 13: one unplanned and one planned danube forward at S = 32768
    under ``torch.profiler`` (no timed window is profiled): device time by
    kernel name into K1, K2 and the rest, the unembedding's (one K1
    launch, no ``aten::mm``), and the planned forward's accumulate chain;
    both traces saved (gzip) to ``chiprun_out/``.  Then the unembedding of
    32768 hidden states by CUDA events, through K1 and as the upcast and
    fp32 ``torch.matmul`` it replaced, in turns."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)

    def planned():
        with planned_matmuls(mesh):
            return model.forward(params, tokens)[0]

    fns = {"unplanned": lambda: model.forward(params, tokens)[0], "planned": planned}
    out = {}
    with torch.no_grad():
        for fn in fns.values():   # warm: plans cached, kernels loaded
            fn()
        torch.cuda.synchronize()
        for name, fn in fns.items():
            with unembed_ranges(), profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            split = profile_split(prof)
            raw = os.path.join(OUT_DIR, f"profile_danube_{name}.json")
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
                shutil.copyfileobj(f, g)
            os.remove(raw)
            split["trace"] = os.path.relpath(raw + ".gz", ROOT)
            out[name] = split
            log(f"[profiler] danube forward S={PREFILL_S} {name}: device {split['device_ms']:.1f}ms"
                f" = K1 {split['k1_ms']:.1f} ({split['k1_launches']} launches) + K2 "
                f"{split['k2_ms']:.1f} + rest {split['rest_ms']:.1f}; chain {split['chain']}; "
                f"top rest kernels " + "; ".join(f"{r['kernel'][:70]} {r['ms']:.1f}ms x"
                                                  f"{r['launches']}"
                                                  for r in split['rest_top_kernels'][:5])
                + "; top operators " + ", ".join(f"{r['op']} {r['ms']:.1f}ms"
                                                 for r in split["top_operators"][:5])
                + f"; the unembedding {split['unembed_ms']:.1f}ms ({split['unembed_calls']} "
                  f"call, K1), aten::mm x{split['mm_calls']}")
        hidden = torch.randn((PREFILL_S, cfg.d_model), generator=torch.Generator(
            device=dev).manual_seed(1), device=dev).to(torch.bfloat16)
        head = params["embed"].get("lm_head", params["embed"]["embedding"].t())
        t = {}
        for key in ("k1_ms", "upcast_ms", "upcast_ms", "k1_ms"):
            fn = ((lambda: unembed(params["embed"], hidden, cfg.vocab_size)) if key == "k1_ms"
                  else (lambda: _upcast_mm(hidden, head)))
            t.setdefault(key, []).append(event_ms(fn, 1))
        out["unembed_alone"] = {key: min(v) for key, v in t.items()} | {"runs": t}
        log(f"[profiler] the unembedding of {PREFILL_S} x {cfg.d_model} hidden states alone "
            f"(CUDA events, in turns): K1 {out['unembed_alone']['k1_ms']:.1f}ms, upcast + fp32 "
            f"torch.matmul {out['unembed_alone']['upcast_ms']:.1f}ms; runs {t}")
        del hidden, head
    mesh.close()
    del params
    torch.cuda.empty_cache()
    if not all(v["device_ms"] > 0 and v["k1_ms"] > 0 and v["k2_ms"] > 0
               for key, v in out.items() if key in fns):
        raise AssertionError(f"torch.profiler saw no device time for K1 or K2: {out}")
    # the planned forward's products also write fp32 (its accumulate chain)
    if not unembed_seen(out["unplanned"]) or out["planned"]["mm_calls"] \
            or out["planned"]["unembed_calls"] != 1:
        raise AssertionError(f"a profiled forward ran aten::mm or did not show the "
                             f"unembedding's K1 launch: {out}")
    extra = {cat: out["planned"]["chain"][cat]["ms"] - out["unplanned"]["chain"][cat]["ms"]
             for cat in CHAIN_KERNELS}
    log(f"[profiler] planned minus unplanned: device {out['planned']['device_ms'] - out['unplanned']['device_ms']:.1f}ms"
        f", K1 {out['planned']['k1_ms'] - out['unplanned']['k1_ms']:.1f}ms, accumulate chain "
        + ", ".join(f"{cat} {v:.1f}ms" for cat, v in extra.items()))
    return {**out, "chain_extra_ms": extra}


# -- training (phase 14) -------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
# the main path: the launcher at its default batch and sequence, 10 steps
# (one checkpoint; the repeats are cut to keep the script within 900 s)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 10
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ)]
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
# fp32 card-vs-CPU step: 2 full-width layers, one sequence of 64 tokens;
# each master leaf's gradient within this relative L2 error (fp32 products
# on both sides, sums in other orders: a sound port reads 1e-6 or so; a
# projection weight that gets no gradient reads 1)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SEQ = 2, 64
TRAIN_GRAD_TOL = 1e-3
# the reference's train_4k cell (seq 4096, batch 256 over 256 chips) cut
# to one sequence on one card, every block recomputed in the backward (3
# steps: captured, that is the eager first step, the capture and a replay)
TRAIN_4K_SEQ, TRAIN_4K_STEPS = 4096, 3
TRAIN_TIMED_STEPS = 3
TRAIN_GRAPH_CALLS = 4      # products a timed CUDA graph replays
# the restart leg: the reference's test_restart_and_loss_decreases on the card
RESTART_CFG = dict(steps=24, lr=1e-3, warmup=4, ckpt_every=8, log_every=8, fail_at_step=13)
# checkpoints go under the checkout's build/ (ignored by git and never
# copied back), each leg's removed when it ends
CKPT_DIR = os.path.join(ROOT, "build")
TRAIN_LOG = re.compile(r"^\[trainer\] step\s+(\d+) loss ([-\d.naif]+) \((\d+) ms\)$")


@contextlib.contextmanager
def step_meter():
    """Within the scope, every call of a ``StaticStep`` (``Trainer.fit``'s,
    the launcher's too) is metered: its kind ("warm": a captured trainer's
    eager first step, on the capture stream; "capture": the capture and the
    first replay; "replay"; "eager": a step of an uncaptured trainer), the
    host clock around it (a sync before and after it: ``fit`` syncs after
    every step anyway), the device time between CUDA events on the caller's
    stream around it, its loss and its learning rate; and every trainer
    whose ``fit`` ran, for its ``graph_report()``.  Yields {"rows": [...],
    "trainers": [...]}: drop the trainers before freeing memory."""
    meter = {"rows": [], "trainers": []}
    real_call, real_fit = StaticStep.__call__, Trainer.fit

    def metered(self, batch):
        kind = ("eager" if not self.capture else "warm" if not self.calls
                else "replay" if self.graph is not None else "capture")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = real_call(self, batch)
        ev[1].record()
        torch.cuda.synchronize()
        meter["rows"].append({"kind": kind, "host_ms": (time.perf_counter() - t0) * 1e3,
                              "device_ms": ev[0].elapsed_time(ev[1]),
                              "loss": out["loss"].item(), "lr": out["lr"].item()})
        return out

    def kept(self, *args, **kw):
        meter["trainers"].append(self)
        return real_fit(self, *args, **kw)

    with mock.patch.object(StaticStep, "__call__", metered), \
            mock.patch.object(Trainer, "fit", kept):
        yield meter


def step_summary(rows: list) -> dict:
    """A metered run (``step_meter``) in its steps' terms: every step's loss
    and learning rate, the steps by kind, the first step's host ms, the
    capturing step's, and the medians of the replays' host and device ms
    (a captured run) or of the eager steps' after the first."""
    steady = [r for r in rows if r["kind"] == "replay"] or \
        [r for i, r in enumerate(rows) if i and r["kind"] == "eager"]
    return {"losses": [r["loss"] for r in rows], "lrs": [r["lr"] for r in rows],
            "kinds": dict(Counter(r["kind"] for r in rows)),
            "first_step_ms": rows[0]["host_ms"],
            "capture_step_ms": next((r["host_ms"] for r in rows if r["kind"] == "capture"), None),
            "host_ms": float(np.median([r["host_ms"] for r in steady])),
            "device_ms": float(np.median([r["device_ms"] for r in steady])),
            "steps_timed": len(steady)}


def held_to_eager(tag: str, cap: dict, eag: dict, tol: float, relative: bool = True) -> dict:
    """A captured run (``step_summary``) against the eager run from the same
    state and batches: each step's loss within ``tol`` (relative, or
    absolute) over the steps both ran, every learning rate bitwise (fp32
    values compared as Python floats)."""
    n = min(len(cap["losses"]), len(eag["losses"]))
    gaps = [abs(a - b) / (abs(b) if relative else 1.0)
            for a, b in zip(cap["losses"][:n], eag["losses"][:n])]
    lr_bitwise = cap["lrs"][:n] == eag["lrs"][:n]
    log(f"[{tag}] captured vs eager over {n} steps: loss gaps "
        f"{[float(f'{g:.3g}') for g in gaps]} ({'relative' if relative else 'absolute'}, limit "
        f"{tol:g}); learning rates bitwise: {lr_bitwise}")
    if not n or max(gaps) > tol or not lr_bitwise:
        raise AssertionError(f"[{tag}] the captured run left the eager one: gaps {gaps}, "
                             f"lr {cap['lrs'][:n]} vs {eag['lrs'][:n]}")
    return {"gaps": gaps, "lr_bitwise": lr_bitwise, "steps": n}


def check_graph(tag: str, graph: dict, per_step: dict, replays: int,
                products: dict = None) -> None:
    """The trainer's ``graph_report()``: one capture, ``replays`` replays of
    ``per_step`` K1 launches by route (and ``products`` planned products a
    replay, when given), replays x those replayed."""
    want = {"captures": 1, "replays": replays, "k1_per_replay": per_step,
            "k1_replayed": {r: replays * n for r, n in per_step.items()}}
    if products is not None:
        want["products_per_replay"] = products
    got = {k: graph[k] for k in want}
    if got != want:
        raise AssertionError(f"[{tag}] graph_report {got}, want {want}")


class _Tee(io.TextIOBase):
    """Writes to several streams: the launcher's log is shown and kept."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def train_kernel_check(dev: torch.device, gen: torch.Generator) -> dict:
    """(a) K1's autograd node at each of Llama's 7 projections at 2048
    tokens, bf16: the forward and both backward products held per row to
    the plain version on the same CUDA tensors, each launch on the wide
    route; then each product timed on the operands the path gives it (the
    backward's Bᵀ and Aᵀ are views of the saved operands, read in place)
    beside the plain version, ``torch.matmul`` on the same operands and its
    bound (CUDA-graph replays, so no host launch time is in them)."""
    t = TRAIN_TOKENS
    rows, worst_abs = [], 0.0
    for (k, n) in LAYER_KN:
        a = torch.randn(t, k, generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
        b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(
            torch.bfloat16).requires_grad_(True)
        dc = torch.randn(t, n, generator=gen, device=dev).to(torch.bfloat16)
        before = dict(k1.launches_by_route)
        out = matmul(a, b)
        fwd_routes = routes_moved(before)
        before = dict(k1.launches_by_route)
        out.backward(dc)
        bwd_routes = routes_moved(before)
        torch.cuda.synchronize()
        if fwd_routes != {"wide": 1} or bwd_routes != {"wide": 2}:
            raise AssertionError(f"({t}, {k}, {n}): forward {fwd_routes}, backward {bwd_routes}, "
                                 f"want every product on the wide route")
        ad, bd = a.detach(), b.detach()
        bt, at = bd.t(), ad.t()
        errs = {"forward": row_err(out, matmul_ref(ad, bd)),
                "dA": row_err(a.grad, matmul_ref(dc, bt)),
                "dB": row_err(b.grad, matmul_ref(at, dc))}
        log(f"[train-kernel] bf16 {t}x{k}x{n}: " + ", ".join(
            f"{p} worst row rel {e['row_rel']:.3e}" for p, e in errs.items())
            + f" (limit {ROW_TOL[torch.bfloat16]:g}); forward {fwd_routes}, backward {bwd_routes}")
        for p, e in errs.items():
            worst_abs = max(worst_abs, e["max_abs_err"])
            if not e["finite"] or e["row_rel"] >= ROW_TOL[torch.bfloat16]:
                raise AssertionError(f"K1's {p} at ({t}, {k}, {n}) disagrees with the plain "
                                     f"version: {e}")
        operands = {"forward": (ad, bd), "dA": (dc, bt), "dB": (at, dc)}
        for p, (x, y) in operands.items():
            m_, k_ = x.shape
            n_ = y.shape[1]
            tm = {}
            # in turns: kernel, plain, library, kernel
            for name, fn in (("ms", matmul), ("plain_ms", matmul_ref),
                             ("library_ms", torch.matmul), ("ms", matmul)):
                tm.setdefault(name, []).append(graph_ms(fn, [(x, y)] * TRAIN_GRAPH_CALLS))
            tm = {name: min(v) for name, v in tm.items()}
            bms, by = bound(m_, k_, n_, torch.bfloat16)
            rows.append({"product": p, "shape": [m_, k_, n_], "route": "wide", **tm,
                         "bound_ms": bms, "bound_by": by, "row_rel": errs[p]["row_rel"]})
        del a, b, dc, out, ad, bd, bt, at
    layers = get_config(TRAIN_ARCH).num_layers
    per_step = {key: layers * sum(r[key] for r in rows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    flops = layers * sum(2.0 * math.prod(r["shape"]) for r in rows)
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    t_bytes = layers * sum(((r["shape"][0] + r["shape"][2]) * r["shape"][1]
                            + r["shape"][0] * r["shape"][2]) * 2 for r in rows) / PEAK_BYTES_S
    per_step["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    per_step["tflop"] = flops / 1e12
    log(f"[train-kernel] K1 per training step ({3 * 7 * layers} layer products, each alone; "
        f"dA and dB on views, no transposed copy): {per_step['ms']:.2f}ms, bound "
        f"{per_step['bound_ms']:.2f}ms ({per_step['bound_by']}, {per_step['tflop']:.2f} TFLOP), "
        f"torch.matmul {per_step['library_ms']:.2f}ms, plain {per_step['plain_ms']:.2f}ms")
    torch.cuda.empty_cache()
    return {"rows": rows, "per_step": per_step, "worst_abs_err": worst_abs}


def _train_batch(vocab: int, batch: int, seq: int, dev: torch.device, step: int = 0) -> dict:
    return device_put_batch(synth_batch(DataConfig(vocab_size=vocab, seq_len=seq,
                                                   global_batch=batch), step), dev)


def _control_grads(trainer, master, batch) -> list:
    """Every master leaf's gradient as autograd gives it, zero where the
    loss does not reach the leaf (the trainer refuses that case)."""
    leaves = tree_leaves(master)
    for w in leaves:
        w.requires_grad_(True)
    params = tree_map(lambda w, t: w.to(t), master, trainer.compute_dtypes())
    loss, _ = trainer.model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for w in leaves:
        w.requires_grad_(False)
    return [torch.zeros_like(w) if g is None else g for g, w in zip(grads, leaves)]


def train_grad_check(dev: torch.device, arch: str = TRAIN_ARCH, depth: dict = None,
                     tag: str = "train-check") -> dict:
    """(b) One fp32 train step of ``arch`` at full width and ``depth`` (a
    2-layer Llama; phase 17a the zoo, each with its config's remat policy)
    on the card and on the CPU, the same weights and batch (seamless also a
    seeded ``src_embed``): the loss and every master leaf's gradient within
    ``TRAIN_GRAD_TOL``, every gradient finite and every projection's
    non-zero; a control whose products detach K1's output lands outside
    the limit (and the trainer refuses it)."""
    t_start = time.perf_counter()
    depth = depth or {"num_layers": TRAIN_CHECK_LAYERS}
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **depth)
    model = build_model(cfg)
    master = tree_map(lambda t: t.float(),
                      model.init(torch.Generator(device=dev).manual_seed(3), dev))
    cpu = torch.device("cpu")
    keys = ["//".join(map(str, p)) for p, _ in tree_paths(master)]

    def batch_on(d):
        b = _train_batch(cfg.vocab_size, 1, TRAIN_CHECK_SEQ, d)
        if cfg.family == "audio":
            b["src_embed"] = torch.from_numpy(np.random.default_rng(3).standard_normal(
                (1, TRAIN_CHECK_SEQ, cfg.d_model), dtype=np.float32)).to(d)
        return b

    out, secs = {}, {}
    for name, d in (("card", dev), ("cpu", cpu)):
        t0 = time.perf_counter()
        m = master if d == dev else tree_map(lambda t: t.to(cpu, copy=True), master)
        k1.reset_launches()
        loss, _, grads = Trainer(model, TrainConfig(), device=d).loss_and_grads(m, batch_on(d))
        # both sides' gradients compared on the card (fp64 norms of 0.5 B-element
        # leaves take seconds on the host)
        out[name] = (loss.item(), [g.to(dev) for g in grads], _nonzero(k1.launches_by_route))
        del m, grads
        secs[name] = time.perf_counter() - t0
    want_launches = {"fma": train_step_launches(cfg, torch.float32)}
    if out["card"][2] != want_launches or out["cpu"][2]:
        raise AssertionError(f"[{tag}] K1 launches: card {out['card'][2]}, cpu {out['cpu'][2]}; "
                             f"want {want_launches} on the card, none on the cpu")

    def rel(g, c):
        return ((g.double() - c.double()).norm() / c.double().norm().clamp_min(1e-300)).item()

    errs = {k: rel(g, c) for k, g, c in zip(keys, out["card"][1], out["cpu"][1])}
    zero = [k for k, g in zip(keys, out["card"][1]) if g.ndim == 2 and "layers" in k
            and not bool(g.abs().sum() > 0)]
    nonfinite = [k for k, g in zip(keys, out["card"][1]) if not bool(torch.isfinite(g).all())]
    loss_card, loss_cpu = out["card"][0], out["cpu"][0]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max(errs, key=errs.get)
    log(f"[{tag}] {cfg.name} full width, {depth}, remat={cfg.remat!r}, fp32 step, "
        f"1x{TRAIN_CHECK_SEQ} tokens: loss card {out['card'][0]:.6f} cpu {out['cpu'][0]:.6f} "
        f"(rel {loss_rel:.2e}); {len(errs)} master leaves, worst gradient rel L2 "
        f"{errs[worst]:.3e} ({worst}), limit {TRAIN_GRAD_TOL:g}; zero projection gradients: "
        f"{zero}; non-finite: {nonfinite}; K1 {out['card'][2]}")
    if zero or nonfinite or errs[worst] >= TRAIN_GRAD_TOL or loss_rel >= TRAIN_GRAD_TOL:
        raise AssertionError(f"[{tag}] card and cpu training steps disagree: worst {worst} "
                             f"{errs[worst]}, loss {loss_rel}, zero gradients {zero}, "
                             f"non-finite {nonfinite}")

    local_mod = importlib.import_module("repro_torch.dist.local")

    def detached(a, b, **kw):   # K1's output with no autograd node
        return matmul(a.detach(), b.detach(), **kw)

    batch = batch_on(dev)
    trainer = Trainer(model, TrainConfig(), device=dev)
    with mock.patch.object(local_mod, "matmul", detached):
        try:
            trainer.loss_and_grads(master, batch)
            refused = None
        except RuntimeError as e:    # a master leaf the loss does not reach
            refused = str(e)[:120]
        ctrl = _control_grads(trainer, master, batch)
    ctrl_errs = {k: rel(g, c) for k, g, c in zip(keys, ctrl, out["cpu"][1])}
    caught = max(ctrl_errs.values())
    secs["all"] = time.perf_counter() - t_start
    log(f"[{tag}] control, K1's output detached: worst gradient rel L2 {caught:.3e} "
        f"(must be >= {TRAIN_GRAD_TOL:g}); the trainer refused it: {refused}; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    if caught < TRAIN_GRAD_TOL or refused is None:
        raise AssertionError(f"[{tag}] a detached K1 product passed: worst {caught}, the "
                             f"trainer refused it: {refused}")
    launches = out["card"][2]
    del master, ctrl, out
    torch.cuda.empty_cache()
    return {"loss": {"card": loss_card, "cpu": loss_cpu}, "grad_rel_l2": errs,
            "worst": [worst, errs[worst]], "launches": launches,
            "control_worst": caught, "control_refused": refused, "seconds": secs}


def _train_step_times(trainer, state, batch, steps: int) -> dict:
    """``steps`` steps of each kind on one state and batch.  Eager (the
    trainer's function, after one warm step): CUDA events around the loss
    and gradients and around the optimizer, the host clock around the whole
    step (ended by a sync).  Captured (``trainer.static_step``: its eager
    first step, then the capture and a replay): CUDA events and the host
    clock around each later replay (the batch's copy into the static
    buffers included), and the capture's seconds."""
    step = trainer.make_train_step()
    state, _ = step(state, batch)           # warm
    torch.cuda.synchronize()
    rows = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        lr = trainer.sched(state["step"])
        _, _, grads = trainer.loss_and_grads(state["master"], batch)
        ev[1].record()
        state, _ = adamw.step(state, grads, lr, trainer.opt_cfg)
        ev[2].record()
        torch.cuda.synchronize()
        rows.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                     "device_ms": ev[0].elapsed_time(ev[2]),
                     "grads_ms": ev[0].elapsed_time(ev[1]), "optimizer_ms": ev[1].elapsed_time(ev[2])})
        del grads
    eager = {key: float(np.median([r[key] for r in rows])) for key in rows[0]} | {"runs": rows}
    static = trainer.static_step(state)
    for _ in range(2):                      # the eager first step; the capture and a replay
        static(batch)
    torch.cuda.synchronize()
    rows = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        static(batch)
        ev[1].record()
        torch.cuda.synchronize()
        rows.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                     "device_ms": ev[0].elapsed_time(ev[1])})
    captured = {key: float(np.median([r[key] for r in rows])) for key in rows[0]}
    return {"eager": eager, "captured": {**captured, "runs": rows,
                                         "capture_s": trainer.graph_report()["capture_s"]}}


@contextlib.contextmanager
def _profiled_step(host_side: bool = True):
    """Within the scope, ``torch.profiler`` over CUDA and (``host_side``)
    the CPU, with a ``record_function`` range around
    ``mamba2._ssd_chunk_scan`` (the SSD scan's forward, and its recompute
    under ``"dots"``; its backward kernels are not in it); yields a dict
    that holds, after the scope, the device time of K1 and of the rest by
    kernel name, and from the host side the unembedding's forward (its K1
    launch, an ``unembed_ranges`` range), its backward's two fp32 products
    (``aten::mm``: a step's only ones), the scan's and the operators'
    (``profile_totals``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    real_scan = mamba2_layer._ssd_chunk_scan

    def ranged_scan(*args, **kw):
        with record_function("ssd_chunk_scan"):
            return real_scan(*args, **kw)

    out = {}
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_side else [])
    with mock.patch.object(mamba2_layer, "_ssd_chunk_scan", ranged_scan), unembed_ranges(), \
            profile(activities=activities) as prof:
        yield out
        torch.cuda.synchronize()
    split = profile_split(prof)
    ssd = split["ranges"].get("ssd_chunk_scan", {}).get("cpu", {})
    out.update({"device_ms": split["device_ms"], "k1_ms": split["k1_ms"],
                "k1_launches": split["k1_launches"], "unembed_ms": split["unembed_ms"],
                "unembed_calls": split["unembed_calls"], "mm_ms": split["mm_ms"],
                "mm_calls": split["mm_calls"], "k1_fp32_out_ms": split["k1_fp32_out_ms"],
                "k1_fp32_out_launches": split["k1_fp32_out_launches"],
                "ssd_scan_forward_ms": ssd.get("ms", 0.0), "ssd_scan_calls": ssd.get("count", 0),
                "top_operators": split["top_operators"],
                "rest_top_kernels": split["rest_top_kernels"]})


def check_unembed_profile(tag: str, prof: dict) -> None:
    """A profiled bf16 training step: the unembedding's one forward call,
    its one K1 launch with an fp32 output, and exactly two ``aten::mm``,
    its backward's fp32 products."""
    if not unembed_seen(prof, mm_calls=2):
        raise AssertionError(f"[{tag}] profiled step: unembedding {prof['unembed_calls']} calls, "
                             f"fp32-out K1 x{prof['k1_fp32_out_launches']}, aten::mm "
                             f"x{prof['mm_calls']} (want 1, 1, 2)")


def _profile_step(trainer, state, batch) -> dict:
    """One train step under ``_profiled_step``."""
    step = trainer.make_train_step()
    with _profiled_step() as prof:
        step(state, batch)
    return prof


def phase_train(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 14: the training path (module docstring)."""
    cfg = get_config(TRAIN_ARCH)
    out = {"kernel": train_kernel_check(dev, gen), "check": train_grad_check(dev)}

    # (c) the main path: the launcher at full width, its step captured,
    # counts from 0 just before; then the same run eager (--eager, no
    # checkpoints): the same state and batches
    per = train_step_launches(cfg)
    os.makedirs(CKPT_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=CKPT_DIR)
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats(dev)
    k1.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(buf, sys.stdout)), step_meter() as meter:
        rc = launch_train.main(TRAIN_ARGV + ["--ckpt", ckpt])
    wall = time.perf_counter() - t0
    path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    peak = torch.cuda.max_memory_allocated(dev)
    graph = meter["trainers"][0].graph_report()
    del meter["trainers"]
    cap = step_summary(meter["rows"])
    logged = [m.groups() for m in map(TRAIN_LOG.match, buf.getvalue().splitlines()) if m]
    losses = [float(x) for _, x, _ in logged]
    latest = train_store.latest_step(ckpt)
    ckpt_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt)
                  for f in fs) / 1e9
    shutil.rmtree(ckpt)
    want = {"wide": 2 * per}     # the eager first step and the capture
    log(f"[train] launcher, captured: rc {rc}, {len(logged)} steps logged in {wall:.1f}s (the "
        f"steps {sum(int(ms) for _, _, ms in logged) / 1e3:.1f}s of it), loss "
        f"{losses[0] if losses else None} -> {losses[-1] if losses else None}; K1 counted on "
        f"the host {path['routes']} (want {want}: the eager first step and the capture), "
        f"replayed {graph['k1_replayed']} ({graph['replays']} replays of "
        f"{graph['k1_per_replay']}); first step {cap['first_step_ms']:.1f}ms, the capturing "
        f"step {cap['capture_step_ms']:.1f}ms (capture {graph['capture_s']:.2f}s), a replay "
        f"{cap['host_ms']:.1f}ms host / {cap['device_ms']:.1f}ms device (median of "
        f"{cap['steps_timed']}); peak memory {peak / 2 ** 30:.2f} GiB; checkpoints "
        f"{ckpt_gb:.1f} GB on disk, LATEST step {latest}")
    if rc != 0 or len(logged) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"the launcher's run: rc {rc}, logged {logged}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if path["routes"] != want or latest != TRAIN_STEPS:
        raise AssertionError(f"K1 on the main path {path['routes']}, want {want}; LATEST {latest}")
    check_graph("train", graph, {"wide": per}, TRAIN_STEPS - 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k1.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()), step_meter() as meter:
        rc_e = launch_train.main(TRAIN_ARGV + ["--eager"])
    eager_routes = _nonzero(k1.launches_by_route)
    eager_peak = torch.cuda.max_memory_allocated(dev)
    del meter["trainers"]
    eag = step_summary(meter["rows"])
    log(f"[train] launcher, --eager: rc {rc_e}, K1 {eager_routes} (want "
        f"{ {'wide': per * TRAIN_STEPS} }); a step {eag['host_ms']:.1f}ms host / "
        f"{eag['device_ms']:.1f}ms device (median of {eag['steps_timed']}); peak memory "
        f"{eager_peak / 2 ** 30:.2f} GiB")
    if rc_e != 0 or eager_routes != {"wide": per * TRAIN_STEPS}:
        raise AssertionError(f"the eager launcher: rc {rc_e}, K1 {eager_routes}")
    held = held_to_eager("train", cap, eag, TRAIN_GRAD_TOL)
    out["path"] = {**path, "rc": rc, "losses": losses, "wall_s": wall,
                   "host_ms_logged": [int(ms) for _, _, ms in logged],
                   "peak_gib": peak / 2 ** 30, "ckpt_gb": ckpt_gb, "graph": graph,
                   "captured": cap, "eager": {**eag, "routes": eager_routes,
                                              "launches": sum(eager_routes.values()),
                                              "peak_gib": eager_peak / 2 ** 30},
                   "held_to_eager": held}

    # the same step timed (eager and replayed) and profiled (eager), outside the launcher
    model = build_model(cfg)
    trainer = Trainer(model, TrainConfig(steps=TRAIN_STEPS), device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    both = _train_step_times(trainer, state, batch, TRAIN_TIMED_STEPS)
    prof = _profile_step(trainer, state, batch)
    times, ctimes = both["eager"], both["captured"]
    times["tokens_per_s"] = TRAIN_TOKENS / times["host_ms"] * 1e3
    times["busy_share"] = prof["device_ms"] / times["device_ms"]
    ctimes["tokens_per_s"] = TRAIN_TOKENS / ctimes["host_ms"] * 1e3
    k = out["kernel"]["per_step"]
    log(f"[train] step at {TRAIN_BATCH}x{TRAIN_SEQ}, eager: host {times['host_ms']:.1f}ms, device "
        f"{times['device_ms']:.1f}ms (loss and gradients {times['grads_ms']:.1f}, optimizer "
        f"{times['optimizer_ms']:.1f}), {times['tokens_per_s']:.0f} tokens/s; captured: a "
        f"replay {ctimes['host_ms']:.1f}ms host / {ctimes['device_ms']:.1f}ms device, "
        f"{ctimes['tokens_per_s']:.0f} tokens/s, capture {ctimes['capture_s']:.2f}s; eager "
        f"step profiled: device "
        f"{prof['device_ms']:.1f}ms (busy {times['busy_share']:.0%} of the step), K1 {prof['k1_ms']:.1f}ms ({prof['k1_launches']} launches; "
        f"bound {k['bound_ms']:.2f}ms), the unembedding's forward (K1) {prof['unembed_ms']:.1f}ms, "
        f"its backward's fp32 aten::mm x{prof['mm_calls']} {prof['mm_ms']:.1f}ms; "
        f"top operators " + ", ".join(f"{r['op']} {r['ms']:.1f}ms" for r in prof["top_operators"][:6]))
    check_unembed_profile("train", prof)
    # phase 19 reads "device_ms": the replay's
    out["timing"] = {**ctimes, "eager": times, "profile": prof}
    del state, batch, trainer, both
    gc.collect()
    torch.cuda.empty_cache()

    # (d) train_4k cut to one sequence, every block recomputed: captured, then eager
    cfg4k = dataclasses.replace(cfg, remat="full")
    # the layers' forward recomputed once (the unembedding is outside them)
    per4k = train_step_launches(cfg) + 7 * cfg.num_layers
    runs = {}
    for capture in (True, False):
        torch.cuda.reset_peak_memory_stats(dev)
        k1.reset_launches()
        t0 = time.perf_counter()
        with step_meter() as meter:
            fit = Trainer(build_model(cfg4k), TrainConfig(steps=TRAIN_4K_STEPS, warmup=1,
                                                          log_every=1),
                          device=dev, capture=capture).fit(
                torch.Generator(device=dev).manual_seed(0), batch_iterator(DataConfig(
                    vocab_size=cfg.vocab_size, seq_len=TRAIN_4K_SEQ, global_batch=1)))
        graph = meter["trainers"][0].graph_report()
        del meter["trainers"]
        runs[capture] = {"losses": [h["loss"] for h in fit["history"]],
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                         "routes": _nonzero(k1.launches_by_route), "graph": graph,
                         "steps": step_summary(meter["rows"]),
                         "ms_per_step": [h["sec_per_step"] * 1e3 for h in fit["history"]],
                         "wall_s": time.perf_counter() - t0}
        del fit
        gc.collect()
        torch.cuda.empty_cache()
    c4k, e4k = runs[True], runs[False]
    want4k = {"wide": 2 * per4k}
    log(f"[train-4k] 1x{TRAIN_4K_SEQ}, remat='full', captured: losses {c4k['losses']}, steps "
        f"{[round(x, 1) for x in c4k['ms_per_step']]} ms (a replay "
        f"{c4k['steps']['device_ms']:.1f}ms device, capture {c4k['graph']['capture_s']:.2f}s), "
        f"{c4k['wall_s']:.1f}s in all; peak memory {c4k['peak_gib']:.2f} GiB; K1 counted "
        f"{c4k['routes']} (want {want4k}), replayed {c4k['graph']['k1_replayed']}; eager: steps "
        f"{[round(x, 1) for x in e4k['ms_per_step']]} ms, peak {e4k['peak_gib']:.2f} GiB, K1 "
        f"{e4k['routes']}")
    if len(c4k["losses"]) != TRAIN_4K_STEPS or not all(map(math.isfinite, c4k["losses"])) \
            or not c4k["losses"][-1] < c4k["losses"][0] or c4k["routes"] != want4k \
            or e4k["routes"] != {"wide": per4k * TRAIN_4K_STEPS}:
        raise AssertionError(f"train_4k: captured {c4k}, eager {e4k}")
    check_graph("train-4k", c4k["graph"], {"wide": per4k}, TRAIN_4K_STEPS - 1)
    held = held_to_eager("train-4k", c4k["steps"], e4k["steps"], TRAIN_GRAD_TOL)
    out["train_4k"] = {**c4k, "eager": e4k, "held_to_eager": held}

    out["restart"] = train_restart(dev)
    return out


def train_restart(dev: torch.device) -> dict:
    """(e) The smoke Llama on the card with a failure injected, captured:
    exactly one restart and one capture (the restore writes into the
    donated state, so the graph is kept), a falling loss, and the state
    right after the restore equal bit for bit to the checkpoint file it
    came from; then the same run eager, each step's loss and learning rate
    held to it."""
    cfg = get_smoke_config(TRAIN_ARCH)
    runs, restored = {}, []
    real_restore = Trainer.restore

    def spy(self, ckpt_dir, state):
        s, tree = real_restore(self, ckpt_dir, state)
        restored.append((ckpt_dir, s, [(p, t.detach().cpu().clone())
                                       for p, t in tree_paths(tree)]))
        return s, tree

    for capture in (True, False):
        ckpt = tempfile.mkdtemp(prefix="train_restart_", dir=CKPT_DIR)
        k1.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(Trainer, "restore", spy), step_meter() as meter:
            fit = Trainer(build_model(cfg), TrainConfig(ckpt_dir=ckpt, **RESTART_CFG),
                          device=dev, capture=capture).fit(
                torch.Generator(device=dev).manual_seed(0),
                batch_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)))
        runs[capture] = {"restarts": fit["restarts"], "losses": [h["loss"] for h in fit["history"]],
                         "routes": _nonzero(k1.launches_by_route),
                         "graph": meter["trainers"][0].graph_report(),
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                         "steps": step_summary(meter["rows"]), "ckpt": ckpt}
        del fit, meter["trainers"]
    cap, eag = runs[True], runs[False]
    mine = [r for r in restored if r[0] == cap["ckpt"]]
    if cap["restarts"] != 1 or len(mine) != 1 or not cap["losses"][-1] < cap["losses"][0] \
            or cap["graph"]["captures"] != 1 or eag["restarts"] != 1:
        raise AssertionError(f"restart leg: {cap['restarts']} restarts, {len(mine)} restores, "
                             f"{cap['graph']['captures']} captures, losses {cap['losses']}; "
                             f"eager {eag['restarts']} restarts")
    _, step, leaves = mine[0]
    with np.load(os.path.join(cap["ckpt"], f"step_{step:08d}", "arrays.npz")) as npz:
        files = {k: npz[k] for k in npz.files}
    differ = []
    for p, t in leaves:
        key = "//".join(map(str, p))
        mine_bits = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        disk = files[key].view(np.int16) if t.dtype == torch.bfloat16 else files[key]
        if mine_bits.dtype != disk.dtype or not np.array_equal(mine_bits, disk):
            differ.append(key)
    for r in runs.values():
        shutil.rmtree(r.pop("ckpt"))
    steps = cap["steps"]
    log(f"[train-restart] smoke on the card, failure at step {RESTART_CFG['fail_at_step']}, "
        f"captured: {cap['restarts']} restart from step {step}, {cap['graph']['captures']} "
        f"capture ({cap['graph']['capture_s']:.3f}s), {cap['graph']['replays']} replays, steps "
        f"by kind {steps['kinds']}; losses {[round(x, 4) for x in cap['losses']]}; "
        f"{len(leaves)} leaves of the state after the restore equal the checkpoint bitwise: "
        f"{not differ}; K1 counted {cap['routes']}, replayed {cap['graph']['k1_replayed']}; a "
        f"replay {steps['host_ms']:.2f}ms host / {steps['device_ms']:.2f}ms device, eager "
        f"{eag['steps']['host_ms']:.2f}ms / {eag['steps']['device_ms']:.2f}ms; peak "
        f"{cap['peak_gib']:.3f} GiB (eager {eag['peak_gib']:.3f})")
    if differ:
        raise AssertionError(f"restored leaves differ from the checkpoint: {differ}")
    held = held_to_eager("train-restart", cap["steps"], eag["steps"], TRAIN_GRAD_TOL)
    return {**cap, "restored_step": step, "leaves": len(leaves), "eager": eag,
            "held_to_eager": held}


def train_route_rows(tr: dict) -> list:
    """(path, part, K1 launches by route) of phase 14's captured runs: the
    launches counted on the host ("": the eager first step and the
    capture), the graph's replays and the same run eager."""
    legs = {"train": tr["path"], "train_4k_remat_full": tr["train_4k"],
            "train_restart_smoke": tr["restart"]}
    return [row for key, leg in legs.items()
            for row in ((key, "", leg["routes"]),
                        (key, "_graph_replays", leg["graph"]["k1_replayed"]),
                        (key, "_eager", leg["eager"]["routes"]))]


def layout_k1_rows(layouts: dict) -> dict:
    """Phase 2's layout rows for the kernels line's ``per_route``: K1 on a
    transposed operand, beside its bound, the plain version's time and
    the library call's."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out = {}
    for r in layouts["rows"]:
        m, k, n = r["shape"]
        label = (f"{r['route']}: {r['what']}, {m}x{k}x{n}"
                 f"{', A stored transposed' if r['a_t'] else ''}"
                 f"{', B stored transposed' if r['b_t'] else ''}, {r['out_dtype']} out")
        out[label] = {key: r[key] for key in keys}
        if "upcast_ms" in r:
            out[label]["upcast_and_fp32_torch_matmul_ms"] = r["upcast_ms"]
    return out


def decode_step_row(timings: list, m: int = 4) -> dict:
    """K1's numbers for one serving forward at M rows (4: a decode step at
    batch 4; 64: the prefill of the 4x16 bucket): the 7 projections of
    each of the 16 layers."""
    by_shape = {tuple(r["shape"]): r for r in timings}
    rows = [by_shape[(m, k, n)] for (k, n) in LAYER_KN]
    layers = get_config("llama3.2-1b").num_layers
    tot = {key: layers * sum(r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = layers * sum((m * k + k * n + m * n) * 2 for (k, n) in LAYER_KN) / PEAK_BYTES_S
    t_ops = layers * sum(2.0 * m * k * n for (k, n) in LAYER_KN) / PEAK_FLOPS[torch.bfloat16]
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return tot


def flash_row(report: dict) -> dict:
    """K2's entry: one long-prefill forward's 24 launches at danube's shape,
    all on the wgmma route; each route's time per launch at both timed
    shapes beside it."""
    layers = get_config(PREFILL_ARCH).num_layers
    timings = report["flash_kernel"]["timings"]
    fam = report["families"]
    big = report["big"]
    t = timings["danube"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "launches": report["long_prefill"]["launches"]["K2"],
        "launches_by_path": {"long_prefill": report["long_prefill"]["launches"]["K2"],
                             "planned_prefill": sum(report["planned_prefill"]["k2_routes"].values()),
                             "family_seamless_encode": fam[ENCDEC_ARCH]["path"]["k2_launches"],
                             "family_zamba2_prefill":
                                 sum(fam["hybrid_prefill"]["launches"]["K2"].values()),
                             "roofline": report["roofline"]["launches"]["K2"],
                             f"big_{BIG_PREFILL_ARCH}_prefill": big["prefill"]["launches"]["K2"]},
        "routes": {"long_prefill": report["long_prefill"]["k2_routes"],
                   "planned_prefill": report["planned_prefill"]["k2_routes"],
                   "long_prefill_fp32_check": {"fma": report["long_prefill"]["fp32"]["launches"]},
                   "family_seamless_encode": fam[ENCDEC_ARCH]["path"]["k2_routes"],
                   "family_zamba2_prefill": fam["hybrid_prefill"]["launches"]["K2"],
                   "roofline": report["roofline"]["launches"]["K2_routes"],
                   f"big_{BIG_PREFILL_ARCH}_prefill": big["prefill"]["k2_routes"],
                   f"big_{BIG_PREFILL_ARCH}_prefill_non_causal_control":
                       big["prefill"]["control_k2_routes"]},
        "max_abs_err": max(report["flash_kernel"]["worst_bf16_abs_err"],
                           *(fam[key]["k2"]["check"]["max_abs_err"]
                             for key in (ENCDEC_ARCH, "hybrid_prefill")),
                           *(r["check"]["max_abs_err"] for r in big["k2"].values())),
        **{key: layers * t[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": t["bound_by"],
        "work": f"one bf16 long-prefill forward of {PREFILL_ARCH}: {layers} launches at "
                f"(B, S_q, S_kv, H_q, H_kv, D, window) = {tuple(t['shape'])}; library: "
                f"scaled_dot_product_attention[{t['sdpa_backend']}]",
        "per_launch": {**{name: {key: r[key] for key in (
            "shape", "ms", "mma_ms", "bound_ms", "library_ms", "plain_ms", "sdpa_backend",
            "tflops")} for name, r in timings.items()},
            **{name: {key: r[key] for key in (
                "shape", "causal", "ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                "sdpa_backend", "tflops")}
               for name, r in (("seamless encoder (non-causal)", fam[ENCDEC_ARCH]["k2"]),
                               ("zamba2 shared block (causal, D 80)",
                                fam["hybrid_prefill"]["k2"]), *big["k2"].items())}},
        "per_forward": {f"{BIG_PREFILL_ARCH} forward, S = {big['prefill']['seq']} "
                        f"({big['prefill']['launches']['K2']} launches), profiled":
                            {"ms": big["prefill"]["profile"]["k2_ms"],
                             "bound_ms": big["prefill"]["k2_bound_ms"],
                             "bound_by": big["prefill"]["k2_bound_by"]}},
        "sources": {"wgmma": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
                    "mma, fma": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"},
    }


# -- the MoE and MLA decoders (phase 15) ------------------------------------------------

ZOO_ARCHS = ("deepseek-moe-16b", "minicpm3-4b")


def weight_bytes(params) -> int:
    """Bytes a decode step reads of the weights: every leaf but the
    embedding table, of which it gathers a few rows; the unembedding
    matrix is read whole, the table itself where the embeddings are tied."""
    table = params["embed"]["embedding"]
    tied = "lm_head" not in params["embed"]
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)
               if tied or t is not table)


def state_bytes(model, dev: torch.device, batch: int) -> int:
    """Bytes of a batch's recurrent state (the Mamba conv and SSM states,
    the mLSTM and sLSTM states): a decode step reads and writes each once.
    0 for a model whose cache is attention K/V only."""
    cache = model.init_cache(batch, 64, dev)
    return sum(t.numel() * t.element_size() for key in ("mamba", "m", "s")
               for t in tree_leaves(cache.get(key, {})))


def expert_products(model, params, dev: torch.device, batch: int) -> dict:
    """The MoE layers' expert products alone (``moe.expert_ffn``: gate, up,
    SiLU, down on the stacked weights) at a decode step's shape, every MoE
    layer's weights in turn in one CUDA graph (CUDA events), beside the
    bound of reading those weights and the slots once."""
    cfg = model.cfg
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    cap = moe_layer._capacity(1, e, cfg.top_k, cfg.capacity_factor)
    gen = torch.Generator(device=dev).manual_seed(3)
    xe = torch.randn(batch, e, cap, d, generator=gen, device=dev).to(model.dtype)
    calls = [(lp["moe"], xe) for lp in params["layers"]]
    with torch.no_grad():
        per_layer = graph_ms(moe_layer.expert_ffn, calls)
    esize = torch.finfo(model.dtype).bits // 8
    nbytes = len(calls) * (3 * e * d * ff + 2 * xe.numel()) * esize
    flops = len(calls) * 2 * 3 * xe.numel() * ff
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[model.dtype] * 1e3
    return {"layers": len(calls), "slots": list(xe.shape), "ms": per_layer * len(calls),
            "ms_per_layer": per_layer, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile_decode_step(model, params, dev: torch.device, bucket) -> dict:
    """One eager decode step at a bucket's shape under ``torch.profiler``
    (untimed; the step's device time comes from graph replays): device
    time by kernel name into K1 and the rest, the rest by top kernels and
    operators, the unembedding's (one call through K1; no ``aten::mm`` in
    the step); and K1's bound for the step, summed over the products it
    ran."""
    from torch.profiler import ProfilerActivity, profile

    batch, seq = bucket
    cache = model.init_cache(batch, 64, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, model.cfg.vocab_size, size=(batch, seq))).to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    with torch.no_grad():
        serve_prefill(model, params, cache, tokens, offsets)
        step = lambda: serve_step(model, params, cache, tokens[:, -1:], seq, offsets)  # noqa: E731
        step()
        torch.cuda.synchronize()
        with k1_calls() as calls, unembed_ranges(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    out = profile_split(prof)
    if not unembed_seen(out):
        raise AssertionError(f"a profiled {model.cfg.name} decode step ran aten::mm "
                             f"x{out['mm_calls']} or no unembedding through K1: {out}")
    out["k1_bound_ms"] = sum(bound(m, k, n, dt, od)[0] for m, n, k, _, _, dt, od, *_ in calls)
    return out


def path_k1_calls(model, params, dev: torch.device) -> dict:
    """K1's calls (``k1_calls``) of one eager prefill and one eager decode
    step at each serving bucket, by (step, bucket)."""
    out = {}
    with torch.no_grad():
        for batch, seq in SERVE_BUCKETS:
            cache = model.init_cache(batch, 64, dev)
            tokens = torch.from_numpy(np.random.default_rng(4).integers(
                1, model.cfg.vocab_size, size=(batch, seq))).to(dev)
            offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
            with k1_calls() as pre:
                serve_prefill(model, params, cache, tokens, offsets)
            with k1_calls() as dec:
                serve_step(model, params, cache, tokens[:, -1:], seq, offsets)
            out[f"prefill {batch}x{seq}"], out[f"decode {batch}x{seq}"] = pre, dec
    return out


def k1_step_times(calls: list, dev: torch.device) -> dict:
    """K1, ``torch.matmul`` (the yardstick, never called by the port) and
    the plain version on one forward's K1 calls: each distinct call timed
    in turns by CUDA-graph replays over weight copies that exceed L2 (as
    phase 2 times Llama's), times its count; and the bound of those calls."""
    gen = torch.Generator(device=dev).manual_seed(6)
    tot = {"ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    t_bytes = t_ops = 0.0
    for (m, n, k, blocks, order, dt, out_dtype, a_t, b_t), count in sorted(
            Counter(calls).items(), key=str):
        if dt != torch.bfloat16 or a_t:
            raise AssertionError(f"a serving step called K1 at {m}x{n}x{k} {dt} -> {out_dtype}"
                                 f" (A transposed {a_t})")
        _, wcalls = _decode_operands(dev, gen, m, k, n, b_t)

        def kernel(a, b, blocks=blocks, order=order, out_dtype=out_dtype):
            return matmul(a, b, block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
                          order=order, out_dtype=out_dtype)

        def plain(a, b, out_dtype=out_dtype):
            return matmul_ref(a, b, out_dtype)
        fns = {"ms": kernel, "library_ms": _library_mm(out_dtype, dt) or _upcast_mm,
               "plain_ms": plain}
        t = {}
        for name in ("ms", "library_ms", "plain_ms", "plain_ms", "library_ms", "ms"):
            t.setdefault(name, []).append(graph_ms(fns[name], wcalls))
        for name, v in t.items():
            tot[name] += count * min(v)
        tot["bound_ms"] += count * bound(m, k, n, dt, out_dtype)[0]
        t_bytes += count * ((m * k + k * n) * 2 + m * n * out_dtype.itemsize) / PEAK_BYTES_S
        t_ops += count * 2.0 * m * k * n / PEAK_FLOPS[dt]
        del wcalls
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    tot["products"] = len(calls)
    return tot


def check_zoo_k1(model, params, dev: torch.device, tag: str) -> dict:
    """Every distinct K1 call of the served model's eager prefills and
    decode steps at both buckets held against the plain version
    (``check_k1_calls``), the worst row per shape logged; then the batch-4
    decode step's calls timed (``k1_step_times``)."""
    by_step = path_k1_calls(model, params, dev)
    per_forward = k1_per_step(model.cfg)
    for step, calls in by_step.items():
        seq = int(step.split("x")[-1])
        want = per_forward * (prefill_steps(model, seq) if step.startswith("prefill") else 1)
        if len(calls) != want:
            raise AssertionError(f"an eager {step} called K1 {len(calls)} times, want {want}")
    checked = check_k1_calls([c for calls in by_step.values() for c in calls], dev)
    routes = {step: dict(Counter(k1.ROUTE_OF[c[5], c[3]] for c in calls))
              for step, calls in by_step.items()}
    log(f"[{tag}] K1 at the served model's own shapes: {checked['calls']} calls of the eager "
        f"prefills and decode steps at both buckets ({routes}), {len(checked['distinct'])} "
        f"distinct, each within ROW_TOL of the plain version (worst row rel "
        f"{checked['worst_row_rel']:.3e}): " + ", ".join(
            f"{'x'.join(map(str, r['shape']))} {r['route']} x{r['calls']} {r['row_rel']:.2e}"
            for r in checked["distinct"]))
    step = SERVE_BUCKETS[0]
    times = k1_step_times(by_step[f"decode {step[0]}x{step[1]}"], dev)
    log(f"[{tag}] K1 on one decode step's {times['products']} products at batch {step[0]}, "
        f"timed alone: {times['ms']:.3f}ms, bound {times['bound_ms']:.3f}ms "
        f"({times['bound_by']}), torch.matmul {times['library_ms']:.3f}ms, plain "
        f"{times['plain_ms']:.3f}ms")
    return {"routes": routes, "check": checked, "decode_step": times}


def zoo_measure(dev: torch.device, tag: str):
    """What phase 15 measures of a served model before it is freed: the
    weight-read bound of a decode step, the expert products alone (MoE),
    and one profiled decode step."""
    def measure(model, params) -> dict:
        batch = SERVE_BUCKETS[0][0]
        nbytes = weight_bytes(params)
        sbytes = state_bytes(model, dev, batch)
        out = {"weight_bytes": nbytes, "weight_bound_ms": nbytes / PEAK_BYTES_S * 1e3,
               "state_bytes": sbytes,
               "step_bound_ms": (nbytes + 2 * sbytes) / PEAK_BYTES_S * 1e3}
        if model.cfg.num_experts:
            out["experts"] = ex = expert_products(model, params, dev, batch)
            log(f"[{tag}] expert products alone, {ex['layers']} MoE layers at slots "
                f"{ex['slots']}: {ex['ms']:.3f}ms a decode step ({ex['ms_per_layer']:.4f}ms a "
                f"layer), bound {ex['bound_ms']:.3f}ms ({ex['bound_by']}, "
                f"{ex['bytes'] / 1e9:.2f} GB)")
        out["k1"] = check_zoo_k1(model, params, dev, tag)
        out["profile"] = prof = profile_decode_step(model, params, dev, SERVE_BUCKETS[0])
        log(f"[{tag}] decode step weight-read bound {out['weight_bound_ms']:.3f}ms "
            f"({nbytes / 1e9:.2f} GB; with the recurrent state read and written, "
            f"{sbytes / 1e9:.3f} GB, {out['step_bound_ms']:.3f}ms); profiled eager step: "
            f"device {prof['device_ms']:.3f}ms, "
            f"K1 {prof['k1_ms']:.3f}ms ({prof['k1_launches']} launches, bound "
            f"{prof['k1_bound_ms']:.3f}ms; the unembedding's {prof['unembed_ms']:.3f}ms, no "
            f"aten::mm), rest {prof['rest_ms']:.3f}ms: " + ", ".join(
                f"{k['kernel'][:60]} {k['ms']:.3f}ms x{k['launches']}"
                for k in prof["rest_top_kernels"][:5]))
        return out
    return measure


def phase_zoo_serve(dev: torch.device) -> dict:
    """Phase 15: for deepseek-moe-16b and minicpm3-4b, (a) the full-width
    2-layer fp32 model card vs CPU (phase 3's check), then (b, c) the full
    model behind ``Server`` as phase 4 runs Llama, and what ``zoo_measure``
    measures; each model freed before the next."""
    out = {}
    for arch in ZOO_ARCHS:
        tag = f"zoo-{arch}"
        out[arch] = {"model": phase_model(dev, arch, tag),
                     "serve": phase_serve(dev, arch, tag, measure=zoo_measure(dev, tag))}
        torch.cuda.empty_cache()
    return out


# -- the recurrent and encoder-decoder families (phase 16) -------------------------------

SERVED_FAMILIES = ("zamba2-2.7b", "xlstm-350m")
ENCDEC_ARCH = "seamless-m4t-medium"
HYBRID_ARCH = "zamba2-2.7b"
# (a): one group at full width, fp32: zamba2's 6 Mamba layers and the shared
# block; xLSTM's mmm-s; one encoder and one decoder layer
FAMILY_CHECK_DEPTH = {"zamba2-2.7b": {"num_layers": 6}, "xlstm-350m": {"num_layers": 4},
                      ENCDEC_ARCH: {"num_layers": 2, "enc_layers": 1, "dec_layers": 1}}
FAMILY_CHECK_SRC = 256     # (a): seamless's source frames on both devices
ENCDEC_SRC = (4, 1024)     # (c): source batch and frames
ENCDEC_NEW = 16            # (c): greedy tokens decoded from the cross cache
HYBRID_PREFILL_S = 8192    # (d): tokens of the uncached zamba2 forward


def family_check(dev: torch.device, arch: str) -> dict:
    """Phase 16a: ``arch`` at full width, one group deep, fp32, on the card
    through K1 and on the CPU through the plain version, the same weights:
    the uncached forward's logits (seamless: ``forward`` = encode +
    decode_train), the teacher-forced prefill's last-token logits
    (seamless after ``encode`` and ``prefill_cross``) and one decode
    step's, each within ``MODEL_TOL``; K1 launched the path's count on the
    card (all fma), none on the CPU."""
    tag = f"family-check-{arch}"
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **FAMILY_CHECK_DEPTH[arch])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    cpu = torch.device("cpu")
    cpu_params = _to(params, cpu)
    rng = np.random.default_rng(1)
    sp = 16
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, sp)))
    src = None
    per_step = k1_per_step(cfg)
    want = per_step * (1 + sp + 1)
    if cfg.family == "audio":
        src = torch.from_numpy(rng.standard_normal((2, FAMILY_CHECK_SRC, cfg.d_model),
                                                   dtype=np.float32))
        # the encoder twice (forward, then for the cross cache): 7 a layer;
        # forward's decoder 11 a layer (cross k and v too) and its
        # unembedding; prefill_cross 2 a decoder layer; then the steps
        want = 14 * cfg.enc_layers + 13 * cfg.dec_layers + 1 + per_step * (sp + 1)
    out = {}
    for name, p, d in (("card", params, dev), ("cpu", cpu_params, cpu)):
        k1.reset_launches()
        with torch.no_grad():
            if src is None:
                fwd, _ = model.forward(p, tokens.to(d))
                cache = model.init_cache(2, 32, d)
            else:
                fwd, _ = model.forward(p, {"src_embed": src.to(d), "tokens": tokens.to(d)})
                cache = model.prefill_cross(p, model.encode(p, src.to(d)),
                                            model.init_cache(2, 32, d, src_len=FAMILY_CHECK_SRC))
            pre = serve_prefill(model, p, cache, tokens.to(d))
            nxt = pre.argmax(-1) if name == "card" else out["card"]["next"]
            dec = serve_step(model, p, cache, nxt.to(d)[:, None],
                             torch.tensor(sp, dtype=torch.int64, device=d))
        out[name] = {"forward": fwd.cpu(), "prefill": pre.cpu(), "decode": dec.cpu(),
                     "next": nxt.cpu(), "routes": _nonzero(k1.launches_by_route)}
    v = cfg.vocab_size
    errs = {}
    for what in ("forward", "prefill", "decode"):
        g, c = out["card"][what][..., :v], out["cpu"][what][..., :v]
        if not (bool(torch.isfinite(g).all()) and g.shape == c.shape and g.shape[-1] == v):
            raise AssertionError(f"[{tag}] {what} logits malformed: {tuple(g.shape)}")
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
    routes = out["card"]["routes"]
    log(f"[{tag}] {cfg.name} full width, {FAMILY_CHECK_DEPTH[arch]}, fp32: forward rel_err="
        f"{errs['forward']:.3e} prefill (teacher-forced, {sp} steps) rel_err="
        f"{errs['prefill']:.3e} decode rel_err={errs['decode']:.3e}; K1 on the card {routes} "
        f"(want {want} fma), on the cpu {out['cpu']['routes']}")
    if routes != {"fma": want} or out["cpu"]["routes"]:
        raise AssertionError(f"[{tag}] K1 launched {routes} on the card, "
                             f"{out['cpu']['routes']} on the cpu; want {want} fma, none")
    if max(errs.values()) >= MODEL_TOL:
        raise AssertionError(f"[{tag}] card and cpu logits disagree: {errs}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return {"rel_err": errs, "launches": want, "routes": routes,
            "depth": FAMILY_CHECK_DEPTH[arch]}


def k2_case(dev: torch.device, gen: torch.Generator, name: str, shape: tuple,
            causal: bool, tag: str = "families") -> dict:
    """K2 through ``mha`` at one of phase 16's shapes (B, S_q, S_kv, H_q,
    H_kv, D, window): on the wgmma route, held row by row to its plain
    version (head by head), and timed in turns beside
    ``F.scaled_dot_product_attention`` (the yardstick) and the plain
    version; its bound."""
    b, sq, skv, hq, hkv, d, window = shape
    q, k, v = _qkv(gen, dev, torch.bfloat16, b, sq, skv, hq, hkv, d)
    sdpa, backend = sdpa_yardstick(q, k, v, window, causal)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    g = hq // hkv
    kept = {}

    def kern():
        kept["out"] = mha(q, k, v, causal=causal, window=window)

    def plain():
        kv = [(i // hq) * hkv + (i % hq) // g for i in range(qh.shape[0])]
        kept["ref"] = [attention_ref(qh[i:i + 1], kh[j:j + 1], vh[j:j + 1], causal=causal,
                                     window=window) for i, j in enumerate(kv)]

    k2.reset_launches()
    kern()
    if _nonzero(k2.launches_by_route) != {"wgmma": 1}:
        raise AssertionError(f"K2 {name}: mha took {k2.launches_by_route}, not wgmma")
    t = {}
    for key in ("ms", "library_ms", "plain_ms", "library_ms", "ms"):
        fn = {"ms": kern, "library_ms": sdpa, "plain_ms": plain}[key]
        t.setdefault(key, []).append(event_ms(fn, 1 if key == "plain_ms" else 5))
    e = _check_rows(tag, f"K2 bfloat16 wgmma {name} {list(shape)} causal={causal}",
                    _heads(kept["out"]), torch.cat(kept["ref"]), ROW_TOL[torch.bfloat16])
    bms, by = flash_bound(b, sq, skv, hq, hkv, d, window, causal=causal)
    pairs = attention_pairs(sq, skv, causal, window)
    row = {"shape": list(shape), "causal": causal, "dtype": "bfloat16", "route": "wgmma",
           **{key: min(val) for key, val in t.items()}, "runs": t, "check": e,
           "bound_ms": bms, "bound_by": by, "sdpa_backend": backend,
           "exp_floor_ms": exp_floor_ms(b, sq, skv, hq, window, dev, causal),
           "pairs_per_head": pairs}
    row["bound_share"] = bms / row["ms"]
    row["tflops"] = 4.0 * d * b * hq * pairs / row["ms"] / 1e9
    log(f"[{tag}] K2 {name} {list(shape)} causal={causal}: wgmma {row['ms']:.3f}ms "
        f"({row['tflops']:.0f} TFLOP/s) bound {bms:.3f}ms ({by}, {row['bound_share']:.1%}) "
        f"sdpa[{backend}] {row['library_ms']:.3f}ms plain (head by head) "
        f"{row['plain_ms']:.3f}ms")
    del q, k, v, qh, kh, vh, kept, sdpa
    torch.cuda.empty_cache()
    return row


def encdec_greedy(model, params, memory: torch.Tensor, first: torch.Tensor, steps: int,
                  forced: torch.Tensor = None):
    """The encoder-decoder's inference path after ``encode``:
    ``prefill_cross`` from ``memory`` into a fresh cache, then ``steps``
    decode steps from ``first`` (B, 1), each fed the previous step's argmax
    (or, with ``forced`` (B, steps), that token: teacher forcing).
    Returns the argmax tokens (B, steps), each step's logits, and the host
    clock after the cross cache and after each step (synchronised)."""
    dev = memory.device
    cache = model.init_cache(memory.shape[0], 64, dev, src_len=memory.shape[1])
    model.prefill_cross(params, memory, cache)
    cur, toks, logits, marks = first, [], [], [time.perf_counter()]
    for t in range(steps):
        model.check_decode_pos(cache, t)
        out = model.decode_step(params, cache, cur,
                                torch.full((), t, dtype=torch.int64, device=dev))[0]
        nxt = out.argmax(-1)
        toks.append(nxt)
        logits.append(out)
        cur = (nxt if forced is None else forced[:, t])[:, None]
        torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())
    return torch.stack(toks, dim=1), logits, marks


def phase_encdec(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 16c: full-depth bf16 seamless-m4t-medium (12 + 12 layers) on
    its own inference path: ``encode`` of a seeded (4, 1024, 1024)
    ``src_embed`` with ``attn_impl="flash"`` (K2 non-causal, 12 launches),
    ``prefill_cross``, 16 greedy decode steps (the main path, counts from 0
    just before); the same steps with ``attn_impl="xla"``, fed the same
    tokens, within ``PREFILL_LOGITS_TOL`` per row; another source changes
    the tokens; K2 at the encoder's shape against its plain version; every
    distinct K1 call of the path against the plain version and timed."""
    from torch.profiler import ProfilerActivity, profile

    tag = "family-seamless"
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH), attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    b, s_src = ENCDEC_SRC
    src_gen = torch.Generator(device=dev).manual_seed(7)
    src = torch.randn((b, s_src, cfg.d_model), generator=src_gen, device=dev)
    first = torch.full((b, 1), DUMMY_TOKEN, dtype=torch.int64, device=dev)
    per_step = k1_per_step(cfg)
    want_k1 = {"wide": 7 * cfg.enc_layers + 2 * cfg.dec_layers, "thin": per_step * ENCDEC_NEW}
    want_k2 = {"wgmma": cfg.enc_layers}
    with torch.no_grad():
        # the main path: counts from 0 just before, read just after
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        memory = model.encode(params, src)
        toks, logits, marks = encdec_greedy(model, params, memory, first, ENCDEC_NEW)
        path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route),
                "k2_launches": k2.launches, "k2_routes": _nonzero(k2.launches_by_route)}
        if path["routes"] != want_k1 or path["k2_routes"] != want_k2:
            raise AssertionError(f"[{tag}] the path launched K1 {path['routes']} (want "
                                 f"{want_k1}), K2 {path['k2_routes']} (want {want_k2})")
        if not (bool(torch.isfinite(memory).all()) and tuple(memory.shape) == (b, s_src,
                                                                              cfg.d_model)):
            raise AssertionError(f"[{tag}] encoder output malformed: {tuple(memory.shape)}")
        steps_s = np.diff(np.asarray(marks))
        ttft_s = marks[1] - t0
        wall_s = marks[-1] - t0
        new = toks.cpu().tolist()
        if not all(0 <= x < cfg.vocab_size for row in new for x in row):
            raise AssertionError(f"[{tag}] tokens outside the vocabulary: {new}")
        # the xla route's encoder, fed the flash route's tokens; logits over
        # the real vocabulary (the padded columns' -1e30 would swamp a row)
        v = cfg.vocab_size
        xmem = xla.encode(params, src)
        mem_err = row_err(memory, xmem)
        _, xlogits, _ = encdec_greedy(xla, params, xmem, first, ENCDEC_NEW, forced=toks)
        errs = [row_err(a[:, :v], x[:, :v]) for a, x in zip(logits, xlogits)]
        worst = max(e["row_rel"] for e in errs)
        del xmem, xlogits
        # another source
        src2 = torch.randn((b, s_src, cfg.d_model), generator=src_gen, device=dev)
        toks2, logits2, _ = encdec_greedy(model, params, model.encode(params, src2), first,
                                          ENCDEC_NEW)
        changed = (toks2 != toks).sum().item()
        first_step_moved = row_err(logits2[0][:, :v], logits[0][:, :v])["row_rel"]
        del logits2, src2
        # device times: the encoder (CUDA events, and its kernels by name
        # under torch.profiler); one decode step captured
        encode_ms = event_ms(lambda: model.encode(params, src), 3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.encode(params, src)
            torch.cuda.synchronize()
        enc_prof = profile_split(prof)
        cache = model.init_cache(b, 64, dev, src_len=s_src)
        model.prefill_cross(params, memory, cache)
        pos = torch.full((), ENCDEC_NEW, dtype=torch.int64, device=dev)
        step_ms = graph_ms(lambda: model.decode_step(params, cache, first, pos), [()])
        # K1's calls of the path, held to the plain version and timed
        with k1_calls() as enc_calls:
            model.encode(params, src)
            model.prefill_cross(params, memory, cache)
        with k1_calls() as dec_calls:
            model.decode_step(params, cache, first, pos)
    log(f"[{tag}] {cfg.name} bf16: encode (4 x {s_src} frames) + prefill_cross + "
        f"{ENCDEC_NEW} greedy steps: K1 {path['routes']}, K2 {path['k2_routes']}; ttft "
        f"{ttft_s * 1e3:.2f}ms, step p50 {np.percentile(steps_s, 50) * 1e3:.3f}ms p99 "
        f"{np.percentile(steps_s, 99) * 1e3:.3f}ms, {b * ENCDEC_NEW / wall_s:.1f} tok/s (eager); "
        f"device: encode {encode_ms:.3f}ms, a captured decode step {step_ms:.3f}ms; req0 "
        f"tokens {new[0][:8]}...")
    log(f"[{tag}] profiled encode: device {enc_prof['device_ms']:.3f}ms = K1 "
        f"{enc_prof['k1_ms']:.3f}ms + K2 {enc_prof['k2_ms']:.3f}ms + rest "
        f"{enc_prof['rest_ms']:.3f}ms; top kernels of the rest: " + ", ".join(
            f"{k['kernel'][:50]} {k['ms']:.3f}ms x{k['launches']}"
            for k in enc_prof["rest_top_kernels"][:5]) + "; top operators: " + ", ".join(
            f"{o['op']} {o['ms']:.3f}ms" for o in enc_prof["top_operators"][:5]))
    log(f"[{tag}] flash vs xla: encoder output worst row rel {mem_err['row_rel']:.3e}, decode "
        f"logits worst row rel {worst:.3e} (limit {PREFILL_LOGITS_TOL:g}); another source "
        f"changed {changed} of {b * ENCDEC_NEW} tokens, the first step's logits by "
        f"{first_step_moved:.3e} per row")
    if worst >= PREFILL_LOGITS_TOL or not all(e["finite"] for e in errs):
        raise AssertionError(f"[{tag}] flash and xla routes disagree: worst row {worst}")
    if not changed:
        raise AssertionError(f"[{tag}] another source gave the same tokens: the decoder "
                             f"does not read the source")
    checked = check_k1_calls(enc_calls + dec_calls, dev)
    log(f"[{tag}] K1 at the path's own shapes: {checked['calls']} calls, "
        f"{len(checked['distinct'])} distinct, each within ROW_TOL of the plain version "
        f"(worst row rel {checked['worst_row_rel']:.3e}): " + ", ".join(
            f"{'x'.join(map(str, r['shape']))} {r['route']} x{r['calls']} {r['row_rel']:.2e}"
            for r in checked["distinct"]))
    times = {"decode_step": k1_step_times(dec_calls, dev),
             "encode_and_cross": k1_step_times(enc_calls, dev)}
    for what, t in times.items():
        log(f"[{tag}] K1 on the {what.replace('_', ' ')}'s {t['products']} products, timed "
            f"alone: {t['ms']:.3f}ms, bound {t['bound_ms']:.3f}ms ({t['bound_by']}), "
            f"torch.matmul {t['library_ms']:.3f}ms, plain {t['plain_ms']:.3f}ms")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params, memory, cache, logits
    torch.cuda.empty_cache()
    k2_row = k2_case(dev, gen, "seamless-encoder", (b, s_src, s_src, cfg.num_heads,
                                                    cfg.num_kv_heads, cfg.head_dim, 0), False)
    return {"path": path, "ttft_ms": ttft_s * 1e3, "p50_ms": float(np.percentile(steps_s, 50)
                                                                    * 1e3),
            "p99_ms": float(np.percentile(steps_s, 99) * 1e3),
            "tokens_per_s": b * ENCDEC_NEW / wall_s, "encode_ms": encode_ms,
            "encode_profile": {key: enc_prof[key] for key in (
                "device_ms", "k1_ms", "k2_ms", "rest_ms", "rest_top_kernels", "top_operators")},
            "decode_step_ms": step_ms, "tokens": new, "encoder_vs_xla": mem_err,
            "logits_vs_xla_worst_row_rel": worst, "another_source_changed_tokens": changed,
            "another_source_first_step_row_rel": first_step_moved, "k1": {"check": checked,
                                                                          **times},
            "k2": k2_row, "peak_gib": peak}


def phase_hybrid_prefill(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 16d: one uncached forward of full-depth bf16 zamba2-2.7b at
    8192 tokens with ``attn_impl="flash"``: K2 9 launches (the shared
    block, causal, head dim 80) all wgmma, K1 181 all wide; logits finite
    and within ``PREFILL_LOGITS_TOL`` per row of the xla route; the
    forward's device time (CUDA events) and, under ``torch.profiler``, its
    split into K1, K2, the SSD chunk scan (a ``record_function`` range
    around ``mamba2._ssd_chunk_scan``) and the rest; every distinct K1 call
    against the plain version and timed; K2 at the shared block's shape
    against its plain version and SDPA."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = "family-zamba2-prefill"
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    s = HYBRID_PREFILL_S
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, s))).to(dev)
    want = {"K1": {"wide": k1_per_step(cfg)},
            "K2": {"wgmma": cfg.num_layers // cfg.shared_attn_every}}
    real_scan = mamba2_layer._ssd_chunk_scan

    def ranged_scan(*args, **kw):
        with record_function("ssd_chunk_scan"):
            return real_scan(*args, **kw)

    with torch.no_grad():
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        with k1_calls() as calls:
            logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = {"K1": _nonzero(k1.launches_by_route), "K2": _nonzero(k2.launches_by_route)}
        if got != want:
            raise AssertionError(f"[{tag}] the forward launched {got}, want {want}")
        if tuple(logits.shape) != (1, s, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[{tag}] logits malformed: {tuple(logits.shape)}")
        fwd_ms = event_ms(lambda: model.forward(params, tokens), 1, warm=False)
        xlogits, _ = xla.forward(params, tokens)
        e = row_err(logits, xlogits)
        del logits, xlogits
        torch.cuda.empty_cache()
        with mock.patch.object(mamba2_layer, "_ssd_chunk_scan", ranged_scan), \
                unembed_ranges(), profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.forward(params, tokens)
            torch.cuda.synchronize()
    split = profile_split(prof)
    ssd = split["ranges"].get("ssd_chunk_scan", {})
    ssd_ms = ssd.get("cpu", {}).get("ms", 0.0)
    log(f"[{tag}] {cfg.name} bf16 S={s} flash: K1 {got['K1']}, K2 {got['K2']}; first call "
        f"{first_s:.2f}s with set-up; forward {fwd_ms:.1f}ms between CUDA events "
        f"({s / (fwd_ms / 1e3):.0f} prefill tokens/s; the device busy "
        f"{split['device_ms'] / fwd_ms:.0%} of it, by the profile below); flash vs xla logits "
        f"worst row rel {e['row_rel']:.3e} (limit {PREFILL_LOGITS_TOL:g})")
    log(f"[{tag}] profiled: device {split['device_ms']:.1f}ms = K1 {split['k1_ms']:.1f}ms + K2 "
        f"{split['k2_ms']:.1f}ms + rest {split['rest_ms']:.1f}ms; of the rest, the SSD chunk "
        f"scan {ssd_ms:.1f}ms (its kernels; device span "
        f"{ssd.get('device', {}).get('ms', 0.0):.1f}ms, {ssd.get('cpu', {}).get('count', 0)} "
        f"calls); the unembedding {split['unembed_ms']:.1f}ms ({split['unembed_calls']} call, "
        f"K1), aten::mm x{split['mm_calls']}; top kernels: " + ", ".join(
            f"{k['kernel'][:50]} {k['ms']:.1f}ms x{k['launches']}"
            for k in split["rest_top_kernels"][:5]))
    if not e["finite"] or e["row_rel"] >= PREFILL_LOGITS_TOL:
        raise AssertionError(f"[{tag}] flash and xla routes disagree: {e}")
    if not ssd_ms > 0:
        raise AssertionError(f"[{tag}] the profile shows no SSD scan time: {ssd}")
    if not unembed_seen(split):
        raise AssertionError(f"[{tag}] the profiled forward ran aten::mm x{split['mm_calls']} "
                             f"or no unembedding through K1: {split['unembed_calls']} calls")
    checked = check_k1_calls(calls, dev)
    times = k1_step_times(calls, dev)
    log(f"[{tag}] K1's {checked['calls']} calls ({len(checked['distinct'])} distinct) within "
        f"ROW_TOL (worst row rel {checked['worst_row_rel']:.3e}); timed alone "
        f"{times['ms']:.1f}ms, bound {times['bound_ms']:.1f}ms ({times['bound_by']}), "
        f"torch.matmul {times['library_ms']:.1f}ms, plain {times['plain_ms']:.1f}ms")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params
    torch.cuda.empty_cache()
    k2_row = k2_case(dev, gen, "zamba2-shared", (1, s, s, cfg.num_heads, cfg.num_kv_heads,
                                                 cfg.head_dim, 0), True)
    return {"launches": got, "first_forward_s": first_s, "forward_ms": fwd_ms,
            "tokens_per_s": s / (fwd_ms / 1e3), "vs_xla": e,
            "profile": {key: split[key] for key in ("device_ms", "k1_ms", "k2_ms", "rest_ms",
                                                    "k1_launches", "rest_top_kernels",
                                                    "top_operators", "ranges")},
            "ssd_scan_ms": ssd_ms, "k1": {"check": checked, "forward": times}, "k2": k2_row,
            "peak_gib": peak}


def phase_families(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 16: (a) each new family one group deep, fp32, card vs CPU;
    (b) zamba2-2.7b and xlstm-350m at full depth behind ``Server``, run as
    phase 4 runs Llama and measured as phase 15 measures the zoo; (c)
    seamless-m4t-medium encoded and decoded; (d) the uncached zamba2
    forward at 8192 tokens.  Each model freed before the next."""
    out = {"check": {arch: family_check(dev, arch)
                     for arch in (*SERVED_FAMILIES, ENCDEC_ARCH)}}
    for arch in SERVED_FAMILIES:
        tag = f"family-{arch}"
        out[arch] = phase_serve(dev, arch, tag, measure=zoo_measure(dev, tag))
        torch.cuda.empty_cache()
    out[ENCDEC_ARCH] = phase_encdec(dev, gen)
    out["hybrid_prefill"] = phase_hybrid_prefill(dev, gen)
    return out


def family_launches(fam: dict) -> dict:
    """K1's launches on phase 16's paths, for the kernels line."""
    out = {}
    for arch in SERVED_FAMILIES:
        sv = fam[arch]
        out.update({f"family_{arch}_serve": sv["path"]["launches"],
                    f"family_{arch}_serve_graph_replays_per_generate": sv["runs"][0]["launches"],
                    f"family_{arch}_serve_eager_per_generate": sv["eager_runs"][0]["launches"]})
    for arch, c in fam["check"].items():
        out[f"family_{arch}_check_fp32"] = c["launches"]
    out["family_seamless_path"] = fam[ENCDEC_ARCH]["path"]["launches"]
    out["family_zamba2_prefill"] = sum(fam["hybrid_prefill"]["launches"]["K1"].values())
    return out


def family_routes(fam: dict) -> dict:
    """K1's launches by route on phase 16's paths, for the kernels line."""
    out = {}
    for arch in SERVED_FAMILIES:
        sv = fam[arch]
        out.update({f"family_{arch}_serve": sv["path"]["routes"],
                    f"family_{arch}_serve_graph_replays": sv["runs"][0]["routes"],
                    **{f"family_{arch}_serve_{step}_step": r
                       for step, r in sv["step_device_ms"]["routes"].items()}})
    out["family_seamless_path"] = fam[ENCDEC_ARCH]["path"]["routes"]
    out["family_zamba2_prefill"] = fam["hybrid_prefill"]["launches"]["K1"]
    return out


def family_k1_rows(fam: dict) -> dict:
    """K1's time beside its bound, the plain version's and the library's
    on phase 16's paths, for the kernels line's ``per_route``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    rows = {}
    for arch in SERVED_FAMILIES:
        m = fam[arch]["measured"]
        t = m["k1"]["decode_step"]
        rows[f"thin: {arch} decode step, M = 4 ({t['products']} products)"] = {
            **{key: t[key] for key in keys},
            "profiled_in_the_step_ms": m["profile"]["k1_ms"]}
    sm = fam[ENCDEC_ARCH]["k1"]
    rows[f"thin: {ENCDEC_ARCH} decode step, M = 4 ({sm['decode_step']['products']} products)"] = {
        key: sm["decode_step"][key] for key in keys}
    rows[f"wide: {ENCDEC_ARCH} encode + prefill_cross, M = 4096 "
         f"({sm['encode_and_cross']['products']} products)"] = {
        key: sm["encode_and_cross"][key] for key in keys}
    hp = fam["hybrid_prefill"]
    rows[f"wide: {HYBRID_ARCH} forward, M = {HYBRID_PREFILL_S} "
         f"({hp['k1']['forward']['products']} products)"] = {
        **{key: hp["k1"]["forward"][key] for key in keys},
        "profiled_in_the_forward_ms": hp["profile"]["k1_ms"]}
    return rows


# -- every family trained (phase 17) ----------------------------------------------------

# (a): full width, reduced depth, fp32, card vs CPU: zamba2's first group (6
# Mamba layers and the shared block), xLSTM's mmm-s, deepseek's dense layer
# and one MoE layer of all 64 experts, 2 MLA layers, 1 encoder + 1 decoder layer
ZOO_TRAIN_CHECK_DEPTH = {"zamba2-2.7b": {"num_layers": 6}, "xlstm-350m": {"num_layers": 4},
                         "deepseek-moe-16b": {"num_layers": 2}, "minicpm3-4b": {"num_layers": 2},
                         ENCDEC_ARCH: {"num_layers": 2, "enc_layers": 1, "dec_layers": 1}}
# (b): the remat policies side by side on zamba2's first two groups, bf16
REMAT_LAYERS, REMAT_BATCH, REMAT_SEQ = 12, 2, 512
# (c, d): the launcher at full width and depth; (e): deepseek-moe-16b cut to
# its dense layer and 3 MoE layers (the whole model's AdamW state, ~260 GB,
# does not fit one card), driven through Trainer
# (batch, seq, steps): 10 steps each keeps the whole script within 900 s
# (repeats cut, not widths, depths or checks)
ZOO_TRAIN_RUNS = {"zamba2-2.7b": (2, 512, 10), "xlstm-350m": (8, 256, 10)}
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_RUN = "deepseek-moe-16b", 4, (4, 256, 10)
# each leg runs captured for its steps (the main path), then eager for the
# first ZOO_EAGER_STEPS of them (the same state, batches and learning rates:
# the launcher's warmup is 5 steps for both), measured (the medians of the
# 3 steps that are neither the first nor the profiled one) and profiled
ZOO_EAGER_STEPS = 5


def k1_train_times(calls: list, dev: torch.device) -> dict:
    """K1 on one training step's calls (``k1_calls``: forward, dA, dB):
    each distinct call held against its plain version per row
    (``ROW_TOL``) on seeded operands, and K1, ``torch.matmul`` (the
    yardstick, never called by the port) and the plain version timed in
    turns by CUDA-graph replays (phase 14a's way), times its count; and the
    bound of those calls."""
    gen = torch.Generator(device=dev).manual_seed(8)
    tot = {"ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    t_bytes = t_ops = worst = worst_abs = 0.0
    for (m, n, k, blocks, order, dt, out_dtype, a_t, b_t), count in sorted(
            Counter(calls).items(), key=str):
        a = _stored_operand(gen, dev, m, k, a_t, dtype=dt)
        b = _stored_operand(gen, dev, k, n, b_t, 1 / math.sqrt(k), dtype=dt)

        def kernel(x, y, blocks=blocks, order=order, out_dtype=out_dtype):
            return matmul(x, y, block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
                          order=order, out_dtype=out_dtype)

        def plain(x, y, out_dtype=out_dtype):
            return matmul_ref(x, y, out_dtype)
        e = row_err(kernel(a, b), plain(a, b))
        if not e["finite"] or not e["row_rel"] < min(ROW_TOL[dt], ROW_TOL[out_dtype]):
            raise AssertionError(f"K1 at {m}x{n}x{k} {dt} -> {out_dtype} disagrees with its "
                                 f"plain version: {e}")
        worst, worst_abs = max(worst, e["row_rel"]), max(worst_abs, e["max_abs_err"])
        fns = {"ms": kernel, "library_ms": _library_mm(out_dtype, dt) or _upcast_mm,
               "plain_ms": plain}
        t = {}
        for name in ("ms", "library_ms", "plain_ms", "ms"):
            t.setdefault(name, []).append(graph_ms(fns[name], [(a, b)] * TRAIN_GRAPH_CALLS))
        for name, v in t.items():
            tot[name] += count * min(v)
        tot["bound_ms"] += count * bound(m, k, n, dt, out_dtype)[0]
        esize = dt.itemsize
        t_bytes += count * ((m * k + k * n) * esize + m * n * out_dtype.itemsize) / PEAK_BYTES_S
        t_ops += count * 2.0 * m * k * n / PEAK_FLOPS[dt]
        del a, b
    tot.update(bound_by="bytes" if t_bytes >= t_ops else "operations", products=len(calls),
               distinct=len(set(calls)), tflop=t_ops * PEAK_FLOPS[torch.bfloat16] / 1e12,
               worst_row_rel=worst, worst_abs_err=worst_abs)
    return tot


def remat_compare(dev: torch.device) -> dict:
    """(b) One bf16 step of full-width zamba2 at ``REMAT_LAYERS`` layers
    under each remat policy, the same masters and batch: K1 launches
    ("dots" as many as "none", 3 x the forward's products; "full" also the
    Mamba layers' forward products again), every gradient of "dots" within
    ``ROW_TOL[bf16]`` relative L2 of "none"'s, and each step's peak memory
    above what was allocated before it ("dots" below "none")."""
    tag = "zoo-train-remat"
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), num_layers=REMAT_LAYERS)
    master = tree_map(lambda t: t.float(), build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(4), dev))
    batch = _train_batch(cfg.vocab_size, REMAT_BATCH, REMAT_SEQ, dev)
    step = train_step_launches(cfg)
    want = {"none": step, "dots": step, "full": step + 2 * cfg.num_layers}
    out, ref = {}, None
    for mode in ("none", "full", "dots"):
        trainer = Trainer(build_model(dataclasses.replace(cfg, remat=mode)), TrainConfig(),
                          device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        k1.reset_launches()
        t0 = time.perf_counter()
        loss, _, grads = trainer.loss_and_grads(master, batch)
        torch.cuda.synchronize()
        row = {"loss": loss.item(), "seconds": time.perf_counter() - t0,
               "routes": _nonzero(k1.launches_by_route),
               "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30}
        if mode == "none":
            ref = grads
        elif mode == "dots":
            errs = [((g.double() - r.double()).norm() / r.double().norm().clamp_min(1e-300)).item()
                    for g, r in zip(grads, ref)]
            row["worst_grad_rel_vs_none"] = max(errs)
        out[mode] = row
        del grads
        log(f"[{tag}] {cfg.name} {REMAT_LAYERS} layers, bf16, {REMAT_BATCH}x{REMAT_SEQ}, "
            f"remat={mode!r}: loss {row['loss']:.4f}, K1 {row['routes']} (want {want[mode]}), "
            f"peak {row['peak_gib']:.2f} GiB above the masters, {row['seconds']:.2f}s"
            + (f"; worst gradient rel L2 vs 'none' {row['worst_grad_rel_vs_none']:.3e} "
               f"(limit {ROW_TOL[torch.bfloat16]:g})" if mode == "dots" else ""))
    del ref, master
    torch.cuda.empty_cache()
    bad = {m: r["routes"] for m, r in out.items() if sum(r["routes"].values()) != want[m]}
    if bad or out["dots"]["worst_grad_rel_vs_none"] >= ROW_TOL[torch.bfloat16]:
        raise AssertionError(f"[{tag}] K1 launches {bad} (want {want}), or 'dots' gradients "
                             f"{out['dots']['worst_grad_rel_vs_none']} off 'none'")
    if not out["dots"]["peak_gib"] < out["none"]["peak_gib"]:
        raise AssertionError(f"[{tag}] 'dots' peaks at {out['dots']['peak_gib']:.2f} GiB, "
                             f"not below 'none' ({out['none']['peak_gib']:.2f})")
    log(f"[{tag}] took {time.perf_counter() - t_start:.1f}s")
    return out


@contextlib.contextmanager
def metered_steps(profile_at: int, host_side: bool):
    """Within the scope, each step of the trainer's loop (``Trainer.fit``,
    the launcher's too) is timed: CUDA events around the loss and
    gradients and around the optimizer, the host clock around the whole
    step (ended by the sync ``fit`` makes after it anyway); step number
    ``profile_at`` (from 0) runs under ``_profiled_step(host_side)`` with its K1 calls
    recorded (``k1_calls``).  Yields {"rows": [...], "profile": {...},
    "calls": [...]}, filled as the steps run."""
    meter = {"rows": [], "profile": {}, "calls": []}

    def make_train_step(self):
        def train_step(state, batch):
            i = len(meter["rows"])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            scope = contextlib.ExitStack()
            if i == profile_at:
                meter["profile"] = scope.enter_context(_profiled_step(host_side))
                meter["calls"] = scope.enter_context(k1_calls())
            with scope:
                t0 = time.perf_counter()
                ev[0].record()
                lr = self.sched(state["step"])
                loss, metrics, grads = self.loss_and_grads(state["master"], batch)
                ev[1].record()
                state, opt_metrics = adamw.step(state, grads, lr, self.opt_cfg)
                ev[2].record()
                torch.cuda.synchronize()
            meter["rows"].append((time.perf_counter() - t0, ev))
            return state, {"loss": loss, **metrics, **opt_metrics}
        return train_step

    with mock.patch.object(Trainer, "make_train_step", make_train_step):
        yield meter


def _zoo_run(dev: torch.device, cfg, run: tuple, launcher: bool, capture: bool,
             steps: int) -> dict:
    """One run of a zoo leg: ``launch.train.main`` (``--eager`` unless
    ``capture``) or ``Trainer.fit`` with the launcher's schedule; its logged
    losses, K1's launches counted on the host from 0 just before, the peak
    memory, its steps (``step_meter``) and its trainer's ``graph_report()``."""
    batch, seq, _ = run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k1.reset_launches()
    t0 = time.perf_counter()
    with step_meter() as meter:
        if launcher:
            buf = io.StringIO()
            with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
                rc = launch_train.main(["--arch", cfg.name, "--steps", str(steps), "--batch",
                                        str(batch), "--seq", str(seq)]
                                       + ([] if capture else ["--eager"]))
            logged = [m.groups() for m in map(TRAIN_LOG.match, buf.getvalue().splitlines()) if m]
            losses = [float(x) for _, x, _ in logged]
        else:
            fit = Trainer(build_model(cfg), TrainConfig(steps=steps, warmup=max(steps // 20, 5),
                                                        log_every=1),
                          device=dev, capture=capture).fit(
                torch.Generator(device=dev).manual_seed(0), batch_iterator(
                    DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)))
            rc, losses = 0, [h["loss"] for h in fit["history"]]
            del fit
    graph = meter["trainers"][0].graph_report()
    del meter["trainers"]
    return {"rc": rc, "losses": losses, "wall_s": time.perf_counter() - t0,
            "routes": _nonzero(k1.launches_by_route),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "steps": step_summary(meter["rows"]), "graph": graph}


def zoo_train_leg(dev: torch.device, tag: str, cfg, run: tuple, launcher: bool) -> dict:
    """(c, d) ``launch.train.main(["--arch", ..., "--steps", ..., "--batch",
    ..., "--seq", ...])`` at full width and depth (``launcher``), or (e)
    ``Trainer.fit`` on ``cfg`` with the launcher's schedule, bf16, the
    config's remat policy; the main path captured: every logged loss finite
    and the last below the first, K1 3 x the forward's products a step but
    the unembedding's dA and dB (``train_step_launches``), all wide, counted
    on the host for the eager first step and the capture (counts from 0
    just before) and by ``graph_report()`` for each replay; a replay's host
    and device ms, the capture's seconds, the peak memory.  Then the first
    ``ZOO_EAGER_STEPS`` steps eager (``--eager``): each step's loss within
    ``TRAIN_GRAD_TOL`` of the captured run's and its learning rate bitwise,
    K1 ``train_step_launches`` a step, and its steps measured
    (``metered_steps``): the medians over the steps after the first, the
    profiled one left out, of the host step time, tokens/s and the
    CUDA-event split (loss and gradients, optimizer); the next-to-last step
    profiled (K1 and the rest by kernel; for zamba2 also the unembed, the
    SSD scan's forward and the operators), and its K1 calls held against
    the plain version and timed beside ``torch.matmul`` and their bound."""
    batch, seq, steps = run
    t0 = time.perf_counter()
    per_step = train_step_launches(cfg)
    cap = _zoo_run(dev, cfg, run, launcher, True, steps)
    want = {"wide": 2 * per_step}
    losses, cs, graph = cap["losses"], cap["steps"], cap["graph"]
    log(f"[{tag}] {'launcher' if launcher else 'Trainer.fit'}, captured: {cfg.name} "
        f"({cfg.num_layers} layers, remat={cfg.remat!r}), {batch}x{seq} tokens, rc {cap['rc']}, "
        f"{len(losses)} steps in {cap['wall_s']:.1f}s, loss {losses[0] if losses else None} -> "
        f"{losses[-1] if losses else None}; K1 counted {cap['routes']} (want {want}: the eager "
        f"first step and the capture, {per_step} each), replayed {graph['k1_replayed']}; first "
        f"step {cs['first_step_ms']:.0f}ms, the capturing step {cs['capture_step_ms']:.0f}ms "
        f"(capture {graph['capture_s']:.2f}s), a replay {cs['host_ms']:.1f}ms host / "
        f"{cs['device_ms']:.1f}ms device (median of {cs['steps_timed']}), "
        f"{batch * seq / cs['host_ms'] * 1e3:.0f} tokens/s; peak memory {cap['peak_gib']:.2f} GiB")
    if cap["rc"] != 0 or len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{tag}] the run: rc {cap['rc']}, losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    if cap["routes"] != want:
        raise AssertionError(f"[{tag}] K1 launched {cap['routes']}, want {want}")
    check_graph(tag, graph, {"wide": per_step}, steps - 1)

    # the eager run: the host side of the trace where the SSD scan's range is
    # read: xLSTM's step alone is ~2 x 10^5 operators (its sLSTM steps through time)
    with metered_steps(ZOO_EAGER_STEPS - 2, host_side=cfg.family == "hybrid") as meter:
        eag = _zoo_run(dev, cfg, run, launcher, False, ZOO_EAGER_STEPS)
    want_eager = {"wide": per_step * ZOO_EAGER_STEPS}
    if eag["rc"] != 0 or len(eag["losses"]) != ZOO_EAGER_STEPS \
            or not all(map(math.isfinite, eag["losses"])) or eag["routes"] != want_eager:
        raise AssertionError(f"[{tag}] the eager run: rc {eag['rc']}, losses {eag['losses']}, "
                             f"K1 {eag['routes']} (want {want_eager})")
    held = held_to_eager(tag, cs, eag["steps"], TRAIN_GRAD_TOL)
    calls, prof = meter["calls"], meter["profile"]
    if len(calls) != per_step:
        raise AssertionError(f"[{tag}] the profiled step called K1 {len(calls)} times, "
                             f"want {per_step}")
    if cfg.family == "hybrid":   # the one leg profiled from the host side too
        check_unembed_profile(tag, prof)
    steady = [(host, ev) for i, (host, ev) in enumerate(meter["rows"])
              if i and i != ZOO_EAGER_STEPS - 2]
    times = {"host_ms": float(np.median([h * 1e3 for h, _ in steady])),
             "device_ms": float(np.median([ev[0].elapsed_time(ev[2]) for _, ev in steady])),
             "grads_ms": float(np.median([ev[0].elapsed_time(ev[1]) for _, ev in steady])),
             "optimizer_ms": float(np.median([ev[1].elapsed_time(ev[2]) for _, ev in steady])),
             "first_step_ms": meter["rows"][0][0] * 1e3}
    times["tokens_per_s"] = batch * seq / times["host_ms"] * 1e3
    times["busy_share"] = prof["device_ms"] / times["device_ms"]
    gc.collect()
    torch.cuda.empty_cache()
    k1t = k1_train_times(calls, dev)
    log(f"[{tag}] eager, its steps at {batch}x{seq} (medians of {len(steady)}): host "
        f"{times['host_ms']:.1f}ms, device {times['device_ms']:.1f}ms (loss and gradients "
        f"{times['grads_ms']:.1f}, optimizer {times['optimizer_ms']:.1f}), "
        f"{times['tokens_per_s']:.0f} tokens/s, the first {times['first_step_ms']:.0f}ms; peak "
        f"memory {eag['peak_gib']:.2f} GiB; step {ZOO_EAGER_STEPS - 1} profiled: device "
        f"{prof['device_ms']:.1f}ms (busy {times['busy_share']:.0%}), "
        f"K1 {prof['k1_ms']:.1f}ms ({prof['k1_launches']} launches), the SSD scan's forward "
        f"{prof['ssd_scan_forward_ms']:.1f}ms ({prof['ssd_scan_calls']} calls), the "
        f"unembedding's forward (K1) {prof['unembed_ms']:.1f}ms, its backward's fp32 aten::mm "
        f"x{prof['mm_calls']} {prof['mm_ms']:.1f}ms; top operators " + ", ".join(
            f"{r['op']} {r['ms']:.1f}ms" for r in prof["top_operators"][:6])
        + "; top kernels besides K1 " + ", ".join(
            f"{k['kernel'][:50]} {k['ms']:.1f}ms x{k['launches']}"
            for k in prof["rest_top_kernels"][:4]))
    log(f"[{tag}] K1's {k1t['products']} calls of that step ({k1t['distinct']} distinct, each "
        f"within ROW_TOL, worst row rel {k1t['worst_row_rel']:.3e}) timed alone: "
        f"{k1t['ms']:.2f}ms, bound {k1t['bound_ms']:.2f}ms ({k1t['bound_by']}, "
        f"{k1t['tflop']:.2f} TFLOP), torch.matmul {k1t['library_ms']:.2f}ms, plain "
        f"{k1t['plain_ms']:.2f}ms; the leg took {time.perf_counter() - t0:.1f}s")
    return {"launches": sum(cap["routes"].values()), "routes": cap["routes"], "losses": losses,
            "graph": graph, "captured": {**cs, "peak_gib": cap["peak_gib"],
                                         "wall_s": cap["wall_s"]},
            "eager": {"routes": eag["routes"], "launches": sum(eag["routes"].values()),
                      "losses": eag["losses"], "peak_gib": eag["peak_gib"],
                      "host_ms_per_step": [h * 1e3 for h, _ in meter["rows"]],
                      "wall_s": eag["wall_s"]},
            "held_to_eager": held, "seconds": time.perf_counter() - t0,
            "peak_gib": cap["peak_gib"], "timing": {**times, "profile": prof}, "k1": k1t,
            "layers": cfg.num_layers, "batch": batch, "seq": seq}


def phase_zoo_train(dev: torch.device) -> dict:
    """Phase 17: (a) five families' fp32 gradients card vs CPU; (b) the
    remat policies side by side; (c) zamba2-2.7b and (d) xlstm-350m trained
    through the launcher at full width and depth; (e) deepseek-moe-16b at 4
    layers through ``Trainer``.  Each model freed before the next."""
    t0 = time.perf_counter()
    out = {"check": {arch: train_grad_check(dev, arch, depth, f"zoo-train-check-{arch}")
                     for arch, depth in ZOO_TRAIN_CHECK_DEPTH.items()}}
    out["remat"] = remat_compare(dev)
    for arch, run in ZOO_TRAIN_RUNS.items():
        out[arch] = zoo_train_leg(dev, f"zoo-train-{arch}", get_config(arch), run, True)
    moe_cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), num_layers=MOE_TRAIN_LAYERS)
    out[MOE_TRAIN_ARCH] = zoo_train_leg(dev, f"zoo-train-{MOE_TRAIN_ARCH}", moe_cfg,
                                        MOE_TRAIN_RUN, False)
    out[MOE_TRAIN_ARCH]["reduced"] = (f"num_layers {get_config(MOE_TRAIN_ARCH).num_layers} -> "
                                      f"{MOE_TRAIN_LAYERS}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[zoo-train] phase 17 took {out['seconds']:.1f}s")
    return out


def zoo_train_launches(zt: dict) -> dict:
    """K1's launches on phase 17's paths, for the kernels line: each main
    path's counted on the host (the eager first step and the capture), its
    graph's replays, and the eager run's."""
    legs = (*ZOO_TRAIN_RUNS, MOE_TRAIN_ARCH)
    return {**{f"zoo_train_{arch}": zt[arch]["launches"] for arch in legs},
            **{f"zoo_train_{arch}_graph_replays": sum(zt[arch]["graph"]["k1_replayed"].values())
               for arch in legs},
            **{f"zoo_train_{arch}_eager": zt[arch]["eager"]["launches"] for arch in legs},
            **{f"zoo_train_check_{arch}_fp32": sum(c["launches"].values())
               for arch, c in zt["check"].items()},
            **{f"zoo_train_remat_{mode}_step": sum(r["routes"].values())
               for mode, r in zt["remat"].items()}}


def zoo_train_routes(zt: dict) -> dict:
    """K1's launches by route on phase 17's paths, for the kernels line."""
    legs = (*ZOO_TRAIN_RUNS, MOE_TRAIN_ARCH)
    return {**{f"zoo_train_{arch}": zt[arch]["routes"] for arch in legs},
            **{f"zoo_train_{arch}_graph_replays": zt[arch]["graph"]["k1_replayed"]
               for arch in legs},
            **{f"zoo_train_{arch}_eager": zt[arch]["eager"]["routes"] for arch in legs},
            **{f"zoo_train_check_{arch}_fp32": c["launches"] for arch, c in zt["check"].items()},
            **{f"zoo_train_remat_{mode}_step": r["routes"] for mode, r in zt["remat"].items()}}


def zoo_train_rows(zt: dict) -> dict:
    """K1's time beside its bound, the plain version's and the library's
    on phase 17's training steps, for the kernels line's ``per_route``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {f"wide: {arch} training step, {zt[arch]['batch']}x{zt[arch]['seq']} tokens, "
            f"{zt[arch]['layers']} layers ({zt[arch]['k1']['products']} products: forward, dA, "
            f"dB)": {**{key: zt[arch]["k1"][key] for key in keys},
                     "profiled_in_the_step_ms": zt[arch]["timing"]["profile"]["k1_ms"]}
            for arch in (*ZOO_TRAIN_RUNS, MOE_TRAIN_ARCH)}


# -- sharded training (phase 18) ---------------------------------------------------

# (a) fp32 gradients on the 2x2 rank-thread mesh against mesh=None, both on
# the card: Llama-3.2-1B at full width and 2 of its 16 layers, 2 x 64
# tokens.  Both sides fp32 through K1's fma route, sums in other orders (the
# planned products split the contraction): a sound port reads ~1e-6 per
# leaf; a product whose dB is dropped reads 1.
SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_CHECK_LAYERS, SHARD_CHECK_BATCH, SHARD_CHECK_SEQ = 2, 2, 64
SHARD_GRAD_TOL = 1e-4
# (b) the launcher on the mesh: full width and depth, bf16, 8 x 256 tokens
# a step, and the same steps without a mesh from the same seed.  bf16
# products rounded in other orders move a step's loss by ~1e-3; the gap
# allowed is 2e-2 absolute at every step (captured against eager too).
SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 8, 256, 2
SHARD_LOSS_GAP = 2e-2
SHARD_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(SHARD_STEPS), "--batch", str(SHARD_BATCH),
              "--seq", str(SHARD_SEQ)]
# the main path runs captured for 3 steps (the eager first step, the
# capture and a replay, then a replay), beside 2 eager steps on the mesh and
# 3 captured ones with mesh=None: the launcher's 5 warmup steps give all
# three runs the same learning rates
SHARD_CAPTURED_STEPS = 3
SHARD_CAPTURED_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(SHARD_CAPTURED_STEPS), "--batch",
                       str(SHARD_BATCH), "--seq", str(SHARD_SEQ)]
SHARD_MESH_ARGV = ["--tp", "2", "--ranks", "4"]
# (c) elastic: 2 full-width layers, (pod 2, data 1, model 2) -> (data 1, model 2)
ELASTIC_MESH = ((2, 1, 2), ("pod", "data", "model"))
ELASTIC_LAYERS, ELASTIC_BATCH, ELASTIC_SEQ = 2, 4, 128
# (d) compressed_psum: 4 ranks, each with the gradients of its own batch of
# (a)'s model; 8 rounds with error feedback.  The reference's
# test_error_feedback_unbiased holds one stream's drift to 1e-4 at a
# gradient scale of 0.1: here the bound is scaled to each leaf's scale.
COMPRESS_RANKS, COMPRESS_ROUNDS = 4, 8
EF_BOUND, EF_SCALE = 1e-4, 0.1


def _rel_l2(g: torch.Tensor, want: torch.Tensor) -> float:
    return ((g.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300)).item()


def _grad_rels(got: list, want: list, keys: list) -> dict:
    return {k: _rel_l2(g, w) for k, g, w in zip(keys, got, want)}


def sharded_grad_check(dev: torch.device) -> dict:
    """(a) The loss and every master leaf's gradient of one fp32 step on
    the 2x2 mesh (``planned_matmuls``: every product and both gradients
    planned) against ``mesh=None`` on the card, worst leaf within
    ``SHARD_GRAD_TOL``, 3 x 14 planned products; a control whose planned
    backward drops one product's dB must land outside the limit."""
    tag = "shard-check"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              num_layers=SHARD_CHECK_LAYERS)
    model = build_model(cfg)
    master = tree_map(lambda t: t.float(),
                      model.init(torch.Generator(device=dev).manual_seed(3), dev))
    batch = _train_batch(cfg.vocab_size, SHARD_CHECK_BATCH, SHARD_CHECK_SEQ, dev)
    keys = ["//".join(map(str, p)) for p, _ in tree_paths(master)]
    mesh = Mesh(*SHARD_MESH, device=dev)
    plain = Trainer(model, TrainConfig(), device=dev)
    sharded = Trainer(model, TrainConfig(), mesh=mesh)
    loss0, _, want = plain.loss_and_grads(master, batch)

    def planned():
        with sharding.use_mesh(mesh), planned_matmuls(mesh):
            return sharded.loss_and_grads(master, batch)

    k1.reset_launches()
    lower_dist_mod.reset_executions()
    loss1, _, got = planned()
    torch.cuda.synchronize()
    routes, execs = _nonzero(k1.launches_by_route), lower_dist_mod.executions_snapshot()
    errs = _grad_rels(got, want, keys)
    worst = max(errs, key=errs.get)
    loss_rel = abs(loss1.item() - loss0.item()) / abs(loss0.item())
    del got
    dist_api = importlib.import_module("repro_torch.dist.api")
    real_backward = dist_api._PlannedMatmul.backward
    dropped = []

    def zero_first_db(ctx, dc):      # the first product the backward reaches
        da, db, rest = real_backward(ctx, dc)
        if not dropped and db is not None:
            dropped.append(tuple(db.shape))
            db = torch.zeros_like(db)
        return da, db, rest

    with mock.patch.object(dist_api._PlannedMatmul, "backward", staticmethod(zero_first_db)):
        _, _, ctrl = planned()
    ctrl_errs = _grad_rels(ctrl, want, keys)
    caught = max(ctrl_errs.values())
    products = 3 * layer_products(cfg, cached=False)
    log(f"[{tag}] {cfg.name} full width, {SHARD_CHECK_LAYERS} layers, fp32, "
        f"{SHARD_CHECK_BATCH}x{SHARD_CHECK_SEQ} tokens on {dict(mesh.shape)} vs mesh=None: loss "
        f"rel {loss_rel:.2e}, worst gradient rel L2 {errs[worst]:.3e} ({worst}) of {len(errs)} "
        f"leaves, limit {SHARD_GRAD_TOL:g}; planned {execs} (want {products}); K1 {routes}; "
        f"control, dB of the product {dropped} dropped: worst {caught:.3e} (must be >= "
        f"{SHARD_GRAD_TOL:g}); {time.perf_counter() - t0:.1f}s")
    if errs[worst] >= SHARD_GRAD_TOL or loss_rel >= SHARD_GRAD_TOL \
            or sum(execs.values()) != products or set(routes) != {"fma"}:
        raise AssertionError(f"[{tag}] the planned step disagrees: worst {worst} {errs[worst]}, "
                             f"loss {loss_rel}, planned {execs}, K1 {routes}")
    if caught < SHARD_GRAD_TOL or len(dropped) != 1:
        raise AssertionError(f"[{tag}] a dropped dB passed: worst {caught}, dropped {dropped}")
    mesh.close()
    del master, want, ctrl
    torch.cuda.empty_cache()
    return {"loss": {"mesh": loss1.item(), "none": loss0.item()}, "grad_rel_l2": errs,
            "worst": [worst, errs[worst]], "planned": execs, "routes": routes,
            "control_worst": caught, "control_dropped_db": dropped,
            "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def sharded_meter():
    """Within the scope: each planned product counted by side (forward, or
    inside a planned backward, which autograd runs on its device thread on
    the card: its threads' names kept) and strategy; each K1 call recorded (``k1_calls``' tuple) and counted by
    whether a rank thread made it; the trainer ``fit`` returned kept."""
    plan_pkg = importlib.import_module("repro_torch.plan")
    ops = importlib.import_module("repro_torch.kernels.matmul.ops")
    dist_api = importlib.import_module("repro_torch.dist.api")
    real_exec, real_run, real_fit = plan_pkg.execute_plan, ops._run, Trainer.fit
    real_backward = dist_api._PlannedMatmul.backward
    meter = {"planned": Counter(), "calls": [], "outside_ranks": 0, "fit": None,
             "backward_threads": set()}
    inside = threading.local()

    def marked_backward(ctx, dc):
        meter["backward_threads"].add(threading.current_thread().name)
        inside.backward = True
        try:
            return real_backward(ctx, dc)
        finally:
            inside.backward = False

    def counted_exec(plan, a, b):
        side = "backward" if getattr(inside, "backward", False) else "forward"
        meter["planned"][side, f"{plan.strategy}{'+ov' if plan.overlap else ''}"] += 1
        return real_exec(plan, a, b)

    def recorded_run(a, b, blocks, order, out_dtype):
        if not threading.current_thread().name.startswith("mesh-rank"):
            meter["outside_ranks"] += 1
        meter["calls"].append((a.shape[0], b.shape[1], a.shape[1], tuple(blocks), order,
                               a.dtype, out_dtype, ops.layout(a), ops.layout(b)))
        return real_run(a, b, blocks, order, out_dtype)

    def kept_fit(self, *args, **kw):
        out = real_fit(self, *args, **kw)
        meter["fit"] = out
        return out

    with mock.patch.object(plan_pkg, "execute_plan", counted_exec), \
            mock.patch.object(dist_api._PlannedMatmul, "backward",
                              staticmethod(marked_backward)), \
            mock.patch.object(ops, "_run", recorded_run), \
            mock.patch.object(Trainer, "fit", kept_fit):
        yield meter


ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


@contextlib.contextmanager
def _run_conditions(dev: torch.device):
    """Within the scope: the host time each step spends in
    ``Trainer.loss_and_grads`` and in ``adamw.step`` (no sync added), the
    caching allocator's retries and device allocations, the threads alive,
    and the card's SM clock and power draw sampled each second by
    ``nvidia-smi`` in a thread of its own."""
    real_lg, real_step = Trainer.loss_and_grads, adamw.step
    out = {"loss_and_grads_ms": [], "adamw_ms": [], "threads": threading.active_count(),
           "reserved_gib_before": torch.cuda.memory_reserved(dev) / 2 ** 30, "smi": []}

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                out[key].append((time.perf_counter() - t0) * 1e3)
        return run

    done = threading.Event()

    def sample():
        while not done.wait(1.0):
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=30)
            if r.returncode == 0 and r.stdout.strip():
                out["smi"].append([float(v) for v in r.stdout.split(",")[:2]])

    before = torch.cuda.memory_stats(dev)
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        with mock.patch.object(Trainer, "loss_and_grads", timed(real_lg, "loss_and_grads_ms")), \
                mock.patch.object(adamw, "step", timed(real_step, "adamw_ms")):
            yield out
    finally:
        done.set()
        sampler.join(60)
    after = torch.cuda.memory_stats(dev)
    out.update({k: after.get(k, 0) - before.get(k, 0) for k in ALLOC_STATS})
    clocks = [c for c, _ in out["smi"]]
    out["sm_clock_mhz_median"] = float(np.median(clocks)) if clocks else None
    out["power_w_median"] = float(np.median([w for _, w in out["smi"]])) if clocks else None


def _launcher_run(argv: list, dev: torch.device) -> dict:
    """``launch.train.main(argv)``: its logged losses and step times, K1's
    launches by route (counted from 0 just before), the peak memory, the
    run's conditions (``_run_conditions``), its steps (``step_meter``) and
    its trainer's ``graph_report()``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k1.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(buf, sys.stdout)), _run_conditions(dev) as cond, \
            step_meter() as meter:
        rc = launch_train.main(argv)
    wall = time.perf_counter() - t0
    graph = meter["trainers"][0].graph_report()
    del meter["trainers"]
    logged = [m.groups() for m in map(TRAIN_LOG.match, buf.getvalue().splitlines()) if m]
    return {"rc": rc, "losses": [float(x) for _, x, _ in logged],
            "host_ms": [int(ms) for _, _, ms in logged], "wall_s": wall,
            "routes": _nonzero(k1.launches_by_route), "launches": k1.launches,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30, "conditions": cond,
            "steps": step_summary(meter["rows"]), "graph": graph}


def _conditions_line(c: dict) -> str:
    return (f"host ms in loss_and_grads {[round(x) for x in c['loss_and_grads_ms']]}, in "
            f"adamw.step {[round(x) for x in c['adamw_ms']]}; allocator retries "
            f"{c['num_alloc_retries']}, device allocs / frees {c['num_device_alloc']} / "
            f"{c['num_device_free']}, reserved before {c['reserved_gib_before']:.2f} GiB; "
            f"{c['threads']} threads alive; SM clock {c['sm_clock_mhz_median']} MHz, power "
            f"{c['power_w_median']} W (medians of {len(c['smi'])} samples)")


def _state_bytes(state, mesh) -> dict:
    """Each rank's bytes of the placed state, the distinct blocks' in all,
    and what ``param_shardings`` predicts per rank (master, m, v in fp32
    and the int32 step)."""
    shardings = param_shardings(state["master"], mesh)
    held = {r: sum(x[r].numel() * x[r].element_size() for x in tree_leaves(state))
            for r in mesh.local_ranks()}
    def block_numel(shape, spec, r):
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return math.prod(len(range(*s.indices(n)))
                         for s, n in zip(block_slices(shape, spec, mesh, r), shape))

    predicted = {r: 3 * 4 * sum(block_numel(x.shape, ns.spec, r)
                                for x, ns in zip(tree_leaves(state["master"]),
                                                 tree_leaves(shardings))) + 4
                 for r in mesh.local_ranks()}
    distinct = sum(b.numel() * b.element_size() for x in tree_leaves(state) for b in x.distinct())
    full = sum(4 * math.prod(x.shape) for x in tree_leaves(state))
    return {"per_rank": held, "predicted_per_rank": predicted, "distinct": distinct,
            "unplaced": full}


def sharded_main_path(dev: torch.device) -> dict:
    """(b) The launcher on the 2x2 mesh (``--tp 2 --ranks 4``), full-width
    Llama-3.2-1B, 8 x 256 tokens a step, bf16, fp32 masters: captured, 3
    steps (the main path); then 2 steps eager on the mesh (``--eager``), and
    3 captured without a mesh, from the same seed (module docstring)."""
    tag = "shard-train"
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    # every product but the unembedding's, which runs K1 outside the rank
    # threads once a step (its bf16 backward none)
    layers = layer_products(cfg, cached=False)
    want_planned = {"forward": layers, "backward": 2 * layers}
    lower_dist_mod.reset_executions()
    with sharded_meter() as cmeter:
        run = _launcher_run(SHARD_CAPTURED_ARGV + SHARD_MESH_ARGV, dev)
        state = cmeter["fit"]["state"]
        mesh = tree_leaves(state)[0].sharding.mesh
        nbytes = _state_bytes(state, mesh)
        del state, cmeter["fit"]
    # counted on the host: the eager first step and the capture
    planned_host = {side: sum(n for (sd, _), n in cmeter["planned"].items() if sd == side)
                    for side in ("forward", "backward")}
    graph, cs = run["graph"], run["steps"]
    products = dict(Counter(s for (_, s), n in cmeter["planned"].items() for _ in range(n // 2)))
    lower_dist_mod.reset_executions()
    with sharded_meter() as meter:
        eager = _launcher_run(SHARD_ARGV + SHARD_MESH_ARGV + ["--eager"], dev)
        del meter["fit"]
    gc.collect()
    torch.cuda.empty_cache()
    plain = _launcher_run(SHARD_CAPTURED_ARGV, dev)
    per_step = {side: {s: n // SHARD_STEPS for (sd, s), n in sorted(meter["planned"].items())
                       if sd == side} for side in ("forward", "backward")}
    planned = {side: sum(v.values()) for side, v in per_step.items()}
    gaps = [abs(a - b) for a, b in zip(run["losses"], plain["losses"])]
    calls = meter["calls"]
    one_step = [c for c, n in Counter(calls).items() for _ in range(n // SHARD_STEPS)]
    routes_step = {r: n // SHARD_STEPS for r, n in eager["routes"].items()}
    es = eager["steps"]
    log(f"[{tag}] launcher on {dict(mesh.shape)} (rank threads on the card), captured: rc "
        f"{run['rc']}, losses {run['losses']}; mesh=None (captured) {plain['losses']}; gaps "
        f"{[round(g, 5) for g in gaps]} (limit {SHARD_LOSS_GAP:g}); planned counted on the host "
        f"{planned_host} (the eager first step and the capture: want twice {want_planned}), a "
        f"replay's {graph['products_per_replay']}, replayed {graph['products_replayed']}; K1 "
        f"counted {run['routes']}, replayed {graph['k1_replayed']} ({graph['replays']} replays "
        f"of {graph['k1_per_replay']}), {cmeter['outside_ranks']} K1 calls outside the rank "
        f"threads; the planned backward ran on {sorted(cmeter['backward_threads'])}; first step "
        f"{cs['first_step_ms']:.1f}ms, the capturing step {cs['capture_step_ms']:.1f}ms "
        f"(capture {graph['capture_s']:.2f}s), a replay {cs['host_ms']:.1f}ms host / "
        f"{cs['device_ms']:.1f}ms device, {SHARD_BATCH * SHARD_SEQ / cs['host_ms'] * 1e3:.0f} "
        f"tokens/s; mesh=None a replay {plain['steps']['host_ms']:.1f}ms host; peak "
        f"{run['peak_gib']:.2f} GiB (mesh=None {plain['peak_gib']:.2f}); state bytes per rank "
        f"{nbytes['per_rank']} (param_shardings predicts {nbytes['predicted_per_rank']}), "
        f"distinct {nbytes['distinct'] / 1e9:.3f} GB vs unplaced {nbytes['unplaced'] / 1e9:.3f} GB")
    log(f"[{tag}] eager on the mesh: losses {eager['losses']}; planned a step: forward "
        f"{per_step['forward']}, backward {per_step['backward']} (want {want_planned}); K1 a "
        f"step {routes_step}, {meter['outside_ranks']} K1 calls outside the rank threads; the "
        f"planned backward ran on {sorted(meter['backward_threads'])}; steps "
        f"{eager['host_ms']} ms, after the first {es['host_ms']:.1f}ms host / "
        f"{es['device_ms']:.1f}ms device; peak {eager['peak_gib']:.2f} GiB")
    log(f"[{tag}] captured on the mesh: {_conditions_line(run['conditions'])}")
    log(f"[{tag}] eager on the mesh: {_conditions_line(eager['conditions'])}")
    log(f"[{tag}] mesh=None: {_conditions_line(plain['conditions'])}")
    if run["rc"] != 0 or plain["rc"] != 0 or eager["rc"] != 0 \
            or len(run["losses"]) != SHARD_CAPTURED_STEPS \
            or len(plain["losses"]) != SHARD_CAPTURED_STEPS \
            or len(eager["losses"]) != SHARD_STEPS \
            or not all(map(math.isfinite, run["losses"])):
        raise AssertionError(f"[{tag}] runs: {run}, {eager}, {plain}")
    if max(gaps) > SHARD_LOSS_GAP:
        raise AssertionError(f"[{tag}] loss gaps {gaps} over {SHARD_LOSS_GAP}")
    if planned != want_planned or meter["outside_ranks"] != SHARD_STEPS:
        raise AssertionError(f"[{tag}] planned a step {planned}, want {want_planned}; "
                             f"{meter['outside_ranks']} K1 calls ran locally, want "
                             f"{SHARD_STEPS} (the unembedding's)")
    if planned_host != {k: 2 * v for k, v in want_planned.items()} \
            or cmeter["outside_ranks"] != 2:
        raise AssertionError(f"[{tag}] captured: planned on the host {planned_host}, "
                             f"{cmeter['outside_ranks']} K1 calls outside the rank threads")
    check_graph(tag, graph, {r: n // 2 for r, n in run["routes"].items()},
                SHARD_CAPTURED_STEPS - 1, products)
    held = held_to_eager(tag, cs, es, SHARD_LOSS_GAP, relative=False)
    if nbytes["per_rank"] != nbytes["predicted_per_rank"] \
            or nbytes["distinct"] != nbytes["unplaced"]:
        raise AssertionError(f"[{tag}] state bytes {nbytes}")
    if not run["launches"]:
        raise AssertionError(f"[{tag}] the sharded path launched K1 no time")
    k1t = k1_train_times(one_step, dev)
    log(f"[{tag}] K1's {k1t['products']} per-rank block products of one step "
        f"({k1t['distinct']} distinct, each within ROW_TOL, worst row rel "
        f"{k1t['worst_row_rel']:.3e}) timed alone: {k1t['ms']:.2f}ms, bound "
        f"{k1t['bound_ms']:.2f}ms ({k1t['bound_by']}), torch.matmul {k1t['library_ms']:.2f}ms, "
        f"plain {k1t['plain_ms']:.2f}ms; the leg took {time.perf_counter() - t0:.1f}s")
    return {"launches": run["launches"], "routes": run["routes"], "graph": graph,
            "routes_per_step": routes_step, "losses": run["losses"],
            "losses_mesh_none": plain["losses"], "gaps": gaps,
            "planned_per_step": per_step, "planned_host_captured": planned_host,
            "local_k1_calls": meter["outside_ranks"],
            "backward_threads": sorted(cmeter["backward_threads"] | meter["backward_threads"]),
            "captured": cs, "step_ms": cs["host_ms"], "device_ms": cs["device_ms"],
            "tokens_per_s": SHARD_BATCH * SHARD_SEQ / cs["host_ms"] * 1e3,
            "eager": {"losses": eager["losses"], "routes": eager["routes"],
                      "launches": eager["launches"], "steps": es, "host_ms": eager["host_ms"],
                      "peak_gib": eager["peak_gib"], "conditions": eager["conditions"]},
            "held_to_eager": held,
            "mesh_none_host_ms": plain["host_ms"], "mesh_none": plain["steps"],
            "peak_gib": run["peak_gib"],
            "conditions": run["conditions"], "conditions_mesh_none": plain["conditions"],
            "peak_gib_mesh_none": plain["peak_gib"], "state_bytes": nbytes, "k1": k1t,
            "mesh": dict(mesh.shape), "seconds": time.perf_counter() - t0}


def sharded_elastic(dev: torch.device) -> dict:
    """(c) 2 steps on (pod 2, data 1, model 2) with a checkpoint, a failure
    injected at the third, the pod dropped (``shrink_after_failure``), the
    checkpoint re-placed onto (data 1, model 2) (``replace_state``), 2 more
    steps: the four losses within ``SHARD_LOSS_GAP`` of 4 unbroken steps
    without a mesh.  Full width, 2 layers, bf16."""
    tag = "shard-elastic"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=ELASTIC_LAYERS)
    model = build_model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=ELASTIC_SEQ, global_batch=ELASTIC_BATCH)
    os.makedirs(CKPT_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="elastic_", dir=CKPT_DIR)

    def fit(mesh, steps, state=None, ckpt_dir=ckpt, **kw):
        tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, ckpt_dir=ckpt_dir, ckpt_every=2,
                         log_every=1, **kw)
        start = train_store.latest_step(ckpt_dir) or 0 if ckpt_dir else 0
        return Trainer(model, tc, mesh=mesh, device=dev).fit(
            torch.Generator(device=dev).manual_seed(0), batch_iterator(dc, start_step=start),
            state=state)

    try:
        pods = elastic.make_mesh(*ELASTIC_MESH, device=dev)
        first = fit(pods, 2)
        try:
            fit(pods, 4, fail_at_step=2, max_restarts=0)
            raise AssertionError(f"[{tag}] the injected failure did not surface")
        except RuntimeError as e:
            if "injected node failure" not in str(e):
                raise
        survivors = elastic.shrink_after_failure(pods)
        step, full = train_store.restore(ckpt, first["state"])
        del first["state"]
        state = elastic.replace_state(full, survivors)
        del full
        rest = fit(survivors, 4, state=state)
        del state
        pods.close()
        survivors.close()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    unbroken = fit(None, 4, ckpt_dir=None)
    got = [h["loss"] for h in first["history"] + rest["history"]]
    want = [h["loss"] for h in unbroken["history"]]
    gaps = [abs(a - b) for a, b in zip(got, want)]
    log(f"[{tag}] {dict(pods.shape)} -> {dict(survivors.shape)} after a failure at step 2 "
        f"(restored step {step}): losses {got}; unbroken mesh=None {want}; gaps "
        f"{[round(g, 5) for g in gaps]} (limit {SHARD_LOSS_GAP:g}); "
        f"{time.perf_counter() - t0:.1f}s")
    if step != 2 or len(got) != 4 or len(want) != 4 or max(gaps) > SHARD_LOSS_GAP:
        raise AssertionError(f"[{tag}] the elastic restart: step {step}, {got} vs {want}")
    del rest, unbroken
    gc.collect()
    torch.cuda.empty_cache()
    return {"from": dict(pods.shape), "to": dict(survivors.shape), "losses": got,
            "losses_unbroken": want, "gaps": gaps, "seconds": time.perf_counter() - t0}


def sharded_compress(dev: torch.device) -> dict:
    """(d) ``compress_tree_psum`` over a 4-rank thread mesh on the gradient
    leaves of (a)'s model, each rank's from its own batch: the bytes
    ``_collectives.stats`` counts against an fp32 psum's, the mean's
    relative error after one round and, with error feedback, after
    ``COMPRESS_ROUNDS``; each rank's error-fed stream (the reference's
    test_error_feedback_unbiased on every leaf) within its bound."""
    tag = "shard-compress"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              num_layers=SHARD_CHECK_LAYERS)
    model = build_model(cfg)
    master = tree_map(lambda t: t.float(),
                      model.init(torch.Generator(device=dev).manual_seed(3), dev))
    trainer = Trainer(model, TrainConfig(), device=dev)
    grads = {r: trainer.loss_and_grads(master, _train_batch(
        cfg.vocab_size, 1, SHARD_CHECK_SEQ, dev, step=r))[2] for r in range(COMPRESS_RANKS)}
    del master
    mesh = Mesh((COMPRESS_RANKS,), ("data",), device=dev)
    _collectives.reset_stats()
    true_mean = mesh.run(lambda g: [_collectives.psum(x, "data") / COMPRESS_RANKS for x in g],
                         {r: (grads[r],) for r in grads})[0]
    fp32_bytes = _collectives.stats["psum"]["bytes"]
    res = {r: [torch.zeros_like(x) for x in grads[r]] for r in grads}
    acc_q = [torch.zeros_like(x) for x in true_mean]
    rounds = []
    for i in range(COMPRESS_ROUNDS):
        _collectives.reset_stats()
        outs = mesh.run(lambda g, rs: compress.compress_tree_psum(g, "data", rs),
                        {r: (grads[r], res[r]) for r in grads})
        if i == 0:
            int8_bytes = _collectives.stats["psum"]["bytes"]
        res = {r: outs[r][1] for r in outs}
        for a, x in zip(acc_q, outs[0][0]):
            a.add_(x)
        n = i + 1   # acc_q against n x the true mean, over every leaf
        err = sum(((a.double() - n * t.double()).norm() ** 2).item()
                  for a, t in zip(acc_q, true_mean))
        ref = sum(((n * t.double()).norm() ** 2).item() for t in true_mean)
        rounds.append(math.sqrt(err / ref))
    # each rank's own stream: the reference test's loop on every leaf
    drift_ratio = 0.0
    for r in grads:
        for g in grads[r]:
            residual = torch.zeros_like(g)
            acc_t = torch.zeros_like(g)
            acc_d = torch.zeros_like(g)
            for _ in range(COMPRESS_ROUNDS):
                acc_t += g
                x = g + residual
                q, s = compress.quantize_int8(x)
                deq = compress.dequantize_int8(q, s)
                residual = x - deq
                acc_d += deq
            drift = (acc_d + residual - acc_t).abs().max().item()
            bound = EF_BOUND * max(g.std().item(), 1e-30) / EF_SCALE
            drift_ratio = max(drift_ratio, drift / bound)
    mesh.close()
    log(f"[{tag}] {len(true_mean)} gradient leaves ({sum(t.numel() for t in true_mean) / 1e6:.1f} M "
        f"elements) over {COMPRESS_RANKS} rank threads: psum bytes counted, int8 codes (summed "
        f"as int32, the reference's) {int8_bytes} vs fp32 {fp32_bytes} ({int8_bytes / fp32_bytes:.4f}x); "
        f"the mean's relative L2 error after 1 round {rounds[0]:.3e}, accumulated over "
        f"{COMPRESS_ROUNDS} rounds with error feedback {rounds[-1]:.3e} ({[f'{e:.2e}' for e in rounds]}); "
        f"each rank's error-fed stream: worst drift / bound {drift_ratio:.3e} (must be <= 1; "
        f"bound {EF_BOUND:g} at gradient std {EF_SCALE:g}, scaled); {time.perf_counter() - t0:.1f}s")
    if not drift_ratio <= 1.0 or not all(map(math.isfinite, rounds)):
        raise AssertionError(f"[{tag}] error feedback drifted: {drift_ratio}, rounds {rounds}")
    del grads, res, acc_q, true_mean
    torch.cuda.empty_cache()
    return {"bytes": {"int8_codes_int32_psum": int8_bytes, "fp32_psum": fp32_bytes},
            "mean_rel_l2_by_round": rounds, "ef_drift_over_bound": drift_ratio,
            "seconds": time.perf_counter() - t0}


def sharded_launches(st: dict) -> dict:
    """K1's launches on phase 18's paths, for the kernels line: the captured
    main path's counted on the host, its graph's replays, the eager run's."""
    return {"sharded_train_2x2": st["path"]["launches"],
            "sharded_train_2x2_graph_replays":
                sum(st["path"]["graph"]["k1_replayed"].values()),
            "sharded_train_2x2_eager": st["path"]["eager"]["launches"],
            "sharded_train_check_fp32": sum(st["check"]["routes"].values())}


def sharded_routes(st: dict) -> dict:
    return {"sharded_train_2x2": st["path"]["routes"],
            "sharded_train_2x2_graph_replays": st["path"]["graph"]["k1_replayed"],
            "sharded_train_2x2_eager": st["path"]["eager"]["routes"],
            "sharded_train_check_fp32": st["check"]["routes"]}


def sharded_rows(st: dict) -> dict:
    """K1 on one step of phase 18's main path: every rank's block products."""
    k1t = st["path"]["k1"]
    routes = " and ".join(sorted(st["path"]["routes"]))
    planned = sum(sum(v.values()) for v in st["path"]["planned_per_step"].values())
    return {f"{routes}: Llama training step on 2x2, {SHARD_BATCH}x{SHARD_SEQ} tokens "
            f"({k1t['products']} per-rank block products of {planned} planned)":
            {key: k1t[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def phase_sharded_train(dev: torch.device) -> dict:
    """Phase 18: (a) fp32 planned gradients vs mesh=None on the card; (b)
    the launcher on the 2x2 mesh vs mesh=None; (c) an elastic restart;
    (d) ``compressed_psum``."""
    t0 = time.perf_counter()
    out = {"check": sharded_grad_check(dev)}
    out["path"] = sharded_main_path(dev)
    out["elastic"] = sharded_elastic(dev)
    out["compress"] = sharded_compress(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"[shard] phase 18 took {out['seconds']:.1f}s")
    return out


# -- the roofline and the dry run (phase 19) ---------------------------------------------

ROOF_FRACTION_MAX = 1.05     # measured device time may not beat the counted bound by more
ARG_BYTES_TOL = 0.01         # (b): predicted argument bytes vs the allocator's
# (b): predicted peak / the allocator's peak, the band PERF.md wrote before the first run
PEAK_BAND = (0.85, 1.15)
ROOF_TRAIN_CELL = ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")   # phase 14's cut
PROBE_ARGV = ["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "single"]


def _fake_count(setup, step) -> hlo_stats.Counter:
    """``step(*setup())`` under a fresh fake mode, the step alone under the
    cost counter; K1's, K2's and D1's launch counters may not move."""
    before = (k1.launches, k2.launches, kdec.launches)
    with FakeTensorMode():
        args = setup()
        with hlo_stats.counting() as counter, torch.no_grad():
            step(*args)
    if (k1.launches, k2.launches, kdec.launches) != before:
        raise AssertionError(f"a fake trace moved the launch counters: {before} -> "
                             f"{(k1.launches, k2.launches, kdec.launches)}")
    return counter


def _head_copies(counter, head) -> list:
    """The counted ops that copy or cast a tensor of the LM head's shape
    (``head``: (vocab, d_model)) or of its transpose."""
    shapes = (f"[{head[0]}, {head[1]}]", f"[{head[1]}, {head[0]}]")
    return sorted(key for key in counter.shapes
                  if key.split(" ")[0] in ("aten::_to_copy", "aten::clone", "aten::copy_")
                  and key.endswith(shapes))


def _held_to_launches(tag: str, counter, k1_calls, k2_calls, measured_ms: float,
                      model_flops: float, mm_calls: int = 0, head=None) -> dict:
    """The counted K1 and K2 FLOPs against the launched shapes' (exact), and
    the counted program's roofline beside a measured device time; the
    program's ``aten::mm`` calls (``mm_calls``: none but a training step's
    two, the unembedding's fp32 backward products) and, for ``head`` (a
    step that only serves or prefills), no copy of the LM head."""
    k1_launched = sum(2.0 * m * n * k for (m, n, k, _) in k1_calls)
    k2_launched = sum(hlo_stats.flash_cost(b, sq, skv, hq, hkv, d, causal, window,
                                           torch.bfloat16).flops
                      for (b, sq, skv, hq, hkv, d, causal, window, _) in k2_calls)
    k1_counted = counter.by_op.get(hlo_stats.K1_OP, hlo_stats.Cost()).flops
    k2_counted = counter.by_op.get(hlo_stats.K2_OP, hlo_stats.Cost()).flops
    roof = roof_analysis.from_cost(counter.program(), chips=1, model_flops=model_flops)
    summary = roof.summary()
    fraction = roof.step_s / (measured_ms / 1e3)
    log(f"[roofline] {tag}: K1 counted {k1_counted:.6e} FLOPs, launched {k1_launched:.6e} "
        f"({len(k1_calls)} launches); K2 counted {k2_counted:.6e}, launched {k2_launched:.6e} "
        f"({len(k2_calls)}); bound {roof.step_s * 1e3:.3f}ms ({summary['dominant']}: compute "
        f"{roof.compute_s * 1e3:.3f}, memory {roof.memory_s * 1e3:.3f}ms; "
        f"{counter.program().flops:.4e} FLOPs, {counter.program().bytes:.4e} bytes), measured "
        f"{measured_ms:.3f}ms: roofline fraction {fraction:.3f} (limit {ROOF_FRACTION_MAX}); "
        f"aten::mm x{counter.calls.get('aten::mm', 0)} (want {mm_calls})"
        + ("" if head is None else f", copies of the head {_head_copies(counter, head)}"))
    if counter.calls.get("aten::mm", 0) != mm_calls or (
            head is not None and _head_copies(counter, head)):
        raise AssertionError(f"{tag}: aten::mm x{counter.calls.get('aten::mm', 0)} (want "
                             f"{mm_calls}) or a copy of the LM head")
    if k1_counted != k1_launched or k2_counted != k2_launched:
        raise AssertionError(f"{tag}: counted K1 {k1_counted} / K2 {k2_counted} FLOPs, "
                             f"launched {k1_launched} / {k2_launched}")
    if not 0 < fraction <= ROOF_FRACTION_MAX:
        raise AssertionError(f"{tag}: roofline fraction {fraction} outside (0, "
                             f"{ROOF_FRACTION_MAX}]: the count left out work")
    return {"summary": summary, "measured_ms": measured_ms, "fraction": fraction,
            "k1_flops": k1_counted, "k2_flops": k2_counted, "k1_launches": len(k1_calls),
            "k2_launches": len(k2_calls),
            "by_op": {name: {"flops": c.flops, "bytes": c.bytes, "calls": counter.calls[name]}
                      for name, c in sorted(counter.by_op.items(), key=lambda kv: -kv[1].bytes)[:12]}}


def roofline_decode(dev: torch.device, report: dict) -> dict:
    """(a) Llama-3.2-1B's decode step in the (4, 16) bucket, as phase 4
    captures it (``step_device_ms``): counted on fake CUDA tensors, then
    run once eagerly with K1's launches logged; phase 4's graph-replay
    time."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    batch, seq = SERVE_BUCKETS[0]

    def setup():
        return (abstract_params(cfg, dev)[1], model.init_cache(batch, 64, dev),
                torch.empty((batch, 1), dtype=torch.int64, device=dev),
                torch.zeros(batch, dtype=torch.int64, device=dev))

    counter = _fake_count(setup, lambda p, c, t, o: serve_step(model, p, c, t, seq, o))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    cache = model.init_cache(batch, 64, dev)
    tokens = torch.ones((batch, 1), dtype=torch.int64, device=dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    kdec.reset_launches()
    with torch.no_grad(), k1.trace_launches() as c1, k2.trace_launches() as c2:
        serve_step(model, params, cache, tokens, seq, offsets)
        torch.cuda.synchronize()
    d1 = {"counted": counter.calls.get(hlo_stats.D1_OP, 0), "launched": kdec.launches}
    log(f"[roofline] Llama-3.2-1B decode step: D1 counted {d1['counted']} ops, launched "
        f"{d1['launched']} (one a layer)")
    if not d1["counted"] == d1["launched"] == cfg.num_layers:
        raise AssertionError(f"decode step: D1 counted {d1['counted']}, launched "
                             f"{d1['launched']}, want {cfg.num_layers}")
    out = _held_to_launches("Llama-3.2-1B decode step, bucket 4x16", counter, c1, c2,
                            report["serve"]["step_device_ms"]["decode"],
                            roof_analysis.infer_model_flops(cfg.active_param_count(), batch),
                            head=(padded_vocab(cfg.vocab_size), cfg.d_model))
    out["d1"] = d1
    del params, cache
    torch.cuda.empty_cache()
    return out


def roofline_train(dev: torch.device, report: dict) -> dict:
    """(a) + (b): the Llama training cell cut as phase 14 cuts it, counted
    by ``lower_cell(mesh=None)`` on fake CUDA tensors; the real state's
    bytes and one real step's peak beside the prediction, the step's K1
    launches logged; phase 14's step time."""
    cfg = get_config(TRAIN_ARCH)
    counter = hlo_stats.Counter()
    before = (k1.launches, k2.launches)
    rec = lower_cell(TRAIN_ARCH, ROOF_TRAIN_CELL, None, device=dev, counter=counter)
    if (k1.launches, k2.launches) != before:
        raise AssertionError("the dry run moved the launch counters")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    trainer = Trainer(build_model(cfg), TrainConfig(), device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    args = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    with k1.trace_launches() as c1, k2.trace_launches() as c2:
        trainer.make_train_step()(state, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    mem = rec["memory"]
    arg_rel = abs(mem["argument_bytes"] - args) / args
    peak_ratio = mem["peak_bytes"] / peak
    log(f"[roofline] Llama-3.2-1B train {TRAIN_BATCH}x{TRAIN_SEQ}, lower_cell(mesh=None): "
        f"argument bytes predicted {mem['argument_bytes']} vs allocated {args} (rel "
        f"{arg_rel:.2e}, limit {ARG_BYTES_TOL}); peak predicted {mem['peak_bytes'] / 2**30:.3f} "
        f"GiB vs max_memory_allocated {peak / 2**30:.3f} GiB (ratio {peak_ratio:.3f}, band "
        f"{PEAK_BAND}); lower {rec['lower_s']}s, count {rec['compile_s']}s")
    if arg_rel > ARG_BYTES_TOL:
        raise AssertionError(f"argument bytes {mem['argument_bytes']} vs {args}")
    if not PEAK_BAND[0] <= peak_ratio <= PEAK_BAND[1]:
        raise AssertionError(f"peak ratio {peak_ratio} outside {PEAK_BAND}")
    out = _held_to_launches(f"Llama-3.2-1B train step {TRAIN_BATCH}x{TRAIN_SEQ}", counter, c1,
                            c2, report["train"]["timing"]["device_ms"],
                            rec["roofline"]["model_flops"], mm_calls=2)
    out.update(memory=mem, allocated_argument_bytes=args, allocated_peak_bytes=peak,
               argument_rel=arg_rel, peak_ratio=peak_ratio, lower_s=rec["lower_s"],
               count_s=rec["compile_s"])
    del state, batch, trainer
    torch.cuda.empty_cache()
    return out


def roofline_prefill(dev: torch.device, report: dict) -> dict:
    """(a) h2o-danube-3-4b's 32768-token ``flash`` forward: counted on fake
    CUDA tensors, run once with K1's and K2's launches logged; phase 6's
    forward time."""
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)

    def setup():
        return (abstract_params(cfg, dev)[1],
                torch.empty((1, PREFILL_S), dtype=torch.int64, device=dev))

    counter = _fake_count(setup, model.forward)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    with torch.no_grad(), k1.trace_launches() as c1, k2.trace_launches() as c2:
        logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
    del logits, params
    torch.cuda.empty_cache()
    return _held_to_launches(f"{PREFILL_ARCH} flash forward S={PREFILL_S}", counter, c1, c2,
                             report["long_prefill"]["forward_ms"],
                             roof_analysis.infer_model_flops(cfg.active_param_count(),
                                                             PREFILL_S),
                             head=(padded_vocab(cfg.vocab_size), cfg.d_model))


def start_probe() -> dict:
    """Start (c) ``python -m repro_torch.launch.perf_probe --arch xlstm-350m
    --shape decode_32k --mesh single`` in a subprocess (fake CUDA tensors on
    the (16, 16) production mesh: host work only, no kernel), beside the
    phases that run until ``roofline_probe`` reads it."""
    out_path = os.path.join(OUT_DIR, "perf_iterations.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    job = {"t0": time.perf_counter(), "out_path": out_path}
    job["proc"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.perf_probe", *PROBE_ARGV, "--out", out_path],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def reap():
        job["stdout"], job["stderr"] = job["proc"].communicate()
        job["seconds"] = time.perf_counter() - job["t0"]

    job["reaper"] = threading.Thread(target=reap, daemon=True)
    job["reaper"].start()
    return job


def stop_probe(job: dict) -> None:
    """Kill ``start_probe``'s process if it still runs (a phase failed)."""
    if job["proc"].poll() is None:
        job["proc"].kill()
    job["reaper"].join(timeout=30)


def roofline_probe(job: dict) -> dict:
    """(c) ``start_probe``'s run: its JSON, and the seconds it took."""
    t0 = time.perf_counter()
    job["reaper"].join(timeout=600)
    if job["reaper"].is_alive():
        stop_probe(job)
        raise AssertionError("perf_probe --arch did not end within 600 s of phase 19")
    res, secs = job["proc"], job["seconds"]
    if res.returncode != 0:
        raise AssertionError(f"perf_probe --arch: rc {res.returncode}\n{job['stderr'][-3000:]}")
    probe = json.loads(job["stdout"])
    want = {"tag", "arch", "shape", "dominant", "compute_s", "memory_s", "collective_s",
            "step_bound_s", "roofline_fraction", "coll_by_kind", "peak_GiB"}
    with open(job["out_path"]) as f:
        rec = json.load(f)[-1]
    log(f"[roofline] perf_probe {' '.join(PROBE_ARGV)}: {secs:.1f}s from its start before "
        f"phase 15 (waited {time.perf_counter() - t0:.1f}s here), {json.dumps(probe)}; "
        f"analyzer {rec['analyzer']}, mesh {rec['mesh']}")
    if set(probe) != want or rec["mesh"] != "16x16" or probe["memory_s"] <= 0:
        raise AssertionError(f"perf_probe printed {sorted(probe)}, mesh {rec['mesh']}")
    return {"probe": probe, "seconds": secs, "counted": rec["counted"]}


def roofline_hlo(dev: torch.device) -> dict:
    """(d) ``check(plan, hlo=True)`` over phase 10's catalog (``run_matrix``:
    every cell up to 16 ranks, square, ragged and batched, fp32 and bf16,
    staged and overlapped) on meshes of rank threads on the card: the
    counted collective bytes of fake runs present exactly where the trace
    has words."""
    t0 = time.perf_counter()
    rows = run_matrix(measure=False, hlo=True, device=dev)
    secs = time.perf_counter() - t0
    failed = [r for r in rows if not r["ok"]]
    log(f"[roofline] check(plan, hlo=True) over the catalog on the card: {len(rows) - len(failed)}"
        f"/{len(rows)} plans pass in {secs:.1f}s")
    if failed:
        raise AssertionError(f"HLO leg failed on {len(failed)} plans: {failed[:3]}")
    return {"plans": len(rows), "seconds": secs}


def phase_roofline(dev: torch.device, report: dict, probe_job: dict) -> dict:
    """Phase 19: the roofline and the dry run against the kernels (module
    docstring); (c) from ``start_probe``'s process."""
    t0 = time.perf_counter()
    k1.reset_launches()
    k2.reset_launches()
    out = {"decode": roofline_decode(dev, report), "train": roofline_train(dev, report),
           "prefill": roofline_prefill(dev, report)}
    out["launches"] = {"K1": k1.launches, "K2": k2.launches,
                       "K1_routes": _nonzero(k1.launches_by_route),
                       "K2_routes": _nonzero(k2.launches_by_route)}
    out["probe"] = roofline_probe(probe_job)
    out["hlo"] = roofline_hlo(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"[roofline] phase 19 took {out['seconds']:.1f}s")
    return out


# -- the largest configs on one card (phase 20) ------------------------------------------

BIG_ARCHS = ("granite-20b", "chameleon-34b", "qwen3-moe-30b-a3b")
# what the earlier phases may leave allocated when phase 20 starts
BIG_BASE_MAX = 2 ** 30
# granite's long prefill: the reference's prefill_32k cell cut to one
# sequence of its 32768 tokens, as phase 6 cuts danube's
BIG_PREFILL_ARCH = "granite-20b"
BIG_PREFILL_S = 32768
# K2 alone at the three models' head layouts, causal: (B, S_q, S_kv, H_q,
# H_kv, D, window)
BIG_K2 = {"granite-20b MQA 48/1": (1, 8192, 8192, 48, 1, 128, 0),
          "chameleon-34b GQA 64/8": (1, 8192, 8192, 64, 8, 128, 0),
          "qwen3-moe-30b-a3b GQA 32/4": (1, 8192, 8192, 32, 4, 128, 0)}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if torch.is_tensor(t))


def card_budget(dev: torch.device) -> int:
    """Bytes this process can still allocate on the card: what the driver
    reports free (``mem_get_info``) plus what the caching allocator holds
    unused."""
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)


def predict_peak(tag: str, dev: torch.device, setup, step) -> dict:
    """``step(*setup())`` counted on fake CUDA tensors (``_fake_count``):
    the predicted peak is its arguments' bytes plus the counter's
    live-bytes peak over the step (the dry run's rule); raises, with the
    numbers, unless that fits in what the card has free."""
    sized = {}

    def sized_setup():
        args = setup()
        sized["bytes"] = _nbytes(list(args))
        return args

    counter = _fake_count(sized_setup, step)
    budget = card_budget(dev)
    out = {"argument_bytes": sized["bytes"], "live_peak_bytes": counter.peak_bytes(None),
           "budget_bytes": budget}
    out["peak_bytes"] = out["argument_bytes"] + out["live_peak_bytes"]
    log(f"[big] {tag}: predicted peak {out['peak_bytes'] / 2 ** 30:.3f} GiB (arguments "
        f"{out['argument_bytes'] / 2 ** 30:.3f} + live {out['live_peak_bytes'] / 2 ** 30:.3f}) "
        f"against {budget / 2 ** 30:.3f} GiB the card has free")
    if out["peak_bytes"] > budget:
        raise AssertionError(f"{tag} does not fit: predicted peak {out['peak_bytes']} bytes, "
                             f"the card has {budget} free")
    return out


def held_peak(tag: str, dev: torch.device, predicted: dict, arg_bytes: int, fn):
    """Run ``fn()`` and hold its peak (``arg_bytes`` plus what the
    allocator's peak rose over what was allocated before) to the
    prediction within ``PEAK_BAND``: (``fn()``'s result, the record)."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result = fn()
    torch.cuda.synchronize(dev)
    peak = arg_bytes + torch.cuda.max_memory_allocated(dev) - before
    ratio = predicted["peak_bytes"] / peak
    log(f"[big] {tag}: allocated peak {peak / 2 ** 30:.3f} GiB (arguments {arg_bytes / 2 ** 30:.3f}"
        f"), predicted / allocated {ratio:.4f} (band {PEAK_BAND})")
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(f"{tag}: predicted peak {predicted['peak_bytes']} vs allocated "
                             f"{peak}: ratio {ratio} outside {PEAK_BAND}")
    return result, {**predicted, "allocated_peak_bytes": peak, "argument_bytes_allocated":
                    arg_bytes, "ratio": ratio}


def big_decode_fit(dev: torch.device, arch: str, tag: str):
    """(a) for one served model: its batch-4 decode step (bucket 4x16, the
    cache ``phase_serve`` allocates) predicted on fake CUDA tensors before
    anything is allocated, then ``fit(model, params)`` for ``phase_serve``:
    one real eager decode step after a prefill, its peak held to the
    prediction."""
    cfg = get_config(arch)
    model = build_model(cfg)
    batch, seq = SERVE_BUCKETS[0]

    def setup():
        return (abstract_params(cfg, dev)[1], model.init_cache(batch, SERVE_MAX_SEQ, dev),
                torch.empty((batch, 1), dtype=torch.int64, device=dev),
                torch.zeros(batch, dtype=torch.int64, device=dev))

    predicted = predict_peak(f"{tag} decode step {batch}x{seq}", dev, setup,
                             lambda p, c, t, o: serve_step(model, p, c, t, seq, o))

    def fit(model, params) -> dict:
        cache = model.init_cache(batch, SERVE_MAX_SEQ, dev)
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            1, cfg.vocab_size, size=(batch, seq))).to(dev)
        offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
        with torch.no_grad():
            serve_prefill(model, params, cache, tokens, offsets)
            cur = tokens[:, -1:].clone()
            args = _nbytes([params, cache, cur, offsets])
            _, rec = held_peak(f"{tag} decode step {batch}x{seq}", dev, predicted, args,
                               lambda: serve_step(model, params, cache, cur, seq, offsets))
        rec["param_bytes"] = _nbytes(params)
        del cache
        return rec
    return fit


def hidden_recorder(into: dict, name: str):
    """Within the scope, ``DecoderLM``'s unembedding keeps its input (the
    final normed hidden states) as ``into[name]``, so two forwards can be
    compared row by row without holding two full logits tensors."""
    def keeping(p, x, vocab):
        into[name] = x
        return unembed(p, x, vocab)
    return mock.patch.object(decoder_lm, "unembed", keeping)


def chunked_logits_err(params, got: torch.Tensor, ref: torch.Tensor, vocab: int,
                       rows: int = 2048) -> dict:
    """``row_err`` of the logits two forwards' hidden states give, the
    unembedding applied ``rows`` rows at a time (a full 32768-row fp32
    logits tensor of a 49152 vocabulary is 6 GiB)."""
    g, r = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    rels, means, absmax, finite = [], [], [], True
    for i in range(0, g.shape[0], rows):
        e = row_err(unembed_rows(params, g[i:i + rows], vocab),
                    unembed_rows(params, r[i:i + rows], vocab))
        rels.append(e["row_rel"])
        means.append(e["row_rel_mean"])
        absmax.append(e["max_abs_err"])
        finite = finite and e["finite"]
    return {"row_rel": max(rels), "row_rel_mean": float(np.mean(means)),
            "max_abs_err": max(absmax), "finite": finite}


def unembed_rows(params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """The unembedding over the real vocabulary (padded columns dropped)."""
    return unembed(params["embed"], x, vocab)[..., :vocab]


def big_prefill(dev: torch.device, gen: torch.Generator) -> dict:
    """(d) granite-20b's ``flash`` forward over one sequence of
    ``BIG_PREFILL_S`` tokens at full width and depth: its peak predicted
    and held (a); K2 on the wgmma route and K1 on the wide route once a
    layer and ``train_products`` times; logits finite, of their shape, and
    within ``PREFILL_LOGITS_TOL`` per row of the ``xla`` route (chunked
    fp32 attention), while the same forward with K2 run non-causally must
    land outside; the forward's time (CUDA events), tokens/s, one
    profiled forward split into K1, K2 and the rest; then K1 alone at the
    layer's 7 products at that M beside ``torch.matmul``, its plain version
    and its bound."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(BIG_PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    s = BIG_PREFILL_S
    tag = f"{cfg.name} flash forward S={s}"

    def setup():
        return (abstract_params(cfg, dev)[1],
                torch.empty((1, s), dtype=torch.int64, device=dev))

    predicted = predict_peak(tag, dev, setup, model.forward)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, s))).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full((1, 1), -100, device=dev)], dim=1)
    want = {"K2": cfg.num_layers, "K1": train_products(cfg)}
    seen = {}

    def non_causal(q, k, v, *, causal=True, window=0, scale=None):
        return mha(q, k, v, causal=False, window=window, scale=scale)

    with torch.no_grad():
        k1.reset_launches()
        k2.reset_launches()
        with hidden_recorder(seen, "flash"), k1_calls() as calls:
            (logits, _), fit = held_peak(tag, dev, predicted, _nbytes([params, tokens]),
                                         lambda: model.forward(params, tokens))
        got = {"K2": k2.launches, "K1": k1.launches}
        k1_routes, k2_routes = _nonzero(k1.launches_by_route), _nonzero(k2.launches_by_route)
        log(f"[big] {tag}: K2 {got['K2']}x {k2_routes}, K1 {got['K1']}x {k1_routes} (want "
            f"{want}, K2 all wgmma, K1 all wide)")
        if got != want or k1_routes != {"wide": want["K1"]} or \
                k2_routes != {"wgmma": want["K2"]}:
            raise AssertionError(f"{tag}: launches {got} (K2 {k2_routes}, K1 {k1_routes}), "
                                 f"want {want}")
        # chunked: isfinite of a whole 6 GiB fp32 tensor takes 9 GiB more
        if tuple(logits.shape) != (1, s, cfg.vocab_size) or not all(
                bool(torch.isfinite(c).all()) for c in logits.split(2048, dim=1)):
            raise AssertionError(f"{tag}: logits malformed: {tuple(logits.shape)}")
        loss = cross_entropy(logits, labels).item()
        # the chunked re-unembedding gives the forward's own logits
        head = row_err(unembed_rows(params, seen["flash"][0, :2048], cfg.vocab_size),
                       logits[0, :2048, :cfg.vocab_size])
        if head["row_rel"] > 1e-5:
            raise AssertionError(f"the chunked logits differ from the forward's: {head}")
        del logits
        fwd_ms = event_ms(lambda: model.forward(params, tokens), 1, warm=False)
        with hidden_recorder(seen, "xla"):
            xlogits, _ = xla.forward(params, tokens)
        xloss = cross_entropy(xlogits, labels).item()
        del xlogits
        k2.reset_launches()
        with hidden_recorder(seen, "K2 non-causal"), \
                mock.patch.object(attention_layer, "mha", non_causal):
            clogits, _ = model.forward(params, tokens)
        closs = cross_entropy(clogits, labels).item()
        del clogits
        control_k2 = _nonzero(k2.launches_by_route)
        if control_k2 != {"wgmma": want["K2"]}:
            raise AssertionError(f"the non-causal control launched K2 {control_k2}")
        routes = {"flash": {**chunked_logits_err(params, seen["flash"], seen["xla"],
                                                 cfg.vocab_size), "loss": loss},
                  "K2 non-causal": {**chunked_logits_err(params, seen["K2 non-causal"],
                                                         seen["xla"], cfg.vocab_size),
                                    "loss": closs}}
        seen.clear()
        torch.cuda.synchronize()
        with unembed_ranges(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.forward(params, tokens)
            torch.cuda.synchronize()
    split = profile_split(prof)
    del prof
    for what, e in routes.items():
        log(f"[big] {what} vs xla: logits worst row rel {e['row_rel']:.3e} (mean "
            f"{e['row_rel_mean']:.3e}), loss {e['loss']:.6f} against {xloss:.6f}; limit "
            f"{PREFILL_LOGITS_TOL:g}")
    if not routes["flash"]["finite"] or routes["flash"]["row_rel"] >= PREFILL_LOGITS_TOL:
        raise AssertionError(f"{tag}: flash and xla routes disagree: {routes['flash']}")
    if routes["K2 non-causal"]["row_rel"] < PREFILL_LOGITS_TOL:
        raise AssertionError(f"the limit {PREFILL_LOGITS_TOL} cannot tell the xla route from "
                             f"K2 run non-causally: {routes['K2 non-causal']}")
    if not (split["k1_ms"] > 0 and split["k2_ms"] > 0):
        raise AssertionError(f"torch.profiler saw no device time for K1 or K2: {split}")
    if not unembed_seen(split):
        raise AssertionError(f"{tag}: the profiled forward ran aten::mm x{split['mm_calls']} "
                             f"or no unembedding through K1: {split['unembed_calls']} calls")
    tok_s = s / (fwd_ms / 1e3)
    k2_bound, k2_by = flash_bound(1, s, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                  cfg.window)
    k2_bound *= cfg.num_layers
    log(f"[big] {tag}: forward {fwd_ms:.1f}ms ({tok_s:.0f} prefill tokens/s, init "
        f"{init_s:.1f}s); profiled: device {split['device_ms']:.1f}ms = K1 {split['k1_ms']:.1f} "
        f"({split['k1_launches']} launches; the unembedding's {split['unembed_ms']:.1f}) + K2 "
        f"{split['k2_ms']:.1f} (bound {k2_bound:.1f}ms) + rest "
        f"{split['rest_ms']:.1f}: " + "; ".join(f"{r['kernel'][:60]} {r['ms']:.1f}ms"
                                               for r in split["rest_top_kernels"][:4]))
    del params, tokens, labels
    torch.cuda.empty_cache()
    checked = check_k1_calls(calls, dev, head_n=padded_vocab(cfg.vocab_size))
    log(f"[big] {tag}: K1's {checked['calls']} calls ({len(checked['distinct'])} distinct, the "
        f"unembedding's among them) each within ROW_TOL of the plain version at its own "
        f"shape, blocks and layouts (worst row rel {checked['worst_row_rel']:.3e})")
    torch.cuda.empty_cache()
    projections = projection_times(dev, gen, BIG_PREFILL_ARCH, s)
    k1_fwd = {key: cfg.num_layers * sum(r[key] for r in projections)
              for key in ("ms", "wide128_ms", "library_ms", "plain_ms", "bound_ms")}
    t_bytes = cfg.num_layers * sum(sum(r["shape"][i] * r["shape"][j] for i, j in
                                       ((0, 1), (1, 2), (0, 2))) * 2 for r in projections)
    t_ops = cfg.num_layers * sum(2.0 * math.prod(r["shape"]) for r in projections)
    k1_fwd["bound_by"] = ("bytes" if t_bytes / PEAK_BYTES_S >= t_ops / PEAK_FLOPS[torch.bfloat16]
                          else "operations")
    log(f"[big] {tag}: K1's {want['K1']} products alone {k1_fwd['ms']:.1f}ms, torch.matmul "
        f"{k1_fwd['library_ms']:.1f}ms, plain {k1_fwd['plain_ms']:.1f}ms, bound "
        f"{k1_fwd['bound_ms']:.1f}ms ({k1_fwd['bound_by']})")
    return {"seq": s, "init_s": init_s, "launches": want, "k1_routes": k1_routes,
            "k2_routes": k2_routes, "control_k2_routes": control_k2, "fit": fit,
            "loss": loss, "xla_loss": xloss, "routes": routes, "chunked_vs_forward": head,
            "forward_ms": fwd_ms, "tokens_per_s": tok_s, "profile": split,
            "k1_check": checked, "k2_bound_ms": k2_bound, "k2_bound_by": k2_by,
            "projections": projections, "k1_per_forward": k1_fwd}


def big_launches(big: dict) -> dict:
    """K1's launches on phase 20's paths, for the kernels line."""
    out = {}
    for arch in BIG_ARCHS:
        sv = big[arch]["serve"]
        out.update({f"big_{arch}_serve": sv["path"]["launches"],
                    f"big_{arch}_serve_graph_replays_per_generate": sv["runs"][0]["launches"],
                    f"big_{arch}_serve_eager_per_generate": sv["eager_runs"][0]["launches"],
                    f"big_{arch}_check_fp32": big[arch]["model"]["launches"]})
    out[f"big_{BIG_PREFILL_ARCH}_prefill"] = big["prefill"]["launches"]["K1"]
    return out


def big_routes(big: dict) -> dict:
    """K1's launches by route on phase 20's paths, for the kernels line."""
    out = {}
    for arch in BIG_ARCHS:
        sv = big[arch]["serve"]
        out.update({f"big_{arch}_serve": sv["path"]["routes"],
                    f"big_{arch}_serve_graph_replays": sv["runs"][0]["routes"],
                    **{f"big_{arch}_serve_{step}_step": r
                       for step, r in sv["step_device_ms"]["routes"].items()}})
    out[f"big_{BIG_PREFILL_ARCH}_prefill"] = big["prefill"]["k1_routes"]
    return out


def big_k1_rows(big: dict) -> dict:
    """K1's time beside its bound, the plain version's and the library's
    on phase 20's paths, for the kernels line's ``per_route``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    rows = {}
    for arch in BIG_ARCHS:
        m = big[arch]["serve"]["measured"]
        t = m["k1"]["decode_step"]
        rows[f"thin: {arch} decode step, M = 4 ({t['products']} products)"] = {
            **{key: t[key] for key in keys},
            "profiled_in_the_step_ms": m["profile"]["k1_ms"]}
    pf = big["prefill"]
    rows[f"wide: {BIG_PREFILL_ARCH} forward, M = {pf['seq']} "
         f"({pf['launches']['K1'] - UNEMBED_LAUNCHES} layer products; the unembedding "
         f"apart)"] = {**{key: pf["k1_per_forward"][key] for key in keys},
                       "profiled_in_the_forward_ms": pf["profile"]["k1_ms"],
                       "unembedding_profiled_ms": pf["profile"]["unembed_ms"]}
    return rows


def phase_big(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 20: granite-20b, chameleon-34b and qwen3-moe-30b-a3b, every leg
    fatal, each model freed before the next (module docstring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    log(f"[big] memory allocated before phase 20: {base} bytes (limit {BIG_BASE_MAX})")
    if base > BIG_BASE_MAX:
        raise AssertionError(f"earlier phases left {base} bytes allocated on the card")
    out = {"base_bytes": base}
    for arch in BIG_ARCHS:
        tag = f"big-{arch}"
        t1 = time.perf_counter()
        fit = big_decode_fit(dev, arch, tag)
        out[arch] = {"model": phase_model(dev, arch, tag),
                     "serve": phase_serve(dev, arch, tag, measure=zoo_measure(dev, tag),
                                          warm=SERVE_BUCKETS[:1], fit=fit)}
        out[arch]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out["prefill"] = big_prefill(dev, gen)
    out["k2"] = {name: k2_case(dev, gen, name, shape, True, "big")
                 for name, shape in BIG_K2.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"[big] phase 20 took {out['seconds']:.1f}s")
    return out


# -- phase 21: the reference's examples and the Sec. 4.3 tile orders ------------------------

# What the reference's quickstart prints (examples/quickstart.py, run on the CPU)
QUICKSTART_WANT = {"schedules": 3648, "min_hop_cost": 2,
                   "movements": {"A": (1, 0), "B": (0, 0), "C": (0, 1)},
                   "skew": [(1, 4), (1, 0), (1, 1), (1, 2), (1, 3)],
                   "words_per_node": "5.369e+06", "lower_bound": "5.152e+05", "factor": "10.4"}
# The collective bytes per device the reference's demo prints
# (examples/distributed_matmul.py on 16 fake CPU devices, where XLA's CPU
# compiler makes every bf16 collective an f32 one): the port's fp32 run
# counts these; its bf16 run half of each kind but the 2.5D all-reduce,
# which sums fp32 partials
DEMO_F32_BYTES = {"cannon": {"collective-permute": 524288}, "summa": {"all-gather": 524288},
                  "summa+ov": {"collective-permute": 393216},
                  "pod25d": {"all-reduce": 262144, "collective-permute": 262144},
                  "ring_ag": {"collective-permute": 458752}}
DEMO_RANKS = {"cannon": 16, "summa": 16, "summa+ov": 16, "pod25d": 8, "ring_ag": 8}
DEMO_TIMED_REPS = 3
EX_SERVE_ARCH = "llama3.2-1b"
# (d): the example's own full-width model (12 layers, d_model 768, vocab
# 32768), 60 steps at 8 x 256, a failure injected at step 30
EX_TRAIN_ARGV = ["--preset", "100m", "--steps", "60", "--batch", "8", "--seq", "256"]
EX_TRAIN_FAIL = 30
# (e): K1's two tile orders at n^3, bf16, wide route; CUDA-graph calls a timing
ORDER_SIZES = {2048: 16, 8192: 4, 16384: 2}
ORDER_ROUNDS = 3           # rounds of the turns (z, r, library, library, r, z)
ORDER_MODEL_GRID = 16
ORDER_MODEL_CACHES = (48, 192, 768)


def _moved_routes(fn):
    """(fn(), K1's launches by route during it)."""
    before = dict(k1.launches_by_route)
    out = fn()
    return out, routes_moved(before)


def examples_quickstart() -> dict:
    """(a) ``repro_torch.examples.quickstart`` on the card: the solver's
    numbers are the reference quickstart's, and K1's fp32 (fma) and bf16
    (wide) rows at 256^3 within ``TOL`` per row of the plain version."""
    qs, routes = _moved_routes(lambda: ex_quickstart.main([]))
    got = {**{k: qs[k] for k in ("schedules", "min_hop_cost", "movements", "skew")},
           "words_per_node": f"{qs['words_per_node']:.3e}",
           "lower_bound": f"{qs['lower_bound']:.3e}", "factor": f"{qs['factor']:.1f}"}
    if got != QUICKSTART_WANT or not (qs["cannon_like"] and qs["cannon_found"]
                                      and qs["simulated"] and all(qs["systolic"].values())):
        raise AssertionError(f"[examples] the quickstart gave {got}, want {QUICKSTART_WANT}")
    for name, dtype, route in (("float32", torch.float32, "fma"),
                               ("bfloat16", torch.bfloat16, "wide")):
        r = qs["k1"][name]
        if r["launched"] != {route: 1} or not r["finite"] or r["row_rel"] >= TOL[dtype]:
            raise AssertionError(f"[examples] quickstart's K1 {name}: {r}, want one {route} "
                                 f"launch within {TOL[dtype]} per row")
    log(f"[examples] quickstart: the reference's numbers; K1 " + ", ".join(
        f"{name} {r['route']} worst row {r['row_rel']:.3e} max abs {r['max_abs_err']:.3e}"
        for name, r in qs["k1"].items()))
    return {**qs, "k1_routes": routes}


def examples_distributed(dev: torch.device) -> dict:
    """(b) ``repro_torch.examples.distributed_matmul`` on the card, bf16 and
    fp32: bytes by kind per strategy against the reference demo's, each
    product's rows against the fp32 product, the ranks' threads, K1's
    launches by route; then each bf16 strategy's device ms (CUDA events on
    the caller's stream, which ``Mesh.run`` joins)."""
    seen = set()
    real = _collectives.run_rank

    def spy(comm, *args, **kw):
        seen.add((comm.mesh.size, comm.rank, threading.get_ident()))
        return real(comm, *args, **kw)

    runs = {}
    with mock.patch.object(_collectives, "run_rank", spy):
        for dt in ("bfloat16", "float32"):
            runs[dt], routes = _moved_routes(lambda: ex_distributed.main(["--dtype", dt]))
            runs[dt]["k1_path_routes"] = routes
    main_thread = threading.get_ident()
    torus = {(r, t) for size, r, t in seen if size == 16}
    if {r for r, _ in torus} != set(range(16)) or len({t for _, t in torus}) < 16 \
            or main_thread in {t for _, t in torus}:
        raise AssertionError(f"[examples] the 4x4 torus ran ranks {sorted(torus)}")
    rows = {}
    for name, want in DEMO_F32_BYTES.items():
        f32, bf16 = runs["float32"]["strategies"][name], runs["bfloat16"]["strategies"][name]
        halves = {k: v if k == "all-reduce" else v // 2 for k, v in want.items()}
        e16, e32 = row_err(bf16.pop("out"), bf16.pop("ref")), row_err(f32.pop("out"),
                                                                      f32.pop("ref"))
        ok = (f32["by_kind"] == want and bf16["by_kind"] == halves
              and f32["same_on_every_rank"] and bf16["same_on_every_rank"]
              and f32["ranks"] == bf16["ranks"] == DEMO_RANKS[name]
              and set(f32["k1_routes"]) == {"fma"} and bf16["k1_routes"]
              and e16["row_rel"] <= ROW_TOL[torch.bfloat16] and e16["finite"]
              and e32["row_rel"] <= ROW_TOL[torch.float32] and e32["finite"])
        rows[name] = {"bf16": {**bf16, "rows": e16}, "fp32": {**f32, "rows": e32}}
        log(f"[examples] {name:8s} {DEMO_RANKS[name]} ranks: fp32 bytes {f32['by_kind']} "
            f"(reference {want}), bf16 {bf16['by_kind']}; worst row bf16 {e16['row_rel']:.3e} "
            f"fp32 {e32['row_rel']:.3e}; K1 bf16 {bf16['k1_routes']} fp32 {f32['k1_routes']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[examples] {name}: {rows[name]}")
    meshes, products = ex_distributed.cases(dev)
    try:
        for name, (fn, operands) in products.items():
            fn(*operands)
            ms = []
            for _ in range(DEMO_TIMED_REPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                fn(*operands)
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            rows[name]["ms"] = float(np.median(ms))
            rows[name]["runs_ms"] = ms
    finally:
        for mesh in meshes:
            mesh.close()
    log("[examples] bf16 device ms a product (events, median of "
        f"{DEMO_TIMED_REPS}): " + ", ".join(f"{n} {r['ms']:.3f}" for n, r in rows.items()))
    return {"strategies": rows, "threads": len({t for _, _, t in seen}),
            "torus_ranks": len({r for r, _ in torus}),
            "k1_routes": {dt: r["k1_path_routes"] for dt, r in runs.items()},
            "cost_model": runs["bfloat16"]["cost_model"]}


def examples_serve(dev: torch.device) -> dict:
    """(c) ``repro_torch.examples.serve_batched`` on the card with the 2x2
    mesh and with ``--no-mesh``: bucket 4x16 replayed from its graphs, 16
    tokens a request, the planned run's serve-window hit rate 1.0; the
    planned path's logits along the planned run's tokens within
    ``PLANNED_LOGITS_TOL`` per row of ``mesh=None``'s (phase 8's limit)."""
    runs = {}
    for mesh in (True, False):
        runs[mesh], routes = _moved_routes(
            lambda: ex_serve.main(["--arch", EX_SERVE_ARCH] + ([] if mesh else ["--no-mesh"])))
        runs[mesh]["k1_path_routes"] = routes
        r = runs[mesh]
        if r["bucket"] != "4x16" or not r["graphs"] or \
                [len(t) for t in r["new_tokens"]] != [16] * len(r["prompts"]) or \
                (mesh and (r["hit_rate"] != 1.0 or not r["strategies"])):
            raise AssertionError(f"[examples] serve_batched mesh={mesh}: bucket {r['bucket']}, "
                                 f"graphs {r['graphs']}, hit rate {r['hit_rate']}")
    planned, local = runs[True], runs[False]
    _, model, params = ex_serve.model_and_params(EX_SERVE_ARCH, dev)
    batch, lens = batch_requests(planned["prompts"], PAD_ID, pad_to=16)
    full = np.concatenate([batch, np.asarray(planned["new_tokens"])], axis=1)
    offsets = torch.as_tensor(16 - lens, dtype=torch.int64, device=dev)
    mesh = Mesh(*ex_serve.MESH, device=dev)
    try:
        lower_dist_mod.reset_executions()
        got = forced_logits(model, params, dev, full.tolist(), 16, offsets, mesh, None)
        forced_plans = lower_dist_mod.executions_snapshot()
        ref = forced_logits(model, params, dev, full.tolist(), 16, offsets, None, None)
    finally:
        mesh.close()
    if not forced_plans:
        raise AssertionError("[examples] the planned logits ran no planned product")
    errs = [row_err(g, r) for g, r in zip(got, ref)]
    worst = max(e["row_rel"] for e in errs)
    agree = sum(x == y for p, q in zip(planned["new_tokens"], local["new_tokens"])
                for x, y in zip(p, q))
    log(f"[examples] serve_batched {planned['arch']}: 2x2 {planned['tokens_per_s']:.1f} tok/s, "
        f"ttft {planned['ttft_s'] * 1e3:.2f}ms, p50 {planned['p50_ms']:.2f}ms, hit rate "
        f"{planned['hit_rate']}, strategies {planned['strategies']}; no mesh "
        f"{local['tokens_per_s']:.1f} tok/s, ttft {local['ttft_s'] * 1e3:.2f}ms, p50 "
        f"{local['p50_ms']:.2f}ms; planned logits along the planned tokens, worst row "
        f"{worst:.3e} of mesh=None's (limit {PLANNED_LOGITS_TOL}) over {len(errs)} steps "
        f"({forced_plans}); "
        f"{agree} of {sum(map(len, local['new_tokens']))} tokens agree (printed, not held)")
    if worst > PLANNED_LOGITS_TOL or not all(e["finite"] for e in errs):
        raise AssertionError(f"[examples] planned serving logits left mesh=None's: {worst}")
    del model, params
    return {"mesh": planned, "no_mesh": local, "logits_worst_row": worst,
            "logit_steps": len(errs), "logit_plans": forced_plans, "agree": agree}


def examples_train(dev: torch.device) -> dict:
    """(d) ``repro_torch.examples.train_lm --preset 100m`` on the card,
    captured, a failure injected at step ``EX_TRAIN_FAIL``: one restart,
    one capture, the loss falling; then the same run without the failure,
    fed the batches the restarted run saw (a restart loses the failed
    step's batch), each step's loss and learning rate held to it.  That
    run writes no checkpoint (it restores none): its steps do not read
    them."""
    runs = {}
    for fail in (True, False):
        ckpt = tempfile.mkdtemp(prefix="examples_train_", dir=CKPT_DIR)
        argv = EX_TRAIN_ARGV + ["--ckpt", ckpt] + (
            ["--inject-failure", str(EX_TRAIN_FAIL)] if fail else [])
        skip = None if fail else EX_TRAIN_FAIL

        def batches(dc, start_step=0):
            return (synth_batch(dc, s) for s in itertools.count(start_step) if s != skip)

        try:
            with mock.patch.object(ex_train, "batch_iterator", batches), \
                    contextlib.ExitStack() as stack, step_meter() as meter:
                if not fail:
                    stack.enter_context(mock.patch.object(
                        train_store.AsyncWriter, "save", lambda *a, **kw: None))
                out, routes = _moved_routes(lambda: ex_train.main(argv))
                graph = meter["trainers"][0].graph_report()
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        runs[fail] = {**out, "routes": routes, "graph": graph,
                      "steps_run": step_summary(meter["rows"])}
        del meter["trainers"]
    cut, whole = runs[True], runs[False]
    if cut["restarts"] != 1 or whole["restarts"] != 0 or cut["graph"]["captures"] != 1 \
            or not cut["last_loss"] < cut["first_loss"]:
        raise AssertionError(f"[examples] train_lm: {cut['restarts']} restarts, "
                             f"{cut['graph']['captures']} captures, losses "
                             f"{cut['first_loss']} -> {cut['last_loss']}")
    s, w = cut["steps_run"], whole["steps_run"]
    gaps = [abs(x - y) / abs(y) for x, y in zip(s["losses"], w["losses"])]
    held = {"steps": len(gaps), "worst_gap": max(gaps), "lr_bitwise": s["lrs"] == w["lrs"]}
    log(f"[examples] train_lm restarted vs uninterrupted (the same batches) over {len(gaps)} "
        f"steps: worst relative loss gap {held['worst_gap']:.3g} (limit {TRAIN_GRAD_TOL:g}), "
        f"learning rates bitwise {held['lr_bitwise']}")
    if len(s["losses"]) != len(w["losses"]) or held["worst_gap"] > TRAIN_GRAD_TOL \
            or not held["lr_bitwise"]:
        raise AssertionError(f"[examples] the restarted run left the uninterrupted one: {held}")
    log(f"[examples] train_lm 100m ({cut['params'] / 1e6:.1f}M params) 60 steps at 8x256: "
        f"loss {cut['first_loss']:.4f} -> {cut['last_loss']:.4f}, {cut['restarts']} restart, "
        f"steps by kind {s['kinds']}, a replay {s['host_ms']:.2f}ms host / "
        f"{s['device_ms']:.2f}ms device ({8 * 256 / s['device_ms'] * 1e3:.0f} tokens/s), "
        f"K1 counted {cut['routes']}, replayed {cut['graph']['k1_replayed']}")
    for r in runs.values():
        r.pop("ckpt_dir")
    return {"restart": cut, "uninterrupted": whole, "held": held}


def order_times(dev: torch.device, gen: torch.Generator) -> dict:
    """(e) K1 bf16 (wide route) with its tile table in Z-order and in
    row-major order at n^3 for each n of ``ORDER_SIZES``: both outputs
    bitwise equal, and within ``ROW_TOL`` per row of the plain version
    (timed once between CUDA events); CUDA-graph replays timed in ``ORDER_ROUNDS`` rounds of
    the turns (z, r, library, library, r, z; the library is
    ``torch.matmul``) beside ``bound``; and
    the reference's Sec. 4.3 model rows (``benchmarks/paper_benches.py``:
    block fetches through an LRU cache on a 16^3 grid), printed beside,
    neither claimed to predict the other."""
    rows = []
    for n, calls in ORDER_SIZES.items():
        a = torch.randn(n, n, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(n, n, generator=gen, device=dev) / math.sqrt(n)).to(torch.bfloat16)
        z, r = matmul(a, b, order="zorder"), matmul(a, b, order="rowmajor")
        bitwise = torch.equal(z, r)
        rows_err = row_err(z, matmul_ref(a, b))
        del z, r
        if not bitwise or meant_route(n, n, n, torch.bfloat16) != "wide":
            raise AssertionError(f"[examples] K1's tile orders disagree at {n}^3")
        if not rows_err["finite"] or rows_err["row_rel"] > ROW_TOL[torch.bfloat16]:
            raise AssertionError(f"[examples] K1 at {n}^3 left its plain version: {rows_err}")
        plain_ms = event_ms(lambda: matmul_ref(a, b), 1)
        fns = {"zorder": functools.partial(matmul, order="zorder"),
               "rowmajor": functools.partial(matmul, order="rowmajor"),
               "library": torch.matmul}
        t = {name: [] for name in fns}
        for _ in range(ORDER_ROUNDS):
            for name in ("zorder", "rowmajor", "library", "library", "rowmajor", "zorder"):
                t[name].append(graph_ms(fns[name], [(a, b)] * calls))
        bms, by = bound(n, n, n, torch.bfloat16)
        row = {"n": n, "calls": calls, **{f"{name}_ms": min(v) for name, v in t.items()},
               **{f"{name}_median_ms": float(np.median(v)) for name, v in t.items()},
               "runs": t, "bound_ms": bms, "bound_by": by, "bitwise": bitwise,
               "rows": rows_err, "plain_ms": plain_ms}
        row["rowmajor_over_zorder"] = row["rowmajor_ms"] / row["zorder_ms"]
        rows.append(row)
        log(f"[examples] K1 bf16 {n}^3 wide, min (median) of {2 * ORDER_ROUNDS}: zorder "
            f"{row['zorder_ms']:.3f}ms ({row['zorder_median_ms']:.3f}) rowmajor "
            f"{row['rowmajor_ms']:.3f}ms ({row['rowmajor_median_ms']:.3f}), "
            f"x{row['rowmajor_over_zorder']:.3f}; bound {bms:.3f}ms ({by}), torch.matmul "
            f"{row['library_ms']:.3f}ms ({row['library_median_ms']:.3f}), plain {plain_ms:.3f}ms; "
            f"outputs bitwise equal, worst row {rows_err['row_rel']:.3e} of the plain version's "
            f"(limit {ROW_TOL[torch.bfloat16]:g})")
        del a, b
        torch.cuda.empty_cache()
    g = ORDER_MODEL_GRID
    zo, ro = zorder_schedule(g, g, g), rowmajor_schedule(g, g, g)
    model = []
    for cache in ORDER_MODEL_CACHES:
        tz, tr = block_reuse_distance_traffic(zo, cache), block_reuse_distance_traffic(ro, cache)
        model.append({"cache_blocks": cache, "zorder": tz, "rowmajor": tr, "saving": tr / tz,
                      "ideal": ideal_traffic(len(zo), cache)})
        log(f"[examples] Sec. 4.3 model, {g}^3 grid, LRU of {cache} blocks: zorder {tz} "
            f"rowmajor {tr} fetches (saving x{tr / tz:.2f}; ideal {model[-1]['ideal']:.1f})")
    return {"timed": rows, "model": model}


def phase_examples(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 21: the reference's examples on the card through their port
    (``repro_torch.examples``), each ``main`` in this process, and K1's
    two tile orders timed past the L2 (module docstring)."""
    out = {}
    for key, fn in (("quickstart", examples_quickstart),
                    ("distributed", lambda: examples_distributed(dev)),
                    ("serve", lambda: examples_serve(dev)),
                    ("train", lambda: examples_train(dev)),
                    ("orders", lambda: order_times(dev, gen))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds"] = time.perf_counter() - t0
        log(f"[examples] ({key}) took {out[key]['seconds']:.1f}s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def examples_routes(ex: dict) -> dict:
    """Phase 21's K1 launches by route counted on each example's path (the
    serving graphs' replays apart; the training run's host counts, then its
    replays)."""
    return {"examples_quickstart": ex["quickstart"]["k1_routes"],
            **{f"examples_distributed_{dt}": r
               for dt, r in ex["distributed"]["k1_routes"].items()},
            **{f"examples_serve_{leg}": ex["serve"][leg]["k1_path_routes"]
               for leg in ("mesh", "no_mesh")},
            **{f"examples_serve_{leg}_replayed": ex["serve"][leg]["k1"]["replayed_by_route"]
               for leg in ("mesh", "no_mesh")},
            "examples_train": ex["train"]["restart"]["routes"],
            "examples_train_replayed": ex["train"]["restart"]["graph"]["k1_replayed"]}


# -- the split-KV decode-attention kernel (phase 22) -----------------------------------

# the serving cells' decode steps (portbench's danube-serve-b64, deepseek-serve-b64):
# (layers, B, S, H_kv, G, D)
DECODE_CELLS = {"h2o-danube-3-4b": (24, 64, 850, 8, 4, 120),
                "deepseek-moe-16b": (28, 64, 850, 16, 1, 128)}
# the card tests' tolerance (tests/test_torch_cuda.py): one bf16 ulp of the
# plain version's fp32 output, plus 1e-5 absolute for outputs near 0
DECODE_RTOL, DECODE_ATOL = 2.0 ** -8, 1e-5
# the serving mix's prompts: a lognormal of sigma 0.8 with ShareGPT's mean
# input (161.31 tokens; vLLM, arXiv:2309.06180), left-padded into a 512 bucket
SHAREGPT_MEAN_IN, SHAREGPT_SIGMA, DECODE_BUCKET = 161.31, 0.8, 512


def decode_offsets(rng, b: int, dev: torch.device) -> torch.Tensor:
    """Each row's left padding in the 512 bucket for prompts of the serving
    mix's lengths."""
    mu = math.log(SHAREGPT_MEAN_IN) - SHAREGPT_SIGMA ** 2 / 2
    lens = np.clip(np.exp(rng.normal(mu, SHAREGPT_SIGMA, size=b)).astype(np.int64), 1,
                   DECODE_BUCKET)
    return torch.from_numpy(DECODE_BUCKET - lens).to(dev)


def decode_cases(rng, b: int, s: int, dev: torch.device) -> dict:
    """(qpos, kpos, window, causal) of each checked case, as the callers
    build them; the first two are timed."""
    idx = torch.arange(s, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    off = decode_offsets(rng, b, dev)
    p = torch.tensor(3 * s + 5, device=dev)
    return {"step at pos 512, no padding": (512 - zero[:, None], idx[None, :] - zero[:, None],
                                            0, True),
            "step at pos 680, the serving mix's padding": (680 - off[:, None],
                                                           idx[None, :] - off[:, None], 0, True),
            "rolling window cache": (p.reshape(1), p - torch.remainder(p - idx, s), s, True),
            "non-causal (S,) keys": (torch.zeros(1, dtype=torch.int64, device=dev), idx, 0,
                                     False)}


def phase_decode_kernel(dev: torch.device) -> dict:
    """Phase 22 (module docstring)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checks, timings, worst = [], {}, 0.0
    for arch, (layers, b, s, hkv, g, d) in DECODE_CELLS.items():
        chunk, splits = kdec.split_plan(b, hkv, g, s, sms)
        q = torch.randn(b, 1, hkv, g, d, device=dev).bfloat16()
        ks = [torch.randn(b, s, hkv, d, device=dev).bfloat16() for _ in range(layers)]
        vs = [torch.randn(b, s, hkv, d, device=dev).bfloat16() for _ in range(layers)]
        scale = d ** -0.5
        for name, (qpos, kpos, window, causal) in decode_cases(rng, b, s, dev).items():

            def kern(i):
                return kdec.decode_attention(q, ks[i], vs[i], qpos, kpos, window=window,
                                             scale=scale, causal=causal)

            def plain(i):
                return attention_layer._sdpa(q, ks[i], vs[i], qpos, kpos, window, scale, causal)

            kdec.reset_launches()
            out, again = kern(0), kern(0)
            torch.cuda.synchronize()
            if kdec.launches != 2 or not torch.equal(out, again):
                raise AssertionError(f"D1 {arch} {name}: {kdec.launches} launches for 2 calls, "
                                     f"or two calls disagree")
            ref = attention_layer._sdpa(q, ks[0], vs[0].float(), qpos, kpos, window, scale,
                                        causal)
            err = (out.float() - ref).abs()
            over = int((err > DECODE_RTOL * ref.abs() + DECODE_ATOL).sum())
            e = row_err(out, ref)
            cost = hlo_stats.decode_cost(q, ks[0], vs[0], qpos, kpos, window, causal)
            valid = cost.flops / (2.0 * 2 * d * hkv * g * b)
            log(f"[decode-kernel] D1 {arch} {name}: {splits} chunks of {chunk} slots, "
                f"{valid:.1f} valid slots a row; worst abs err {e['max_abs_err']:.3g}, row rel "
                f"{e['row_rel']:.3g}, {over} outputs past {DECODE_RTOL:.3g} rel + "
                f"{DECODE_ATOL:g}; rerun bitwise")
            if over or not e["finite"]:
                raise AssertionError(f"D1 {arch} {name}: {over} outputs outside the tolerance")
            worst = max(worst, e["max_abs_err"])
            checks.append({"arch": arch, "case": name, "chunk": chunk, "splits": splits,
                           "valid_slots_per_row": valid, "outputs_outside": over, **e})
            if len(timings.get(arch, {})) == 2:
                continue
            qh = q.reshape(b, 1, hkv * g, d).transpose(1, 2)
            mask = attention_layer._mask(qpos, kpos, window, causal)[:, None]

            def library(i):
                return F.scaled_dot_product_attention(
                    qh, ks[i].transpose(1, 2), vs[i].transpose(1, 2), attn_mask=mask,
                    scale=scale, enable_gqa=True)

            calls = [(i,) for i in range(layers)]
            t = {}
            for key in ("ms", "library_ms", "plain_ms", "library_ms", "ms"):
                fn = {"ms": kern, "library_ms": library, "plain_ms": plain}[key]
                t.setdefault(key, []).append(layers * graph_ms(fn, calls))
            bms, by = _bound(cost.scaled(layers), torch.bfloat16)
            row = {"shape": [layers, b, s, hkv, g, d], "case": name, "chunk": chunk,
                   "splits": splits, "valid_slots_per_row": valid,
                   **{key: min(v) for key, v in t.items()}, "runs": t, "bound_ms": bms,
                   "bound_by": by}
            row["bound_share"] = bms / row["ms"]
            timings.setdefault(arch, {})[name] = row
            log(f"[decode-time] D1 {arch} decode step ({layers} layers x (B, S, H_kv, G, D) = "
                f"{(b, s, hkv, g, d)}), {name}: {row['ms']:.3f}ms, bound {bms:.3f}ms ({by}, "
                f"{row['bound_share']:.1%}), plain {row['plain_ms']:.3f}ms, "
                f"scaled_dot_product_attention {row['library_ms']:.3f}ms")
        del q, ks, vs
        torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "worst_abs_err": worst}


def decode_row(report: dict) -> dict:
    """D1's entry: a danube serving cell's decode step at the serving mix's
    mean, every layer's launch; the main path's launches (phase 4's
    warmup, captures and eager run; the zoo's and phase 20's served
    decoders; phase 19's real step) and each timed step beside it."""
    t = report["decode_kernel"]["timings"]
    row = t["h2o-danube-3-4b"]["step at pos 680, the serving mix's padding"]
    served = {"serve": report["serve"], **{f"zoo_{a}": z["serve"]
                                            for a, z in report["zoo_serve"].items()},
              **{f"family_{a}": report["families"][a] for a in SERVED_FAMILIES},
              **{f"big_{a}": report["big"][a]["serve"] for a in BIG_ARCHS}}
    by_path = {}
    for key, srv in served.items():
        by_path[f"{key}_warmup_and_captures"] = srv["path"]["d1_launches"]
        by_path[f"{key}_eager_per_generate"] = srv["eager_runs"][0]["d1_launches"]
        by_path[f"{key}_decode_step"] = srv["step_device_ms"]["d1_launches"]["decode"]
    by_path["roofline_decode_step"] = report["roofline"]["decode"]["d1"]["launched"]
    by_path["decode_kernel_checks"] = 2 * len(report["decode_kernel"]["checks"])
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": None,
        "launches": report["serve"]["path"]["d1_launches"]
                    + report["serve"]["eager_runs"][0]["d1_launches"],
        "launches_by_path": by_path,
        "routes": {"split_kv": by_path},
        "max_abs_err": report["decode_kernel"]["worst_abs_err"],
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
        "work": f"one bf16 decode step of h2o-danube-3-4b's serving cell: {row['shape'][0]} "
                f"launches at (B, S, H_kv, G, D) = {tuple(row['shape'][1:])}, pos 680 with "
                f"the serving mix's left padding ({row['valid_slots_per_row']:.1f} valid slots "
                f"a row); library: scaled_dot_product_attention with the boolean mask and "
                f"enable_gqa",
        "per_step": {f"{arch}: {name}": {key: r[key] for key in (
            "shape", "chunk", "splits", "valid_slots_per_row", "ms", "bound_ms", "bound_by",
            "plain_ms", "library_ms")} for arch, rows in t.items() for name, r in rows.items()},
    }


# phase 23: each MoE serving cell's model and its MoE layers at decode (64 rows), and
# one prefill slice: deepseek-serve-b64's 64 x 512 prefill, a few layers of it
MOE_CELLS = {"deepseek-moe-16b": 27, "deepseek-v2-lite": 26}
MOE_ROWS = 64
MOE_PREFILL = ("deepseek-moe-16b", (64, 512), 4)


def moe_layers(cfg, dev: torch.device, gen: torch.Generator, layers: int, b: int, s: int):
    """bf16 x (b, s, d) and, for each of ``layers`` MoE layers of ``cfg`` with
    weights of its own (``moe_params``' draws, no shared experts), the
    routing its router makes of x as ``moe`` makes it (the top-k experts
    and gates, (T, k) views), and the pair list of that routing
    (``moe.pairs``): (x, params, routes, pair lists, group, capacity)."""
    cfg = dataclasses.replace(cfg, num_shared_experts=0)
    e, k = cfg.num_experts, cfg.top_k
    g = min(cfg.moe_group_size, s)
    n = b * s // g
    cap = moe_layer._capacity(g, e, k, cfg.capacity_factor)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).bfloat16()
    ps, routes, pairs = [], [], []
    for _ in range(layers):
        p = moe_layer.moe_params(gen, cfg, torch.bfloat16, dev)
        _, gate_vals, idx = moe_layer._route(p, x.reshape(n, g, -1).float(), cfg)
        ps.append(p)
        routes.append((idx.reshape(n * g, k), gate_vals.reshape(n * g, k)))
        pairs.append(moe_layer.pairs(idx, gate_vals, e, cap))
    return x, ps, routes, pairs, g, cap


def moe_library(x2: torch.Tensor, p: dict, pairs: tuple):
    """The batched cuBLAS yardstick of one layer: each expert's rows
    gathered into an (E, R, d) block padded to the most rows an expert has
    (made here, outside the timing), and the call that runs its SwiGLU
    with three ``torch.bmm``."""
    rows, offsets = pairs[0], pairs[1]
    bounds = offsets.tolist()
    r = max(hi - lo for lo, hi in zip(bounds, bounds[1:]))
    xe = x2.new_zeros((len(bounds) - 1, r, x2.shape[1]))
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        xe[e, :hi - lo] = x2[rows[lo:hi].long()]

    def call():
        gate = torch.bmm(xe, p["w_gate"]).float()
        up = torch.bmm(xe, p["w_up"]).float()
        return torch.bmm((torch.nn.functional.silu(gate) * up).bfloat16(), p["w_down"])
    return call


def moe_time(tag: str, cfg, dev: torch.device, gen: torch.Generator, layers: int, b: int,
             s: int) -> dict:
    """Phase 23 at one shape: layer 0 checked against the plain version and
    rerun bitwise, then the layers timed (module docstring)."""
    x, ps, routes, pairs, g, cap = moe_layers(cfg, dev, gen, layers, b, s)
    x2 = x.reshape(b * s, -1)
    e, d, ff = ps[0]["w_gate"].shape

    def kern(i):
        return kmoe.moe_experts(x2, ps[i]["w_gate"], ps[i]["w_up"], ps[i]["w_down"], *routes[i],
                                g, cap)

    def layer(i):
        return moe_layer.moe(ps[i], x, cfg)[0]

    kmoe.reset_launches()
    with torch.no_grad():
        out, again = kern(0), kern(0)
        ref = moe_plain(x2, ps[0]["w_gate"], ps[0]["w_up"], ps[0]["w_down"], *routes[0], g, cap)
        routed = layer(0)
    torch.cuda.synchronize()
    err = row_err(out, ref)
    if kmoe.launches != 3 or not torch.equal(out, again) or not torch.equal(
            routed.reshape(b * s, d), out):
        raise AssertionError(f"M1 {tag}: {kmoe.launches} launch sets for 3 calls, or two calls "
                             f"disagree, or the layer's routed route is not the kernel's")
    if err["row_rel"] > ROW_TOL[torch.bfloat16] or not err["finite"]:
        raise AssertionError(f"M1 {tag}: worst row {err['row_rel']:.3g} from the plain version")
    offsets = torch.stack([pr[1] for pr in pairs]).long()
    counts = offsets[:, 1:] - offsets[:, :-1]
    kept = int(offsets[:, -1].sum())
    used = int((counts > 0).sum())
    nbytes = used * 3 * d * ff * 2 + layers * 2 * x2.numel() * 2
    flops = kept * 6.0 * d * ff
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    libs = [moe_library(x2, ps[i], pairs[i]) for i in range(layers)]
    calls = [(i,) for i in range(layers)]
    fns = {"ms": kern, "layer_ms": layer, "plain_ms": layer, "library_ms": lambda i: libs[i]()}
    t = {}
    with torch.no_grad():
        for key in ("ms", "layer_ms", "plain_ms", "library_ms", "library_ms", "plain_ms",
                    "layer_ms", "ms"):
            with (mock.patch.object(moe_layer.moe_experts, "takes", lambda *a: False)
                  if key == "plain_ms" else contextlib.nullcontext()):
                t.setdefault(key, []).append(layers * graph_ms(fns[key], calls))
    row = {"layers": layers, "rows": b * s, "experts": e, "top_k": cfg.top_k, "d": d, "ff": ff,
           "tile": kmoe.tile_for(b * s * cfg.top_k, e), "kept_pairs": kept,
           "dropped_pairs": layers * b * s * cfg.top_k - kept, "experts_used": used,
           **{key: min(v) for key, v in t.items()}, "runs": t,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
           "operations", **err}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log(f"[moe-kernel] M1 {tag}: {layers} layers x {b * s} rows, top-{cfg.top_k} of {e}, d {d}, "
        f"ff {ff} ({row['tile']} tiles; {kept} kept pairs, {row['dropped_pairs']} dropped, "
        f"{used} experts used): {row['ms']:.3f}ms, bound {row['bound_ms']:.3f}ms "
        f"({row['bound_by']}, {row['bound_share']:.1%}); the routed layer {row['layer_ms']:.3f}ms, "
        f"the dense route {row['plain_ms']:.3f}ms, batched cuBLAS {row['library_ms']:.3f}ms; "
        f"layer 0 worst row {err['row_rel']:.3g} from the plain version, rerun bitwise")
    del x, ps, routes, pairs, libs
    torch.cuda.empty_cache()
    return row


def phase_moe_kernel(dev: torch.device) -> dict:
    """Phase 23 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    timings = {f"{arch}: decode": moe_time(f"{arch} decode", get_config(arch), dev, gen, layers,
                                           MOE_ROWS, 1)
               for arch, layers in MOE_CELLS.items()}
    arch, (b, s), layers = MOE_PREFILL
    timings[f"{arch}: prefill slice"] = moe_time(f"{arch} prefill slice", get_config(arch), dev,
                                                 gen, layers, b, s)
    return {"timings": timings, "worst_row_rel": max(r["row_rel"] for r in timings.values())}


def moe_row(report: dict) -> dict:
    """M1's entry: deepseek-serve-b64's decode step (27 MoE layers, 64
    rows); the main path's launches (the served MoE models: warmup and
    captures, each eager ``generate``, one decode step) and each timed
    shape beside it."""
    t = report["moe_kernel"]["timings"]
    row = t["deepseek-moe-16b: decode"]
    served = {f"zoo_{a}": z["serve"] for a, z in report["zoo_serve"].items()}
    served.update({f"big_{a}": report["big"][a]["serve"] for a in BIG_ARCHS})
    by_path = {}
    for key, srv in served.items():
        by_path[f"{key}_warmup_and_captures"] = srv["path"]["m1_launches"]
        by_path[f"{key}_eager_per_generate"] = srv["eager_runs"][0]["m1_launches"]
        by_path[f"{key}_decode_step"] = srv["step_device_ms"]["m1_launches"]["decode"]
    by_path["moe_kernel_checks"] = 3 * len(t)
    zoo = report["zoo_serve"]["deepseek-moe-16b"]["serve"]
    return {
        "name": "moe_experts",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_experts/csrc/moe_experts.cu",
        "replaces": None,
        "launches": zoo["path"]["m1_launches"] + zoo["eager_runs"][0]["m1_launches"],
        "launches_by_path": by_path,
        "routes": {"grouped": by_path},
        "max_abs_err": max(r["max_abs_err"] for r in t.values()),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
        "work": f"the routed experts of deepseek-serve-b64's decode step: {row['layers']} MoE "
                f"layers of {row['rows']} rows, top-{row['top_k']} of {row['experts']} experts, "
                f"d {row['d']}, ff {row['ff']}; plain: the dense route's layer; library: "
                f"batched cuBLAS on the gathered rows",
        "per_shape": {name: {key: r[key] for key in (
            "layers", "rows", "tile", "kept_pairs", "experts_used", "ms", "layer_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share")} for name, r in t.items()},
    }


def examples_launches(ex: dict) -> dict:
    """``examples_routes`` summed over the routes."""
    return {key: sum(r.values()) for key, r in examples_routes(ex).items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    report, seconds = {}, {}

    def run(key, phase, *args):
        t0 = time.perf_counter()
        report[key] = phase(*args)
        seconds[key] = time.perf_counter() - t0
        log(f"[time] {key} took {seconds[key]:.1f}s")

    run("build", phase_build)
    gen = torch.Generator(device=dev).manual_seed(0)
    run("kernel", phase_kernel, dev, gen)
    run("model", phase_model, dev)
    run("serve", phase_serve, dev)
    run("flash_kernel", phase_flash_kernel, dev, gen)
    run("long_prefill", phase_long_prefill, dev, report["flash_kernel"])
    run("plan_sweep", phase_plan_sweep, dev, gen)
    run("planned_serve", phase_planned_serve, dev)
    run("planned_prefill", phase_planned_prefill, dev)
    run("conformance", phase_conformance, dev)
    run("calibrate", phase_calibrate, dev)
    run("obs_drift", phase_obs_drift, dev, report["calibrate"]["profile_path"])
    run("profiler", phase_profiler, dev)
    run("train", phase_train, dev, gen)
    probe_job = start_probe()
    try:
        run("zoo_serve", phase_zoo_serve, dev)
        run("families", phase_families, dev, gen)
        run("zoo_train", phase_zoo_train, dev)
        run("sharded_train", phase_sharded_train, dev)
        run("roofline", phase_roofline, dev, report, probe_job)
    finally:
        stop_probe(probe_job)
    run("big", phase_big, dev, gen)
    run("examples", phase_examples, dev, gen)
    run("decode_kernel", phase_decode_kernel, dev)
    run("moe_kernel", phase_moe_kernel, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    step = decode_step_row(report["kernel"]["timings"])
    unembed_ms = {r["what"]: r["ms"] for r in report["kernel"]["layouts"]["rows"]
                  if r["what"].startswith("unembed")}
    kernels = [{
        "name": "zorder_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/zorder_matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:46",
        # counted where the wrapper launches: the main path's warmup and
        # captures (a graph replay launches nothing from Python)
        "launches": report["serve"]["path"]["launches"],
        "launches_by_path": {"serve": report["serve"]["path"]["launches"],
                             "serve_graph_replays_per_generate":
                                 report["serve"]["runs"][0]["launches"],
                             "serve_eager_per_generate": report["serve"]["eager_runs"][0]["launches"],
                             "long_prefill": report["long_prefill"]["launches"]["K1"],
                             "planned_serve": report["planned_serve"]["path"]["launches"],
                             "planned_serve_graph_replays_per_generate":
                                 report["planned_serve"]["runs"][0]["launches"],
                             "planned_prefill": report["planned_prefill"]["k1_launches"],
                             "plan_sweep": report["plan_sweep"]["k1_launches"],
                             "conformance": report["conformance"]["k1_launches"],
                             "calibrate_and_tune": report["calibrate"]["k1_launches"],
                             "tuned_planned_serve_graph_replays_per_generate":
                                 report["calibrate"]["tuned_serve"]["runs"][0]["launches"],
                             "profiled_planned_forward":
                                 report["profiler"]["planned"]["k1_launches"],
                             # a captured training run: counted on the host (its
                             # eager first step and the capture), its graph's
                             # replays, and the same run eager
                             **{f"{key}{part}": sum(routes.values())
                                for key, part, routes in train_route_rows(report["train"])},
                             "train_check_fp32": sum(report["train"]["check"]["launches"].values()),
                             **{f"zoo_{arch}_{leg}": v
                                for arch, z in report["zoo_serve"].items()
                                for leg, v in (("serve", z["serve"]["path"]["launches"]),
                                               ("serve_graph_replays_per_generate",
                                                z["serve"]["runs"][0]["launches"]),
                                               ("serve_eager_per_generate",
                                                z["serve"]["eager_runs"][0]["launches"]),
                                               ("check_fp32", z["model"]["launches"]))},
                             **family_launches(report["families"]),
                             **zoo_train_launches(report["zoo_train"]),
                             **sharded_launches(report["sharded_train"]),
                             "roofline": report["roofline"]["launches"]["K1"],
                             **big_launches(report["big"]),
                             **examples_launches(report["examples"])},
        "routes": {"serve": report["serve"]["path"]["routes"],
                   "serve_graph_replays": report["serve"]["runs"][0]["routes"],
                   **{f"serve_{step}_step": r
                      for step, r in report["serve"]["step_device_ms"]["routes"].items()},
                   "long_prefill": report["long_prefill"]["k1_routes"],
                   "planned_serve": report["planned_serve"]["path"]["routes"],
                   "planned_serve_graph_replays": report["planned_serve"]["runs"][0]["routes"],
                   "planned_prefill": report["planned_prefill"]["k1_routes"],
                   "conformance": report["conformance"]["k1_routes"],
                   "calibrate_and_tune": report["calibrate"]["k1_routes"],
                   "tuned_planned_serve_graph_replays":
                       report["calibrate"]["tuned_serve"]["runs"][0]["routes"],
                   "tuned_planned_serve_eager":
                       report["calibrate"]["tuned_serve"]["eager_runs"][0]["routes"],
                   **{f"{key}{part}": routes
                      for key, part, routes in train_route_rows(report["train"])},
                   "train_check_fp32": report["train"]["check"]["launches"],
                   **{f"zoo_{arch}_{leg}": v
                      for arch, z in report["zoo_serve"].items()
                      for leg, v in (("serve", z["serve"]["path"]["routes"]),
                                     ("serve_graph_replays", z["serve"]["runs"][0]["routes"]),
                                     *((f"serve_{step}_step", r) for step, r in
                                       z["serve"]["step_device_ms"]["routes"].items()))},
                   **family_routes(report["families"]),
                   **zoo_train_routes(report["zoo_train"]),
                   **sharded_routes(report["sharded_train"]),
                   "roofline": report["roofline"]["launches"]["K1_routes"],
                   **big_routes(report["big"]),
                   **examples_routes(report["examples"])},
        "max_abs_err": max(report["kernel"]["worst_main_abs_err"],
                           report["train"]["kernel"]["worst_abs_err"],
                           *(z["serve"]["measured"]["k1"]["check"]["worst_abs_err"]
                             for z in report["zoo_serve"].values()),
                           *(report["families"][key]["k1"]["check"]["worst_abs_err"]
                             for key in (ENCDEC_ARCH, "hybrid_prefill")),
                           *(report["families"][a]["measured"]["k1"]["check"]["worst_abs_err"]
                             for a in SERVED_FAMILIES),
                           *(r["check"]["max_abs_err"]
                             for r in report["flash_kernel"]["projections"]),
                           *(report["zoo_train"][a]["k1"]["worst_abs_err"]
                             for a in (*ZOO_TRAIN_RUNS, MOE_TRAIN_ARCH)),
                           report["sharded_train"]["path"]["k1"]["worst_abs_err"],
                           *(report["big"][a]["serve"]["measured"]["k1"]["check"]["worst_abs_err"]
                             for a in BIG_ARCHS),
                           *(r["check"]["max_abs_err"] for r in report["big"]["prefill"]["projections"]),
                           report["long_prefill"]["k1_check"]["worst_abs_err"],
                           report["big"]["prefill"]["k1_check"]["worst_abs_err"],
                           *(r["max_abs_err"]
                             for r in report["examples"]["quickstart"]["k1"].values())),
        "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": step["library_ms"],
        "work": "one bf16 decode step at batch 4: 16 layers x 7 projections",
        "per_route": {
            "thin: decode step, M = 4 (112 layer products; the unembedding apart)":
                {**step, "unembedding_ms": unembed_ms["unembed decode"]},
            "thin: serving prefill, M = 64 (112 layer products)":
                decode_step_row(report["kernel"]["timings"], 64),
            **layout_k1_rows(report["kernel"]["layouts"]),
            "wide: danube forward, M = 32768 (168 layer products; the unembedding apart)":
                {**report["long_prefill"]["k1_per_forward"],
                 "unembedding_ms": report["profiler"]["unembed_alone"]["k1_ms"]},
            f"wide: Llama training step, {TRAIN_TOKENS} tokens (336 layer products: forward, "
            f"dA, dB; the unembedding apart)":
                {**{key: report["train"]["kernel"]["per_step"][key]
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                 "unembedding_ms": unembed_ms["unembed train forward"]},
            **{f"thin: {arch} decode step, M = 4 ({t['products']} products)":
               {**{key: t[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by")},
                "profiled_in_the_step_ms": z["serve"]["measured"]["profile"]["k1_ms"]}
               for arch, z in report["zoo_serve"].items()
               for t in (z["serve"]["measured"]["k1"]["decode_step"],)},
            **family_k1_rows(report["families"]),
            **zoo_train_rows(report["zoo_train"]),
            **sharded_rows(report["sharded_train"]),
            **big_k1_rows(report["big"])},
    }, flash_row(report), decode_row(report), moe_row(report)]
    report.update(kernels=kernels, nvidia_smi=smi, seconds=time.perf_counter() - t_all,
                  phase_seconds=seconds, device=torch.cuda.get_device_name(0))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] all phases passed in {report['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
