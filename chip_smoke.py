#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Every phase prints one JSON line; any failed check or error exits non-zero
and prints no result. Phases:

  1. build   — ``nvidia-smi`` name and power limit, then ``nvcc`` builds the
               kernels from ``src/repro_torch/csrc`` (time, ptxas summary).
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               padded buffers the engine hands it: the SAE's canonical
               packed ``enc1/w`` (96 x 10112) and paper Fig. 2's 1000 x 10000
               and 10000 x 1000 (padded to 1000 x 10112 and 10000 x 1024).
               colstats: sums to rtol 1e-5, maxes exact; mu_solve with a
               vector theta and a partial active-block count: active sets
               equal, mu to atol 1e-5 * colmax; clip_apply: bit-equal in f32
               and bf16. Device times (a CUDA graph of back-to-back calls
               between CUDA events, warm L2) of kernel, plain version and,
               for clip_apply, ``torch.clamp`` as a yardstick; at the SAE
               shape also the kernels' times with L2 flushed, as in 2b. Then
               the Newton loop kernel (newton_loop, one cooperative launch a
               projection) against its plain version, the host loop over
               the same solves (pass 2 cold, later ones warm), on the
               engine's state after pass 1 of phase 3's projection at each
               shape: theta to 1e-6, newton_iters equal or one apart on a
               last fp-rounding step (thetas within 4 ulps, work_cols then
               larger by that step), the alive prefix and mu's support
               equal, mu within 1e-5 * colmax, a rerun bit-equal; the
               kernel's device ms (CUDA graph) L2-warm and flushed, the
               empty loop's (``scripts/torch_kernel_variants.py``'s
               newton_loop_empty, built beside the kernels: the same grid
               and grid.sync() count with nothing solved, the floor of any
               one-launch loop) and the plain loop's wall ms (it syncs once
               a step).
  2b. fused  — the fused step's two kernels (adam_colstats, adam_clip_apply)
               against their plain versions on the leaves the fused step
               hands them: the SAE's ``enc1/w`` (10000 x 96, max axis 1),
               paper Fig. 2's 1000 x 10000 (max axis 0) and a (4, 512, 384)
               stack; f32 and bf16 params, f32 and bf16 moments, with and
               without a mask, sum |u| / clip and sum u^2 / scale. Moments
               and pass-2 output bit-equal, column maxima exact, column sums
               to rtol 1e-6; pass 2 at the identity level reproduces pass
               1's column maxima bit for bit; a rerun is bit-equal. Device
               times with L2 warm and with L2 flushed (a 256 MB write before
               every call; the flush's own time is subtracted).
  3. project — ``project_l1inf_kernel`` against ``project_l1inf_newton`` at
               those shapes (atol 3e-4 * scale, rtol 3e-3; a rerun must be
               bit-equal; exactly one launch of each of colstats, mu_solve,
               newton_loop and clip_apply), with wall times per projection:
               the kernel engine must beat the Newton's. Reruns of the sort-
               based paths (fault C-7) must be bit-equal: project_l1inf_newton
               and project_l1inf_sorted at each shape, the weighted, Hoyer
               (reference), l1-ball and l2,1-ball projections at fig2_wide.
               Fault C-10: project_l1inf_sorted, the kernel engine and
               project_l1inf_newton against project_l1inf_heap (the paper's
               Algorithm 2, float64 on the host) at fig2_wide and fig2_tall,
               on the numpy U(0, 1) draw and on torch.rand's, at atol 3e-4
               * scale, rtol 3e-3. Then the Newton against the sort-based
               oracle on a small input.
  4. train   — the main path: 20 projected SAE steps at the paper's full
               synthetic width (10000 features, 96 hidden, batch 128; spec
               enc1/w l1inf radius 0.2 axis 1) through
               ``ProjectionEngine(solver="kernel").projected_update``, with
               every kernel's launch count read just around them; then the
               same 20 steps under ``solver="newton"`` (final params to
               atol 3e-4 * scale).
  4b. fused_train — this slice's main path: 20 projected SAE steps at the
               same width with ``norm="l12"`` (radius 10, paper Table 1's
               eta) through ``solver="fused"``, then ``solver="newton"``;
               the same for ``norm="bilevel"`` (radius 0.1). Each fused run
               launches adam_colstats and adam_clip_apply once a step and
               no mu_solve; params within 1e-5 * scale of Newton. Then one
               bilevel run with ``solver="kernel"``: colstats and clip_apply
               launched, mu_solve not.
  5. train_sae — ``train_sae`` as the JAX package runs it (``"fused"``, so
               Newton for plain l1,inf), 2 epochs of each descent.
  5b. train_sae_table1 — ``train_sae`` with ``norm="l12"`` (radius 10) and
               ``norm="l1inf_masked"`` (radius 0.1), paper Table 1's two
               other rows, 2 epochs of each descent at lr 2e-3.
  5c. sae_serve — phase 5's l1,inf result compacted (``compact_sae``) and
               served through ``make_serve_step`` on the 200 full-width
               test rows: ``sel`` equal to the support of the structural
               zeros, z and the selected reconstruction within 1e-5 of
               dense ``sae_apply`` times the outputs' scale
               (``tests/test_sae_serve.py``'s atol), a rerun bit-equal;
               ``refresh_model`` (values x 1.5) and ``recompact_model``
               (one more dead feature) keep every shape and still match
               dense. J, J/d and wall ms per served batch, compact and
               dense.
  6. attn_kernels — the flash attention kernel against its plain version
               (f32 atol = rtol 2e-5, bf16 3e-2: the JAX suite's tolerances)
               at hymba-1.5b's prefill (B 2, S 2048, 25 heads, 5 KV heads,
               hd 64, causal, window 1024) in f32 and bf16, and at small
               shapes: causal, non-causal, tail lengths, hd 80 / 128 / 256
               with and without a window; a rerun bit-equal. At the hymba
               shape, in f32 (CUDA cores) and bf16 (tensor cores): device
               ms (L2 warm and flushed), the plain version's ms, and
               ``scaled_dot_product_attention`` with the window mask and
               ``enable_gqa`` as the library yardstick. Fault C-6: an f32
               input that requires grad gets its gradient through the
               forward and backward kernels (one launch of each, equal to
               autograd through the plain forward within 2e-5 of its
               scale), and so does bf16 (through the bf16 backward
               kernel, within 3e-2, for q, k and v each). Fault
               C-9: head_dim 32 runs zero-padded on the hd-64 kernel
               (against the plain version), head_dim 264 raises.
  6b. attn_bwd — the flash backward kernel against its plain version, f32,
               on the forward kernel's out and lse (out within 2e-5 of
               its scale and lse against the plain forward's), at
               stablelm-3b's training attention
               (BH 32, S 2048, hd 80, causal) and hymba-1.5b's prefill (BH
               50, hd 64, window 1024, GQA 5): dq, dk, dv within 2e-5 of
               each gradient's scale, a rerun bit-equal; device ms warm and
               flushed, the plain version's ms, the bound (five products
               over the unmasked pairs) and the backward of
               ``scaled_dot_product_attention`` in f32 (forward + backward
               minus forward, CUDA events around eager calls); from one
               traced call the device ms of the backward's two launches
               (delta, main), and the main kernel's CTAs an SM. At
               stablelm's shape also the f32 forward with lse, as training
               calls it: device ms warm and flushed, plain ms, bound, SDPA's
               forward (the kernels line's second flash_attention_fwd
               row).
  6e. attn_bwd_bf16 — the bf16 backward kernel (flash_attention_bwd_bf16,
               wgmma and TMA at these head dims) the same way at
               stablelm-3b's training shape and hymba-1.5b's (B 1 x S
               2048, the shape phase 16 trains at): dq, dk, dv within 1e-2
               of each gradient's scale of the plain version at the
               kernel's tiles (kernel.bwd_tiles), a rerun bit-equal, one
               launch a call counted under bf16; the bf16 forward's lse
               against the plain forward's; device ms warm and flushed,
               plain ms, the bound (five products at 989 TFLOP/s), SDPA's
               bf16 backward, the earlier design's ms (the first,
               mma.sync kernel, BWD_BF16_EARLIER_MS), the delta and main
               launches' device ms, the main kernel's registers (at
               launch and in its consumer warpgroups), local memory,
               shared memory and CTAs an SM (at every kernel head dim
               too); the bf16 forward with and without lse at stablelm's
               shape.
  6c. attn_zoo — the flash kernels at the shapes the new block kinds give
               them, f32: whisper-small's encoder self attention (BH 24,
               1500 x 1500, hd 64, full) and decoder cross attention (448
               x 1500), llama-3.2-vision's cross attention (BH 64, 2048 x
               1600, hd 128) and deepseek-v2's MLA (BH 128, S 2048, causal,
               q/k hd 192 on the hd-256 kernel, v 128 zero-padded to 192,
               as ``flash_attention`` pads it): forward and backward
               against their plain versions (2e-5 of the scale), reruns
               bit-equal, the padded columns of out exact zeros; device ms
               warm and flushed, the plain versions' ms, the bound on the
               true head dims (q . k at 192, p . v at 128), the share of
               products the padding adds, and SDPA's forward and backward
               on the true dims (its v head dim as it is).
  7. ssd_kernels — the SSD kernel against its plain version (atol = rtol
               2e-4) and against the naive recurrence ``ssd_ref`` (2e-4 of
               the output's scale), y and final state, at hymba-1.5b's shape
               (BH 100, S 2048, P 64, N 16, chunk 64) with dt in [3, 20], as
               the reference's full-width weights give (ROADMAP C-5), and at
               mamba2-370m's (BH 64, N 128) with large and small dt; no NaN;
               a rerun bit-equal; y and the state bit-equal to the plain
               version (checked for f32, reported for all); a small bf16
               case. Times as in phase 6 (no single PyTorch call computes
               SSD: library null), and each of the three launches' device
               ms from a one-call profiler trace; the forward at a reduced
               shape (chunk 8, P 8, N 8: zero-padded to the kernels' P 64
               and N 16, C-9) bit-equal to plain. Fault C-6: an f32 input
               that requires grad gets its gradient through SSDFunction
               (one forward and one backward launch), equal to the plain
               backward within 2e-4 of its scale; bf16 refuses.
  7b. ssd_bwd — the SSD backward kernel against its plain version and
               against float64 autograd through ``ssd_ref`` at
               hymba-1.5b's (BH 50, S 2048, P 64, N 16, chunk 64) and
               mamba2-370m's (BH 32, N 128) training shapes, B 1, each with
               dt in [3, 20] (the reference's full-width init, where its
               gradient is NaN: C-11) and in [0.05, 0.6]: every gradient
               finite and within 2e-4 of its scale of both, a rerun
               bit-equal; device ms warm and flushed, the plain version's
               ms, the bound (the kernel's products, or its bytes), each
               of the four launches' device ms from one traced call, and
               the first two launches' registers and CTAs an SM.
  7c. block_bwd — one block's backward on the card against the CPU, for a
               ``global``, an ``ssm`` and a ``hybrid`` block at full width
               (stablelm-3b's, mamba2-370m's and hymba-1.5b's), and for
               whisper-small's ``enc`` and ``dec_cross``, llama-3.2-
               vision's ``cross``, deepseek-v2's ``mla`` (160 experts) and
               mixtral-8x7b's ``local`` with its MoE MLP, B 1 x S 2048,
               f32, none cut (``models/blockcheck.py``): the same input
               (and, for the cross-attention kinds, the same memory of the
               model's length: 1500 encoder positions, 1600 image tokens)
               and the same upstream gradient through the block's two
               parts (``block_apply_full``'s) with
               ``torch.autograd.grad(..., grad_outputs=...)``, so no depth
               amplifies the rounding;
               every parameter's, the input's and the memory's gradient
               finite and within twice its noise floor (a card backward
               from PERTURB-perturbed params, the same run) of the CPU's
               (plain versions). A MoE block's routing (each token's top-k
               experts and the capacity keep mask) must be equal in the
               three runs first; a flip fails the check and the line
               reports the smallest gap between a token's k-th and
               (k+1)-th gate. Each card backward launches the block's
               flash and SSD kernels once each way. Then stablelm-3b's
               ``global`` and hymba-1.5b's ``hybrid`` block in bf16 (block,
               input and upstream gradient bf16; the SSD in f32 as the
               model casts it; the floor at perturb 2^-8, about one bf16
               ulp of each parameter), every flash backward on bf16.
  8. lm_forward — this slice's main path: ``build(get_config("hymba-1.5b"))``
               at full width and depth (32 layers, 1.59 B params), params
               from ``Model.init`` in f32 and then bf16, ``forward`` on a
               (2, 2048) batch: logits finite, each kernel launched exactly
               32 times (counts reset just before, read just after), wall ms
               per forward, peak memory, a one-forward ``torch.profiler``
               trace (top device ops, device idle share, the two kernels'
               device ms and share); mamba2-370m at full config (48 SSD
               launches, the same trace); hymba at full width and depth
               2, B 1: the card's forward (kernels) against the same forward
               on CPU copies (plain versions), max |diff| within the model's
               noise floor (see PERTURB).
  9. lm_decode — depth 2, full width: a 1152-token prompt (longer than the
               1024 window) stepped through ``decode_step`` on the card, its
               logits against the forward's at every position, within the
               noise floor; full depth: a 64-token prompt the same way for
               B 2, then 8 greedy tokens, and one traced decode step.
 10. lm_compact — the compact-serving path: hymba-1.5b at full size, each
               hidden unit's w1 column scaled by one U(0, 1) factor shared
               by all layers (``lm_compact_params``), projected under its
               own specs (mlp/w1 and ssm/wx, radius 32, axis 0) through
               ``ProjectionEngine(solver="kernel")`` (every l1,inf kernel
               launched) and held to ``solver="newton"``'s projection
               (atol 3e-4 * scale, as phase 4) and to the radius (every
               slice's norm within 1e-4 of it); then ``compact_model``:
               ssm/wx skipped, 0 < live < m on mlp/w1. Each of the 32
               layers' MLP alone, compact against dense on one N(0, 1)
               input: within SERVE_TOL of the output's scale (f32 1e-5,
               bf16 5e-2: tests/test_sae_serve.py's). Forward (B 2, S 2048)
               in f32 and bf16, each kernel launched once a layer, logits
               finite, a rerun bit-equal, and decode of a 64-token prompt,
               compact against dense, at full depth and at the first 2
               layers. At depth 2 the distance is checked: f32 forward and
               decode within the run's noise floor (PERTURB's weight
               noise) and LM_MAX_REL of the logits' scale, bf16 within
               SERVE_TOL's 5e-2 of it. At full depth the model's noise
               floor is the logits' own scale, so the distance is reported
               beside the floor, not checked. Compaction ratio, wall ms of
               compact and dense, peak memory.
 10b. fleet_serve — the serving loop: ``FleetEngine`` (``serve/engine.py``)
               serving hymba-1.5b at full width, 8 of its 32 layers (f32,
               the reference's init) with 8 slots and max_seq 256, its
               decode step captured once into a CUDA graph over a cache
               written in place. (a) The dense engine under churn: 24
               requests from the seed (prompts 4-48 tokens, budgets 4-40,
               heavy-tailed) in three waves, one cancelled in flight; every
               completion equal to the same request served alone in an
               8-slot engine (a 1-slot engine would run GEMMs of another M;
               the cancelled one a prefix of it), the three shortest equal
               to an eager ``decode_step`` loop at width 8 (the graph
               against no graph). (b) The compacted engine: phase 10's
               projection (``solver="kernel"``) and ``compact_model``, 8
               requests, a ``refresh`` (values x 1.25) and a ``recompact``
               (one more w1 column dead) mid-flight; every completion
               equal to a solo run switching at the same local step. Per
               engine: one capture across the lifecycle (the solo engines'
               reloads included), the cache tensors' addresses unchanged
               from the first step to the last, allocated memory flat over
               50 steady steps, replays equal to steps; the graphed step's
               wall ms (median of the 50), one replay's device ms (CUDA
               events), the eager ``decode_step``'s wall ms at the same B,
               the device ms of ``decode_step`` (one cache copy) and
               ``decode_step_`` (in place) each captured alone, a ten-step
               profiler window (idle share, device calls, top ops), tokens
               a second, TTFT and per-token p50 / p99.
 11. lm_train — this slice's main path: ``train`` (``train/loop.py``) of
               stablelm-3b at full width, 8 of its 32 layers, f32,
               B 1 x S 2048 from ``LMBatcher(SyntheticLM(vocab,
               seed=1), 1, 2049)``, ten steps with
               ``proj_solver="kernel"``; the config's every_k 10 fires the
               projection at the tenth. Every loss finite; the flash
               forward launched twice a layer a step (remat recomputes
               it) and the backward once, the l1,inf kernels once in the
               run; every projected w1 slice's l1,inf norm within 1e-4 of
               the radius 48. Step ms, the median of steps 2-9, peak
               memory, and one traced step more (device idle share, top
               device ops, the flash kernels' share). Then one step more
               through ``build_accum_step`` with an engine whose specs
               take every_k 1 and which keeps the weights it projects: the
               l1,inf kernels launched once each, the slices within the
               radius, and the kernel projection held to
               ``solver="newton"``'s on those weights (atol 3e-4 * scale,
               as phase 4).
 11b. lm_train_cpu — one ``build_accum_step`` step of stablelm-3b at full
               width, depth 2, B 1 x S 2048, f32, from the same params and
               batch on the card (flash kernels, remat, the in-place Adam)
               and on CPU copies (plain versions). The loss within twice
               the logits' noise floor (the mean cross-entropy moves at
               most twice as far as the logits' max-norm); each leaf's
               Adam moments (the step's gradients: mu = (1 - b1) g at the
               first step; no global-norm clip, whose one scale would
               tie every leaf to the worst-conditioned ones) within the
               floor of a card step from the PERTURB-perturbed params;
               every param within lr |u_card - u_cpu| plus f32 rounding of
               the CPU's, u Adam's update direction from each run's
               moments (float64). Flash launched twice a layer forward
               and once backward.
 12. lm_resume — stablelm-3b at full width, depth 1, B 1 x S 512, every_k
               2: six steps uninterrupted, three steps and a checkpoint,
               a resume to six; params, Adam moments and theta bit-equal
               to the uninterrupted run's, losses equal. One checkpoint's
               size, save and restore seconds. The checkpoints live in a
               temporary directory under build/, removed at the end.
 13. lm_train_ssm — this slice's main path: ``train`` of hymba-1.5b at
               full width, 8 of its 32 layers, f32, remat,
               B 1 x S 2048, ten steps with ``proj_solver="kernel"`` (every_k
               10: the projection of mlp/w1 and ssm/wx fires at the tenth),
               then mamba2-370m at full width (8 of 48 layers, N 128) the same
               way. Every loss finite; each step launches the SSD and flash
               forwards twice a layer (remat), their backwards once, the
               l1,inf kernels once in the run; every projected slice within
               1e-4 of its radius; step ms, peak memory, one traced step
               more (idle share, top device ops, the SSD and flash
               kernels' share). Then one ``build_accum_step`` step of
               hymba-1.5b at depth 2 on the card against the CPU, as 11b.
 14. zoo_encdec — whisper-small at full size (12 encoder and 12 decoder
               layers, 0.24 B params), the reference's init, B 2, 1500
               frames, 448 tokens: forward in f32 and bf16, logits finite,
               the flash forward launched 12 times at each of 1500 x 1500
               (full), 448 x 448 (causal) and 448 x 1500 (cross); prefill
               ms, peak memory, a one-forward trace (flash share). B 1,
               cut to 6 + 6 and to 2 + 2 layers, f32: every block of the
               forward fed the card's input to it on the CPU too, within
               FLOOR_FACTOR times its own noise floor (PERTURB), and what
               lies between the blocks (positions, norms, the memory,
               embedding and unembedding) within GLUE_REL of its scale;
               the whole model on the card, on the CPU and perturbed on
               each (at this init the floor is a third to three quarters
               of the logits' scale, C-5): at the cut the encoder's output
               within FLOOR_FACTOR times its floor and the logits' median
               within FLOOR_FACTOR times the floor's, whole reported only;
               ``decode_step`` over the first 64 positions, each layer's
               ck / cv filled from the encoder's memory through its cross
               wk / wv, against the forward: at the cut within the floor
               and LM_MAX_REL of the logits' scale, whole reported only.
               One ``Model.loss`` backward at full size (B 2, remat):
               loss and every gradient finite, the flash backward launched
               36 times (the forward 72). Then llama-3.2-vision-90b at full
               width cut to one cycle of its pattern (4 global + 1 cross
               layer, 6.50 B params), B 1 x S 2048, 1600 image tokens:
               forward in f32 and bf16 (launches by shape: 4 causal 2048 x
               2048, 1 full 2048 x 1600), decode over 64 positions with
               the cross cache filled from the image embeddings, against
               the forward within the noise floor (measured last, with the
               params perturbed in place).
 15. zoo_moe — mixtral-8x7b at full width: depth 4 (6.07 B params), B 1
               x S 2048, forward in f32 and bf16 with its MoE auxiliaries
               (lb_loss, z_loss, dropped_frac); ``train`` at depth 2 (3.16
               B params), f32, remat, B 1 x S 2049, ten steps with
               ``proj_solver="kernel"``: its own moe/w1 l1,inf spec (radius
               64, every_k 10) fires at the tenth on the stacked expert
               leaf (2, 8, 4096, 14336), every slice within 1e-4 of the
               radius; one step more whose engine projects and keeps the
               leaf, held to ``solver="newton"`` (atol 3e-4 * scale);
               losses finite, flash launches, step ms, peak memory. Then
               deepseek-v2-236b at full width, depth 2 (8.99 B params, 160
               experts, top-6, 2 shared), B 1 x S 2048: forward in f32 and
               bf16 (MLA through flash at hd 192 with v 128, 2 launches),
               decode over 64 positions with ``mla_absorb`` off and on,
               each against the forward and each other within the noise
               floor. Last, reduced mixtral-8x7b and deepseek-v2 behind
               ``FleetEngine`` (3 slots, 7 requests, a refresh
               mid-flight): one capture, replays equal to steps, tokens
               equal to the CPU engine's.
 16. lm_train_bf16 — hymba-1.5b at full width (8 of 32 layers) trained in
               bf16 with f32 Adam moments through the production step
               (``launch.steps.build_train_step``), B 1 x S 2048, from the
               seed-0 init in each run: two steps under remat "dots", then
               ten under "full" (its first two losses and params bit-equal
               to "dots"'), the config's spec (every_k 10) projecting
               mlp/w1 and ssm/wx at the tenth step: each slice on its ball
               within one bf16 rounding and within 3e-4 of the scale,
               beyond one bf16 rounding, of the Newton on the weights it
               projected; every flash backward launch on bf16 (by dtype),
               the SSD's forward and backward each layer, no l1,inf or
               fused-step launch; three steps at every_k 1 (the extra
               Newton evaluations a step, launches); four in f32 at the
               same shape. Step ms, peak memory, and of one traced step
               more the idle share and flash's share of the device time.
 17. dist_projection — the distributed l1,inf projection, D ranks spawned
               on this one card in a gloo group (NCCL refuses two ranks on
               a GPU; gloo stages CUDA tensors through host memory, so no
               time here says anything of an interconnect), D 2 on a (2,
               1) and D 4 on a (2, 2) ("data", "model") mesh, over
               hymba-1.5b's projected leaves at full width (8 layers of
               mlp/w1 1600 x 5504 and ssm/wx 1600 x 3200, random from a
               seed), held against the single-device solves run here
               first and shared with the ranks (CUDA IPC): (a) the
               config's spec (l1,inf, radius 32, every_k 10) through
               solver="sharded" at step 10, the leaves row-sharded (FSDP):
               params within 1e-5, theta within 1e-6 of solver="newton",
               the Newton counts at most one apart; (b) bilevel and l1,2
               at every_k 1 (radius 0.05 x the first matrix's l1,inf
               norm), one projected_update through solver="fused_sharded"
               on column-sharded leaves against solver="fused": the same
               tolerances, Adam moments bit-equal, adam_colstats and
               adam_clip_apply launched on every rank; (c) the row-sharded
               leaves moved by one all-to-all each way, no all-gather
               (CommDebugMode); (d) per solve one (3, G) SUM, one (2, G)
               SUM per evaluation and one (G,) MAX (the phase's own record
               of dist.all_reduce); (e) compressed_psum of per-rank
               gradients the size of mlp/w1: "none" within (D - 1) eps of
               the magnitudes' sum of the exact sum, "int8" within D
               scale / 2, "topk" bit-equal to the rank-ordered
               index_add_, and the "none" sum as grad_reduce of a
               fused_sharded step bit-equal to the step on the summed
               gradient; (f) every run of (a)-(e) twice, bit-equal; (g)
               each rank's wall ms of the sharded solve and the fused
               step and the ms inside gloo collectives (the card
               synchronised around each), the two kernels' device ms on
               each rank's column block (ranks in turn).
 18. lm_train_mesh — the sharded production step: hymba-1.5b at full
               width, 8 of its 32 layers, in bf16 with f32 Adam moments
               (its leaves under the l1,2 ball at every_k 1, so
               fused_sharded launches its kernels) through launch.steps.build_train_step(model, mesh,
               rules) on a (2, 2) data x model mesh of 4 gloo ranks
               sharing the card, B 2 x S 2048, two steps: losses and every
               param piece within twice the same-run noise floor of the
               one-device step run here first (the larger of its distance
               from params x (1 + 2^-8 N(0, 1)) and from the batch as two
               microbatches), reruns bit-equal, every adam_colstats /
               adam_clip_apply launch against its plain version, the
               collectives by kind (dist.sharding's counts; every
               all_gather an FSDP gather; per plan one (3, G) SUM, one
               (2, G) SUM per Newton evaluation, one (G,) MAX), one
               prefill over the mesh within twice its floor; each rank's
               step ms, its share inside gloo, peak memory (each layer
               gathers its own weights over data on entry). deepseek-v2
               at depth 2 (B 1 x S 512, bf16) on (1, 2), on the
               reference's layout (MLA by heads, the routed experts over
               model, the shared experts column / row parallel): moe_impl
               "shardmap" and "gspmd" each within 2e-2 of one device; the
               same for mixtral-8x7b at depth 2 (its query heads and the
               experts' hidden units over model, "gspmd"). The
               GPipe ring (dist.pipeline) over 2 ranks, one full-width
               hymba MLP stage each, against the stages in order. Phases
               7 / 7b also hold the bf16-tile SSD kernels (ssd_bf16) to
               their plain versions at hymba-1.5b's and mamba2-370m's
               training shapes and run a depth-2 ssd_bf16 hymba-1.5b loss
               backward that launches them.
 19. lm_serve_mesh — serving over a mesh, 4 gloo ranks sharing the card,
               no hand-written kernel (the decode path is plain PyTorch in
               both packages; each call's launches of the LM kernels
               counted: none). (a) launch.steps.build_decode_step(model,
               mesh, rules) under the reference's decode rules on a (2, 2)
               mesh, hymba-1.5b and stablelm-3b at full width, 8 of their
               32 layers, f32 params, a bf16 cache filled from a seed below
               each row's first position, the cache in its pieces on the
               ranks (convert.cache_to_mesh) and written in place:
               hymba-1.5b decode_32k (B 16 of 128, S 32768), long_500k (B
               1, S 524288), stablelm-3b decode_32k (B 2, S 32768); two
               calls each (a per-row position vector with rows in the last
               slice, hymba's 1024-token window straddling a slice
               boundary and slices wholly masked; then a scalar), each
               held against the one-device step on the same cache run in
               the parent: logits within 1e-5 + 1e-5 of their scale or
               twice the noise floor (the same calls from params x (1 +
               1e-6 N(0, 1))), the written cache entries and the SSM
               state / conv tails within one bf16 ulp (f32 state: 1e-5
               relative) or twice their floor, every other position bit
               for bit unchanged; reruns bit-equal; per call one
               decode_max and one decode_sum per attention layer, one FSDP
               gather per data-split leaf and layer, the SSM's norm sum
               and conv gather per layer, stablelm's head-split wq / wo
               gathered over model per layer (the decode rules give the
               model axis to the cache's sequence), tensor-parallel sums,
               no other all_gather, no all-to-all; per-rank call ms and gloo
               seconds, cache bytes and peak memory a rank beside the
               one-device step's device ms. (b) FleetEngine(mesh=) on a
               (4, 1) data mesh, hymba-1.5b at 8 layers, B 8 (2 slots a
               rank), phase 10b's 24 requests in three waves with a cancel
               and its compacted model refreshed and recompacted
               mid-flight: every completion equal to the request served
               alone by a one-device engine of 2 slots (each rank checks a
               quarter), one capture per engine per rank, replays = steps,
               no collective in the captured step and one
               engine_out_gather a step outside it; replay ms beside the
               2-slot engine's, the exchange's ms a step. (c)
               make_serve_step(mesh=) of phase 5c's compact SAE over 4
               ranks against the one-device step, no collective.
 20. dryrun — launch/dryrun.py against the card, in a spawned process
               of its own after phase 16 (its fake process group meets no
               gloo group): (a) hymba-1.5b at phase 16's settings (bf16
               params, f32 moments, 8 of 32 layers, B 1 x S 2048, its
               l1,inf spec) on a (1, 1) mesh, traced by
               launch.steps.lower_cell on meta tensors as the one rank of
               a fake group, and the same step from the same builder on
               the card over a one-rank gloo group (a warm-up step, a
               measured one, one under FlopCounterMode, one traced), every
               step at a count that fires the every_k gate (the dry-run's
               rule): kernel launches by name (the wrappers' counts)
               equal to the dry-run's, FlopCounterMode's aten dot FLOPs
               equal to the dry-run's, its live-bytes peak within 20% of
               max_memory_allocated after reset_peak_memory_stats; the
               step's wall ms and device busy ms and the counted FLOPs'
               share of 989 TFLOP/s at each, beside the card's name and
               power limit. (b) hymba_15b train_4k, stablelm_3b
               decode_32k and deepseek_v2_236b prefill_32k at full size
               as rank 0 of 256 fake ranks, each "ok": dominant term,
               roofline_fraction, bytes a device against 80 GB. In (a)
               and (b) the arguments' bytes (their storages) equal the sum
               of their pieces' own bytes, printed beside them.
 21. the ``kernels`` line, the ``nvidia-smi`` line, and the result line.

TF32 is off for matmuls and cuDNN, so float32 products are full float32.
"""
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np

SHAPES = {"sae_enc1": (96, 10112), "fig2_wide": (1000, 10112),
          "fig2_tall": (10000, 1024)}
SOURCE = "src/repro_torch/csrc/l1inf.cu"
REPLACES = {"colstats": "src/repro/kernels/l1inf/kernel.py:58",
            "mu_solve": "src/repro/kernels/l1inf/kernel.py:136",
            "clip_apply": "src/repro/kernels/l1inf/kernel.py:198",
            # no pallas_call: the JAX engine's jax.lax.while_loop over
            # mu_solve, which the loop kernel runs as one launch
            "newton_loop": "src/repro/kernels/l1inf/ops.py:194"}
FUSED_SOURCE = "src/repro_torch/csrc/fused_step.cu"
FUSED_REPLACES = {
    "adam_colstats": "src/repro/kernels/fused_step/kernel.py:154",
    "adam_clip_apply": "src/repro/kernels/fused_step/kernel.py:196"}
# (L, R, C) leaf stack and whether the max axis is the trailing dim
FUSED_SHAPES = {"sae_enc1": ((1, 10000, 96), True),
                "fig2_wide": ((1, 1000, 10000), False),
                "stack": ((4, 512, 384), False)}
# enc1/w radius of each norm the SAE runs here (paper Table 1's eta for
# l12; scripts/torch_profile.py reads this table too)
RADIUS = {"l1inf": 0.2, "l12": 10.0, "bilevel": 0.1, "l1inf_masked": 0.1}
LM_SOURCE = {"flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
             "ssd_fwd": "src/repro_torch/csrc/ssd.cu",
             "flash_attention_bwd":
                 "src/repro_torch/csrc/flash_attention_bwd.cu",
             "flash_attention_bwd_bf16":
                 "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
             "ssd_bwd": "src/repro_torch/csrc/ssd_bwd.cu"}
LM_REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:78",
    "ssd_fwd": "src/repro/kernels/ssd/kernel.py:75",
    # no pallas_call: the jnp autodiff of chunked_attention, which the
    # reference runs in place of a TPU backward
    "flash_attention_bwd": "src/repro/models/attention.py:97",
    # the same autodiff on bf16 q, k, v (the reference's production dtype)
    "flash_attention_bwd_bf16": "src/repro/models/attention.py:97",
    # no pallas_call: the jnp autodiff of the chunked SSD scan
    "ssd_bwd": "src/repro/models/ssm.py:67"}
# the device kernels of each LM wrapper, by name in a profiler trace
LM_TRACE_NAMES = ("flash_f32_kernel", "flash_bf16_kernel",
                  "ssd_chunk_state_kernel", "ssd_state_scan_kernel",
                  "ssd_chunk_output_kernel")
SSD_BWD_TRACE_NAMES = ("ssd_bwd_state_kernel", "ssd_bwd_scan_kernel",
                       "ssd_bwd_chunk_kernel", "ssd_bwd_sum_kernel")
# (name, B, H, KV, S, head_dim, causal, window); the first is hymba-1.5b's
# prefill, the one the kernels line reports
ATTN_SHAPES = [("hymba_prefill", 2, 25, 5, 2048, 64, True, 1024),
               ("causal", 1, 8, 2, 512, 64, True, 0),
               ("non_causal", 1, 8, 8, 384, 64, False, 0),
               ("tail_hd80", 1, 8, 8, 200, 80, True, 0),
               ("tail_hd128", 1, 8, 2, 300, 128, True, 0),
               ("window_hd256", 1, 8, 4, 520, 256, True, 128)]
# the backward's shapes (name, B, H, KV, S, head_dim, causal, window): the
# first is stablelm-3b's training attention (the lm_train phase's, the one
# the kernels line reports), the second hymba-1.5b's prefill
BWD_SHAPES = [("stablelm_train", 1, 32, 32, 2048, 80, True, 0),
              ("hymba_prefill", 2, 25, 5, 2048, 64, True, 1024)]
# phase 6e's: stablelm-3b's training attention and hymba-1.5b's (B 1, the
# shape phase 16 trains it at)
BWD_BF16_SHAPES = [BWD_SHAPES[0], ("hymba_train", 1, 25, 5, 2048, 64, True,
                                   1024)]
# dq, dk, dv against the plain version, as a fraction of each gradient's
# largest entry: the forward's f32 tolerance; in bf16 (phase 6e) 1e-2: the
# kernel and the plain version round the same operands to bf16 and sum
# them in other orders, and each output is rounded to bf16 once (2^-9)
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# phase 6e: the first design of the bf16 backward (mma.sync), device ms
# warm at each shape in this script's last run of it (H100 80GB HBM3,
# 700 W), beside the redesigned kernel's
BWD_BF16_EARLIER_MS = {"stablelm_train": 0.8196, "hymba_train": 0.5653}
# the bf16 backward's device kernels, by name in a profiler trace
BWD_TRACE_NAMES = {"float32": ("bwd_delta_kernel", "bwd_main_kernel"),
                   "bfloat16": ("bwd_bf16_delta_kernel",
                                "bwd_bf16_main_kernel")}
# (name, B, heads per group, S, P, N, chunk, dt range, dtype); the first is
# hymba-1.5b's, the one the kernels line reports
SSD_SHAPES = [("hymba", 2, 50, 2048, 64, 16, 64, (3.0, 20.0), "float32"),
              ("mamba2", 2, 32, 2048, 64, 128, 64, (3.0, 20.0), "float32"),
              ("mamba2_small_dt", 2, 32, 2048, 64, 128, 64, (0.05, 0.6),
               "float32"),
              ("small_bf16", 2, 4, 256, 64, 32, 64, (0.05, 0.6), "bfloat16"),
              ("reduced", 2, 4, 256, 8, 8, 8, (0.05, 0.6), "float32")]
# the backward's shapes (name, B, heads per group, S, P, N, chunk, dt
# range): hymba-1.5b's and mamba2-370m's training SSD (the lm_train_ssm
# phase's, B 1), each with the reference's full-width dt (C-5, C-11) and a
# small one; the first is the one the kernels line reports
SSD_BWD_SHAPES = [
    ("hymba_train", 1, 50, 2048, 64, 16, 64, (3.0, 20.0)),
    ("hymba_train_small_dt", 1, 50, 2048, 64, 16, 64, (0.05, 0.6)),
    ("mamba2_train", 1, 32, 2048, 64, 128, 64, (3.0, 20.0)),
    ("mamba2_train_small_dt", 1, 32, 2048, 64, 128, 64, (0.05, 0.6))]
# phase 7c: one block of each ported kind with an SSD or flash kernel at
# full width, (config, block kind), B 1 x S BLOCK_SEQ; the cross-attention
# kinds attend to the model's memory length (whisper's 1500 encoder
# positions, llama-vision's 1600 image tokens)
BLOCK_BWD = [("stablelm-3b", "global"), ("mamba2-370m", "ssm"),
             ("hymba-1.5b", "hybrid"), ("whisper-small", "enc"),
             ("whisper-small", "dec_cross"),
             ("llama-3.2-vision-90b", "cross"), ("deepseek-v2-236b", "mla"),
             ("mixtral-8x7b", "local")]
BLOCK_SEQ = 2048
# phase 7c's bf16 rows: stablelm-3b's global block (hd 80) and hymba-1.5b's
# hybrid block, the bf16 flash kernels forward and backward
BLOCK_BWD_BF16 = [("stablelm-3b", "global"), ("hymba-1.5b", "hybrid")]
# the flash launches a block's forward makes
BLOCK_ATTN = {"global": 1, "local": 1, "hybrid": 1, "enc": 1, "cross": 1,
              "mla": 1, "dec_cross": 2, "ssm": 0}
# the LM phases: models, batch and the cuts of the comparison phases
LM = dict(arch="hymba-1.5b", ssm_arch="mamba2-370m", batch=2, seq=2048,
          cut_depth=2, decode_prompt=1152, full_prompt=64, greedy=8)
# the training phases: stablelm-3b at full width, ``depth`` of its 32
# layers (hymba-1.5b's 32 and mamba2-370m's 48 in phase 13 likewise; the
# cut keeps the run inside its time limit), B 1, S 2048, ten steps (the
# config's every_k 10 fires the projection at the tenth); the resume check
# at depth 1, S 512, every_k 2 (the projection fires in both halves, so
# theta rides in the checkpoint)
TRAIN = dict(arch="stablelm-3b", seq=2048, steps=10, depth=8,
             resume_seq=512, resume_steps=6, resume_every_k=2,
             ssm_archs=("hymba-1.5b", "mamba2-370m"))
# phase 10b: the serving loop at hymba-1.5b's full width, ``depth`` of its
# 32 layers (the cut keeps the run inside its time limit), B 8, Smax 256; 24
# requests in three waves of ``wave_steps`` steps each (prompts 4-48
# tokens, budgets 4-40, heavy-tailed), the three shortest also through an
# eager decode_step loop; 8 short requests on the compacted engine with a
# refresh and a recompact mid-flight; 50 steady steps per engine
FLEET = dict(arch="hymba-1.5b", depth=8, slots=8, max_seq=256, requests=24,
             prompt=(4, 48), budget=(4, 40), waves=3, wave_steps=12,
             eager_requests=3, steady=50, compact_prompt=(4, 12),
             compact_budget=(6, 16), refresh_at=5, recompact_at=10)
# phase 16: hymba-1.5b at full width, ``depth`` of its 32 layers (the cut
# keeps the run inside its time limit), trained in bf16 (f32 Adam moments)
# through launch/steps.build_train_step, B 1 x S 2048 (phase 13's shape):
# ten steps under remat "full" (every_k 10: the projection at the tenth),
# two under "dots" from the same init (bit-equal to "full"'s first two),
# three at every_k 1, and f32 steps at the same shape to compare with
TRAIN_BF16 = dict(arch="hymba-1.5b", depth=8, seq=2048, steps=10,
                  dots_steps=2, every1_steps=3, f32_steps=4)
# phase 20: the dry-run against the card. (a) hymba-1.5b at phase 16's
# settings (bf16 params, f32 Adam moments, ``depth`` of its 32 layers, B 1
# x S 2048, its l1,inf spec) on a (1, 1) mesh: launch/steps.lower_cell's
# trace of the train step on meta tensors under a fake process group of one
# rank, and the same step from the same builder on the card over a one-rank
# gloo group, every step at a count that fires every every_k gate (the
# dry-run's rule); launches by kernel and aten dot FLOPs equal, the peak
# estimate within ``peak_tol`` of the card's peak; (b) ``cells``, full
# size, as rank 0 of the production mesh's 256 fake ranks
DRYRUN = dict(arch="hymba-1.5b", depth=8, seq=2048, batch=1, peak_tol=0.2,
              cells=(("hymba_15b", "train_4k"), ("stablelm_3b", "decode_32k"),
                     ("deepseek_v2_236b", "prefill_32k")))
# phases 14 and 15: the rest of the zoo at full width. whisper-small whole
# (B 2, its 1500 encoder positions, 448 decoder tokens); llama-3.2-vision-
# 90b cut to one cycle of its pattern (4 global + 1 cross), B 1 x S 2048,
# 1600 image tokens; mixtral-8x7b's forward at depth 4 and train() at depth
# 2 (B 1 x S 2048, ten steps: its moe/w1 spec's every_k 10 fires at the
# tenth); deepseek-v2-236b at depth 2; decode against forward over the
# first ``decode_prompt`` positions; reduced MoE models behind FleetEngine
ZOO = dict(encdec="whisper-small", encdec_batch=2, encdec_seq=448,
           encdec_cpu_depth=6,
           vision="llama-3.2-vision-90b", vision_seq=2048, decode_prompt=64,
           moe="mixtral-8x7b", moe_fwd_depth=4, moe_train_depth=2,
           moe_train_steps=10, moe_seq=2048, mla="deepseek-v2-236b",
           mla_depth=2, engine_archs=("mixtral-8x7b", "deepseek-v2-236b"))
# phase 6c: the flash kernels at the new kinds' shapes, f32 (name, B, H,
# Sq, Skv, head_dim, v head_dim, causal): whisper's encoder self attention
# and decoder cross attention, llama-vision's cross attention, and
# deepseek's MLA (q/k 192 on the hd-256 kernel, v 128 padded to 192)
ZOO_ATTN_SHAPES = [("whisper_enc", 2, 12, 1500, 1500, 64, 64, False),
                   ("whisper_cross", 2, 12, 448, 1500, 64, 64, False),
                   ("vision_cross", 1, 64, 2048, 1600, 128, 128, False),
                   ("deepseek_mla", 1, 128, 2048, 2048, 192, 128, True)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_TOL = 2e-4
# the SSD backward against its plain version and against float64 autograd
# through ssd_ref, as a fraction of each gradient's largest entry: the JAX
# suite's SSD tolerance
SSD_BWD_TOL = 2e-4
# At the reference's full-width init (ROADMAP C-5) the model amplifies f32
# rounding about a thousandfold, so the LM comparisons are held to the
# model's own noise floor, measured in the same run: how far the logits move
# when every weight is multiplied by (1 + PERTURB * N(0, 1)), about ten f32
# ulps. A comparison passes within that floor and within 1e-2 of the
# logits' scale.
PERTURB = 1e-6
LM_MAX_REL = 1e-2
# models/blockcheck.py's factor: the noise floor's own spread from one draw
# of the noise to the next, for comparisons whose two sides sum in other
# orders (decode against forward) or whose floor is the logits' own scale
FLOOR_FACTOR = 2.0
# what a model computes between its blocks (positions, norms, the
# embedding and unembedding) on the card against the CPU, from the same
# inputs, as a fraction of its scale: a few f32 ulps over a norm's or a
# 768-long dot product's reduction
GLUE_REL = 1e-5
# compact serving against dense, as a fraction of the dense output's scale:
# tests/test_sae_serve.py's atol (f32) and its bf16 tolerance
SERVE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FAILURES = []


# the wall clock between phase lines: each line's seconds since the line
# before it (the build's since the start) go to standard error as it is
# printed, and their sums by phase into the "timing" line before the result
_CLOCK = [time.perf_counter()]
PHASE_SECONDS = {}


def emit(obj):
    phase = obj.get("phase")
    if phase is not None:
        now = time.perf_counter()
        PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + now - _CLOCK[-1]
        print(f"chip_smoke: {phase} {obj.get('arch', obj.get('shape', ''))} "
              f"+{now - _CLOCK[-1]:.1f} s, at {now - _CLOCK[0]:.1f} s",
              file=sys.stderr, flush=True)
        _CLOCK.append(now)
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", flush=True)
    return bool(ok)


def _graph_ms(torch, fn, reps):
    """Device time in ms of one replay of a CUDA graph of ``reps``
    back-to-back fn() calls, between two CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _warm(torch, fn):
    """Run fn a few times on a side stream (graph capture needs it) and
    return one eager call's device time in ms."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
        start.record(side)
        fn()
        end.record(side)
    end.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    return start.elapsed_time(end)


def time_ms(torch, fn, budget_ms=100.0):
    """Mean device time of one fn() call in ms. fn is captured back to back
    into a CUDA graph, which is replayed once between two CUDA events, so
    the host's launch overhead stays out of the number; inputs stay warm in
    L2. fn must not synchronise."""
    once = _warm(torch, fn)
    reps = int(min(200, max(10, budget_ms / max(once, 1e-3))))
    return _graph_ms(torch, fn, reps) / reps


def time_cold_ms(torch, fn, flush, reps=20):
    """Mean device time of one fn() call in ms with L2 flushed before it:
    graphs of ``reps`` x (flush) and ``reps`` x (flush, fn) are timed as in
    ``time_ms`` and the difference is divided by ``reps``."""
    both = lambda: (flush(), fn())
    _warm(torch, both)
    return (_graph_ms(torch, both, reps) - _graph_ms(torch, flush, reps)) \
        / reps


def wall_ms(torch, fn, reps=5):
    """Mean wall time of fn() in ms, host clock, synchronised: for calls
    that synchronise themselves (the projection's host Newton loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def bits_equal(torch, a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def refuses_grad(torch, call, x):
    """True when ``call(x)`` raises (forward-only kernel, fault C-6) while
    x requires grad under grad mode, and runs under no_grad."""
    x = x.clone().requires_grad_(True)
    try:
        call(x)
        return False
    except RuntimeError as e:
        if "forward-only" not in str(e):
            raise
    with torch.no_grad():
        call(x)
    return True


def _empty_loop(torch, lib, args, kw, iters):
    """A call of the empty loop library (the loop kernel with nothing
    solved, stepping until max_newton) on the wrapper's arguments, run to
    ``iters`` Newton steps: the same grid and grid.sync() count as the
    kernel's run."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.l1inf_newton_loop.argtypes = [P] * 10 + [I] * 8 + [P]
    lib.l1inf_newton_loop_clusters.argtypes = [I, I, I]
    A = args[0]
    n, m = A.shape
    ncl = lib.l1inf_newton_loop_clusters(n, m, 1)
    out = [torch.empty(m, device=A.device), torch.empty(1, device=A.device),
           torch.empty(3, dtype=torch.int64, device=A.device),
           torch.empty(2 * ncl * 3, device=A.device)]
    ptrs = [t.data_ptr() for t in args] + [t.data_ptr() for t in out]

    def call():
        rc = lib.l1inf_newton_loop(
            *ptrs, n, m, 1, kw["block_m"], 26, 8, iters, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty loop launch failed: CUDA error {rc}")
    return call


def loop_phase(torch, K, O, Y, C, flush, empty_lib):
    """The Newton loop kernel against its plain version (the host loop over
    the same solves) on the engine's state after pass 1 of projecting Y
    onto the ball of radius C: theta to atol = rtol 1e-6, newton_iters
    equal or one apart where the last step is fp rounding (thetas within 4
    ulps, work_cols then larger by that step's prefix), active_cols_per_step
    and mu's support equal, mu within 1e-5 * colmax; a rerun bit-equal.
    Times: the kernel in a CUDA graph (``time_ms``) L2-warm and flushed
    (``time_cold_ms``), the empty loop the same way at the kernel's step
    count, the plain loop on the host clock (``wall_ms``: it syncs once a
    step, so it cannot be captured)."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    n, m = Y.shape
    Ypad, bm = O._padded(Y, 0)
    sids = (torch.arange(Ypad.shape[1], device=Y.device) >= m).to(
        torch.int32)
    li = O._loop_inputs(Ypad, sids, torch.full((1,), C, device=Y.device), 1,
                        None, bm=bm, n_bisect=26, n_polish=8, shrink=True)
    args = (li["A"], li["sids"], li["colsum"], li["t1"], li["Csafe"],
            li["num_active"])
    kw = dict(num_segments=1, block_m=bm)
    got = K.newton_loop(*args, **kw)
    want = K.newton_loop_plain(*args, **kw)
    th, mu, it, work, acps = got
    thp, mup, itp, workp, acpsp = want
    extra = int(it) - int(itp)
    ulp = float(np.spacing(np.float32(float(thp[0]))))
    dth = float((th - thp).abs().max())
    colmax = li["A"].amax(dim=0)
    dmu = float((mu - mup).abs().max())
    check(dth <= 1e-6 + 1e-6 * float(thp.abs().max()),
          f"newton_loop theta {float(th[0])} vs plain {float(thp[0])}")
    check(extra == 0 or (abs(extra) == 1 and dth <= 4 * ulp),
          f"newton_loop iters {int(it)} vs plain {int(itp)}")
    check(int(work) == int(workp) + extra * int(acpsp) and
          int(acps) == int(acpsp), f"newton_loop work {int(work)}/"
          f"{int(acps)} vs plain {int(workp)}/{int(acpsp)}")
    check(torch.equal(mu > 0, mup > 0) and
          bool(((mu - mup).abs() <= 1e-5 * colmax).all()),
          f"newton_loop mu: max err {dmu}")
    again = K.newton_loop(*args, **kw)
    check(all(bits_equal(torch, a, b) if a.is_floating_point()
              else torch.equal(a, b) for a, b in zip(got, again)),
          "newton_loop: rerun not bit-equal")
    # bound: newton_loop_cost of the first evaluation's prefix and the
    # columns of every later one (the work counter less m and the first)
    first = min(int(li["num_active"]) + bm - 1, Ypad.shape[1]) // bm * bm
    later = int(work) - Ypad.shape[1] - first
    bound = kernel_bound_ms(K.newton_loop_cost(n, first, later))
    loop = lambda: K.newton_loop(*args, **kw)
    empty = _empty_loop(torch, empty_lib, args, kw, int(it))
    return {"newton_iters": int(it), "newton_iters_plain": int(itp),
            "work_cols": int(work), "work_cols_plain": int(workp),
            "active_cols_per_step": int(acps),
            "num_active": int(li["num_active"]),
            "theta": float(th[0]), "theta_plain": float(thp[0]),
            "max_abs_err": dmu,
            "ms": time_ms(torch, loop),
            "ms_l2_flushed": time_cold_ms(torch, loop, flush),
            "empty_loop_ms": time_ms(torch, empty),
            "empty_loop_ms_l2_flushed": time_cold_ms(torch, empty, flush),
            "plain_ms": wall_ms(torch, lambda: K.newton_loop_plain(
                *args, **kw), reps=3),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def _dtype(torch, name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _pairs(S, causal, window):
    """Unmasked (query, key) pairs of one head."""
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    return int(mask.sum()), mask


def _profile(torch, fn, kernels=()):
    """One traced call: top device ops, device busy ms and idle share, and
    the device ms and share of the ops whose names contain one of
    ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one small op first: a single-call trace otherwise misses the
        # first launches of its call now and then
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    rows = sorted(((e.key, e.count, dev_us(e)) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    out = {"wall_ms": wall, "device_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall),
           "device_calls": sum(r[1] for r in rows),
           "top_device": [{"name": r[0][:80], "calls": r[1],
                           "device_ms": r[2] / 1e3} for r in rows[:10]]}
    if kernels:
        mine = {k: sum(r[2] for r in rows if k in r[0]) / 1e3
                for k in kernels}
        out["kernels_device_ms"] = mine
        out["kernels_share"] = sum(mine.values()) / max(busy, 1e-9)
    return out


def attn_kernel_phase(torch, FA, dev, flush, shapes=ATTN_SHAPES):
    """Phase 6; returns the kernels-line row of the first shape (f32)."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(11)
    err, row, bf16 = 0.0, None, None
    for name, B, H, KV, S, hd, causal, window in shapes:
        kw = dict(groups=H // KV, causal=causal, window=window)
        _, mask = _pairs(S, causal, window)
        line = {"phase": "attn_kernels", "shape": name, "B": B, "H": H,
                "KV": KV, "S": S, "head_dim": hd, "causal": causal,
                "window": window}
        for dname in ("float32", "bfloat16"):
            dt = _dtype(torch, dname)
            q = torch.randn((B * H, S, hd), generator=g, device=dev).to(dt)
            k = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
            v = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
            out = FA.flash_attention_fwd(q, k, v, **kw)
            plain = FA.flash_attention_fwd_plain(q, k, v, **kw)
            tol = FLASH_TOL[dname]
            e = float((out.float() - plain.float()).abs().max())
            check(bool(torch.isfinite(out).all()), f"flash {name} {dname}: "
                  "non-finite output")
            check(torch.allclose(out.float(), plain.float(), atol=tol,
                                 rtol=tol), f"flash {name} {dname}: "
                  f"kernel vs plain max err {e}")
            check(bits_equal(torch, out, FA.flash_attention_fwd(q, k, v,
                                                                **kw)),
                  f"flash {name} {dname}: rerun not bit-equal")
            err = max(err, e)
            line[f"max_abs_err_{dname}"] = e
            if name != shapes[0][0]:
                continue
            ops, nbytes = FA.flash_attention_fwd_cost(
                B * H, S, S, hd, H // KV, causal, window, q.element_size())
            bound = kernel_bound_ms((ops, nbytes), q.dtype)
            qs, ks, vs = (t.view(B, -1, S, hd) for t in (q, k, v))
            mk = torch.from_numpy(mask).to(dev)
            lib = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mk, enable_gqa=True)
            lib_err = float((lib().reshape(B * H, S, hd).float()
                             - out.float()).abs().max())
            t = {"ms": time_ms(torch, lambda: FA.flash_attention_fwd(
                q, k, v, **kw)),
                 "ms_l2_flushed": time_cold_ms(
                     torch, lambda: FA.flash_attention_fwd(q, k, v, **kw),
                     flush),
                 "plain_ms": time_ms(torch, lambda: FA.flash_attention_fwd_plain(
                     q, k, v, **kw), budget_ms=300.0),
                 "bound_ms": bound[0], "bound_by": bound[1],
                 "library_ms": time_ms(torch, lib),
                 "library_max_abs_err": lib_err,
                 "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
            line[dname] = t
            if dname == "float32":
                row = dict(t)
            else:
                bf16 = {k: t[k] for k in ("ms", "ms_l2_flushed", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}
        emit(line)
    # C-9: a head_dim that is not a kernel's runs zero-padded to the next
    # one (here 32 on the hd-64 kernels); above 256 the call raises
    x = torch.randn((2, 96, 32), generator=g, device=dev)
    want = FA.flash_attention_fwd_plain(x, x, x)
    perr = float((FA.flash_attention_fwd(x, x, x) - want).abs().max())
    check(perr <= FLASH_TOL["float32"] * float(want.abs().max()),
          f"flash head_dim 32 (padded): kernel vs plain max err {perr}")
    try:
        FA.flash_attention_fwd(*(torch.ones((2, 8, 264), device=dev),) * 3)
        check(False, "flash kernel took head_dim 264")
    except ValueError:
        pass
    # C-6: inputs that require grad get their gradients through the
    # kernels, f32 and bf16: each of dq, dk, dv against autograd through
    # the plain forward (f32 arithmetic rounded once, P unrounded in its
    # backward), within the f32 backward's tolerance and, in bf16, the
    # JAX suite's bf16 tolerance (3e-2; the kernel's own, against its
    # plain version, is phase 6e's)
    for dname, tol in (("float32", BWD_TOL["float32"]),
                       ("bfloat16", FLASH_TOL["bfloat16"])):
        qkv = [torch.randn((2, 64, 64), generator=g, device=dev).to(
            _dtype(torch, dname)) for _ in range(3)]
        xg = [t.clone().requires_grad_(True) for t in qkv]
        FA.reset_launch_counts()
        grads = torch.autograd.grad(
            FA.flash_attention_fwd(*xg).float().sum(), xg)
        by_dtype = FA.bwd_launches_by_dtype()
        xp = [t.clone().requires_grad_(True) for t in qkv]
        with torch.enable_grad():
            FA.flash_attention_fwd_plain(*xp).float().sum().backward()
        gerr = max(float((a.float() - b.grad.float()).abs().max())
                   / float(b.grad.float().abs().max())
                   for a, b in zip(grads, xp))
        check(FA.launch_counts() == {"flash_attention_fwd": 1,
                                     "flash_attention_bwd": 1}
              and by_dtype[dname] == 1
              and all(a.dtype == qkv[0].dtype for a in grads)
              and gerr <= tol,
              f"flash {dname} under grad: launches {FA.launch_counts()} "
              f"{by_dtype}, gradients vs autograd of the plain forward, "
              f"largest error of the scale {gerr}")
    row.update(max_abs_err=err, bfloat16=bf16)
    return row


def eager_ms(torch, fn, reps=10):
    """Mean device time of fn() in ms between two CUDA events around
    ``reps`` eager calls after two warm-up calls: for calls that run
    autograd, which the CUDA-graph timer does not capture."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attn_bwd_phase(torch, FA, dev, flush, shapes=BWD_SHAPES,
                   dname="float32"):
    """Phase 6b (f32) and 6e (``dname="bfloat16"``): the flash backward
    kernel of that dtype against its plain version on the forward kernel's
    out and lse, at stablelm-3b's training shape and hymba-1.5b's
    prefill: dq, dk, dv within BWD_TOL of each gradient's scale, a rerun
    bit-equal, the forward's lse against the plain forward's; device ms
    warm and flushed, the plain version's ms and the backward of
    ``scaled_dot_product_attention`` in the same dtype (forward + backward
    minus forward, device time of one traced call each; the eager event
    times beside it); the device ms of the delta and main launches from one
    traced call and the main kernel's CTAs an SM. Returns the kernels-line
    rows of every shape (the backward's) and of the first shape's forward
    with lse, as training runs it."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    import torch.nn.functional as F
    dt = _dtype(torch, dname)
    esize = 4 if dname == "float32" else 2
    g = torch.Generator(device=dev).manual_seed(13)
    rows, fwd_row = [], None
    for name, B, H, KV, S, hd, causal, window in shapes:
        kw = dict(groups=H // KV, causal=causal, window=window)
        _, mask = _pairs(S, causal, window)
        q = torch.randn((B * H, S, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
        dout = torch.randn((B * H, S, hd), generator=g, device=dev).to(dt)
        out, lse = FA._fwd_kernel(q, k, v, H // KV, causal, window, True)
        plain_out, plain_lse = FA.flash_attention_fwd_plain(
            q, k, v, return_lse=True, **kw)
        # the forward that feeds the backward, held as phase 6 holds it
        out_err = float((out.float() - plain_out.float()).abs().max())
        out_scale = float(plain_out.float().abs().max())
        check(bool(torch.isfinite(out).all())
              and out_err <= FLASH_TOL[dname] * out_scale,
              f"flash fwd {dname} out {name}: max err {out_err}, scale "
              f"{out_scale}")
        lse_err = float((lse - plain_lse).abs().max())
        check(lse_err <= 2e-5 * float(plain_lse.abs().max()),
              f"flash fwd {dname} lse {name}: max err {lse_err}")
        del plain_out
        args = (q, k, v, out, dout, lse)
        FA.reset_launch_counts()
        got = FA.flash_attention_bwd(*args, **kw)
        by_dtype = FA.bwd_launches_by_dtype()
        check(by_dtype[dname] == 1 and sum(by_dtype.values()) == 1,
              f"flash bwd {dname} {name}: launches {by_dtype}")
        block_q, block_kv = FA.bwd_tiles(hd, dt)
        want = FA.flash_attention_bwd_plain(
            *args, **kw, block_q=block_q, block_kv=block_kv)
        errs = {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            scale = float(b.float().abs().max())
            errs[gname] = float((a.float() - b.float()).abs().max())
            check(bool(torch.isfinite(a).all())
                  and errs[gname] <= BWD_TOL[dname] * scale,
                  f"flash bwd {dname} {name} {gname}: max err "
                  f"{errs[gname]}, scale {scale}")
        again = FA.flash_attention_bwd(*args, **kw)
        check(all(bits_equal(torch, a, b) for a, b in zip(got, again)),
              f"flash bwd {dname} {name}: rerun not bit-equal")
        # bound: five products over the unmasked pairs; q, k, v, out, dout
        # and lse read once, dq, dk, dv written once
        ops, nbytes = FA.flash_attention_bwd_cost(
            B * H, S, S, hd, H // KV, causal, window, esize)
        bound = kernel_bound_ms((ops, nbytes), dt)
        # the library yardstick: SDPA's backward in the same dtype (its
        # flash, efficient or math kernel), forward + backward minus
        # forward
        qs, ks, vs = (t.view(B, -1, S, hd).clone().requires_grad_(True)
                      for t in (q, k, v))
        ds = dout.view(B, H, S, hd)
        mk = torch.from_numpy(mask).to(dev) if window else None
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mk, is_causal=mk is None, enable_gqa=True)
        lib_grads = torch.autograd.grad(sdpa(), (qs, ks, vs), ds)
        lib_err = max(float((a.reshape(b.shape).float()
                             - b.float()).abs().max())
                      for a, b in zip(lib_grads, got))

        def sdpa_fwd():
            with torch.no_grad():
                sdpa()

        def sdpa_both():
            torch.autograd.grad(sdpa(), (qs, ks, vs), ds)

        lib_fwd, lib_both = eager_ms(torch, sdpa_fwd), eager_ms(torch,
                                                               sdpa_both)
        # the same as device time of one traced call each (the eager
        # event times carry the host's enqueue gaps, which grow as the
        # host is loaded): the library row is the device time
        lib_fwd_dev = _profile(torch, sdpa_fwd)["device_ms"]
        lib_both_dev = _profile(torch, sdpa_both)["device_ms"]
        trace = _profile(torch, lambda: FA.flash_attention_bwd(*args, **kw),
                         BWD_TRACE_NAMES[dname])
        t = {"ms": time_ms(torch, lambda: FA.flash_attention_bwd(*args,
                                                                 **kw)),
             "ms_l2_flushed": time_cold_ms(
                 torch, lambda: FA.flash_attention_bwd(*args, **kw), flush),
             "plain_ms": time_ms(torch, lambda: FA.flash_attention_bwd_plain(
                 *args, **kw), budget_ms=300.0),
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib_both_dev - lib_fwd_dev,
             "library_fwd_bwd_device_ms": lib_both_dev,
             "library_fwd_device_ms": lib_fwd_dev,
             "library_eager_ms": lib_both - lib_fwd,
             "library_fwd_bwd_ms": lib_both, "library_fwd_ms": lib_fwd,
             "library_max_abs_err": lib_err,
             "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
             "launch_device_ms": {
                 k.split("_kernel")[0]: v
                 for k, v in trace["kernels_device_ms"].items()},
             "ctas_per_sm": FA.bwd_ctas_per_sm(hd, dt)}
        extra = {"plain_tiles": [block_q, block_kv]}
        if esize == 2:
            # the main kernel at this head dim, and at every kernel head
            # dim: the kernels row takes what the built kernel reports
            # (registers at launch, local memory, CTAs an SM); the phase
            # line also the consumers' setmaxnreg count and the dynamic
            # shared memory (the source's constants) and the first
            # design's time (an earlier run's, not this one's)
            attrs = FA.bwd_kernel_attrs(hd)
            t["kernel_attrs"] = {a: attrs[a] for a in (
                "registers", "local_bytes", "ctas_per_sm")}
            extra.update({
                "kernel_attrs": attrs,
                "kernel_attrs_by_head_dim": {
                    kd: FA.bwd_kernel_attrs(kd)
                    for kd in FA.KERNEL_HEAD_DIMS},
                "earlier_design_ms": BWD_BF16_EARLIER_MS.get(name)})
        line = {"phase": "attn_bwd" if esize == 4 else "attn_bwd_bf16",
                "dtype": dname, "shape": name, "B": B, "H": H,
                "KV": KV, "S": S, "head_dim": hd, "causal": causal,
                "window": window, "max_abs_err": errs,
                "out_max_abs_err": out_err, "out_scale": out_scale,
                "lse_max_abs_err": lse_err, **t, **extra}
        rows.append(dict(t, shape=name, max_abs_err=max(errs.values())))
        if fwd_row is None:
            # the forward as training calls it (with lse) at this shape,
            # and without lse; bound: two products over the unmasked
            # pairs, q, k, v read and out, lse written once
            fwd = lambda: FA._fwd_kernel(q, k, v, H // KV, causal, window,
                                         True)
            no_lse = lambda: FA._fwd_kernel(q, k, v, H // KV, causal,
                                            window, False)
            fops, fbytes = FA.flash_attention_fwd_cost(
                B * H, S, S, hd, H // KV, causal, window, esize, lse=True)
            fbound = kernel_bound_ms((fops, fbytes), dt)
            fwd_row = {
                "shape": name, "ms": time_ms(torch, fwd),
                "ms_l2_flushed": time_cold_ms(torch, fwd, flush),
                "ms_without_lse": time_ms(torch, no_lse),
                "plain_ms": time_ms(torch, lambda: FA.flash_attention_fwd_plain(
                    q, k, v, return_lse=True, **kw), budget_ms=300.0),
                "bound_ms": fbound[0], "bound_by": fbound[1],
                "library_ms": lib_fwd_dev, "library_eager_ms": lib_fwd,
                "max_abs_err": out_err, "lse_max_abs_err": lse_err,
                "gflop": fops / 1e9, "mbytes": fbytes / 1e6}
            line[f"fwd_{'f32' if esize == 4 else 'bf16'}"] = fwd_row
        emit(line)
        del qs, ks, vs, lib_grads, got, want, again
        torch.cuda.empty_cache()
    return rows, fwd_row


def ssd_kernel_phase(torch, SK, Sref, dev, flush, shapes=SSD_SHAPES):
    """Phase 7; returns the kernels-line row of the first shape."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    g = torch.Generator(device=dev).manual_seed(12)
    err, row = 0.0, None
    for name, BG, groups, S, P, N, Q, (lo, hi), dname in shapes:
        BH = BG * groups
        dt_ = _dtype(torch, dname)
        x = torch.randn((BH, S, P), generator=g, device=dev).to(dt_)
        dt = (torch.rand((BH, S), generator=g, device=dev) * (hi - lo)
              + lo).to(dt_)
        # a = -exp(A_log): A_log starts at 0 in Model.init, so a = -1
        a = -torch.exp(torch.rand((BH,), generator=g, device=dev) - 0.5)
        d = torch.ones((BH,), device=dev)
        Bm = (torch.randn((BG, S, N), generator=g, device=dev) * 2).to(dt_)
        Cm = (torch.randn((BG, S, N), generator=g, device=dev) * 2).to(dt_)
        args = (x, dt, a, d, Bm, Cm)
        kw = dict(chunk=Q, groups=groups)
        y, st = SK.ssd_fwd(*args, **kw)
        yp, stp = SK.ssd_fwd_plain(*args, **kw)
        yr, str_ = Sref.ssd_ref(*args, groups=groups)
        tol = SSD_TOL if dname == "float32" else FLASH_TOL[dname]
        finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        check(finite, f"ssd {name}: NaN or inf in y or the state")
        e = max(float((y.float() - yp.float()).abs().max()),
                float((st - stp).abs().max()))
        check(torch.allclose(y.float(), yp.float(), atol=tol, rtol=tol)
              and torch.allclose(st, stp, atol=tol, rtol=tol),
              f"ssd {name}: kernel vs plain max err {e}")
        scale = max(1.0, float(yr.float().abs().max()))
        sscale = max(1.0, float(str_.abs().max()))
        e_ref = float((y.float() - yr.float()).abs().max())
        e_sref = float((st - str_).abs().max())
        check(e_ref <= tol * scale and e_sref <= tol * sscale,
              f"ssd {name}: kernel vs ssd_ref {e_ref} (scale {scale}), "
              f"state {e_sref} (scale {sscale})")
        y2, st2 = SK.ssd_fwd(*args, **kw)
        check(bits_equal(torch, y, y2) and bits_equal(torch, st, st2),
              f"ssd {name}: rerun not bit-equal")
        same = bits_equal(torch, y, yp) and bits_equal(torch, st, stp)
        err = max(err, e)
        ops, nbytes = SK.ssd_fwd_cost(BH, S, P, N, Q, groups,
                                      x.element_size())
        bound = kernel_bound_ms((ops, nbytes))
        line = {"phase": "ssd_kernels", "shape": name, "BH": BH, "S": S,
                "P": P, "N": N, "chunk": Q, "dt_range": [lo, hi],
                "dtype": dname, "finite": finite, "max_abs_err_vs_plain": e,
                "max_abs_err_vs_ref": e_ref, "ref_scale": scale,
                "state_max_abs_err_vs_ref": e_sref,
                "bit_equal_to_plain": same}
        if dname == "float32":
            check(same, f"ssd {name}: y or the state not bit-equal to the "
                  "plain version")
            trace = _profile(torch, lambda: SK.ssd_fwd(*args, **kw))
            line["passes_device_ms"] = {
                r["name"]: r["device_ms"] for r in trace["top_device"]
                if "ssd_" in r["name"]}
            line.update({
                "ms": time_ms(torch, lambda: SK.ssd_fwd(*args, **kw)),
                "ms_l2_flushed": time_cold_ms(
                    torch, lambda: SK.ssd_fwd(*args, **kw), flush),
                "plain_ms": time_ms(torch, lambda: SK.ssd_fwd_plain(
                    *args, **kw), budget_ms=300.0),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None, "gflop": ops / 1e9,
                "mbytes": nbytes / 1e6})
            if row is None:
                row = {k: line[k] for k in ("ms", "ms_l2_flushed",
                                            "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
        emit(line)
    # fault C-6: an f32 input that requires grad gets its gradient through
    # SSDFunction (one launch of each kernel); bf16, which has no backward,
    # refuses
    x = torch.randn((2, 128, 64), generator=g, device=dev)
    B1 = torch.randn((2, 128, 16), generator=g, device=dev)
    dt1 = torch.rand((2, 128), generator=g, device=dev) + 0.1
    ad = torch.ones((2,), device=dev)
    SK.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    SK.ssd_fwd(xg, dt1, -ad, ad, B1, B1)[0].sum().backward()
    launched = SK.launch_counts()
    _, _, saved = SK.ssd_fwd_plain(x, dt1, -ad, ad, B1, B1, return_saved=True)
    want = SK.ssd_bwd_plain(x, dt1, -ad, ad, B1, B1, torch.ones_like(x), None,
                            saved)[0]
    grad_err = float((xg.grad - want).abs().max())
    check(launched == {"ssd_fwd": 1, "ssd_bwd": 1, "ssd_fwd_tile_bf16": 0,
                       "ssd_bwd_tile_bf16": 0}
          and grad_err <= SSD_BWD_TOL * float(want.abs().max()),
          f"ssd f32 gradient: launches {launched}, max err {grad_err}")
    bf = lambda t: t.to(torch.bfloat16)
    check(refuses_grad(torch, lambda t: SK.ssd_fwd(t, bf(dt1), -ad, ad,
                                                   bf(B1), bf(B1)), bf(x)),
          "ssd kernel ran a bf16 input that requires grad")
    emit({"phase": "ssd_kernels", "check": "grad", "launches": launched,
          "dx_max_abs_err": grad_err})
    row.update(max_abs_err=err)
    return row


def ssd_bwd_phase(torch, SK, Sref, dev, flush, shapes=SSD_BWD_SHAPES):
    """Phase 7b: the SSD backward kernel against its plain version and
    against float64 autograd through ``ssd_ref`` (dy given, no state
    gradient, as ``ssd_attention`` runs it), on the forward kernels' saved
    state; times, the bound and the four launches' device ms. Returns the
    kernels-line row of the first shape."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    g = torch.Generator(device=dev).manual_seed(14)
    names = ("dx", "ddt", "da", "dd", "dB", "dC")
    row, worst = None, 0.0
    for name, BG, groups, S, P, N, Q, (lo, hi) in shapes:
        BH = BG * groups
        x = torch.randn((BH, S, P), generator=g, device=dev)
        dt = torch.rand((BH, S), generator=g, device=dev) * (hi - lo) + lo
        # a = -exp(A_log): A_log starts at 0 in Model.init, so a = -1
        a = -torch.exp(torch.rand((BH,), generator=g, device=dev) - 0.5)
        d = torch.ones((BH,), device=dev)
        Bm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        Cm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        dy = torch.randn((BH, S, P), generator=g, device=dev)
        args = (x, dt, a, d, Bm, Cm)
        kw = dict(chunk=Q, groups=groups)
        _, _, saved = SK._fwd_kernel(*args, Q, groups)
        bargs = (*args, dy, None, saved)
        got = SK.ssd_bwd(*bargs, **kw)
        _, _, psaved = SK.ssd_fwd_plain(*args, return_saved=True, **kw)
        want = SK.ssd_bwd_plain(*args, dy, None, psaved, **kw)
        ref64 = [t.double().requires_grad_() for t in args]
        yr, _ = Sref.ssd_ref(*ref64, groups=groups)
        exact = torch.autograd.grad((yr * dy.double()).sum(), ref64)
        del yr, ref64, psaved
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        err, rel, rel64 = {}, {}, {}
        for gname, k, p, r in zip(names, got, want, exact):
            err[gname] = float((k - p).abs().max())
            rel[gname] = err[gname] / max(float(p.abs().max()), 1e-30)
            rel64[gname] = float((k.double() - r).abs().max()) / max(
                float(r.abs().max()), 1e-30)
        del want, exact
        worst = max(worst, max(err.values()))
        check(finite, f"ssd_bwd {name}: NaN or inf in a gradient")
        check(max(rel.values()) <= SSD_BWD_TOL,
              f"ssd_bwd {name}: kernel vs plain, relative to each "
              f"gradient's scale {rel}")
        check(max(rel64.values()) <= SSD_BWD_TOL,
              f"ssd_bwd {name}: kernel vs float64 autograd through ssd_ref, "
              f"relative {rel64}")
        again = SK.ssd_bwd(*bargs, **kw)
        check(all(bits_equal(torch, u, v) for u, v in zip(got, again)),
              f"ssd_bwd {name}: rerun not bit-equal")
        del again
        ops, nbytes = SK.ssd_bwd_cost(BH, S, P, N, Q, groups)
        bound = kernel_bound_ms((ops, nbytes))
        trace = _profile(torch, lambda: SK.ssd_bwd(*bargs, **kw),
                         SSD_BWD_TRACE_NAMES)
        t = {"ms": time_ms(torch, lambda: SK.ssd_bwd(*bargs, **kw)),
             "ms_l2_flushed": time_cold_ms(
                 torch, lambda: SK.ssd_bwd(*bargs, **kw), flush),
             "plain_ms": time_ms(torch, lambda: SK.ssd_bwd_plain(
                 *args, dy, None, saved, **kw), budget_ms=300.0),
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
             "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
             "launch_device_ms": {k.split("_kernel")[0]: v for k, v in
                                  trace["kernels_device_ms"].items()},
             "kernel_attrs": SK.bwd_kernel_attrs(Q, N)}
        emit({"phase": "ssd_bwd", "shape": name, "BH": BH, "S": S, "P": P,
              "N": N, "chunk": Q, "dt_range": [lo, hi], "finite": finite,
              "max_abs_err_vs_plain": err, "rel_err_vs_plain": rel,
              "rel_err_vs_float64": rel64, **t})
        if row is None:
            row = dict(t, shape=name)
        del got, saved, bargs, args
        torch.cuda.empty_cache()
    row.update(max_abs_err=worst)
    row.pop("launch_device_ms")
    row.pop("kernel_attrs")
    return row


def block_bwd_phase(torch, C, FA, SK, dev, blocks=BLOCK_BWD,
                    seq=BLOCK_SEQ, dname="float32"):
    """Phase 7c: one block's backward, card against CPU, for each
    (config, kind) of ``blocks`` at full width (``block_backward_check``),
    the memory's gradient checked for the cross-attention kinds and the
    routing for the MoE ones (equal in the three runs, else the check
    fails and the smallest gap between a token's k-th and (k+1)-th gate is
    reported). The card's two backwards (the check's and the noise
    floor's) launch the block's kernels twice each way. In bf16 (this
    slice's rows) the block, its input and its upstream gradient are bf16
    and the noise floor is taken at bf16's scale (blockcheck.PERTURB)."""
    from repro_torch.models.blockcheck import (PERTURB as BLOCK_PERTURB,
                                               block_backward_check,
                                               memory_len)
    dt = _dtype(torch, dname)
    perturb = PERTURB if dname == "float32" else BLOCK_PERTURB[dt]
    by_block = {}
    for arch, kind in blocks:
        cfg = C.get_config(arch)
        _lm_reset(FA, SK)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with _flash_shapes(FA) as shapes:
            rep = block_backward_check(cfg, kind, dev, seq=seq,
                                       perturb=perturb, dtype=dt)
        seconds = time.perf_counter() - t
        by_block[(arch, kind)] = shapes
        launched = _lm_counts(FA, SK)
        attn, ssm = BLOCK_ATTN[kind], kind in ("ssm", "hybrid")
        want = {"flash_attention_fwd": 2 * attn, "flash_attention_bwd":
                2 * attn, "ssd_fwd": 2 * ssm, "ssd_bwd": 2 * ssm,
                "ssd_fwd_tile_bf16": 0, "ssd_bwd_tile_bf16": 0}
        by_dtype = FA.bwd_launches_by_dtype()
        check(by_dtype[dname] == 2 * attn, f"block_bwd {arch} {kind} "
              f"{dname}: flash backward launches by dtype {by_dtype}")
        check(rep["routing_equal"], f"block_bwd {arch} {kind}: routing "
              f"differs between card, CPU and perturbed runs; smallest "
              f"k-th to (k+1)-th gate gap {rep['min_gate_gap']}")
        check(rep["ok"], f"block_bwd {arch} {kind}: gradients beyond twice "
              f"their noise floor: {rep['failed']}")
        check(launched == want, f"block_bwd {arch} {kind}: launches "
              f"{launched}, want {want}")
        emit({"phase": "block_bwd", "arch": arch, "kind": kind,
              "dtype": dname, "batch": 1,
              "seq": seq, "memory_len": memory_len(cfg, kind),
              "n_experts": cfg.n_experts if cfg.d_ff else 0,
              "perturb": perturb, "ok": rep["ok"], "failed": rep["failed"],
              "flash_bwd_launches_by_dtype": by_dtype,
              "routing_equal": rep["routing_equal"],
              "min_gate_gap": rep["min_gate_gap"], "launches": launched,
              "flash_launches_by_shape": shapes,
              "worst_over_floor": max(r["over_floor"]
                                      for r in rep["leaves"].values()),
              "seconds": seconds,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              # the CPU side's threads, vector unit and instruction sets
              # (ROADMAP C-12: which machine a failing run had)
              "cpu_threads": torch.get_num_threads(),
              "cpu_capability": torch.backends.cpu.get_cpu_capability(),
              "cpu_features": {
                  n[4:-10]: bool(getattr(torch.cpu, n)())
                  for n in sorted(dir(torch.cpu))
                  if n.startswith("_is_") and n.endswith("_supported")},
              "leaves": rep["leaves"]})
        del rep
        gc.collect()
        torch.cuda.empty_cache()
    return by_block


def _noise_floor(torch, model, params, batch, logits, V, seed):
    """max |logits(P * (1 + PERTURB * eps)) - logits(P)| over the true
    vocab: how far weight changes of about ten f32 ulps move this model."""
    from repro_torch._tree import tree_map
    g = torch.Generator(device=logits.device).manual_seed(seed)
    pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
        a.shape, generator=g, device=a.device))
        if a.is_floating_point() else a, params)
    moved, _ = model.forward(pert, batch)
    return float((moved[..., :V] - logits[..., :V]).abs().max())


def _cast(torch, params, dtype):
    """The float leaves of ``params`` in ``dtype``; integer leaves (the
    ``*_sel`` indices of a compact tree) as they are."""
    from repro_torch._tree import tree_map
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    params)


def _lm_counts(FA, SK):
    return {**FA.launch_counts(), **SK.launch_counts()}


def _fwd_counts(flash, ssd):
    """The LM counts of a forward with no gradient: no backward launch."""
    return {"flash_attention_fwd": flash, "flash_attention_bwd": 0,
            "ssd_fwd": ssd, "ssd_bwd": 0, "ssd_fwd_tile_bf16": 0,
            "ssd_bwd_tile_bf16": 0}


def _has_ssd(cfg):
    return any(k in ("ssm", "hybrid") for k in cfg.pattern)


def _lm_batcher(cfg, tr=TRAIN):
    """B 1 batches of ``SyntheticLM(vocab, seed=1)``. ``LMBatcher(source,
    1, n)`` yields n input positions: stablelm-3b's phases take
    ``tr["seq"] + 1`` (2049), the SSD models ``tr["seq"]`` (2048), since
    the scan needs a multiple of its chunk."""
    from repro_torch.data import LMBatcher, SyntheticLM
    return LMBatcher(SyntheticLM(cfg.vocab, seed=1), 1,
                     tr["seq"] + (0 if _has_ssd(cfg) else 1))


def _step_counts(cfg):
    """The LM counts of one training step of ``cfg``: per layer, each
    forward and its recompute under remat, and each backward once."""
    fwd = (2 if cfg.remat else 1) * cfg.n_layers
    attn = any(k in ("global", "local", "hybrid") for k in cfg.pattern)
    ssd = _has_ssd(cfg)
    tile = "_tile_bf16" if cfg.ssd_bf16 else ""
    return {"flash_attention_fwd": fwd if attn else 0,
            "flash_attention_bwd": cfg.n_layers if attn else 0,
            "ssd_fwd": 0, "ssd_bwd": 0, "ssd_fwd_tile_bf16": 0,
            "ssd_bwd_tile_bf16": 0,
            "ssd_fwd" + tile: fwd if ssd else 0,
            "ssd_bwd" + tile: cfg.n_layers if ssd else 0}


def _lm_reset(FA, SK):
    FA.reset_launch_counts()
    SK.reset_launch_counts()


def lm_forward_phase(torch, Z, C, FA, SK, dev, lm=LM):
    """Phase 8, the main path; returns the launches of one hymba forward."""
    from repro_torch._tree import tree_map
    cfg = C.get_config(lm["arch"])
    model = Z.build(cfg)
    B, S = lm["batch"], lm["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    main_launches = None
    for dname in ("float32", "bfloat16"):
        params = model.init(generator=torch.Generator(device=dev).manual_seed(
            0), dtype=_dtype(torch, dname), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lm_reset(FA, SK)
        logits, aux = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        launched = _lm_counts(FA, SK)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if dname == "float32":
            main_launches = dict(launched)
        check(launched == _fwd_counts(cfg.n_layers, cfg.n_layers),
              f"{cfg.name} {dname} forward launches {launched}, want "
              f"{cfg.n_layers} of each kernel")
        valid = logits[..., :cfg.vocab].float()
        finite = bool(torch.isfinite(valid).all())
        check(finite and logits.shape == (B, S, cfg.vocab_padded)
              and logits.dtype == _dtype(torch, dname),
              f"{cfg.name} {dname} logits: finite {finite}, shape "
              f"{tuple(logits.shape)}, dtype {logits.dtype}")
        line = {"phase": "lm_forward", "arch": cfg.name, "dtype": dname,
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "n_params": model.n_params(), "batch": B, "seq": S,
                "launches": launched, "logits_finite": finite,
                "logits_abs_max": float(valid.abs().max()),
                "peak_memory_gb": peak_gb,
                "wall_ms_per_forward": wall_ms(
                    torch, lambda: model.forward(params, {"tokens": tokens}),
                    reps=3)}
        line["profile"] = _profile(
            torch, lambda: model.forward(params, {"tokens": tokens}),
            kernels=LM_TRACE_NAMES)
        emit(line)
        del params, logits, valid
        torch.cuda.empty_cache()

    scfg = C.get_config(lm["ssm_arch"])
    smodel = Z.build(scfg)
    sparams = smodel.init(generator=torch.Generator(device=dev).manual_seed(
        0), device=dev)
    stokens = torch.randint(0, scfg.vocab, (B, S), generator=gen, device=dev)
    _lm_reset(FA, SK)
    slogits, _ = smodel.forward(sparams, {"tokens": stokens})
    torch.cuda.synchronize()
    launched = _lm_counts(FA, SK)
    check(launched == _fwd_counts(0, scfg.n_layers),
          f"{scfg.name} forward launches {launched}")
    finite = bool(torch.isfinite(slogits[..., :scfg.vocab]).all())
    check(finite, f"{scfg.name} logits not finite")
    emit({"phase": "lm_forward", "arch": scfg.name, "dtype": "float32",
          "n_layers": scfg.n_layers, "n_params": smodel.n_params(),
          "batch": B, "seq": S, "launches": launched,
          "logits_finite": finite,
          "wall_ms_per_forward": wall_ms(
              torch, lambda: smodel.forward(sparams, {"tokens": stokens}),
              reps=3),
          "profile": _profile(
              torch, lambda: smodel.forward(sparams, {"tokens": stokens}),
              kernels=LM_TRACE_NAMES)})
    del sparams, slogits
    torch.cuda.empty_cache()

    # full width, depth cut: the card's forward against the CPU's
    dcfg = dataclasses.replace(cfg, n_layers=lm["cut_depth"])
    dmodel = Z.build(dcfg)
    dparams = dmodel.init(generator=torch.Generator(device=dev).manual_seed(
        1), device=dev)
    dtok = tokens[:1]
    _lm_reset(FA, SK)
    on_card, _ = dmodel.forward(dparams, {"tokens": dtok})
    torch.cuda.synchronize()
    launched = _lm_counts(FA, SK)
    cpu_params = tree_map(lambda t: t.cpu(), dparams)
    t = time.perf_counter()
    on_cpu, _ = dmodel.forward(cpu_params, {"tokens": dtok.cpu()})
    cpu_s = time.perf_counter() - t
    V = dcfg.vocab
    ref = on_cpu[..., :V]
    scale = float(ref.abs().max())
    diff = float((on_card[..., :V].cpu() - ref).abs().max())
    noise = _noise_floor(torch, dmodel, dparams, {"tokens": dtok}, on_card,
                         V, seed=4)
    check(launched == _fwd_counts(dcfg.n_layers, dcfg.n_layers),
          f"depth-{dcfg.n_layers} forward launches {launched}")
    check(diff <= noise and diff <= LM_MAX_REL * scale,
          f"depth-{dcfg.n_layers} forward: card vs CPU max diff {diff}, "
          f"noise floor {noise}, scale {scale}")
    emit({"phase": "lm_forward", "arch": cfg.name, "check": "card_vs_cpu",
          "n_layers": dcfg.n_layers, "batch": 1, "seq": S,
          "launches": launched, "max_abs_diff": diff, "logits_scale": scale,
          "rel_diff": diff / max(scale, 1e-30), "noise_floor": noise,
          "noise_rel": noise / max(scale, 1e-30), "perturb": PERTURB,
          "cpu_forward_s": cpu_s})
    return main_launches


def _decode_all(torch, model, params, tokens, smax, cache=None):
    """Step every prompt position through decode_step from ``cache`` (a
    zeroed f32 cache of ``smax`` positions when None); (logits (B, S, V),
    cache, mean wall ms per step)."""
    B, S = tokens.shape
    if cache is None:
        cache = model.init_cache(B, smax, dtype=torch.float32,
                                 device=tokens.device)
    outs = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(S):
        lg, cache = model.decode(params, cache, tokens[:, i:i + 1], i)
        outs.append(lg)
    torch.cuda.synchronize()
    return torch.cat(outs, dim=1), cache, (time.perf_counter() - t) * 1e3 / S


def lm_decode_phase(torch, Z, C, FA, SK, dev, lm=LM):
    """Phase 9: decode_step against forward, then greedy tokens."""
    cfg = C.get_config(lm["arch"])
    gen = torch.Generator(device=dev).manual_seed(2)
    for depth, B, S, greedy in ((lm["cut_depth"], 1, lm["decode_prompt"], 0),
                                (cfg.n_layers, lm["batch"],
                                 lm["full_prompt"], lm["greedy"])):
        dcfg = dataclasses.replace(cfg, n_layers=depth)
        model = Z.build(dcfg)
        params = model.init(generator=torch.Generator(device=dev).manual_seed(
            3), device=dev)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev)
        _lm_reset(FA, SK)
        full, _ = model.forward(params, {"tokens": tokens})
        launched = _lm_counts(FA, SK)
        steps, cache, step_ms = _decode_all(torch, model, params, tokens,
                                            S + greedy + 1)
        V = cfg.vocab
        scale = float(full[..., :V].abs().max())
        diff = float((steps[..., :V] - full[..., :V]).abs().max())
        noise = _noise_floor(torch, model, params, {"tokens": tokens}, full,
                             V, seed=5)
        check(diff <= noise and diff <= LM_MAX_REL * scale,
              f"decode vs forward, depth {depth}: max diff {diff}, noise "
              f"floor {noise}, scale {scale}")
        line = {"phase": "lm_decode", "arch": cfg.name, "n_layers": depth,
                "batch": B, "prompt": S, "window": cfg.window,
                "forward_launches": launched, "max_abs_diff": diff,
                "logits_scale": scale, "rel_diff": diff / max(scale, 1e-30),
                "noise_floor": noise, "noise_rel": noise / max(scale, 1e-30),
                "decode_ms_per_step": step_ms}
        if greedy:
            nxt = steps[:, -1, :V].argmax(dim=-1, keepdim=True)
            out = []
            for i in range(greedy):
                out.append(nxt)
                lg, cache = model.decode(params, cache, nxt, S + i)
                check(bool(torch.isfinite(lg[..., :V]).all()),
                      f"greedy step {i}: non-finite logits")
                nxt = lg[:, -1, :V].argmax(dim=-1, keepdim=True)
            gen_tok = torch.cat(out, dim=1)
            check(bool(((gen_tok >= 0) & (gen_tok < V)).all()),
                  "greedy tokens out of range")
            line["greedy_tokens"] = gen_tok.tolist()
            line["decode_step_profile"] = _profile(
                torch, lambda: model.decode(params, cache, nxt, S + greedy))
        emit(line)
        del params, cache
        torch.cuda.empty_cache()


def sae_serve_phase(torch, params, spec, X, dev):
    """Phase 5c: phase 5's l1,inf ``train_sae`` result compacted and served
    at full width."""
    from repro_torch._tree import leaves, tree_map
    from repro_torch.sae import compact_sae, make_serve_step, sae_apply
    from repro_torch.sae.serve import _SAE_RULES
    from repro_torch.serve import (compact_model, recompact_model,
                                   refresh_model)
    x = torch.from_numpy(X).to(dev)
    d = int(params["enc1"]["w"].shape[0])
    compact = compact_sae(params, (spec,))
    J = compact.n_selected
    alive = np.nonzero((params["enc1"]["w"] != 0).any(dim=1).cpu().numpy())[0]
    check(np.array_equal(compact.sel, alive),
          "sae_serve: sel is not the support of the structural zeros")
    check(0 < J < d, f"sae_serve: {J} of {d} features selected")
    step = make_serve_step(compact)

    def served(step_params, dense_params, sel):
        """max |compact - dense| of z and of xhat on sel, and the dense
        outputs' scale; the served outputs too."""
        z, xs = step(step_params, x)
        z_d, xh_d = sae_apply(dense_params, x)
        xh_sel = xh_d[:, torch.as_tensor(sel, device=dev).long()]
        scale = max(float(z_d.abs().max()), float(xh_sel.abs().max()), 1.0)
        err = max(float((z - z_d).abs().max()),
                  float((xs - xh_sel).abs().max()))
        return err, scale, (z, xs)

    err, scale, (z, xs) = served(compact.params, params, compact.sel)
    tol = SERVE_TOL["float32"]
    check(err <= tol * scale,
          f"sae_serve: compact vs dense max err {err} (scale {scale})")
    check(tuple(z.shape) == (x.shape[0], 2) and tuple(xs.shape)
          == (x.shape[0], J), f"sae_serve: shapes {z.shape}, {xs.shape}")
    z2, xs2 = step(compact.params, x)
    rerun = bits_equal(torch, z, z2) and bits_equal(torch, xs, xs2)
    check(rerun, "sae_serve: a rerun is not bit-equal")

    # the checkpoint lifecycle: a refresh (same support, new values), then
    # a live re-compaction after one more feature dies
    cm = compact_model(params, (spec,), rules=_SAE_RULES)
    enc = "enc1/w"
    params2 = tree_map(lambda a: a * 1.5, params)
    cm2 = refresh_model(cm, params2)
    shapes = lambda t: [tuple(a.shape) for a in leaves(t)]
    err2, scale2, _ = served(cm2.params, params2, cm2.sels[enc])
    params3 = tree_map(lambda a: a.clone(), params2)
    params3["enc1"]["w"][int(cm2.sels[enc][0])] = 0.0
    cm3 = recompact_model(cm2, params3)
    err3, scale3, _ = served(cm3.params, params3, cm3.sels[enc])
    check(shapes(cm2.params) == shapes(cm.params) == shapes(cm3.params),
          "sae_serve: refresh or recompact changed a shape")
    check(cm3.live[enc] == J - 1 and cm3.slot_width(enc) == J,
          f"sae_serve: recompact live {cm3.live[enc]}, slot "
          f"{cm3.slot_width(enc)}, want {J - 1}, {J}")
    check(err2 <= tol * scale2 and err3 <= tol * scale3,
          f"sae_serve: refreshed {err2}, recompacted {err3} vs dense")
    line = {"phase": "sae_serve", "n_features": d, "selected": J,
            "ratio": compact.compaction_ratio, "batch": int(x.shape[0]),
            "max_abs_err": err, "scale": scale, "tol": tol * scale,
            "rerun_bit_equal": rerun,
            "refresh_max_abs_err": err2, "recompact_max_abs_err": err3,
            "recompact_live": cm3.live[enc],
            "wall_ms_compact": wall_ms(
                torch, lambda: step(compact.params, x), reps=20),
            "wall_ms_dense": wall_ms(
                torch, lambda: sae_apply(params, x), reps=20)}
    emit(line)


def _compact_vs_dense(torch, model, dense, compact, batch, V, FA, SK,
                      f32_dense=None):
    """One forward of the compact and the dense params: (line, dense f32
    logits). The noise floor is the model's own: in f32 how far ~ten f32
    ulps of weight noise move the dense logits; in bf16 how far the dense
    bf16 logits lie from the dense f32 ones (``f32_dense``)."""
    n_layers = model.cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lm_reset(FA, SK)
    out_c, _ = model.forward(compact, batch)
    torch.cuda.synchronize()
    launched = _lm_counts(FA, SK)
    peak_c = torch.cuda.max_memory_allocated() / 1e9
    check(launched == _fwd_counts(n_layers, n_layers),
          f"lm_compact depth {n_layers}: compact forward launches {launched}")
    rerun = bits_equal(torch, out_c, model.forward(compact, batch)[0])
    torch.cuda.reset_peak_memory_stats()
    out_d, _ = model.forward(dense, batch)
    torch.cuda.synchronize()
    peak_d = torch.cuda.max_memory_allocated() / 1e9
    lc, ld = out_c[..., :V].float(), out_d[..., :V].float()
    if f32_dense is None:
        noise = _noise_floor(torch, model, dense, batch, out_d, V, seed=8)
    else:
        noise = float((ld - f32_dense).abs().max())
    scale = float(ld.abs().max())
    line = {"n_layers": n_layers, "launches": launched,
            "max_abs_diff": float((lc - ld).abs().max()),
            "noise_floor": noise, "logits_scale": scale,
            "logits_finite": bool(torch.isfinite(lc).all()),
            "rerun_bit_equal": rerun,
            "peak_memory_gb_compact": peak_c, "peak_memory_gb_dense": peak_d}
    line["rel_diff"] = line["max_abs_diff"] / max(scale, 1e-30)
    line["noise_rel"] = noise / max(scale, 1e-30)
    return line, ld


def lm_compact_params(torch, Z, C, dev, lm=LM, depth=None):
    """Phase 10's model: hymba-1.5b's config and its full-size params from
    seed 6, each hidden unit's ``mlp/w1`` column scaled by one U(0, 1)
    factor shared by every layer. At the plain init every hidden unit's w1
    column looks alike: the projection kills only the units whose column
    sums fall lowest, a different few in each layer, and the union over
    the 32 layers keeps every unit; with the shared factor, as in a
    checkpoint whose weak units are weak throughout, the layers share most
    of their dead units. ``scripts/torch_lm_compact_probe.py`` starts from
    the same params. ``depth`` cuts the model to its first layers."""
    cfg = C.get_config(lm["arch"])
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    gen = torch.Generator(device=dev).manual_seed(6)
    params = Z.build(cfg).init(generator=gen, device=dev)
    unit = torch.rand((cfg.d_ff,), generator=gen, device=dev)
    for block in params["blocks"].values():
        block["mlp"]["w1"] *= unit
    return cfg, params


def _norm_over_radius(params, specs):
    """The largest l1,inf norm over its radius of any slice that ``specs``
    constrain in ``params``."""
    from repro_torch._tree import flatten_with_path
    from repro_torch.core.constraints import _first_match
    from repro_torch.core.l1inf import l1inf_norm
    ratio = 0.0
    for path, leaf in flatten_with_path(params):
        spec = _first_match(specs, path, leaf)
        if spec is not None:
            for sl in leaf.reshape((-1,) + leaf.shape[-2:]):
                ratio = max(ratio, float(l1inf_norm(sl, axis=spec.axis))
                            / spec.radius)
    return ratio


def _projection_vs_newton(torch, params, dense, specs):
    """The kernel engine's projection of ``params`` (``dense``) against
    ``ProjectionEngine(solver="newton")``'s, and the l1,inf norm of every
    projected slice over its radius (the largest)."""
    from repro_torch._tree import flatten_with_path
    from repro_torch.core import ProjectionEngine
    newton, _ = ProjectionEngine(specs, solver="newton").apply(params)
    flat_k = dict(flatten_with_path(dense))
    err, scale = 0.0, 1.0
    for path, leaf in flatten_with_path(newton):
        err = max(err, float((flat_k[path] - leaf).abs().max()))
        scale = max(scale, float(leaf.abs().max()))
    return err, scale, _norm_over_radius(dense, specs)


def _mlp_by_layer(torch, dense, compact, cfg, dev, lm=LM):
    """Each layer's MLP alone, compact against dense, on one N(0, 1) input
    of the forward's shape, in f32 and bf16: the worst layer's max |diff|
    over the dense output's scale. No layer feeds the next, so no rounding
    is amplified, and a wrong gather or scatter shows at its own layer."""
    from repro_torch.models.layers import mlp_apply
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((lm["batch"], lm["seq"], cfg.d_model), generator=g,
                    device=dev)
    worst = {}
    for dname in ("float32", "bfloat16"):
        dt = _dtype(torch, dname)
        xd, worst[dname] = x.to(dt), 0.0
        for key, block in dense["blocks"].items():
            mlp_d, mlp_c = block["mlp"], compact["blocks"][key]["mlp"]
            for i in range(mlp_d["w1"].shape[0]):
                layer = lambda t: _cast(torch, {k: v[i] for k, v in
                                                t.items()}, dt)
                yd = mlp_apply(layer(mlp_d), xd, cfg.mlp_kind).float()
                yc = mlp_apply(layer(mlp_c), xd, cfg.mlp_kind).float()
                worst[dname] = max(worst[dname], float(
                    (yc - yd).abs().max() / yd.abs().max()))
    return worst


def lm_compact_phase(torch, Z, C, K, FA, SK, dev, lm=LM):
    """Phase 10: hymba-1.5b at full size projected through the l1,inf
    kernels under its own specs and held to the Newton's projection,
    compacted, and served against the dense projected params: each
    layer's MLP alone at full depth, then forward in f32 and bf16 and
    decode, at full depth and at the first ``cut_depth`` layers."""
    from repro_torch._tree import tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.serve import compact_model
    cfg, params = lm_compact_params(torch, Z, C, dev, lm)
    V, B, S = cfg.vocab, lm["batch"], lm["seq"]
    engine = ProjectionEngine(cfg.projection_specs, solver="kernel")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t = time.perf_counter()
    dense, _ = engine.apply(params)
    torch.cuda.synchronize()
    proj_s = time.perf_counter() - t
    proj_launches = K.launch_counts()
    check(all(proj_launches[k] > 0 for k in REPLACES),
          f"lm_compact: projection launches {proj_launches}")
    # the projection itself, held as phase 4 holds the train steps
    proj_err, proj_scale, norm_ratio = _projection_vs_newton(
        torch, params, dense, cfg.projection_specs)
    check(proj_err <= 3e-4 * proj_scale,
          f"lm_compact: kernel projection vs newton max err {proj_err} "
          f"(scale {proj_scale})")
    check(norm_ratio <= 1 + 1e-4,
          f"lm_compact: a projected slice's l1,inf norm is {norm_ratio} "
          f"of its radius")
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cm = compact_model(dense, cfg.projection_specs)
    compact_s = time.perf_counter() - t
    w1 = next(p for p in cm.live if p.endswith("mlp/w1"))
    m = cm.supports[w1].n_cols
    check(0 < cm.live[w1] < m, f"lm_compact: {cm.live[w1]} of {m} live")
    check(any(p.endswith("ssm/wx") for p in cm.skipped),
          f"lm_compact: ssm/wx not skipped ({cm.skipped})")
    by_layer = _mlp_by_layer(torch, dense, cm.params, cfg, dev, lm)
    for dname, worst in by_layer.items():
        check(worst <= SERVE_TOL[dname],
              f"lm_compact: {dname} MLP compact vs dense {worst} of the "
              f"output's scale in some layer")
    line = {"phase": "lm_compact", "arch": cfg.name, "batch": B, "seq": S,
            "projection_s": proj_s, "projection_launches": proj_launches,
            "projection_max_abs_err_vs_newton": proj_err,
            "projection_scale": proj_scale,
            "l1inf_norm_over_radius_max": norm_ratio,
            "compact_s": compact_s, "ratios": cm.compaction_ratios(),
            "live": dict(cm.live),
            "n_cols": {p: s.n_cols for p, s in cm.supports.items()},
            "skipped": list(cm.skipped),
            "mlp_by_layer_rel_diff_max": by_layer}
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, V, (B, S), generator=gen,
                                     device=dev)}
    P = lm["full_prompt"]
    prompt = batch["tokens"][:, :P]
    # Projected at this init, the model amplifies f32 rounding past its
    # first few layers until ~ten ulps of weight noise move the full-depth
    # logits by about their own scale (scripts/torch_lm_compact_probe.py):
    # there the logits' distance is reported, not checked, and every layer
    # was held alone above. The first cut_depth layers of the same params,
    # where the floor is far below the logits' scale, are checked: f32
    # forward and decode within the floor and LM_MAX_REL, bf16 (whose
    # floor, the distance from f32, is still near the scale) within
    # SERVE_TOL's bf16 fraction.
    for depth in (cfg.n_layers, lm["cut_depth"]):
        model = Z.build(dataclasses.replace(cfg, n_layers=depth))
        cut = lambda p: {**p, "blocks": tree_map(lambda a: a[:depth],
                                                 p["blocks"])}
        dp, cp = cut(dense), cut(cm.params)
        rows, f32_dense = {}, None
        for dname in ("float32", "bfloat16"):
            dt = _dtype(torch, dname)
            dpt, cpt = _cast(torch, dp, dt), _cast(torch, cp, dt)
            row, ld = _compact_vs_dense(torch, model, dpt, cpt, batch, V,
                                        FA, SK, f32_dense)
            if dname == "float32":
                f32_dense = ld
            row["wall_ms_compact"] = wall_ms(
                torch, lambda: model.forward(cpt, batch), reps=3)
            row["wall_ms_dense"] = wall_ms(
                torch, lambda: model.forward(dpt, batch), reps=3)
            rows[dname] = row
            del dpt, cpt, ld
            torch.cuda.empty_cache()
        del f32_dense
        # decode of a short prompt, compact against dense
        dec_d, _, ms_d = _decode_all(torch, model, dp, prompt, P + 1)
        dec_c, _, ms_c = _decode_all(torch, model, cp, prompt, P + 1)
        full, _ = model.forward(dp, {"tokens": prompt})
        rows["decode"] = {
            "batch": B, "prompt": P,
            "max_abs_diff": float((dec_c[..., :V] - dec_d[..., :V]).abs()
                                  .max()),
            "noise_floor": _noise_floor(torch, model, dp, {"tokens": prompt},
                                        full, V, seed=9),
            "logits_scale": float(full[..., :V].abs().max()),
            "decode_ms_per_step_compact": ms_c,
            "decode_ms_per_step_dense": ms_d}
        del dec_d, dec_c, full
        for what, row in rows.items():
            ok = (row.get("logits_finite", True)
                  and row.get("rerun_bit_equal", True))
            row["distance_checked"] = depth < cfg.n_layers
            if row["distance_checked"]:
                if what == "bfloat16":
                    bound = SERVE_TOL["bfloat16"] * row["logits_scale"]
                else:
                    bound = min(row["noise_floor"],
                                LM_MAX_REL * row["logits_scale"])
                row["bound"] = bound
                ok = ok and row["max_abs_diff"] <= bound
            check(ok, f"lm_compact depth {depth} {what}: {row}")
        line[f"depth_{depth}"] = rows
    emit(line)
    del dense, cm
    torch.cuda.empty_cache()


def _fleet_requests(rng, n, V, prompt, budget):
    """``n`` requests from ``rng``: prompt lengths uniform in ``prompt``
    (inclusive), token ids uniform over the vocab, budgets heavy-tailed
    (the shortest plus a Pareto(1.2) tail, capped at ``budget[1]``)."""
    lens = rng.integers(prompt[0], prompt[1] + 1, size=n)
    tail = np.floor(rng.pareto(1.2, size=n) * 4).astype(np.int64)
    budgets = np.minimum(budget[0] + tail, budget[1])
    return ([rng.integers(0, V, size=int(k)).tolist() for k in lens],
            [int(b) for b in budgets])


def _cache_ptrs(eng):
    from repro_torch._tree import leaves
    return [a.data_ptr() for a in leaves(eng._cache)]


def _solo_tokens(eng, params, prompt, max_new, switches=()):
    """``prompt`` served alone by ``eng`` (reloaded with ``params``, a
    dense tree or a ``CompactModel``), every other slot idle; ``switches``:
    (local step, engine method, dense tree) applied after that many
    steps. Returns the completion's tokens."""
    if hasattr(params, "sels"):
        eng.load_compact(params)
    else:
        eng.load(params)
    eng.submit(prompt, max_new)
    steps, done = 0, []
    for at, method, tree in switches:
        while steps < at:
            done += eng.step()
            steps += 1
        getattr(eng, method)(tree)
    done += eng.drain()
    assert len(done) == 1, done
    return done[0].tokens


def _eager_tokens(torch, model, params, prompt, max_new, B, smax, dev):
    """Greedy tokens of ``prompt`` in row 0 of a width-``B`` eager
    ``decode_step`` loop (the other rows fed token 0 at position 0): the
    engine's step without the graph."""
    cache = model.init_cache(B, smax, dtype=torch.float32, device=dev)
    out, feed = list(prompt), prompt[0]
    for p in range(len(prompt) + max_new - 1):
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        tok[0, 0] = feed
        pos = torch.zeros((B,), dtype=torch.long, device=dev)
        pos[0] = p
        lg, cache = model.decode(params, cache, tok, pos)
        nxt = int(lg[0, -1].argmax())
        if p + 1 < len(prompt):
            feed = prompt[p + 1]
        else:
            out.append(nxt)
            feed = nxt
    return out


def _steady(torch, eng, n, prompt_len, V, rng):
    """Fill every slot with a request longer than ``n`` steps and time ``n``
    steps of the full engine: per-step wall ms (host clock; each step
    waits only for the previous step's outputs), allocated memory before
    and after, the largest in between."""
    rids = [eng.submit(rng.integers(0, V, size=prompt_len).tolist(), n + 8)
            for _ in range(eng.B)]
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    mem0, peak, times = torch.cuda.memory_allocated(), 0, []
    for _ in range(n):
        t = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t) * 1e3)
        peak = max(peak, torch.cuda.memory_allocated())
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    for rid in rids:
        eng.cancel(rid)
    eng.drain()
    return {"step_ms_median": float(np.median(times)),
            "step_ms_max": float(np.max(times)),
            "mem_before": mem0, "mem_after": mem1, "mem_peak": peak}


def _replay_ms(torch, eng, reps=20):
    """Device ms of one replay of the engine's graph (CUDA events around
    ``reps`` replays on its stream), on an engine with no row active."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(eng._stream):
        eng._graph.replay()
        start.record()
        for _ in range(reps):
            eng._graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _engine_report(torch, eng, model, params, name, first_ptrs, steady,
                   eager_B, dev, fleet):
    """The per-engine checks and numbers: one capture, the cache's
    addresses, flat memory over the steady steps, replays equal to steps;
    graphed step wall ms, one replay's device ms, the eager decode_step at
    the same width, one traced engine step."""
    st = eng.stats()
    check(eng.n_traces == 1, f"fleet_serve {name}: {eng.n_traces} captures")
    check(_cache_ptrs(eng) == first_ptrs,
          f"fleet_serve {name}: a cache tensor moved")
    check(steady["mem_after"] == steady["mem_before"]
          and steady["mem_peak"] == steady["mem_before"],
          f"fleet_serve {name}: allocated memory moved over the steady "
          f"steps: {steady}")
    check(eng.n_replays == st["steps"],
          f"fleet_serve {name}: {eng.n_replays} replays, {st['steps']} "
          f"steps")
    replay = _replay_ms(torch, eng)
    cache = model.init_cache(eager_B, fleet["max_seq"], dtype=torch.float32,
                             device=dev)
    tok = torch.zeros((eager_B, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((eager_B,), dtype=torch.long, device=dev)
    eager = wall_ms(torch, lambda: model.decode(params, cache, tok, pos),
                    reps=3)
    # device ms of the step with its one cache copy and in place, each
    # captured on its own (no host in the number)
    graph_dev = {"decode_step": time_ms(
        torch, lambda: model.decode(params, cache, tok, pos), 150.0),
        "decode_step_": time_ms(
        torch, lambda: model.decode_(params, cache, tok, pos), 150.0)}
    del cache
    # a steady window of ten engine steps under the profiler
    prof = _profile(torch, lambda: [eng.step() for _ in range(10)])
    prof["steps"] = 10
    eng.flush()
    lat = eng.latency_report()
    return {"n_traces": eng.n_traces, "replays": eng.n_replays,
            "stats": st, "graph_step_wall_ms_median": steady[
                "step_ms_median"], "steady": steady,
            "replay_device_ms": replay,
            "idle_share_from_replay": max(
                0.0, 1.0 - replay / steady["step_ms_median"]),
            "eager_decode_step_ms": eager, "eager_batch": eager_B,
            "graph_device_ms": graph_dev,
            "traced_step": prof,
            "ttft_ms": {k: lat["ttft"][k] * 1e3 for k in ("p50", "p99")},
            "per_token_ms": {k: lat["per_token"][k] * 1e3
                             for k in ("p50", "p99")}}


def fleet_serve_phase(torch, Z, C, K, dev, fleet=FLEET, seed=11):
    """Phase 10b: the serving loop. hymba-1.5b at full width, FLEET's depth
    (f32, the reference's init) behind ``FleetEngine``: (a) the dense
    engine under churn, (b) the compacted engine through a mid-flight
    refresh and recompact."""
    from repro_torch._tree import leaves, tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.serve import (EngineConfig, FleetEngine,
                                   compact_model)
    cfg = dataclasses.replace(C.get_config(fleet["arch"]),
                              n_layers=fleet["depth"])
    model = Z.build(cfg)
    V, B, smax = cfg.vocab, fleet["slots"], fleet["max_seq"]
    ecfg = EngineConfig(max_seq=smax)
    rng = np.random.default_rng(seed)

    # (a) the dense engine under churn: three waves, one cancel
    params = model.init(generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    prompts, budgets = _fleet_requests(rng, fleet["requests"], V,
                                       fleet["prompt"], fleet["budget"])
    eng = FleetEngine(model, B, ecfg)
    eng.load(params)
    waves = np.array_split(np.arange(len(prompts)), fleet["waves"])
    rids, done, first_ptrs = {}, [], None
    cancelled = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w, idx in enumerate(waves):
        for i in idx:
            rids[eng.submit(prompts[i], budgets[i])] = int(i)
        for _ in range(fleet["wave_steps"]):
            done += eng.step()
            if first_ptrs is None:
                first_ptrs = _cache_ptrs(eng)
        if w == 0:
            # the request of wave 0 (all admitted at the first step) with
            # the most left to do that has not finished
            finished = {c.rid for c in done}
            left = {r: len(prompts[i]) + budgets[i] for r, i in rids.items()
                    if r not in finished}
            cancelled = max(left, key=left.get)
            check(eng.cancel(cancelled),
                  f"fleet_serve dense: cancel({cancelled}) refused")
    done += eng.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    got = {c.rid: c for c in done}
    check(sorted(got) == sorted(rids),
          f"fleet_serve dense: {len(got)} of {len(rids)} completions")
    gen_tokens = sum(len(c.generated) for c in got.values())
    solo = FleetEngine(model, B, ecfg)
    mismatched = []
    t = time.perf_counter()
    for r, i in rids.items():
        want = _solo_tokens(solo, params, prompts[i], budgets[i])
        c = got[r]
        ok = (c.tokens == want[:len(c.tokens)] and c.evicted
              if r == cancelled else
              c.tokens == want and not c.evicted and not c.truncated)
        if not ok:
            mismatched.append(r)
    solo_s = time.perf_counter() - t
    check(not mismatched,
          f"fleet_serve dense: continuous != solo for rids {mismatched}")
    check(solo.n_traces == 1,
          f"fleet_serve dense: the solo engine captured {solo.n_traces}x")
    # the graph against no graph: the shortest three requests
    short = sorted((r for r in rids if r != cancelled),
                   key=lambda r: len(prompts[rids[r]]) + budgets[rids[r]])
    eager_bad = []
    t = time.perf_counter()
    for r in short[:fleet["eager_requests"]]:
        i = rids[r]
        want = _eager_tokens(torch, model, params, prompts[i], budgets[i],
                             B, smax, dev)
        if want != got[r].tokens:
            eager_bad.append(r)
    eager_s = time.perf_counter() - t
    check(not eager_bad,
          f"fleet_serve dense: graph != eager decode_step for {eager_bad}")
    steady = _steady(torch, eng, fleet["steady"], 4, V, rng)
    dense_line = _engine_report(torch, eng, model, params, "dense",
                                first_ptrs, steady, B, dev, fleet)
    dense_line.update({
        "requests": len(rids), "cancelled": cancelled,
        "generated_tokens": gen_tokens, "serve_s": serve_s,
        "tokens_per_s": gen_tokens / serve_s, "solo_s": solo_s,
        "eager_checked": short[:fleet["eager_requests"]],
        "eager_s": eager_s, "continuous_eq_solo": not mismatched,
        "graph_eq_eager": not eager_bad,
        "cache_bytes": sum(a.numel() * a.element_size()
                           for a in leaves(eng._cache))})
    del eng, solo, params
    torch.cuda.empty_cache()

    # (b) the compacted engine: refresh (values x 1.25) and recompact (one
    # more column dead) mid-flight, against solo runs switching at the
    # same local depth
    _, raw = lm_compact_params(torch, Z, C, dev, depth=cfg.n_layers)
    dense, _ = ProjectionEngine(cfg.projection_specs,
                                solver="kernel").apply(raw)
    del raw
    cm = compact_model(dense, cfg.projection_specs)
    w1 = next(p for p in cm.live if p.endswith("mlp/w1"))
    victim = int(cm.sels[w1][0])
    dense2 = tree_map(lambda a: a * 1.25, dense)
    dense3 = tree_map(torch.clone, dense2)
    for block in dense3["blocks"].values():
        block["mlp"]["w1"][..., victim] = 0.0
    del dense
    torch.cuda.empty_cache()
    cprompts, cbudgets = _fleet_requests(rng, B, V, fleet["compact_prompt"],
                                         fleet["compact_budget"])
    switches = ((fleet["refresh_at"], "refresh", dense2),
                (fleet["recompact_at"], "recompact", dense3))
    eng = FleetEngine(model, B, ecfg)
    eng.load_compact(cm)
    crids = [eng.submit(p, n) for p, n in zip(cprompts, cbudgets)]
    done, steps, first_ptrs = [], 0, None
    t0 = time.perf_counter()
    for at, method, tree in switches:
        while steps < at:
            done += eng.step()
            steps += 1
            if first_ptrs is None:
                first_ptrs = _cache_ptrs(eng)
        getattr(eng, method)(tree)
    live_after = eng.compact.live[w1]
    done += eng.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    got = {c.rid: c for c in done}
    gen_tokens = sum(len(c.generated) for c in got.values())
    check(live_after == cm.live[w1] - 1,
          f"fleet_serve compact: live {live_after} after the recompact, "
          f"{cm.live[w1]} before")
    solo = FleetEngine(model, B, ecfg)
    mismatched = []
    for r, p, n in zip(crids, cprompts, cbudgets):
        if got[r].tokens != _solo_tokens(solo, cm, p, n, switches):
            mismatched.append(r)
    check(not mismatched,
          f"fleet_serve compact: mid-flight switch != solo for {mismatched}")
    check(solo.n_traces == 1,
          f"fleet_serve compact: the solo engine captured {solo.n_traces}x")
    del solo
    steady = _steady(torch, eng, fleet["steady"], 4, V, rng)
    compact_line = _engine_report(torch, eng, model, eng.params, "compact",
                                  first_ptrs, steady, B, dev, fleet)
    compact_line.update({
        "requests": len(crids), "refresh_at": fleet["refresh_at"],
        "recompact_at": fleet["recompact_at"], "live_before": cm.live[w1],
        "live_after": live_after, "slot_width": cm.slot_width(w1),
        "n_cols": cm.supports[w1].n_cols, "generated_tokens": gen_tokens,
        "serve_s": serve_s, "tokens_per_s": gen_tokens / serve_s,
        "midflight_eq_solo": not mismatched})
    emit({"phase": "fleet_serve", "arch": cfg.name, "slots": B,
          "max_seq": smax, "dense": dense_line, "compact": compact_line})
    del eng, cm, dense2, dense3
    torch.cuda.empty_cache()


def _every_k(cfg, k):
    return dataclasses.replace(cfg, projection_specs=tuple(
        dataclasses.replace(spec, every_k=k) for spec in cfg.projection_specs))


def _recording_engine(ProjectionEngine, specs, pre):
    """A ``ProjectionEngine(specs, solver="kernel")`` that keeps a copy of
    the params it is asked to project in ``pre``."""
    from repro_torch._tree import tree_map

    class Recording(ProjectionEngine):
        def apply(self, params, *, step=None, state=None, with_stats=False):
            pre.append(tree_map(lambda a: a.clone(), params))
            return super().apply(params, step=step, state=state,
                                 with_stats=with_stats)
    return Recording(specs, solver="kernel")


def _w1(params):
    return {"blocks": {"p0_global": {"mlp": {
        "w1": params["blocks"]["p0_global"]["mlp"]["w1"]}}}}


def lm_train_phase(torch, Z, C, FA, K, dev, tr=TRAIN):
    """Phase 11, this slice's main path: ``train`` of stablelm-3b at full
    width and depth, f32, B 1 x S 2048, ten steps with
    ``proj_solver="kernel"``; the config's every_k 10 fires the projection
    at the tenth step. Then a traced step, and a step whose engine
    projects (every_k 1) and keeps what it projects, for the check against
    the Newton. Returns the launches of the run."""
    from repro_torch.core import ProjectionEngine
    from repro_torch.data import LMBatcher, SyntheticLM
    from repro_torch.optim import AdamConfig
    from repro_torch.train import loop as TL
    cfg = dataclasses.replace(C.get_config(tr["arch"]), n_layers=tr["depth"])
    model = Z.build(cfg)
    batcher = LMBatcher(SyntheticLM(cfg.vocab, seed=1), 1, tr["seq"] + 1)
    tcfg = TL.TrainConfig(steps=tr["steps"], proj_solver="kernel",
                          log_every=1, ckpt_dir=None)
    every_k = {spec.every_k for spec in cfg.projection_specs}
    layers, steps = cfg.n_layers, tr["steps"]
    # per step and layer: the forward, its recompute under remat, and
    # the backward; the projection once, at the step every_k divides
    want_flash = {"flash_attention_fwd": (2 if cfg.remat else 1) * layers
                  * steps, "flash_attention_bwd": layers * steps}
    want_l1inf = {k: steps // max(every_k) for k in REPLACES}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    K.reset_launch_counts()
    t = time.perf_counter()
    out = TL.train(model, batcher, tcfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    flash, l1inf = FA.launch_counts(), K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"lm_train losses {losses}")
    check(flash == want_flash, f"lm_train flash launches {flash}, want "
          f"{want_flash}")
    check(l1inf == want_l1inf, f"lm_train l1,inf launches {l1inf}, want "
          f"{want_l1inf}")
    # the last step projected: every slice within the radius
    params = out["params"]
    norm_ratio = _norm_over_radius(_w1(params), cfg.projection_specs)
    check(norm_ratio <= 1 + 1e-4, f"lm_train: l1,inf norm {norm_ratio} of "
          f"the radius")
    step_ms = [m["step_time_s"] * 1e3 for m in out["step_metrics"]]
    # one traced step more on the trained state
    acfg = AdamConfig(lr=tcfg.lr)
    step_fn = TL.build_accum_step(model, acfg, tcfg, engine=ProjectionEngine(
        cfg.projection_specs, solver="kernel"))
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in batcher.get(steps).items()}
    state = [params, out["opt_state"], out["proj_state"]]
    del out, params

    def one_step():
        state[:3] = step_fn(*state, batch, TL.lr_at(tcfg, steps),
                            count=steps + 1)[:3]

    profile = _profile(torch, one_step, kernels=(
        "flash_f32_kernel", "bwd_main_kernel", "bwd_delta_kernel"))
    # one step more through an engine that projects at every step and
    # keeps the weights it projects: the kernel projection against the
    # Newton's on those weights
    specs1 = _every_k(cfg, 1).projection_specs
    pre = []
    rec_fn = TL.build_accum_step(model, acfg, tcfg, engine=_recording_engine(
        ProjectionEngine, specs1, pre))
    K.reset_launch_counts()
    state[:3] = rec_fn(*state, batch, TL.lr_at(tcfg, steps + 1),
                       count=steps + 2)[:3]
    torch.cuda.synchronize()
    rec_l1inf = K.launch_counts()
    check(len(pre) == 1 and rec_l1inf == {k: 1 for k in REPLACES},
          f"lm_train projecting step: {len(pre)} projections, l1,inf "
          f"launches {rec_l1inf}")
    err, scale, rec_ratio = _projection_vs_newton(
        torch, _w1(pre[0]), _w1(state[0]), specs1)
    del pre
    check(rec_ratio <= 1 + 1e-4, f"lm_train projecting step: l1,inf norm "
          f"{rec_ratio} of the radius")
    check(err <= 3e-4 * scale, f"lm_train: kernel projection vs newton max "
          f"err {err} (scale {scale})")
    emit({"phase": "lm_train", "arch": cfg.name, "n_layers": layers,
          "d_model": cfg.d_model, "n_params": model.n_params(), "batch": 1,
          "seq": tr["seq"], "steps": steps, "remat": cfg.remat,
          "every_k": sorted(every_k), "losses": losses,
          "launches": {**flash, **l1inf},
          "launches_per_step": {k: v / steps for k, v in flash.items()},
          "expected_launches": {**want_flash, **want_l1inf},
          "step_ms": step_ms,
          "median_step_ms_2_to_9": float(np.median(step_ms[1:9])),
          "wall_s": wall_s, "peak_memory_gb": peak_gb,
          "norm_over_radius": norm_ratio,
          "projecting_step": {"launches": rec_l1inf,
                              "projection_vs_newton_max_err": err,
                              "projection_scale": scale,
                              "norm_over_radius": rec_ratio},
          "profile": profile})
    del state, batch
    torch.cuda.empty_cache()
    return {**flash, **l1inf}


def _adam_direction(torch, acfg, mu, nu, p):
    """Adam's update direction at the first step from the stored moments,
    float64: mhat / (sqrt(vhat) + eps) (+ weight decay * p)."""
    f32 = lambda x: float(np.float32(x))
    b1c, b2c = 1 - f32(acfg.b1), 1 - f32(acfg.b2)
    u = (mu.double() / b1c) / (torch.sqrt(nu.double() / b2c) + acfg.eps)
    return u + acfg.weight_decay * p.double() if acfg.weight_decay else u


def lm_train_cpu_phase(torch, Z, C, FA, SK, dev, arch=TRAIN["arch"],
                       tr=TRAIN, lm=LM):
    """Phases 11b and 13's last check: one ``build_accum_step`` step of
    ``arch`` (stablelm-3b, hymba-1.5b) at full width, depth ``cut_depth``,
    B 1 x S 2048, on the card and on CPU copies of the same params and
    batch; a third step on the card from the PERTURB-perturbed params
    gives the noise floor of each moment."""
    from repro_torch._tree import flatten_with_path, tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.data import LMBatcher, SyntheticLM
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.train import loop as TL
    cfg = dataclasses.replace(C.get_config(arch), n_layers=lm["cut_depth"])
    model = Z.build(cfg)
    tcfg = TL.TrainConfig(proj_solver="kernel")
    # no global-norm clip here: its one scale couples every leaf to the
    # worst-conditioned gradients (attn wq/wk, the embedding, which a
    # 1e-6 weight noise moves by half their scale at this init), so the
    # moments would compare that scale and not each leaf's gradient
    acfg = AdamConfig(lr=tcfg.lr, clip_norm=None)
    lr = TL.lr_at(tcfg, 0)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in _lm_batcher(cfg, tr).get(0).items()}
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
        a.shape, generator=g, device=dev)), params)
    cpu = tree_map(lambda a: a.to("cpu", copy=True), params)
    old = tree_map(lambda a: a.clone(), params)
    # the logits' floor, before the in-place steps move the params
    V = cfg.vocab
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": batch["tokens"]})
        moved, _ = model.forward(pert, {"tokens": batch["tokens"]})
        logit_floor = float((moved[..., :V] - logits[..., :V]).abs().max())
        logit_scale = float(logits[..., :V].abs().max())
    del logits, moved

    def run(p, b):
        engine = ProjectionEngine(cfg.projection_specs, solver="kernel")
        step_fn = TL.build_accum_step(model, acfg, tcfg, engine=engine)
        return step_fn(p, adam_init(p, acfg), engine.init_state(p), b, lr,
                       count=1)

    _lm_reset(FA, SK)
    card = run(params, batch)
    torch.cuda.synchronize()
    launched = _lm_counts(FA, SK)
    floor = run(pert, batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = run(cpu, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t
    want = _step_counts(cfg)
    check(launched == want, f"lm_train_cpu {cfg.name} launches {launched}, "
          f"want {want}")
    loss_diff = abs(float(card[3]) - float(host[3]))
    check(np.isfinite(float(card[3])) and loss_diff <= 2 * logit_floor,
          f"lm_train_cpu {cfg.name}: loss card {float(card[3])} vs CPU "
          f"{float(host[3])}, logits' floor {logit_floor}")
    eps32 = float(np.finfo(np.float32).eps)
    rows = {}
    flat = lambda tree: dict(flatten_with_path(tree))
    moments = {}
    for mname, pick in (("mu", lambda o: o.mu), ("nu", lambda o: o.nu)):
        fc, ff, fh = (flat(pick(r[1])) for r in (card, floor, host))
        for path, a in fc.items():
            h = fh[path].to(dev)
            diff = float((a - h).abs().max())
            noise = float((ff[path] - a).abs().max())
            scale = float(h.abs().max())
            moments.setdefault(path, {})[mname] = {
                "max_abs_diff": diff, "noise_floor": noise, "scale": scale,
                "rel_fro": float(torch.linalg.vector_norm(a - h)
                                 / torch.linalg.vector_norm(h))}
            check(diff <= noise, f"lm_train_cpu {cfg.name} {mname} {path}: "
                  f"card vs "
                  f"CPU max diff {diff}, noise floor {noise}, scale {scale}")
    fp_c, fp_h, fp_o = flat(card[0]), flat(host[0]), flat(old)
    fmu_c, fnu_c = flat(card[1].mu), flat(card[1].nu)
    fmu_h, fnu_h = flat(host[1].mu), flat(host[1].nu)
    for path, pc in fp_c.items():
        ph = fp_h[path].to(dev)
        u_c = _adam_direction(torch, acfg, fmu_c[path], fnu_c[path],
                              fp_o[path])
        u_h = _adam_direction(torch, acfg, fmu_h[path].to(dev),
                              fnu_h[path].to(dev), fp_o[path])
        d = (pc.double() - ph.double()).abs()
        tol = lr * (u_c - u_h).abs() + 16 * eps32 * lr + eps32 * (
            pc.double().abs() + ph.double().abs())
        over = int((d > tol).sum())
        moved = float((pc.double() - fp_o[path].double()).abs().max())
        rows[path] = {"max_abs_diff": float(d.max()), "over_tol": over,
                      "entries_apart": int((d > eps32 * (
                          pc.double().abs() + ph.double().abs())).sum()),
                      "max_update": moved, **moments[path]}
        check(over == 0 and moved > 0, f"lm_train_cpu {cfg.name} params "
              f"{path}: "
              f"{over} entries beyond lr |u_card - u_cpu| + rounding, "
              f"largest update {moved}")
        del d, tol, u_c, u_h
    emit({"phase": "lm_train_cpu", "arch": cfg.name,
          "n_layers": cfg.n_layers, "n_params": model.n_params(),
          "batch": 1, "seq": tr["seq"], "remat": cfg.remat, "lr": lr,
          "launches": launched, "loss": {"card": float(card[3]),
                                         "cpu": float(host[3])},
          "loss_diff": loss_diff, "logit_noise_floor": logit_floor,
          "logits_scale": logit_scale, "perturb": PERTURB,
          "cpu_step_s": cpu_s, "leaves": rows})
    del card, floor, host, params, pert, cpu, old
    torch.cuda.empty_cache()


def lm_resume_phase(torch, Z, C, root, tr=TRAIN):
    """Phase 12: stablelm-3b at full width, depth 1, B 1 x S 512, every_k
    2: six steps uninterrupted, then three steps and a checkpoint, then a
    resume to six; final params, Adam state and theta bit-equal to the
    uninterrupted run's. The checkpoints go to a temporary directory under
    build/, removed at the end; the save and restore seconds of one
    checkpoint are timed alone."""
    import shutil
    import tempfile
    from repro_torch._tree import leaves
    from repro_torch.checkpoint import restore_tree, save
    from repro_torch.data import LMBatcher, SyntheticLM
    from repro_torch.train import TrainConfig, train
    cfg = _every_k(dataclasses.replace(C.get_config(tr["arch"]), n_layers=1),
                   tr["resume_every_k"])
    model = Z.build(cfg)
    batcher = LMBatcher(SyntheticLM(cfg.vocab, seed=1), 1,
                        tr["resume_seq"] + 1)
    n = tr["resume_steps"]
    kw = dict(proj_solver="kernel", log_every=100, ckpt_every=100)
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_resume-", dir=os.path.join(root,
                                                                 "build"))
    try:
        full = train(model, batcher, TrainConfig(steps=n, **kw),
                     resume=False)
        ckpt = os.path.join(tmp, "ckpt")
        train(model, batcher, TrainConfig(steps=n // 2, ckpt_dir=ckpt, **kw),
              resume=False)
        resumed = train(model, batcher, TrainConfig(steps=n, ckpt_dir=ckpt,
                                                    **kw), resume=True)
        state = lambda o: {"params": o["params"], "opt": o["opt_state"],
                           "proj": o["proj_state"]}
        a, b = leaves(full["params"]), leaves(resumed["params"])
        same = all(bits_equal(torch, x, y) for x, y in zip(a, b))
        same_opt = all(bits_equal(torch, x, y) for x, y in zip(
            leaves(full["opt_state"].mu) + leaves(full["opt_state"].nu),
            leaves(resumed["opt_state"].mu) + leaves(resumed["opt_state"].nu)))
        same_theta = sorted(full["proj_state"]) == \
            sorted(resumed["proj_state"]) and all(
                bits_equal(torch, full["proj_state"][k],
                           resumed["proj_state"][k])
                for k in full["proj_state"])
        theta_live = any(float(v.max()) > 0
                         for v in resumed["proj_state"].values())
        check(same and same_opt and same_theta and theta_live
              and resumed["losses"] == full["losses"][n // 2:],
              f"lm_resume: params bit-equal {same}, moments {same_opt}, "
              f"theta {same_theta} (nonzero {theta_live}), losses "
              f"{resumed['losses']} vs {full['losses'][n // 2:]}")
        # one checkpoint's save and restore alone (what train does at a
        # checkpoint, minus the host copy of the async checkpointer)
        probe = os.path.join(tmp, "probe")
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(state(full), probe, n)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back, _ = restore_tree(state(full), probe)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check(all(bits_equal(torch, x, y) for x, y in zip(
            leaves(back["params"]), a)), "lm_resume: restore not bit-equal")
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(probe) for f in fs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "lm_resume", "arch": cfg.name, "n_layers": 1,
          "n_params": model.n_params(), "seq": tr["resume_seq"],
          "steps": n, "resumed_at": n // 2, "every_k": tr["resume_every_k"],
          "bit_equal": {"params": same, "moments": same_opt,
                        "theta": same_theta},
          "losses": full["losses"], "checkpoint_gb": nbytes / 1e9,
          "save_s": save_s, "restore_s": restore_s})


def lm_train_ssm_phase(torch, Z, C, FA, SK, K, dev, tr=TRAIN):
    """Phase 13, this slice's main path: ``train`` of hymba-1.5b and then
    mamba2-370m at full width, TRAIN's depth, f32, B 1 x S 2048, ten steps with
    ``proj_solver="kernel"`` (every_k 10: the projection fires at the
    tenth); then a traced step more of each. Returns hymba-1.5b's launches
    in its run."""
    from repro_torch.core import ProjectionEngine
    from repro_torch.data import LMBatcher, SyntheticLM
    from repro_torch.optim import AdamConfig
    from repro_torch.train import loop as TL
    first = None
    for arch in tr["ssm_archs"]:
        cfg = dataclasses.replace(C.get_config(arch), n_layers=tr["depth"])
        model = Z.build(cfg)
        batcher = _lm_batcher(cfg, tr)
        steps = tr["steps"]
        tcfg = TL.TrainConfig(steps=steps, proj_solver="kernel",
                              log_every=1, ckpt_dir=None)
        every_k = {spec.every_k for spec in cfg.projection_specs}
        want = {k: v * steps for k, v in _step_counts(cfg).items()}
        want_l1inf = {k: steps // max(every_k) for k in REPLACES}
        # earlier phases' tensors that only a collection frees would count
        # in this run's peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        _lm_reset(FA, SK)
        K.reset_launch_counts()
        t = time.perf_counter()
        out = TL.train(model, batcher, tcfg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launched, l1inf = _lm_counts(FA, SK), K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = out["losses"]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"lm_train_ssm {arch} losses {losses}")
        check(launched == want, f"lm_train_ssm {arch} launches {launched}, "
              f"want {want}")
        check(l1inf == want_l1inf, f"lm_train_ssm {arch} l1,inf launches "
              f"{l1inf}, want {want_l1inf}")
        # the last step projected: every slice within its radius
        norm_ratio = _norm_over_radius(out["params"], cfg.projection_specs)
        check(norm_ratio <= 1 + 1e-4, f"lm_train_ssm {arch}: l1,inf norm "
              f"{norm_ratio} of the radius")
        step_ms = [m["step_time_s"] * 1e3 for m in out["step_metrics"]]
        median = float(np.median(step_ms[1:9]))
        # one traced step more on the trained state
        step_fn = TL.build_accum_step(
            model, AdamConfig(lr=tcfg.lr), tcfg,
            engine=ProjectionEngine(cfg.projection_specs, solver="kernel"))
        batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in batcher.get(steps).items()}
        state = [out["params"], out["opt_state"], out["proj_state"]]
        del out

        def one_step():
            state[:3] = step_fn(*state, batch, TL.lr_at(tcfg, steps),
                                count=steps + 1)[:3]

        profile = _profile(torch, one_step, kernels=(
            "flash_f32_kernel", "bwd_main_kernel", "bwd_delta_kernel",
            *LM_TRACE_NAMES[2:], *SSD_BWD_TRACE_NAMES))
        emit({"phase": "lm_train_ssm", "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "n_params": model.n_params(), "ssm_state": cfg.ssm_state,
              "batch": 1, "seq": tr["seq"], "steps": steps,
              "remat": cfg.remat, "every_k": sorted(every_k),
              "losses": losses, "launches": {**launched, **l1inf},
              "launches_per_step": {k: v / steps
                                    for k, v in launched.items()},
              "expected_launches": {**want, **want_l1inf},
              "step_ms": step_ms, "median_step_ms_2_to_9": median,
              # the traced wall carries the profiler's own host cost: the
              # device's share of the untraced median step reads the idle
              # share without it
              "device_ms_over_median_step": profile["device_ms"] / median,
              "wall_s": wall_s, "peak_memory_gb": peak_gb,
              "memory_at_start_gb": base_gb,
              "norm_over_radius": norm_ratio, "profile": profile})
        if first is None:
            first = launched
        del state, batch
        torch.cuda.empty_cache()
    return first


def _hymba_ball(params):
    """The leaves hymba-1.5b's spec constrains: mlp/w1 and ssm/wx."""
    blk = params["blocks"]["p0_hybrid"]
    return {"blocks": {"p0_hybrid": {"mlp": {"w1": blk["mlp"]["w1"]},
                                     "ssm": {"wx": blk["ssm"]["wx"]}}}}


def lm_train_bf16_phase(torch, Z, C, FA, SK, K, FK, dev, tr=TRAIN_BF16):
    """Phase 16, this slice's main path: hymba-1.5b at full width
    (TRAIN_BF16's depth) trained
    in bf16 with f32 Adam moments (``AdamConfig(moment_dtype=float32)``)
    through ``launch.steps.build_train_step``, B 1 x S 2048, from the
    seed-0 init in each run:

    * ten steps under remat "full" with the config's spec (every_k 10:
      the Newton projects mlp/w1 and ssm/wx at the tenth step): every loss
      finite; after step ten every constrained slice on its ball (within
      one bf16 rounding: 1 + 2^-8) and within 3e-4 of the scale, beyond
      one bf16 rounding of each entry (half an ulp, at most 2^-8 of it), of
      ``ProjectionEngine(solver="newton")`` on the weights the step
      projected; every flash backward launch on bf16 inputs;
    * two steps under remat "dots": losses and params bit-equal to the
      "full" run's first two;
    * three steps at every_k 1: the extra Newton evaluations a step and
      the launches of every kernel on that route;
    * f32 steps at the same shape (f32 params and moments).

    Step ms (host clock around each synchronised step; median of steps
    2-9 in bf16 "full", of steps 2-4 in f32), peak memory a run, and of
    one traced step more the idle share and flash's share of the device
    time. Returns the "full" run's launches."""
    from repro_torch._tree import flatten_with_path, tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.launch.steps import (build_train_step,
                                          projection_engine_for)
    from repro_torch.optim import AdamConfig, adam_init
    base = dataclasses.replace(C.get_config(tr["arch"]),
                               n_layers=tr["depth"])
    batcher = _lm_batcher(base, tr)
    acfg = AdamConfig(moment_dtype=torch.float32)
    flash_names = ("flash_bf16_kernel", "flash_f32_kernel",
                   *BWD_TRACE_NAMES["bfloat16"], *BWD_TRACE_NAMES["float32"])

    def batch(i):
        return {k: torch.from_numpy(v).to(dev, torch.int64)
                for k, v in batcher.get(i).items()}

    def run(cfg, dtype, steps, after=None, profile=False):
        model = Z.build(cfg)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=dtype, device=dev)
        opt = adam_init(params, acfg)
        proj = projection_engine_for(cfg).init_state(params)
        step = build_train_step(model, None, None, acfg)
        _lm_reset(FA, SK)
        K.reset_launch_counts()
        FK.reset_launch_counts()
        losses, ms, extra = [], [], []
        for i in range(steps):
            b = batch(i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, met, params, opt, proj = step(params, opt, proj, b)
            losses.append(float(loss))
            extra.append(int(met["proj_newton_extra_evals"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if after is not None:
                after(i, params)
        out = {"losses": losses, "step_ms": ms, "extra_evals": extra,
               "launches": {**_lm_counts(FA, SK), **K.launch_counts(),
                            **FK.launch_counts()},
               "flash_bwd_launches_by_dtype": FA.bwd_launches_by_dtype(),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"lm_train_bf16 {cfg.remat_policy} {dtype} losses {losses}")
        if profile:
            state = [params, opt, proj]
            b = batch(steps)

            def one_step():
                state[:] = step(*state, b)[2:]

            prof = _profile(torch, one_step, kernels=(
                *flash_names, *LM_TRACE_NAMES[2:], *SSD_BWD_TRACE_NAMES))
            mine = prof["kernels_device_ms"]
            prof["flash_share"] = sum(mine[k] for k in flash_names) / max(
                prof["device_ms"], 1e-9)
            out["profile"] = prof
            params = state[0]
            del state
        return out, params

    bf16 = torch.bfloat16
    steps = tr["steps"]
    want = {k: v * steps for k, v in _step_counts(base).items()}
    want.update({k: 0 for k in REPLACES}, adam_colstats=0, adam_clip_apply=0)
    # "dots" first: its two steps' params, kept on the host, are what the
    # "full" run must repeat bit for bit
    dots_cfg = dataclasses.replace(base, remat_policy="dots")
    dots, dparams = run(dots_cfg, bf16, tr["dots_steps"])
    dots_host = {p: a.cpu() for p, a in flatten_with_path(dparams)}
    del dparams
    # "full": the weights the tenth step projects are recorded as they go
    # into the projection
    pre, post, equal = {}, {}, {}
    orig_apply = ProjectionEngine.apply

    def recording_apply(self, params, *, step=None, state=None,
                        with_stats=False):
        if step == steps and self.specs:
            pre["ball"] = tree_map(lambda a: a.clone(), _hymba_ball(params))
        return orig_apply(self, params, step=step, state=state,
                          with_stats=with_stats)

    def after(i, params):
        if i == tr["dots_steps"] - 1:
            # the peak over the steps "dots" ran, to set beside its own
            equal["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            equal["params"] = all(
                bits_equal(torch, a.cpu(), dots_host[p])
                for p, a in flatten_with_path(params))
        if i == steps - 1:
            post["ball"] = tree_map(lambda a: a.clone(), _hymba_ball(params))

    ProjectionEngine.apply = recording_apply
    try:
        full, params = run(base, bf16, steps, after=after, profile=True)
    finally:
        ProjectionEngine.apply = orig_apply
    del dots_host
    k = tr["dots_steps"]
    check(dots["losses"] == full["losses"][:k] and equal.get("params"),
          f"lm_train_bf16: dots losses {dots['losses']} vs full "
          f"{full['losses'][:k]}, params bit-equal {equal.get('params')}")
    check(full["launches"] == want, f"lm_train_bf16 launches "
          f"{full['launches']}, want {want}")
    check(full["flash_bwd_launches_by_dtype"] == {
        "float32": 0, "bfloat16": want["flash_attention_bwd"]},
        f"lm_train_bf16 flash backward by dtype "
        f"{full['flash_bwd_launches_by_dtype']}")
    # the tenth step projected (the profile's step after it did not)
    del params
    ball = tree_map(lambda a: a.float(), post.pop("ball"))
    ratio = _norm_over_radius(ball, base.projection_specs)
    check(len(pre) == 1 and ratio <= 1 + 2 ** -8,
          f"lm_train_bf16: projection recorded {len(pre)}, l1,inf norm "
          f"{ratio} of the radius")
    newton, _ = ProjectionEngine(_every_k(base, 1).projection_specs,
                                 solver="newton").apply(
        tree_map(lambda a: a.float(), pre.pop("ball")))
    flat_n = dict(flatten_with_path(newton))
    excess, scale = 0.0, 0.0
    for path, leaf in flatten_with_path(ball):
        want_leaf = flat_n[path]
        excess = max(excess, float(((leaf - want_leaf).abs()
                                    - 2 ** -8 * want_leaf.abs()).max()))
        scale = max(scale, float(want_leaf.abs().max()))
    del ball, newton, flat_n
    check(excess <= 3e-4 * scale, f"lm_train_bf16: projection vs newton "
          f"{excess} beyond one bf16 rounding (scale {scale})")
    # every_k 1: the Newton at every step, warm-started from the second
    every1, p1 = run(_every_k(base, 1), bf16, tr["every1_steps"])
    del p1
    # f32 at the same shape
    f32, p32 = run(base, torch.float32, tr["f32_steps"], profile=True)
    del p32
    torch.cuda.empty_cache()
    median = lambda r, a, b: float(np.median(r["step_ms"][a:b]))
    emit({"phase": "lm_train_bf16", "arch": base.name,
          "n_params": Z.build(base).n_params(), "batch": 1,
          "seq": tr["seq"], "adam_moment_dtype": "float32",
          "full": {**full, "median_step_ms_2_to_9": median(full, 1, 9),
                   "peak_memory_gb_first_steps": equal.get("peak_gb")},
          "dots": {**dots, "bit_equal_to_full": bool(
              dots["losses"] == full["losses"][:k] and equal.get("params"))},
          "every_k_1": every1,
          "f32": {**f32, "median_step_ms_2_to_4": median(f32, 1, 4)},
          "norm_over_radius": ratio,
          "projection_vs_newton_beyond_bf16": excess,
          "projection_scale": scale})
    return full["launches"], full["flash_bwd_launches_by_dtype"]


def _shape_key(way, sq, skv, hd, causal):
    return f"{way} {sq}x{skv} hd{hd} {'causal' if causal else 'full'}"


@contextlib.contextmanager
def _flash_shapes(FA):
    """Within the block, every launch of a flash kernel on the card adds
    one to the yielded {"fwd|bwd SqxSkv hd<head_dim> causal|full": n}
    (the head dim before any zero-padding)."""
    seen = {}
    fwd, bwd = FA._fwd_kernel, FA.flash_attention_bwd

    def add(way, q, k, causal):
        key = _shape_key(way, q.shape[1], k.shape[1], q.shape[2], causal)
        seen[key] = seen.get(key, 0) + 1

    def rec_fwd(q, k, v, groups, causal, window, want_lse):
        add("fwd", q, k, causal)
        return fwd(q, k, v, groups, causal, window, want_lse)

    def rec_bwd(q, k, v, out, dout, lse, **kw):
        if q.is_cuda:
            add("bwd", q, k, kw.get("causal", True))
        return bwd(q, k, v, out, dout, lse, **kw)

    FA._fwd_kernel, FA.flash_attention_bwd = rec_fwd, rec_bwd
    try:
        yield seen
    finally:
        FA._fwd_kernel, FA.flash_attention_bwd = fwd, bwd


def _perturb_(torch, params, seed):
    """Multiply every float leaf of ``params`` by (1 + PERTURB * N(0, 1))
    in place: the noise floor of a model whose copy would not fit beside
    it. The params stay perturbed."""
    from repro_torch._tree import leaves
    flat = leaves(params)
    g = torch.Generator(device=flat[0].device).manual_seed(seed)
    with torch.no_grad():
        for a in flat:
            if a.is_floating_point():
                a.mul_(1 + PERTURB * torch.randn(a.shape, generator=g,
                                                 device=a.device))


def _fill_cross(torch, params, cache, memory):
    """Each cross-attention layer's ck / cv from ``memory`` (B, Sm, d)
    through its own wk / wv, as a serving prefill fills them."""
    for key, blk in params["blocks"].items():
        if "cross" not in blk:
            continue
        for c in range(blk["cross"]["wk"].shape[0]):
            for name, w in (("ck", "wk"), ("cv", "wv")):
                cache["blocks"][key][name][c].copy_(torch.einsum(
                    "bsd,dhk->bshk", memory, blk["cross"][w][c]))
    return cache


def _memory_batch(torch, cfg, B, S, dev, seed):
    """tokens (B, S) and the memory input ``cfg`` reads: frames (B,
    enc_seq, d) or image_embeds (B, n_img_tokens, d), N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=dev)}
    if cfg.encdec:
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                      generator=g, device=dev)
    if cfg.n_img_tokens:
        batch["image_embeds"] = torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=g, device=dev)
    return batch


def _prefill(torch, FA, model, params, batch, dname, want_shapes):
    """One no-grad forward of ``model`` on the card: logits finite, the
    flash launches by shape equal ``want_shapes``; returns its line (wall
    ms, peak memory, a one-forward trace with the flash kernels' share)
    and the logits."""
    cfg = model.cfg
    # the memory inputs in the params' dtype, as the model's activations
    batch = {k: v.to(_dtype(torch, dname)) if v.is_floating_point() else v
             for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    with torch.no_grad(), _flash_shapes(FA) as shapes:
        logits, aux = model.forward(params, batch)
        torch.cuda.synchronize()
    launched = FA.launch_counts()
    valid = logits[..., :cfg.vocab].float()
    finite = bool(torch.isfinite(valid).all())
    check(finite and logits.dtype == _dtype(torch, dname),
          f"{cfg.name} depth {cfg.n_layers} {dname} logits: finite "
          f"{finite}, dtype {logits.dtype}")
    check(shapes == want_shapes, f"{cfg.name} {dname} flash launches by "
          f"shape {shapes}, want {want_shapes}")
    check(launched["flash_attention_bwd"] == 0, f"{cfg.name} forward ran "
          f"the flash backward")
    line = {"arch": cfg.name, "dtype": dname, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_params": model.n_params(),
            "batch": batch["tokens"].shape[0],
            "seq": batch["tokens"].shape[1], "launches": launched,
            "flash_launches_by_shape": shapes, "logits_finite": finite,
            "logits_abs_max": float(valid.abs().max()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "aux": {k: float(v) for k, v in aux.items()}}
    with torch.no_grad():
        line["prefill_ms"] = wall_ms(
            torch, lambda: model.forward(params, batch), reps=3)
        line["profile"] = _profile(
            torch, lambda: model.forward(params, batch),
            kernels=("flash_f32_kernel", "flash_bf16_kernel"))
    return line, logits


def _decode_vs_forward(torch, model, params, batch, full, P, noise, memory,
                       label, rel=LM_MAX_REL):
    """The first P positions of ``batch`` stepped through ``decode_step``
    (the cross caches filled from ``memory``) against the forward's logits
    ``full`` there, within ``noise`` and (unless ``rel`` is None) ``rel``
    of the logits' scale; returns the line's numbers and the decode
    logits."""
    V = model.cfg.vocab
    tokens = batch["tokens"][:, :P]
    cache = model.init_cache(tokens.shape[0], P + 1, dtype=torch.float32,
                             device=tokens.device)
    with torch.no_grad():
        if memory is not None:
            cache = _fill_cross(torch, params, cache, memory)
        steps, _, step_ms = _decode_all(torch, model, params, tokens, P + 1,
                                        cache=cache)
    ref = full[:, :P, :V].float()
    scale = float(ref.abs().max())
    diff = float((steps[..., :V].float() - ref).abs().max())
    check(diff <= noise and (rel is None or diff <= rel * scale),
          f"{label}: decode vs forward max diff {diff}, limit {noise}, "
          f"scale {scale}")
    return {"prompt": P, "max_abs_diff": diff, "logits_scale": scale,
            "noise_floor": noise, "rel_diff": diff / max(scale, 1e-30),
            "decode_ms_per_step": step_ms}, steps


# the run that gives each phase 6c row its shape: whisper's f32 forward and
# its loss backward (phase 14), llama-vision's and deepseek's forwards
# (phases 14, 15) and, for their backwards (no training run takes them),
# phase 7c's cross and mla blocks
_ZOO_RUNS = {("whisper_enc", "fwd"): "encdec_forward",
             ("whisper_enc", "bwd"): "encdec_step",
             ("whisper_cross", "fwd"): "encdec_forward",
             ("whisper_cross", "bwd"): "encdec_step",
             ("vision_cross", "fwd"): "vision_forward",
             ("vision_cross", "bwd"): "block_cross",
             ("deepseek_mla", "fwd"): "mla_forward",
             ("deepseek_mla", "bwd"): "block_mla"}


def _zoo_launches(launches, row):
    """A phase 6c row's launches: its kernel's launches at its shape in the
    run ``_ZOO_RUNS`` names."""
    way = "bwd" if row["name"] == "flash_attention_bwd" else "fwd"
    key = _shape_key(way, row["Sq"], row["Skv"], row["head_dim"],
                     row["causal"])
    return launches[_ZOO_RUNS[(row["shape"], way)]].get(key, 0)


def _abs_diff(torch, a, b):
    """max and median |a - b|, on the CPU."""
    d = (a.cpu().float() - b.cpu().float()).abs()
    return {"max": float(d.max()), "median": float(d.median())}


def _encdec_forced(torch, model, params, one, cpu_params, seed):
    """The encoder-decoder's forward on the card, then on the CPU with
    every block (``TT.block_apply_full``) fed the card's input to it and
    its output replaced by the card's, so that no depth carries a
    difference on: each block's card-vs-CPU distance within FLOOR_FACTOR
    times its noise floor (the block's params times 1 + PERTURB * N(0, 1),
    on the card), and what the model computes between blocks (frames
    plus positions, the encoder's final norm as the memory each decoder
    layer reads, the embedding, the final norm and the unembedding), from
    the card's values on both sides, within GLUE_REL of its scale.
    Returns the check's numbers."""
    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as TT
    inner = TT.block_apply_full
    calls, blocks, glue = [], [], []

    def record(p, x, kind, cfg, positions, memory=None, aux_acc=None):
        out = inner(p, x, kind, cfg, positions, memory=memory,
                    aux_acc=aux_acc)
        calls.append((p, x, kind, positions, memory, out[0]))
        return out

    def forced(p, x, kind, cfg, positions, memory=None, aux_acc=None):
        i = len(blocks)
        cp, cx, ckind, cpos, cmem, cout = calls[i]
        check(kind == ckind, f"forced block {i}: kind {kind}, card {ckind}")
        glue.append((f"block {i} {kind} input", x, cx))
        if cmem is not None:
            glue.append((f"block {i} {kind} memory", memory, cmem))
        y, aux_acc = inner(p, cx.cpu(), kind, cfg, positions,
                           memory=None if cmem is None else cmem.cpu(),
                           aux_acc=aux_acc)
        g = torch.Generator(device=cx.device).manual_seed(seed + i)
        pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
            a.shape, generator=g, device=a.device)), cp)
        moved = inner(pert, cx, kind, cfg, cpos, memory=cmem)[0]
        diff = float((y - cout.cpu()).abs().max())
        floor = float((moved - cout).abs().max())
        blocks.append({"block": i, "kind": kind, "max_abs_diff": diff,
                       "noise_floor": floor,
                       "scale": float(cout.abs().max()),
                       "ok": diff <= FLOOR_FACTOR * floor})
        return cout.cpu(), aux_acc

    V = model.cfg.vocab
    host = {k: v.cpu() for k, v in one.items()}
    try:
        with torch.no_grad():
            TT.block_apply_full = record
            logits, _ = model.forward(params, one)
            TT.block_apply_full = forced
            on_cpu, _ = model.forward(cpu_params, host)
    finally:
        TT.block_apply_full = inner
    glue.append(("logits", on_cpu[..., :V], logits[..., :V]))
    check(len(blocks) == len(calls), f"forced forward ran {len(blocks)} "
          f"blocks, the card's {len(calls)}")
    bad = [b for b in blocks if not b["ok"]]
    check(not bad, f"{model.cfg.name} blocks beyond FLOOR_FACTOR x their "
          f"noise floor, fed the card's inputs: {bad}")
    rows = []
    for name, cpu_side, card_side in glue:
        diff = float((cpu_side - card_side.cpu()).abs().max())
        scale = float(card_side.abs().max())
        rows.append({"what": name, "max_abs_diff": diff, "scale": scale})
        check(diff <= GLUE_REL * scale, f"{model.cfg.name} {name}: CPU "
              f"vs card max diff {diff}, scale {scale}")
    return {"blocks": blocks, "worst_block_over_floor": max(
                b["max_abs_diff"] / b["noise_floor"] if b["noise_floor"]
                else float(b["max_abs_diff"] > 0) for b in blocks),
            "glue_worst_rel": max(r["max_abs_diff"] / max(r["scale"], 1e-30)
                                  for r in rows),
            "glue": [r for r in rows if "input" not in r["what"]]}


def _encdec_vs_cpu(torch, Z, FA, model, params, one, zoo, strict):
    """The encoder-decoder's f32 forward on the card against the CPU's
    (plain versions) on the B 1 batch ``one``. At the reference's init a
    full-width whisper stack is chaotic (C-5: its stacked attention
    weights put each softmax near an argmax that ten ulps of weight noise
    flip, and each flipped row moves the next layer), so the whole model is
    compared three ways: the card against the CPU; the noise floor on the
    card (its params times 1 + PERTURB * N(0, 1)); and the same perturbed
    params on the CPU against the CPU, a second witness that the
    amplification is the model's and not the card's. Each for the logits
    and the encoder's output, by the largest and the median distance.

    ``strict`` (the 2 + 2 cut, where the encoder's output sits within 1%
    of its scale of the floor and the logits' median far below it): the
    encoder's output within FLOOR_FACTOR times its floor, the logits'
    median within FLOOR_FACTOR times its floor's, and decode over the
    first ``decode_prompt`` positions (each layer's ck / cv filled from
    the encoder's memory through its cross wk / wv) within the floor and
    LM_MAX_REL of the logits' scale, as phase 9. Whole, where the floor is
    the logits' own scale, the same numbers are reported, not checked.
    At both depths ``_encdec_forced`` holds every block, and what lies
    between them, sharply."""
    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as TT
    cfg = model.cfg
    V = cfg.vocab
    host = {k: v.cpu() for k, v in one.items()}
    g = torch.Generator(device=one["tokens"].device).manual_seed(22)
    pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
        a.shape, generator=g, device=a.device)), params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    runs, cpu_s = {}, 0.0
    with torch.no_grad():
        for name, p, b in (("card", params, one), ("cpu", cpu_params, host),
                           ("card_perturbed", pert, one),
                           ("cpu_perturbed", tree_map(lambda t: t.cpu(),
                                                      pert), host)):
            t = time.perf_counter()
            logits, _ = model.forward(p, b)
            if name == "cpu":
                cpu_s = time.perf_counter() - t
            runs[name] = (logits[..., :V], TT._encode(p, b["frames"], cfg))
    del pert
    whole = {}
    for i, what in enumerate(("logits", "encoder_out")):
        card, cpu, card_p, cpu_p = (runs[k][i] for k in (
            "card", "cpu", "card_perturbed", "cpu_perturbed"))
        whole[what] = {"scale": float(cpu.abs().max()),
                       "card_vs_cpu": _abs_diff(torch, card, cpu),
                       "floor_card": _abs_diff(torch, card_p, card),
                       "floor_cpu": _abs_diff(torch, cpu_p, cpu)}
    full, memory = runs["card"]
    del runs
    label = f"{cfg.name} depth {cfg.n_enc_layers} + {cfg.n_layers}"
    if strict:
        enc, lg = whole["encoder_out"], whole["logits"]
        check(enc["card_vs_cpu"]["max"]
              <= FLOOR_FACTOR * enc["floor_card"]["max"],
              f"{label} encoder output: card vs CPU {enc['card_vs_cpu']}, "
              f"floor {enc['floor_card']}, scale {enc['scale']}")
        check(lg["card_vs_cpu"]["median"]
              <= FLOOR_FACTOR * lg["floor_card"]["median"],
              f"{label} logits: card vs CPU {lg['card_vs_cpu']}, floor "
              f"{lg['floor_card']}, scale {lg['scale']}")
    noise = whole["logits"]["floor_card"]["max"]
    dec, _ = _decode_vs_forward(
        torch, model, params, one, full, zoo["decode_prompt"],
        noise if strict else float("inf"), memory, label,
        rel=LM_MAX_REL if strict else None)
    forced = _encdec_forced(torch, model, params, one, cpu_params, seed=26)
    emit({"phase": "zoo_encdec", "check": "card_vs_cpu", "arch": cfg.name,
          "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
          "checked": "encoder output max, logits median, decode within the "
          "floor and LM_MAX_REL; every block fed the card's inputs"
          if strict else "every block fed the card's inputs (whole-model "
          "and decode numbers reported only)",
          "batch": 1, "seq": one["tokens"].shape[1],
          "frames": one["frames"].shape[1], "perturb": PERTURB,
          "cpu_forward_s": cpu_s, "whole": whole, "decode": dec,
          "forced": forced})


def zoo_encdec_phase(torch, Z, C, FA, dev, zoo=None):
    """Phase 14: whisper-small at full size (forward f32 and bf16, card
    against the CPU, decode against forward, one ``Model.loss`` backward)
    and llama-3.2-vision-90b at full width cut to one cycle of its
    pattern (forward f32 and bf16, decode against forward). Returns the
    flash launches of one whisper forward and of its loss backward, and
    llama-vision's forward."""
    from repro_torch._tree import leaves, tree_map
    zoo = zoo or ZOO
    out = {}
    # -- whisper-small, full size --------------------------------------
    cfg = C.get_config(zoo["encdec"])
    model = Z.build(cfg)
    L, E = cfg.n_layers, cfg.n_enc_layers
    B, S, F = zoo["encdec_batch"], zoo["encdec_seq"], cfg.enc_seq
    batch = _memory_batch(torch, cfg, B, S, dev, seed=21)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    hd = cfg.head_dim
    want = {_shape_key("fwd", F, F, hd, False): E,
            _shape_key("fwd", S, S, hd, True): L,
            _shape_key("fwd", S, F, hd, False): L}
    for dname in ("float32", "bfloat16"):
        p = params if dname == "float32" else _cast(torch, params,
                                                    torch.bfloat16)
        line, _ = _prefill(torch, FA, model, p, batch, dname, want)
        if dname == "float32":
            out["encdec_forward"] = line["flash_launches_by_shape"]
        emit({"phase": "zoo_encdec", "check": "forward", **line})
        del p
    # the model's f32 forward on the card against the CPU, B 1, and
    # decode against forward, cut to ``encdec_cpu_depth`` + as many layers
    # (the cut keeps the run inside its time limit) and to 2 + 2
    one = {k: v[:1] for k, v in batch.items()}
    d = zoo["encdec_cpu_depth"]
    mid = dataclasses.replace(cfg, n_layers=d, n_enc_layers=d)
    mmodel = Z.build(mid)
    mparams = mmodel.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    _encdec_vs_cpu(torch, Z, FA, mmodel, mparams, one, zoo, strict=False)
    del mparams
    cut = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    cmodel = Z.build(cut)
    cparams = cmodel.init(torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    _encdec_vs_cpu(torch, Z, FA, cmodel, cparams, one, zoo, strict=True)
    del cparams
    # one Model.loss backward at full size (remat: each layer's forward
    # twice, its backward once)
    g = torch.Generator(device=dev).manual_seed(23)
    batch["labels"] = torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    device=dev)
    q = tree_map(lambda a: a.detach().requires_grad_(), params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    t = time.perf_counter()
    with _flash_shapes(FA) as step_shapes:
        loss, metrics = model.loss(q, batch)
        loss.backward()
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launched = FA.launch_counts()
    out["encdec_step"] = step_shapes
    finite = all(bool(torch.isfinite(a.grad).all()) for a in leaves(q))
    n_attn = E + 2 * L
    want_l = {"flash_attention_fwd": (2 if cfg.remat else 1) * n_attn,
              "flash_attention_bwd": n_attn}
    check(finite and bool(torch.isfinite(loss)), f"whisper-small loss "
          f"{float(loss.detach())}: gradients finite {finite}")
    check(launched == want_l, f"whisper-small loss backward flash launches "
          f"{launched}, want {want_l}")
    emit({"phase": "zoo_encdec", "check": "loss_backward", "arch": cfg.name,
          "batch": B, "seq": S, "frames": F, "loss": float(loss.detach()),
          "grads_finite": finite, "launches": launched,
          "flash_launches_by_shape": step_shapes,
          "expected_launches": want_l, "step_ms": step_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del q, loss, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- llama-3.2-vision-90b, full width, one cycle of its pattern -------
    vcfg = dataclasses.replace(C.get_config(zoo["vision"]),
                               n_layers=len(C.get_config(zoo["vision"])
                                            .pattern))
    vmodel = Z.build(vcfg)
    S, M = zoo["vision_seq"], vcfg.n_img_tokens
    batch = _memory_batch(torch, vcfg, 1, S, dev, seed=24)
    params = vmodel.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_self = sum(k == "global" for k in vcfg.pattern)
    hd = vcfg.head_dim
    want = {_shape_key("fwd", S, S, hd, True): n_self,
            _shape_key("fwd", S, M, hd, False): 1}
    line, full = _prefill(torch, FA, vmodel, params, batch, "float32", want)
    out["vision_forward"] = line["flash_launches_by_shape"]
    emit({"phase": "zoo_encdec", "check": "forward",
          "depth_cut": f"{vcfg.n_layers} of "
                       f"{C.get_config(zoo['vision']).n_layers} layers",
          **line})
    dec, _ = _decode_vs_forward(
        torch, vmodel, params, batch, full, zoo["decode_prompt"],
        float("inf"), batch["image_embeds"], "llama-3.2-vision")
    # the noise floor last: it perturbs the params in place; decode and
    # forward sum in other orders (einsum attention, another GEMM shape),
    # so they are held to FLOOR_FACTOR times the floor, the floor's own
    # spread from one draw to the next
    _perturb_(torch, params, seed=25)
    with torch.no_grad():
        moved, _ = vmodel.forward(params, batch)
    V = vcfg.vocab
    noise = float((moved[:, :zoo["decode_prompt"], :V]
                   - full[:, :zoo["decode_prompt"], :V]).abs().max())
    del moved
    dec["noise_floor"] = noise
    check(dec["max_abs_diff"] <= FLOOR_FACTOR * noise, f"llama-3.2-vision "
          f"decode vs forward max diff {dec['max_abs_diff']}, noise floor "
          f"{noise}")
    emit({"phase": "zoo_encdec", "check": "decode_vs_forward",
          "arch": vcfg.name, "n_layers": vcfg.n_layers, "batch": 1,
          "image_tokens": M, "perturb": PERTURB, **dec})
    del full, params
    torch.cuda.empty_cache()
    bparams = vmodel.init(torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev)
    line, _ = _prefill(torch, FA, vmodel, bparams, batch, "bfloat16", want)
    emit({"phase": "zoo_encdec", "check": "forward",
          "depth_cut": f"{vcfg.n_layers} of "
                       f"{C.get_config(zoo['vision']).n_layers} layers",
          **line})
    del bparams, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _w1_only(params, key):
    return {"blocks": {key: {"moe": {
        "w1": params["blocks"][key]["moe"]["w1"]}}}}


def zoo_moe_phase(torch, Z, C, FA, K, dev, zoo=None):
    """Phase 15: mixtral-8x7b at full width (forward f32 and bf16 at depth
    4; ``train`` at depth 2, ten steps, the config's moe/w1 l1,inf spec
    firing at the tenth through the l1,inf kernels, one step more held to
    the Newton), deepseek-v2-236b at full width, depth 2 (forward f32 and
    bf16, MLA through flash at hd 192 with v 128; decode against forward
    with mla_absorb off and on), and a reduced MoE model behind
    ``FleetEngine`` (one capture, tokens equal to the CPU engine's).
    Returns the flash launches of the mixtral run and of one deepseek
    forward."""
    from repro_torch.core import ProjectionEngine
    from repro_torch.optim import AdamConfig
    from repro_torch.train import loop as TL
    from repro_torch.serve import EngineConfig, FleetEngine
    from repro_torch._tree import tree_map
    zoo = zoo or ZOO
    out = {}
    # -- mixtral-8x7b forward, depth 4 ------------------------------------
    full_cfg = C.get_config(zoo["moe"])
    cfg = dataclasses.replace(full_cfg, n_layers=zoo["moe_fwd_depth"])
    model = Z.build(cfg)
    S, hd = zoo["moe_seq"], cfg.head_dim
    batch = _memory_batch(torch, cfg, 1, S, dev, seed=31)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    want = {_shape_key("fwd", S, S, hd, True): cfg.n_layers}
    cut = f"{cfg.n_layers} of {full_cfg.n_layers} layers"
    for dname in ("float32", "bfloat16"):
        if dname == "bfloat16":     # the init in bf16: the router stays f32
            del params
            torch.cuda.empty_cache()
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
        p = params
        line, logits = _prefill(torch, FA, model, p, batch, dname, want)
        check(set(line["aux"]) == {"lb_loss", "z_loss", "dropped_frac"}
              and all(np.isfinite(list(line["aux"].values()))),
              f"mixtral {dname} MoE aux {line['aux']}")
        emit({"phase": "zoo_moe", "check": "forward", "depth_cut": cut,
              **line})
        del p, logits
    del batch, params
    gc.collect()
    torch.cuda.empty_cache()

    # -- mixtral-8x7b trained, depth 2 ------------------------------------
    tcfg_model = dataclasses.replace(full_cfg, n_layers=zoo["moe_train_depth"])
    tmodel = Z.build(tcfg_model)
    batcher = _lm_batcher(tcfg_model)
    steps = zoo["moe_train_steps"]
    tcfg = TL.TrainConfig(steps=steps, proj_solver="kernel", log_every=1,
                          ckpt_dir=None)
    every_k = {spec.every_k for spec in tcfg_model.projection_specs}
    layers = tcfg_model.n_layers
    want_flash = {"flash_attention_fwd": (2 if tcfg_model.remat else 1)
                  * layers * steps, "flash_attention_bwd": layers * steps}
    want_l1inf = {k: steps // max(every_k) for k in REPLACES}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    K.reset_launch_counts()
    t = time.perf_counter()
    res = TL.train(tmodel, batcher, tcfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    flash, l1inf = FA.launch_counts(), K.launch_counts()
    out["moe_train"] = {**flash, **l1inf}

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"mixtral train losses {losses}")
    check(flash == want_flash, f"mixtral train flash launches {flash}, "
          f"want {want_flash}")
    check(l1inf == want_l1inf, f"mixtral train l1,inf launches {l1inf}, "
          f"want {want_l1inf}")
    key = "p0_local"
    norm_ratio = _norm_over_radius(_w1_only(res["params"], key),
                                   tcfg_model.projection_specs)
    check(norm_ratio <= 1 + 1e-4, f"mixtral train: moe/w1 l1,inf norm "
          f"{norm_ratio} of the radius")
    step_ms = [m["step_time_s"] * 1e3 for m in res["step_metrics"]]
    # one step more through an engine that projects at every step and
    # keeps the stacked expert leaf it projects: the kernel projection
    # against the Newton's on that leaf
    specs1 = _every_k(tcfg_model, 1).projection_specs
    pre = []

    class Recording(ProjectionEngine):
        def apply(self, params, *, step=None, state=None, with_stats=False):
            pre.append(tree_map(lambda a: a.clone(), _w1_only(params, key)))
            return super().apply(params, step=step, state=state,
                                 with_stats=with_stats)

    acfg = AdamConfig(lr=tcfg.lr)
    rec_fn = TL.build_accum_step(tmodel, acfg, tcfg,
                                 engine=Recording(specs1, solver="kernel"))
    tb = {k: torch.from_numpy(v).to(dev, torch.int64)
          for k, v in batcher.get(steps).items()}
    state = [res["params"], res["opt_state"], res["proj_state"]]
    del res
    K.reset_launch_counts()
    state[:3] = rec_fn(*state, tb, TL.lr_at(tcfg, steps), count=steps + 1)[:3]
    torch.cuda.synchronize()
    rec_l1inf = K.launch_counts()
    check(len(pre) == 1 and rec_l1inf == {k: 1 for k in REPLACES},
          f"mixtral projecting step: {len(pre)} projections, l1,inf "
          f"launches {rec_l1inf}")
    err, scale, rec_ratio = _projection_vs_newton(
        torch, pre[0], _w1_only(state[0], key), specs1)
    del pre
    check(rec_ratio <= 1 + 1e-4, f"mixtral projecting step: moe/w1 l1,inf "
          f"norm {rec_ratio} of the radius")
    check(err <= 3e-4 * scale, f"mixtral: kernel projection of moe/w1 vs "
          f"newton max err {err} (scale {scale})")
    w1 = state[0]["blocks"][key]["moe"]["w1"]
    emit({"phase": "zoo_moe", "check": "train", "arch": tcfg_model.name,
          "n_layers": layers, "depth_cut": f"{layers} of "
          f"{full_cfg.n_layers} layers", "n_params": tmodel.n_params(),
          "batch": 1, "seq": batcher.get(0)["tokens"].shape[1],
          "steps": steps, "remat": tcfg_model.remat,
          "every_k": sorted(every_k), "w1_shape": list(w1.shape),
          "radius": tcfg_model.projection_specs[0].radius,
          "losses": losses, "launches": {**flash, **l1inf},
          "expected_launches": {**want_flash, **want_l1inf},
          "step_ms": step_ms,
          "median_step_ms_2_to_9": float(np.median(step_ms[1:9])),
          "wall_s": wall_s, "peak_memory_gb": peak_gb,
          "norm_over_radius": norm_ratio,
          "projecting_step": {"launches": rec_l1inf,
                              "projection_vs_newton_max_err": err,
                              "projection_scale": scale,
                              "norm_over_radius": rec_ratio}})
    del state, tb, w1
    gc.collect()
    torch.cuda.empty_cache()

    # -- deepseek-v2-236b, depth 2 ----------------------------------------
    dfull = C.get_config(zoo["mla"])
    dcfg = dataclasses.replace(dfull, n_layers=zoo["mla_depth"])
    dmodel = Z.build(dcfg)
    S = zoo["moe_seq"]
    batch = _memory_batch(torch, dcfg, 1, S, dev, seed=32)
    params = dmodel.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    qk = dcfg.qk_nope + dcfg.qk_rope
    want = {_shape_key("fwd", S, S, qk, True): dcfg.n_layers}
    cut = f"{dcfg.n_layers} of {dfull.n_layers} layers"
    line, full = _prefill(torch, FA, dmodel, params, batch, "float32", want)
    out["mla_forward"] = line["flash_launches_by_shape"]
    emit({"phase": "zoo_moe", "check": "forward", "depth_cut": cut,
          "v_head_dim": dcfg.v_head_dim, **line})
    P = zoo["decode_prompt"]
    decs = {}
    for absorb in (False, True):
        m = Z.build(dataclasses.replace(dcfg, mla_absorb=absorb))
        decs[absorb] = _decode_vs_forward(
            torch, m, params, batch, full, P, float("inf"), None,
            f"deepseek mla_absorb={absorb}")
    both = float((decs[True][1][..., :dcfg.vocab]
                  - decs[False][1][..., :dcfg.vocab]).abs().max())
    # the noise floor last, the params perturbed in place; decode is held
    # to FLOOR_FACTOR times it, as llama-vision's
    _perturb_(torch, params, seed=33)
    with torch.no_grad():
        moved, _ = dmodel.forward(params, batch)
    V = dcfg.vocab
    noise = float((moved[:, :P, :V] - full[:, :P, :V]).abs().max())
    del moved
    for absorb, (d, _) in decs.items():
        d["noise_floor"] = noise
        check(d["max_abs_diff"] <= FLOOR_FACTOR * noise, f"deepseek decode "
              f"(mla_absorb={absorb}) vs forward max diff "
              f"{d['max_abs_diff']}, noise floor {noise}")
    check(both <= FLOOR_FACTOR * noise, f"deepseek decode mla_absorb on vs "
          f"off max diff {both}, noise floor {noise}")
    emit({"phase": "zoo_moe", "check": "decode_vs_forward",
          "arch": dcfg.name, "n_layers": dcfg.n_layers, "batch": 1,
          "perturb": PERTURB, "plain": decs[False][0],
          "absorb": decs[True][0], "absorb_vs_plain_max_abs_diff": both,
          "noise_floor": noise})
    del full, decs, params
    torch.cuda.empty_cache()
    bparams = dmodel.init(torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev)
    line, _ = _prefill(torch, FA, dmodel, bparams, batch, "bfloat16", want)
    emit({"phase": "zoo_moe", "check": "forward", "depth_cut": cut,
          "v_head_dim": dcfg.v_head_dim, **line})
    del bparams, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- a reduced MoE model behind FleetEngine ----------------------------
    for arch in zoo["engine_archs"]:
        ecfg = C.get_reduced(arch)
        emodel = Z.build(ecfg)
        p = emodel.init(torch.Generator().manual_seed(5), device="cpu")
        p2 = tree_map(lambda a: a * 1.25, p)
        runs = {}
        for where in ("cpu", dev):
            eng = FleetEngine(emodel, 3, EngineConfig(max_seq=24))
            to = lambda t: tree_map(lambda a: a.to(where), t)
            eng.load(to(p))
            rng = np.random.default_rng(12)
            rids = [eng.submit(rng.integers(0, ecfg.vocab, size=int(n))
                               .tolist(), int(b)) for n, b in zip(
                rng.integers(2, 9, size=7), rng.integers(2, 12, size=7))]
            done = []
            for _ in range(4):
                done += eng.step()
            eng.refresh(to(p2))
            done += eng.drain()
            runs[str(where)] = ({c.rid: c.tokens for c in done}, eng)
        (cpu_tok, _), (card_tok, eng) = runs["cpu"], runs[str(dev)]
        check(card_tok == cpu_tok and sorted(card_tok) == sorted(rids),
              f"{arch} engine: card tokens differ from the CPU engine's")
        check(eng.n_traces == 1 and eng.n_replays == eng.stats()["steps"],
              f"{arch} engine: {eng.n_traces} captures, {eng.n_replays} "
              f"replays for {eng.stats()['steps']} steps")
        emit({"phase": "zoo_moe", "check": "fleet_engine", "arch": ecfg.name,
              "reduced": True, "slots": 3, "requests": len(rids),
              "n_traces": eng.n_traces, "n_replays": eng.n_replays,
              "steps": eng.stats()["steps"],
              "tokens_equal_cpu": card_tok == cpu_tok})
        del runs, eng
    torch.cuda.empty_cache()
    return out


def attn_zoo_phase(torch, FA, dev, flush, shapes=None):
    """Phase 6c: the flash kernels at the shapes the new kinds give them,
    f32 (the training dtype): forward and backward against their plain
    versions (2e-5 of the scale), device ms warm and flushed, the plain
    version's ms, the bound on the true head dims and SDPA's ms for the
    same function. MLA's q/k head dim 192 runs on the hd-256 kernel and
    its v 128 is zero-padded to 192 first (``flash_attention``); the bound
    counts 192 for q . k and 128 for p . v, and ``padding_waste`` is the
    share of the kernel's products that the padding adds. Returns the
    kernels-line rows."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    import torch.nn.functional as F
    shapes = shapes or ZOO_ATTN_SHAPES
    g = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for name, B, H, Sq, Skv, hd, hv, causal in shapes:
        BH = B * H
        pairs = (int(np.tril(np.ones((Sq, Skv), bool)).sum()) if causal
                 else Sq * Skv)
        q = torch.randn((BH, Sq, hd), generator=g, device=dev)
        k = torch.randn((BH, Skv, hd), generator=g, device=dev)
        v = torch.randn((BH, Skv, hv), generator=g, device=dev)
        dout = torch.randn((BH, Sq, hd), generator=g, device=dev)
        dout[..., hv:] = 0      # the padded columns' gradient
        vp = F.pad(v, (0, hd - hv))
        kw = dict(groups=1, causal=causal, window=0)
        fwd = lambda: FA.flash_attention_fwd(q, k, vp, **kw)
        out = fwd()
        plain = FA.flash_attention_fwd_plain(q, k, vp, **kw)
        ferr = float((out - plain).abs().max())
        check(bool(torch.isfinite(out).all()) and ferr <= FLASH_TOL[
            "float32"] * float(plain.abs().max()),
            f"flash {name}: kernel vs plain max err {ferr}")
        check(hv == hd or float(out[..., hv:].abs().max()) == 0.0,
              f"flash {name}: padded v columns of out not zero")
        check(bits_equal(torch, out, fwd()), f"flash {name}: rerun not "
              f"bit-equal")
        out, lse = FA._fwd_kernel(q, k, vp, 1, causal, 0, True)
        bargs = (q, k, vp, out, dout, lse)
        bwd = lambda: FA.flash_attention_bwd(*bargs, **kw)
        got = bwd()
        want = FA.flash_attention_bwd_plain(*bargs, **kw)
        berr = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(got, want))
        check(berr <= BWD_TOL["float32"] and all(bool(torch.isfinite(a).all())
                                      for a in got),
              f"flash bwd {name}: kernel vs plain max err {berr} of scale")
        check(all(bits_equal(torch, a, b) for a, b in zip(got, bwd())),
              f"flash bwd {name}: rerun not bit-equal")
        # SDPA on the true dims (it takes v's head dim as it is)
        qs, ks, vs = (t.view(B, H, -1, t.shape[-1]) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)
        lib_err = float((sdpa().reshape(BH, Sq, hv) - out[..., :hv])
                        .abs().max())
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (qs, ks, vs))
        dg = dout[..., :hv].reshape(B, H, Sq, hv)
        sdpa_g = lambda: F.scaled_dot_product_attention(qg, kg, vg,
                                                        is_causal=causal)
        with torch.no_grad():
            lib_fwd = eager_ms(torch, sdpa_g)
        lib_both = eager_ms(torch, lambda: torch.autograd.grad(
            sdpa_g(), (qg, kg, vg), dg))
        kd = FA.kernel_head_dim(hd)
        # bounds on the true dims: q . k at hd, p . v at hv
        f_ops = 2 * pairs * BH * (hd + hv)
        f_bytes = 4 * (q.numel() + k.numel() + v.numel() + BH * Sq * hv)
        # backward: s = q k^T and dp = dout v^T recomputed, dv = p^T dout,
        # dq = ds k, dk = ds^T q
        b_ops = 2 * pairs * BH * (3 * hd + 2 * hv)
        b_bytes = 4 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                       + 2 * BH * Sq * hv + lse.numel())
        fb = kernel_bound_ms((f_ops, f_bytes))
        bb = kernel_bound_ms((b_ops, b_bytes))
        common = {"shape": name, "B": B, "H": H, "Sq": Sq, "Skv": Skv,
                  "head_dim": hd, "v_head_dim": hv, "causal": causal,
                  "kernel_head_dim": kd}
        f_row = {**common, "name": "flash_attention_fwd",
                 "ms": time_ms(torch, fwd),
                 "ms_l2_flushed": time_cold_ms(torch, fwd, flush),
                 "plain_ms": time_ms(torch, lambda: FA.flash_attention_fwd_plain(
                     q, k, vp, **kw), budget_ms=300.0),
                 "bound_ms": fb[0], "bound_by": fb[1], "library_ms": lib_fwd,
                 "library_max_abs_err": lib_err, "max_abs_err": ferr,
                 "gflop": f_ops / 1e9,
                 "padding_waste": 1 - (hd + hv) / (2 * kd)}
        b_row = {**common, "name": "flash_attention_bwd",
                 "ms": time_ms(torch, bwd),
                 "ms_l2_flushed": time_cold_ms(torch, bwd, flush),
                 "plain_ms": time_ms(torch, lambda: FA.flash_attention_bwd_plain(
                     *bargs, **kw), budget_ms=300.0),
                 "bound_ms": bb[0], "bound_by": bb[1],
                 "library_ms": lib_both - lib_fwd,
                 "max_abs_err": berr, "gflop": b_ops / 1e9,
                 "padding_waste": 1 - (3 * hd + 2 * hv) / (5 * kd)}
        emit({"phase": "attn_zoo", "forward": f_row, "backward": b_row})
        rows += [f_row, b_row]
        del q, k, v, vp, dout, out, lse, got, want, qg, kg, vg
        torch.cuda.empty_cache()
    return rows


# phase 17: the distributed l1,inf projection, ranks sharing the card over
# gloo: hymba-1.5b's projected leaves at full width (mlp/w1 and ssm/wx)
# for ``layers`` of its 32 layers (the cut keeps the run inside its time
# limit), meshes (2, 1) and (2, 2) over ("data", "model")
DIST = dict(arch="hymba-1.5b", meshes=((2, 1), (2, 2)), seed=17, step=10,
            layers=8,
            fused_frac=0.05, k_frac=0.05, timeout=420)
DIST_TOL = dict(params=1e-5, theta=1e-6)


def _hymba_leaves(torch, cfg, dev, seed, layers):
    """hymba-1.5b's projected leaves (the config's spec pattern), random
    from a seed: params ~ 0.02 N(0, 1), gradients ~ 1e-3 N(0, 1), Adam
    moments m ~ 1e-3 N(0, 1), v ~ 1e-6 U(0, 1)."""
    L, d = layers, cfg.d_model
    shapes = {"mlp": {"w1": (L, d, cfg.d_ff)},
              "ssm": {"wx": (L, d, cfg.ssm_expand * d)}}
    gen = torch.Generator(device=dev).manual_seed(seed)

    def tree(fn):
        return {"blocks": {"p0_hybrid": {k: {kk: fn(s) for kk, s in v.items()}
                                         for k, v in shapes.items()}}}
    return {"params": tree(lambda s: 0.02 * torch.randn(
                s, generator=gen, device=dev)),
            "grads": tree(lambda s: 1e-3 * torch.randn(
                s, generator=gen, device=dev)),
            "mu": tree(lambda s: 1e-3 * torch.randn(
                s, generator=gen, device=dev)),
            "nu": tree(lambda s: 1e-6 * torch.rand(
                s, generator=gen, device=dev))}


def _dist_specs(ProjectionSpec, cfg, params, leaves):
    """The config's own spec (l1,inf, every_k 10), and bilevel and l1,2 at
    every_k 1 with radius 0.05 x the l1,inf norm of the first mlp/w1
    matrix (``tests/test_multidevice.py``'s rule)."""
    from repro_torch.core.l1inf import l1inf_norm
    w1 = leaves(params)[0]
    radius = DIST["fused_frac"] * float(l1inf_norm(w1[0], axis=0))
    (spec,) = cfg.projection_specs
    fused = {norm: dataclasses.replace(spec, norm=norm, radius=radius,
                                       every_k=1)
             for norm in ("bilevel", "l12")}
    return spec, fused


def dist_projection_phase(torch, C, dev, card, dist_cfg=DIST):
    """Phase 17: the sharded and fused_sharded solvers and compressed
    gradient reduction, D ranks spawned on this one card in a gloo group
    (NCCL refuses two ranks on one GPU), against the single-device solves
    run here first. Gloo stages CUDA tensors through host memory, so the
    times say nothing of an interconnect. ``card``: the nvidia-smi name
    and power limit printed beside the times. Returns {D: per-rank
    results}."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch._tree import leaves
    from repro_torch.core import ProjectionEngine, ProjectionSpec
    from repro_torch.optim import AdamConfig
    from repro_torch.optim.adam import AdamState

    cfg = C.get_config(dist_cfg["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    data = _hymba_leaves(torch, cfg, dev, dist_cfg["seed"],
                         dist_cfg["layers"])
    params = data["params"]
    spec, fused_specs = _dist_specs(ProjectionSpec, cfg, params, leaves)
    acfg = AdamConfig(lr=1e-3, clip_norm=None)
    step = dist_cfg["step"]
    # (a) the single-device solve at a projecting step
    eng = ProjectionEngine((spec,), solver="newton")
    X, st, stats = eng.apply(params, step=step, state=eng.init_state(params),
                             with_stats=True)
    (key,) = st
    shared = {"data": data, "proj_ref": X, "proj_theta": st[key]}
    meta = {"spec": spec, "proj_key": key, "proj_iters": int(stats[key]),
            "fused": {}, "step": step, "k_frac": dist_cfg["k_frac"],
            "radius": fused_specs["bilevel"].radius}
    # (b) the single-device fused step, each norm
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for norm, fspec in fused_specs.items():
        feng = ProjectionEngine((fspec,), solver="fused")
        p, o, s, it = feng.projected_update(
            data["grads"], AdamState(count=zero, mu=data["mu"],
                                     nu=data["nu"]),
            params, acfg, state=feng.init_state(params), with_stats=True)
        (fkey,) = s
        shared[f"fused_{norm}"] = {"params": p, "mu": o.mu, "nu": o.nu,
                                   "theta": s[fkey]}
        meta["fused"][norm] = {"key": fkey, "iters": int(it[fkey]),
                               "spec": fspec}
    del X, p, o
    torch.cuda.synchronize()
    results = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for shape in dist_cfg["meshes"]:
        D = shape[0] * shape[1]
        # (e) per-rank partial gradients the size of mlp/w1, their sum and
        # the sum of their magnitudes (for the summation-order bound)
        w1 = leaves(params)[0]
        gen = torch.Generator(device=dev).manual_seed(dist_cfg["seed"] + D)
        parts = torch.stack([1e-3 * torch.randn(w1.shape, generator=gen,
                                                device=dev)
                             for _ in range(D)])
        shared["partials"] = parts
        shared["exact"] = parts.sum(0)
        shared["abs_sum"] = parts.abs().sum(0)
        shared["absmax"] = parts.abs().max()
        torch.cuda.synchronize()
        work = tempfile.mkdtemp(dir=os.path.join(root, "build"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            _dist_rank, args=(D, shape, work, root, shared, meta),
            nprocs=D, join=False, start_method="spawn")
        failed = None
        deadline = time.monotonic() + dist_cfg["timeout"]
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    failed = f"timed out after {dist_cfg['timeout']} s"
                    break
        except Exception as e:             # a rank raised: its traceback
            failed = f"{type(e).__name__}: {str(e)[-2000:]}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(D):
            path = os.path.join(work, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        shutil.rmtree(work, ignore_errors=True)
        check(failed is None and len(ranks) == D,
              f"dist_projection D={D}: {failed or 'missing rank results'}")
        for r in ranks:
            for what, ok in r["checks"].items():
                check(ok, f"dist_projection D={D} rank {r['rank']}: {what}")
            for k in FUSED_REPLACES:
                check(r["launches"].get(k, 0) > 0,
                      f"dist_projection D={D} rank {r['rank']}: the "
                      f"fused_sharded step never launched {k}")
        results[D] = ranks
        emit({"phase": "dist_projection", "mesh": list(shape), "ranks": D,
              "arch": cfg.name, "leaves": {
                  k: list(v.shape) for k, v in
                  zip(("mlp/w1", "ssm/wx"), leaves(params))},
              "card": card,
              "times": "gloo through host memory, D ranks sharing one card",
              "run_s": wall, "single_device_iters": meta["proj_iters"],
              "fused_radius": meta["radius"],
              # of the rerun's wall, each rank: the share inside gloo
              "gloo_share": {"sharded_solve": [_share(r["a"]) for r in ranks],
                             **{f"fused_step_{n}": [_share(r["b"][n])
                                                    for r in ranks]
                                for n in meta["fused"]}},
              "per_rank": ranks})
        for k in ("partials", "exact", "abs_sum", "absmax"):
            del shared[k]
        del parts
        torch.cuda.empty_cache()
    return results


def _share(row):
    """The share of a rerun's wall ms spent inside gloo collectives."""
    return row["gloo_ms"][1] / row["wall_ms"][1]


def _dist_rank(rank, world, shape, work, root, shared, meta):
    """One rank of phase 17 (a spawned process): joins the gloo group, runs
    (a)-(e) twice (the rerun is (f)) and writes its results. The
    collectives are recorded and counted by the port's test helpers
    (``tests/_dist_ranks.py``), not by the package."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, os.path.join(root, "tests"))
    import _dist_ranks as R
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method="file://" + os.path.join(work, "rdv"))
    try:
        out = _dist_rank_work(torch, dist, R, shape, shared, meta)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _dist_rank_work(torch, dist, R, shape, shared, meta):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch._tree import flatten_with_path, leaves, unflatten_like
    from repro_torch.core import ProjectionEngine
    from repro_torch.dist.compression import compressed_psum, topk_compress
    from repro_torch.dist.layout import MeshLayout, _box, local_of, wrap
    from repro_torch.kernels.fused_step import kernel as FK
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamConfig
    from repro_torch.optim.adam import AdamState, adam_scalars

    data = shared["data"]
    dev = leaves(data["params"])[0].device         # the card
    sync = torch.cuda.synchronize
    mesh = make_local_mesh(*shape, device=dev)
    lay = MeshLayout(mesh)
    acfg = AdamConfig(lr=1e-3, clip_norm=None)
    checks, res = {}, {"rank": dist.get_rank(), "mesh_index": lay.rank}

    def sharded(full, dim):
        """``full`` as a DTensor sharded on tensor dim ``dim`` over every
        mesh dim, and this rank's box of it."""
        pl = (Shard(dim),) * len(lay.shape)
        box = _box(full.shape, pl, lay.shape, lay.coords[lay.me])
        idx = tuple(slice(lo, hi) for lo, hi in box)
        return wrap(full[idx].contiguous(), full.shape, pl, lay), idx

    def tree(t, dim):
        flat = [sharded(v, dim)[0] for _, v in flatten_with_path(t)]
        return unflatten_like(t, flat)

    def box_err(got_tree, want_tree):
        """(max |got - want|, allclose at the params' 1e-5, bit-equal)
        over this rank's pieces of the leaves."""
        worst, close, same = 0.0, True, True
        tol = DIST_TOL["params"]
        for (_, g), (_, w) in zip(flatten_with_path(got_tree),
                                  flatten_with_path(want_tree)):
            box = _box(w.shape, g.placements, lay.shape,
                       lay.coords[lay.me])
            want = w[tuple(slice(lo, hi) for lo, hi in box)]
            got = local_of(g)
            worst = max(worst, float((got - want).abs().max()))
            close = close and bool(torch.allclose(got, want, atol=tol,
                                                  rtol=tol))
            same = same and bool(torch.equal(got.view(torch.int32),
                                             want.view(torch.int32)))
        return worst, close, same

    def theta_close(got, want):
        tol = DIST_TOL["theta"]
        return (bool(torch.allclose(got, want, atol=tol, rtol=tol)),
                float((got - want).abs().max()))

    def newton_ok(calls, G, iters, tail=False):
        """``calls`` (or their tail) are one solve's all-reduces."""
        return any((calls[-len(w):] if tail else calls) == w
                   for w in R.newton_calls([("k", G)], {"k": iters}))

    def locals_of(tree_):
        return [local_of(x).clone() for x in leaves(tree_)]

    def same_bits(a, b):
        return all(bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
                   for x, y in zip(a, b))

    def wall(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    # (a) + (c) + (d): the config's spec through the sharded engine, the
    # leaves entering row-sharded (FSDP)
    step = meta["step"]
    params_rows = tree(data["params"], 1)
    eng = ProjectionEngine((meta["spec"],), solver="sharded", mesh=mesh)
    key = meta["proj_key"]
    runs = []
    for _ in range(2):
        state0 = eng.init_state(params_rows)
        with CommDebugMode() as cdm, R.recorded_collectives(sync) as log:
            (X, st, stats), ms = wall(lambda: eng.apply(
                params_rows, step=step, state=state0, with_stats=True))
        runs.append({"X": X, "theta": st[key].clone(), "iters": stats[key],
                     "ms": ms, "gloo_ms": log.seconds * 1e3,
                     "comm": R.comm_counts(cdm), "reduces": log.reduces})
    a, a2 = runs
    err, close, _ = box_err(a["X"], shared["proj_ref"])
    th_ok, dth = theta_close(a["theta"], shared["proj_theta"])
    checks.update({
        "a_params_within_1e-5": close,
        "a_theta_within_1e-6": th_ok,
        "a_iters_within_one": abs(a["iters"] - meta["proj_iters"]) <= 1,
        "c_zero_all_gathers": a["comm"]["all_gather"] == 0,
        "c_one_all_to_all_each_way_per_leaf": a["comm"]["all_to_all"] == 4,
        "d_collectives": newton_ok(a["reduces"], a["theta"].numel(),
                                   a["iters"]),
        "f_a_rerun_bit_equal": same_bits(locals_of(a["X"]),
                                         locals_of(a2["X"])) and
        bool(torch.equal(a["theta"], a2["theta"]))})
    res["a"] = {"max_abs_err": err, "theta_max_abs_err": dth,
                "iters": a["iters"],
                "single_device_iters": meta["proj_iters"],
                "comm": a["comm"], "all_reduces": len(a["reduces"]),
                "wall_ms": [a["ms"], a2["ms"]],
                "gloo_ms": [a["gloo_ms"], a2["gloo_ms"]]}
    del runs, a, a2, X, params_rows
    torch.cuda.empty_cache()

    # (b): bilevel and l1,2 through fused_sharded, leaves column-sharded,
    # against the single-device fused step; the kernels' launches
    cols = {k: tree(data[k], 2) for k in ("params", "grads", "mu", "nu")}
    res["b"], launches = {}, {k: 0 for k in FUSED_REPLACES}
    kernel_errs = {k: 0.0 for k in FUSED_REPLACES}
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for norm, fm in meta["fused"].items():
        feng = ProjectionEngine((fm["spec"],), solver="fused_sharded",
                                mesh=mesh)
        ref = shared[f"fused_{norm}"]
        runs = []
        for rerun in (False, True):
            opt = AdamState(count=zero, mu=cols["mu"], nu=cols["nu"])
            FK.reset_launch_counts()
            with CommDebugMode() as cdm, R.recorded_collectives(sync) as log, \
                    _kernel_calls(FK, record=not rerun) as kcalls:
                (p, o, s, it), ms = wall(lambda: feng.projected_update(
                    cols["grads"], opt, cols["params"], acfg,
                    state=feng.init_state(cols["params"]), with_stats=True))
            runs.append({"p": p, "o": o, "theta": s[fm["key"]].clone(),
                         "iters": it[fm["key"]], "ms": ms,
                         "gloo_ms": log.seconds * 1e3,
                         "launches": FK.launch_counts(),
                         "comm": R.comm_counts(cdm), "reduces": log.reduces})
            if not rerun:
                # every launch of the step against its plain version on
                # the inputs the step gave it (these launches are not
                # counted), the references dropped before the rerun
                kchecks, kerrs = _against_plain(torch, FK, kcalls)
                kcalls.clear()
                checks.update({f"b_{norm}_{k}": ok
                               for k, ok in kchecks.items()})
                for k, e in kerrs.items():
                    kernel_errs[k] = max(kernel_errs[k], e)
        b, b2 = runs
        for k, n in b["launches"].items():
            launches[k] += n
        perr, close, _ = box_err(b["p"], ref["params"])
        th_ok, dth = theta_close(b["theta"], ref["theta"])
        checks.update({
            f"b_{norm}_params_within_1e-5": close,
            f"b_{norm}_theta_within_1e-6": th_ok,
            f"b_{norm}_iters": abs(b["iters"] - fm["iters"]) <= 1,
            f"b_{norm}_moments_bit_equal": box_err(b["o"].mu, ref["mu"])[2]
            and box_err(b["o"].nu, ref["nu"])[2],
            f"b_{norm}_kernels_launched": all(
                n == 2 for n in b["launches"].values()),
            f"b_{norm}_no_moves_no_gathers": b["comm"]["all_gather"] == 0
            and b["comm"]["all_to_all"] == 0,
            f"b_{norm}_collectives": newton_ok(
                b["reduces"], b["theta"].numel(), b["iters"]),
            f"f_b_{norm}_rerun_bit_equal": same_bits(
                locals_of(b["p"]) + locals_of(b["o"].mu) +
                locals_of(b["o"].nu), locals_of(b2["p"]) +
                locals_of(b2["o"].mu) + locals_of(b2["o"].nu))
            and bool(torch.equal(b["theta"], b2["theta"]))})
        res["b"][norm] = {"params_max_abs_err": perr,
                          "theta_max_abs_err": dth,
                          "iters": b["iters"],
                          "single_device_iters": fm["iters"],
                          "launches": b["launches"],
                          "wall_ms": [b["ms"], b2["ms"]],
                          "gloo_ms": [b["gloo_ms"], b2["gloo_ms"]]}
        del runs, b, b2, p, o
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["kernel_max_abs_err"] = kernel_errs

    # the two kernels on this rank's mlp/w1 column block, device ms, the
    # ranks taking turns (comparison launches: not counted above)
    res["kernels"] = _rank_kernel_times(torch, dist, FK, lay, cols, acfg,
                                        adam_scalars, zero)
    del cols
    torch.cuda.empty_cache()

    # (e): compressed_psum of this rank's partial gradient (mlp/w1's size)
    # in each mode, then fed to the fused_sharded step through grad_reduce
    P = lay.size
    g = shared["partials"][lay.me]
    exact, abs_sum = shared["exact"], shared["abs_sum"]
    eps = float(torch.finfo(torch.float32).eps)
    res["e"] = {}
    outs = {}
    for mode in ("none", "int8", "topk"):
        runs = []
        for _ in range(2):
            with CommDebugMode() as cdm, R.recorded_collectives(sync) as log:
                got, ms = wall(lambda: compressed_psum(
                    {"g": g}, mesh, mode=mode, k_frac=meta["k_frac"])["g"])
            runs.append((got, ms, log.seconds * 1e3, R.comm_counts(cdm)))
        (got, ms, gms, comm), (got2, ms2, gms2, _) = runs
        checks[f"f_e_{mode}_rerun_bit_equal"] = same_bits([got], [got2])
        del got2, runs
        if mode == "none":
            # any summation order: within (P - 1) eps sum |partials|
            ok = bool(((got - exact).abs()
                       <= (P - 1) * eps * abs_sum + 1e-30).all())
            err = float((got - exact).abs().max())
        elif mode == "int8":
            scale = float(shared["absmax"]) / 127.0
            err = float((got - exact).abs().max())
            ok = err <= P * scale / 2 * (1 + 1e-5)
        else:
            ref = torch.zeros(g.numel(), dtype=g.dtype, device=dev)
            for r in range(P):                    # rank order
                v, i = topk_compress(shared["partials"][r], meta["k_frac"])
                ref.index_add_(0, i.to(torch.int64), v)
            ok = bool(torch.equal(got.reshape(-1).view(torch.int32),
                                  ref.view(torch.int32)))
            err = float((got.reshape(-1) - ref).abs().max())
            del ref
        checks[f"e_{mode}"] = ok
        res["e"][mode] = {"max_abs_err": err, "comm": comm,
                          "wall_ms": [ms, ms2], "gloo_ms": [gms, gms2]}
        if mode == "none":
            outs["none"] = got
        else:
            del got
        torch.cuda.empty_cache()
    # grad_reduce composed with the fused_sharded step on mlp/w1 (bilevel)
    w1 = lambda t: {"blocks": {"p0_hybrid": {"mlp": {
        "w1": t["blocks"]["p0_hybrid"]["mlp"]["w1"]}}}}
    cols = {k: tree(w1(data[k]), 2) for k in ("params", "mu", "nu")}
    feng = ProjectionEngine((meta["fused"]["bilevel"]["spec"],),
                            solver="fused_sharded", mesh=mesh)
    partial = {"blocks": {"p0_hybrid": {"mlp": {"w1": g}}}}
    summed = {"blocks": {"p0_hybrid": {"mlp": {"w1": outs.pop("none")}}}}
    runs = []
    for grads_, reduce_ in ((partial, lambda t: compressed_psum(t, mesh,
                                                                "none")),
                            (partial, lambda t: compressed_psum(t, mesh,
                                                                "none")),
                            (summed, None)):
        opt = AdamState(count=zero, mu=cols["mu"], nu=cols["nu"])
        with R.recorded_collectives() as log:
            p, o, s, it = feng.projected_update(
                grads_, opt, cols["params"], acfg, with_stats=True,
                state=feng.init_state(cols["params"]), grad_reduce=reduce_)
        (k,) = s
        runs.append((locals_of(p) + locals_of(o.mu) + locals_of(o.nu),
                     s[k].clone(), it[k], log.reduces))
    (c1, t1, i1, r1), (c2, t2, _, _), (c3, t3, _, _) = runs
    checks.update({
        "e_grad_reduce_feeds_the_step_unchanged": same_bits(c1, c3)
        and bool(torch.equal(t1, t3)),
        "f_e_grad_reduce_rerun_bit_equal": same_bits(c1, c2)
        and bool(torch.equal(t1, t2)),
        "e_grad_reduce_keeps_one_sum_per_eval": newton_ok(
            r1, t1.numel(), i1, tail=True)})
    res["e"]["grad_reduce_iters"] = i1
    res["checks"] = checks
    return _jsonable(res)


@contextlib.contextmanager
def _kernel_calls(FK, record=True):
    """With ``record``, every ``adam_colstats`` / ``adam_clip_apply``
    launch made meanwhile, as (name, args, kwargs, result), so that each
    can be held against its plain version on the inputs it was given."""
    calls = []
    if not record:
        yield calls
        return
    real = {k: getattr(FK, k) for k in FUSED_REPLACES}

    def wrap(name):
        def call(*a, **kw):
            out = real[name](*a, **kw)
            calls.append((name, a, kw, out))
            return out
        return call

    for k in real:
        setattr(FK, k, wrap(k))
    try:
        yield calls
    finally:
        for k, fn in real.items():
            setattr(FK, k, fn)


def _against_plain(torch, FK, calls):
    """Each recorded launch against its plain version on the same inputs,
    held as phase 2b holds them: moments and colmax bit-equal, colsum
    within rel 1e-6, the clipped or scaled params bit-equal. Returns
    ({what: ok}, {kernel: max abs err}); ``what`` names the kernel, the
    block and the stat or mode."""
    checks, errs = {}, {k: 0.0 for k in FUSED_REPLACES}
    for name, a, kw, out in calls:
        p = a[4] if name == "adam_colstats" else a[3]
        what = (f"{name}_vs_plain_{'x'.join(map(str, p.shape))}_"
                f"{kw.get('stat', kw.get('mode'))}")
        want = getattr(FK, name + "_plain")(*a, **kw)
        if name == "adam_colstats":
            rel = float(((out[2] - want[2]).abs()
                         / want[2].clamp(min=1e-30)).max())
            ok = (bits_equal(torch, out[0], want[0])
                  and bits_equal(torch, out[1], want[1])
                  and bool(torch.equal(out[3], want[3])) and rel <= 1e-6)
            err = float((out[2] - want[2]).abs().max())
        else:
            ok = bits_equal(torch, out, want)
            err = float((out.float() - want.float()).abs().max())
        checks[what] = checks.get(what, True) and bool(ok)
        errs[name] = max(errs[name], err)
        del want
    return checks, errs


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    return float(x)


def _rank_kernel_times(torch, dist, FK, lay, cols, acfg, adam_scalars,
                       zero):
    """Device ms of adam_colstats and adam_clip_apply (and their plain
    versions) on this rank's mlp/w1 column block, CUDA events around 10
    back-to-back calls after 2 warm ones, the ranks taking turns so no
    other rank's work shares the card meanwhile; the bound from the bytes
    moved (each input read once, each output written once) and the f32
    operations, as phase 2b counts them."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    from repro_torch.dist.layout import local_of
    pick = lambda t: local_of(t["blocks"]["p0_hybrid"]["mlp"]["w1"])
    g, m, v, p = (pick(cols[k]) for k in ("grads", "mu", "nu", "params"))
    lr_t, b1c, b2c = adam_scalars(acfg, zero + 1)
    sc = torch.stack([torch.ones((), device=p.device),
                      torch.full((), lr_t, device=p.device),
                      b1c.reshape(()), b2c.reshape(())]).float()
    kw = dict(b1=acfg.b1, b2=acfg.b2, eps=acfg.eps, wd=0.0, transpose=False)
    a = FK.adam_colstats(sc, g, m, v, p, None, stat="abs", **kw)
    mu = (a[3] * 0.5).contiguous()
    fns = {"adam_colstats": (
               lambda: FK.adam_colstats(sc, g, m, v, p, None, stat="abs",
                                        **kw),
               lambda: FK.adam_colstats_plain(sc, g, m, v, p, None,
                                              stat="abs", **kw)),
           "adam_clip_apply": (
               lambda: FK.adam_clip_apply(sc, a[0], a[1], p, mu, None,
                                          mode="clip", **kw),
               lambda: FK.adam_clip_apply_plain(sc, a[0], a[1], p, mu, None,
                                                mode="clip", **kw))}
    bound = {name: kernel_bound_ms(getattr(FK, name + "_cost")(
        *p.shape, False)) for name in fns}
    out = {}
    for q in range(lay.size):
        torch.cuda.synchronize()
        dist.barrier()
        if q != lay.me:
            continue
        for name, (kern, plain) in fns.items():
            out[name] = {"ms": _event_ms(torch, kern),
                         "plain_ms": _event_ms(torch, plain),
                         "bound_ms": bound[name][0],
                         "bound_by": bound[name][1],
                         "block": list(p.shape)}
    torch.cuda.synchronize()
    dist.barrier()
    return out


def _event_ms(torch, fn, reps=10):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# phase 7 / 7b's bf16-tile rows: the variant at hymba-1.5b's and
# mamba2-370m's training shapes (name, B, heads per group, S, P, N, chunk,
# dt range), and the model run that drives it (hymba-1.5b at full width,
# depth 2, ssd_bf16, one loss backward)
SSD_TILE_SHAPES = [("hymba_train", 1, 50, 2048, 64, 16, 64, (3.0, 20.0)),
                   ("mamba2_train", 1, 32, 2048, 64, 128, 64, (0.05, 0.6))]
# the bf16-tile kernels against their plain versions, as a fraction of
# each output's largest entry: the forward read bit-equal and the backward
# within 2.1e-7 at both shapes (H100 80GB HBM3, 700 W; PERF.md section 6);
# the f32-tile kernels on the same inputs must land outside the limit
SSD_TILE_TOL = 1e-6
SSD_TILE_MODEL = dict(arch="hymba-1.5b", depth=2, seq=2048)


def ssd_tile_bf16_phase(torch, SK, Z, C, dev, flush,
                        shapes=SSD_TILE_SHAPES, run=SSD_TILE_MODEL):
    """Phases 7 / 7b, the bf16-tile rows: ``ssd_fwd(tile_bf16=True)`` and
    its backward against their plain versions (within SSD_TILE_TOL of each
    output's scale), and the control: the f32-tile kernels on the same
    inputs, held the same way, fall outside that limit; reruns
    bit-equal, device ms warm and L2-flushed, the plain version's, the
    f32-tile kernel's on the same inputs, and the bound (the f32 kernels'
    work: the inputs are f32, the tiles round in registers); then
    ``run``'s loss backward with ``ssd_bf16``
    (the path that launches the variant, counted), its loss within 1e-2
    of the f32 tiles' and every gradient finite. Returns ({kernel: row}
    of the first shape, {kernel: launches})."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    from repro_torch._tree import leaves
    g = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for name, BG, groups, S, P, N, Q, (lo, hi) in shapes:
        BH = BG * groups
        x = torch.randn((BH, S, P), generator=g, device=dev)
        dt = torch.rand((BH, S), generator=g, device=dev) * (hi - lo) + lo
        a = -torch.exp(torch.rand((BH,), generator=g, device=dev) - 0.5)
        d = torch.ones((BH,), device=dev)
        Bm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        Cm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        dy = torch.randn((BH, S, P), generator=g, device=dev)
        args = (x, dt, a, d, Bm, Cm)
        kw = dict(chunk=Q, groups=groups, tile_bf16=True)
        y, st, saved = SK._fwd_kernel(*args, Q, groups, True)
        yp, stp, psaved = SK.ssd_fwd_plain(*args, return_saved=True, **kw)
        rel = _rel_err
        fwd_rel = max(rel(y, yp), rel(st, stp))
        y2, st2, _ = SK._fwd_kernel(*args, Q, groups, True)
        check(bool(torch.isfinite(y).all()) and fwd_rel <= SSD_TILE_TOL,
              f"ssd_fwd_tile_bf16 {name}: kernel vs plain, relative "
              f"{fwd_rel}")
        y32, st32, saved32 = SK._fwd_kernel(*args, Q, groups)
        ctl_fwd = max(rel(y32, yp), rel(st32, stp))
        check(ctl_fwd > SSD_TILE_TOL, f"ssd_fwd_tile_bf16 {name}: the "
              f"f32-tile kernel passes as bf16-tile, relative {ctl_fwd}")
        del y32, st32
        check(bits_equal(torch, y, y2) and bits_equal(torch, st, st2),
              f"ssd_fwd_tile_bf16 {name}: rerun not bit-equal")
        got = SK.ssd_bwd(*args, dy, None, saved, **kw)
        want = SK.ssd_bwd_plain(*args, dy, None, psaved, **kw)
        bwd_rel = {n: rel(u, v) for n, u, v in zip(
            ("dx", "ddt", "da", "dd", "dB", "dC"), got, want)}
        again = SK.ssd_bwd(*args, dy, None, saved, **kw)
        check(all(bool(torch.isfinite(t).all()) for t in got)
              and max(bwd_rel.values()) <= SSD_TILE_TOL,
              f"ssd_bwd_tile_bf16 {name}: kernel vs plain, relative "
              f"{bwd_rel}")
        check(all(bits_equal(torch, u, v) for u, v in zip(got, again)),
              f"ssd_bwd_tile_bf16 {name}: rerun not bit-equal")
        ctl_bwd = {n: rel(u, v) for n, u, v in zip(
            ("dx", "ddt", "da", "dd", "dB", "dC"),
            SK.ssd_bwd(*args, dy, None, saved32, chunk=Q, groups=groups),
            want)}
        check(max(ctl_bwd.values()) > SSD_TILE_TOL, f"ssd_bwd_tile_bf16 "
              f"{name}: the f32-tile kernel passes as bf16-tile, relative "
              f"{ctl_bwd}")
        nc, tri = S // Q, Q * (Q + 1) // 2
        f_ops = nc * BH * (2 * tri * (N + P) + 4 * Q * P * N)
        f_bytes = (2 * x.numel() + dt.numel() + 2 * Bm.numel()) * 4 \
            + (2 * BH + BH * P * N) * 4
        b_ops = nc * BH * (2 * tri * (2 * P + 2 * N) + 8 * Q * P * N)
        hst, _, G = saved
        b_bytes = 4 * (3 * x.numel() + 3 * dt.numel() + 4 * Bm.numel()
                       + hst.numel() + G.numel() + 4 * BH)
        f32kw = dict(chunk=Q, groups=groups)
        for kname, kern, plain, f32, ops, nbytes, err in (
                ("ssd_fwd_tile_bf16",
                 lambda: SK._fwd_kernel(*args, Q, groups, True),
                 lambda: SK.ssd_fwd_plain(*args, **kw),
                 lambda: SK._fwd_kernel(*args, Q, groups), f_ops, f_bytes,
                 float((y - yp).abs().max())),
                ("ssd_bwd_tile_bf16",
                 lambda: SK.ssd_bwd(*args, dy, None, saved, **kw),
                 lambda: SK.ssd_bwd_plain(*args, dy, None, psaved, **kw),
                 lambda: SK.ssd_bwd(*args, dy, None, saved32, **f32kw),
                 b_ops, b_bytes,
                 max(float((u - v).abs().max()) for u, v in zip(got,
                                                                want)))):
            bound = kernel_bound_ms((ops, nbytes))
            line = {"ms": time_ms(torch, kern),
                    "ms_l2_flushed": time_cold_ms(torch, kern, flush),
                    "plain_ms": time_ms(torch, plain, budget_ms=300.0),
                    "f32_tiles_ms": time_ms(torch, f32),
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": None, "max_abs_err": err,
                    "shape": name}
            emit({"phase": "ssd_tile_bf16", "kernel": kname, "BH": BH,
                  "S": S, "P": P, "N": N, "chunk": Q, "dt_range": [lo, hi],
                  "rel_err_vs_plain": fwd_rel if "fwd" in kname else bwd_rel,
                  "tol": SSD_TILE_TOL, "f32_tiles_rel_vs_plain":
                  ctl_fwd if "fwd" in kname else ctl_bwd,
                  **line})
            rows.setdefault(kname, line)
        del got, want, again, saved, psaved, saved32
        torch.cuda.empty_cache()
    # the path: a depth-2 hymba-1.5b loss backward with ssd_bf16
    base = dataclasses.replace(C.get_config(run["arch"]),
                               n_layers=run["depth"])
    tok = torch.randint(0, base.vocab, (1, run["seq"] + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    losses = {}
    for tile in (False, True):
        model = Z.build(dataclasses.replace(base, ssd_bf16=tile))
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        for p in leaves(params):
            p.requires_grad_()
        SK.reset_launch_counts()
        loss, _ = model.loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        launches = SK.launch_counts()
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in leaves(params))
        losses[tile] = float(loss)
        check(finite, f"ssd_bf16 {base.name}: a gradient is not finite")
        del params, model, loss
        torch.cuda.empty_cache()
    want = {"ssd_fwd_tile_bf16": 2 * base.n_layers,
            "ssd_bwd_tile_bf16": base.n_layers}
    check(all(launches[k] == v for k, v in want.items())
          and launches["ssd_fwd"] == 0 and launches["ssd_bwd"] == 0,
          f"ssd_bf16 {base.name}: launches {launches}, want {want}")
    check(abs(losses[True] - losses[False]) <= 1e-2,
          f"ssd_bf16 {base.name}: loss {losses[True]} vs f32 tiles "
          f"{losses[False]}")
    emit({"phase": "ssd_tile_bf16", "model": base.name,
          "n_layers": base.n_layers, "seq": run["seq"], "loss": losses,
          "launches": launches})
    return rows, {k: launches[k] for k in want}


# phase 18: the sharded production step. hymba-1.5b in bf16 with f32 Adam
# moments on a (data 2, model 2) mesh of 4 gloo ranks sharing the card, B 2
# (1 a data rank) x S 2048, its spec at every_k 1 so both steps project
# (fused_sharded); deepseek-v2 at depth 2, B 1 x S 512, on (1, 2) with
# moe_impl "shardmap" and "gspmd", and mixtral-8x7b the same way with
# "gspmd" (the reference's layout); a two-stage pipeline of hymba-1.5b's
# full-width MLP. The update check runs the same step in f32 at
# ``check_depth`` layers for one step (perturbed by PERTURB): in bf16 the
# whole model's update floor is as large as the update, and in f32 after a
# second step about half of it. The main path is cut to ``depth`` of the
# model's 32 layers to keep the run inside its time limit
MESH = dict(arch="hymba-1.5b", mesh=(2, 2), seq=2048, steps=2, depth=8,
            perturb=2.0 ** -8, check_depth=2,
            moe_cases=(("deepseek-v2-236b", ("shardmap", "gspmd")),
                       ("mixtral-8x7b", ("gspmd",))),
            moe_depth=2, moe_seq=512, moe_tol=2e-2, pipe_micro=4,
            pipe_seq=512, timeout=900)


def _spawn(target, world, args, timeout):
    """``target(rank, world, work, *args)`` on ``world`` spawned ranks; the
    ranks' JSON results (``rank{r}.json`` under ``work``), or the failure."""
    import tempfile
    import torch.multiprocessing as mp
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    # the ranks' allocators grow segments in place: four of them share the
    # card's 80 GB with the parent
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    ctx = mp.start_processes(target, args=(world, work, *args),
                             nprocs=world, join=False, start_method="spawn")
    failed = None
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout} s"
                break
    except Exception as e:                 # a rank raised: its traceback
        failed = f"{type(e).__name__}: {str(e)[-3000:]}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = []
    for r in range(world):
        path = os.path.join(work, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    import torch
    torch.cuda.ipc_collect()
    return ranks, failed, time.perf_counter() - t0


def _rank_setup(rank, world, work, shape):
    """Join the gloo group (a file rendezvous under ``work``) and build the
    (data, model) mesh on the card."""
    import torch
    import torch.distributed as dist
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, os.path.join(root, "tests"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method="file://" + os.path.join(work, "rdv"))
    from repro_torch.launch.mesh import make_local_mesh
    return torch, dist, make_local_mesh(*shape, device="cuda")


def _rank_done(dist, work, rank, out, shared=None):
    """Write the rank's results; first drop its references to the
    parent's tensors (``shared``), so that the parent can free them."""
    import torch
    if shared is not None:
        shared.clear()
    gc.collect()
    torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(_jsonable(out), f)


def _box_of(x, lay):
    from repro_torch.dist.layout import _box, placements_of
    box = _box(tuple(x.shape), placements_of(x, lay), lay.shape,
               lay.coords[lay.me])
    return tuple(slice(lo, hi) for lo, hi in box)


def _first_calls(torch, calls):
    """The first recorded launch of each fused kernel, its tensors copied
    to the host (the card's copies are freed with the step), with the
    bytes its tensors move and its element count."""
    first = {}
    for name, a, kw, out in calls:
        if name in first:
            continue
        outs = out if isinstance(out, tuple) else (out,)
        ts = [t for t in list(a) + list(outs) if isinstance(t, torch.Tensor)]
        host = tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in a)
        n_el = (a[4] if name == "adam_colstats" else a[3]).numel()
        first[name] = (host, kw, sum(t.numel() * t.element_size()
                                     for t in ts), n_el)
    return first


def _time_recorded(torch, dist, FK, first, lay):
    """Device ms of each fused kernel's first recorded launch (this rank's
    block of the step's first projected leaf, its inputs back on the card)
    and of its plain version, CUDA events, the ranks taking turns; the
    bound from the bytes its tensors move (each read once, each written
    once) and phase 2b's f32 operation counts."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    res = {}
    for q in range(lay.size):
        torch.cuda.synchronize()
        dist.barrier()
        if q != lay.me:
            continue
        for name, (host, kw, nbytes, n_el) in first.items():
            a = tuple(t.cuda() if isinstance(t, torch.Tensor) else t
                      for t in host)
            ops = (20 if name == "adam_colstats" else 14) * n_el
            bound = kernel_bound_ms((ops, nbytes))
            kern = getattr(FK, name)
            plain = getattr(FK, name + "_plain")
            res[name] = {"ms": _event_ms(torch, lambda: kern(*a, **kw)),
                         "plain_ms": _event_ms(torch,
                                               lambda: plain(*a, **kw)),
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "block": list((a[4] if name == "adam_colstats"
                                        else a[3]).shape)}
            del a
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    return res


# phase 18's LM kernels and the module function that launches each (FA:
# kernels.flash_attention.kernel, SK: kernels.ssd.kernel); the step runs
# bf16 attention (its backward is the bf16 kernel) and f32 SSD
LM_MESH_KERNELS = {"flash_attention_fwd": ("FA", "_fwd_kernel"),
                   "flash_attention_bwd_bf16": ("FA", "flash_attention_bwd"),
                   "ssd_fwd": ("SK", "_fwd_kernel"),
                   "ssd_bwd": ("SK", "ssd_bwd")}


@contextlib.contextmanager
def _lm_first_calls(torch, mods):
    """The first launch of each of ``LM_MESH_KERNELS`` made meanwhile
    (``mods``: {"FA": module, "SK": module}), its inputs and result
    cloned: {kernel: (args, kwargs, result)}."""
    first = {}
    real = {k: getattr(mods[m], f) for k, (m, f) in LM_MESH_KERNELS.items()}

    def clone(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        return tuple(map(clone, t)) if isinstance(t, tuple) else t

    def wrap(name):
        def call(*a, **kw):
            out = real[name](*a, **kw)
            if name not in first:
                first[name] = (clone(a), dict(kw), clone(out))
            return out
        return call

    for k, (m, f) in LM_MESH_KERNELS.items():
        setattr(mods[m], f, wrap(k))
    try:
        yield first
    finally:
        for k, (m, f) in LM_MESH_KERNELS.items():
            setattr(mods[m], f, real[k])


def _rel_err(u, v):
    return float((u.float() - v.float()).abs().max()) / max(
        float(v.float().abs().max()), 1e-30)


def _lm_hold(torch, F, FA, SK, name, a, kw, out):
    """One recorded LM launch of phase 18 against its plain version on the
    same inputs, as phases 6 / 6e / 7 / 7b hold them: the flash forward's
    out within FLASH_TOL and its lse within 2e-5 of their scales, the
    backward's dq, dk, dv within BWD_TOL (the kernel's tiles in the plain
    version), the SSD forward bit-equal, its backward within SSD_BWD_TOL of
    each gradient's scale. Returns (ok, max abs err, {what: relative err},
    the kernel, the plain version, the library call or None, bytes,
    operations, the peak rate)."""
    if name == "flash_attention_fwd":
        q, k, v, groups, causal, window, want_lse = a
        o, lse = out
        pkw = dict(groups=groups, causal=causal, window=window)
        po, plse = FA.flash_attention_fwd_plain(q, k, v, return_lse=True,
                                                **pkw)
        dname = str(q.dtype).split(".")[-1]
        rel = {"out": _rel_err(o, po)}
        if lse is not None:
            rel["lse"] = _rel_err(lse, plse)
        ok = rel["out"] <= FLASH_TOL[dname] and rel.get("lse", 0) <= 2e-5
        err = float((o.float() - po.float()).abs().max())
        BH, S, hd = q.shape
        pairs, mask = _pairs(S, causal, window)
        ops = 4 * hd * pairs * BH
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + (4 * BH * S if want_lse else 0)
        kern = lambda: FA._fwd_kernel(*a)
        plain = lambda: FA.flash_attention_fwd_plain(
            q, k, v, return_lse=want_lse, **pkw)
        mk = torch.from_numpy(mask).to(q.device) if window else None
        qs, ks, vs = (t.view(-1, n, S, hd) for t, n in ((q, groups), (k, 1),
                                                         (v, 1)))

        def lib():
            with torch.no_grad():
                F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mk, is_causal=causal and mk is None,
                    enable_gqa=True)
    elif name == "flash_attention_bwd_bf16":
        q, k, v, o, do, lse = a
        BH, S, hd = q.shape
        block_q, block_kv = FA.bwd_tiles(hd, q.dtype)
        pkw = dict(kw, block_q=block_q, block_kv=block_kv)
        want = FA.flash_attention_bwd_plain(*a, **pkw)
        rel = {g: _rel_err(u, w) for g, u, w in zip(("dq", "dk", "dv"), out,
                                                    want)}
        ok = q.dtype == torch.bfloat16 and max(rel.values()) <= \
            BWD_TOL["bfloat16"]
        err = max(float((u.float() - w.float()).abs().max())
                  for u, w in zip(out, want))
        pairs, mask = _pairs(S, kw["causal"], kw["window"])
        ops = 10 * hd * pairs * BH
        nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel()) + 4 * lse.numel()
        kern = lambda: FA.flash_attention_bwd(*a, **kw)
        plain = lambda: FA.flash_attention_bwd_plain(*a, **pkw)
        mk = torch.from_numpy(mask).to(q.device) if kw["window"] else None
        g = kw["groups"]
        qs, ks, vs = (t.view(-1, n, S, hd).clone().requires_grad_(True)
                      for t, n in ((q, g), (k, 1), (v, 1)))
        ds = do.view(qs.shape)
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mk, is_causal=kw["causal"] and mk is None,
            enable_gqa=True)

        def lib():
            with torch.no_grad():
                sdpa()

        lib_both = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), ds)
        lib = (lib, lib_both)
    elif name == "ssd_fwd":
        x, dt, A, D, Bm, Cm, Q, groups = a[:8]
        tile = a[8] if len(a) > 8 else False
        y, st, _ = out
        pkw = dict(chunk=Q, groups=groups, tile_bf16=tile)
        yp, stp = SK.ssd_fwd_plain(x, dt, A, D, Bm, Cm, **pkw)
        rel = {"y": _rel_err(y, yp), "state": _rel_err(st, stp)}
        ok = bits_equal(torch, y, yp) and bits_equal(torch, st, stp)
        err = max(float((y - yp).abs().max()), float((st - stp).abs().max()))
        BH, S, P = x.shape
        N = Bm.shape[-1]
        nbytes = (2 * x.numel() + dt.numel() + 2 * Bm.numel()) \
            * x.element_size() + (2 * BH + BH * P * N) * 4
        ops = (S // Q) * BH * (2 * (Q * (Q + 1) // 2) * (N + P)
                               + 4 * Q * P * N)
        kern = lambda: SK._fwd_kernel(*a)
        plain = lambda: SK.ssd_fwd_plain(x, dt, A, D, Bm, Cm, **pkw)
        lib = None
    else:
        x, dt, A, D, Bm, Cm, dy, dstate, saved = a
        _, _, psaved = SK.ssd_fwd_plain(x, dt, A, D, Bm, Cm,
                                        return_saved=True, **kw)
        want = SK.ssd_bwd_plain(x, dt, A, D, Bm, Cm, dy, dstate, psaved,
                                **kw)
        rel = {g: _rel_err(u, w) for g, u, w in zip(
            ("dx", "ddt", "da", "dd", "dB", "dC"), out, want)}
        ok = max(rel.values()) <= SSD_BWD_TOL
        err = max(float((u - w).abs().max()) for u, w in zip(out, want))
        BH, S, P = x.shape
        N, Q = Bm.shape[-1], kw["chunk"]
        hst, _, G = saved
        ops = (S // Q) * BH * (2 * (Q * (Q + 1) // 2) * (2 * P + 2 * N)
                               + 8 * Q * P * N)
        nbytes = 4 * (3 * x.numel() + 3 * dt.numel() + 4 * Bm.numel()
                      + hst.numel() + G.numel() + 4 * BH)
        kern = lambda: SK.ssd_bwd(*a, **kw)
        plain = lambda: SK.ssd_bwd_plain(x, dt, A, D, Bm, Cm, dy, dstate,
                                         psaved, **kw)
        lib = None
    return ok, err, rel, kern, plain, lib, nbytes, ops, a[0].dtype


def _lm_hold_and_time(torch, dist, FA, SK, first, lay):
    """Phase 18's recorded LM launches (``_lm_first_calls``), the ranks
    taking turns: each held against its plain version (``_lm_hold``), then
    its device ms, its plain version's and the library call's
    (``scaled_dot_product_attention`` for flash, its backward as forward +
    backward less forward; none for SSD), CUDA events; the bound from this
    launch's bytes (each input read once, each output written once) and
    operations. Returns ({what: ok}, {kernel: row})."""
    from repro_torch.roofline.analysis import kernel_bound_ms
    import torch.nn.functional as F
    checks, rows = {}, {}
    for turn in range(lay.size):
        torch.cuda.synchronize()
        dist.barrier()
        if turn != lay.me:
            continue
        for name, (a, kw, out) in first.items():
            ok, err, rel, kern, plain, lib, nbytes, ops, dt = _lm_hold(
                torch, F, FA, SK, name, a, kw, out)
            checks[f"{name}_vs_plain"] = bool(ok)
            bound = kernel_bound_ms((ops, nbytes), dt)
            if isinstance(lib, tuple):
                fwd_ms = _event_ms(torch, lib[0])
                lib_ms = _event_ms(torch, lib[1]) - fwd_ms
            else:
                lib_ms = None if lib is None else _event_ms(torch, lib)
            rows[name] = {"ms": _event_ms(torch, kern),
                          "plain_ms": _event_ms(torch, plain, reps=3),
                          "library_ms": lib_ms, "bound_ms": bound[0],
                          "bound_by": bound[1], "max_abs_err": err,
                          "rel_err_vs_plain": rel,
                          "input_shapes": [list(t.shape) for t in a
                                           if isinstance(t, torch.Tensor)]}
        first.clear()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    return checks, rows


def _mesh_rank(rank, world, work, shape, shared, meta):
    """One rank of phase 18's train step (a spawned process): two steps of
    ``build_train_step(model, mesh, rules)`` from the shared params with
    its fused kernels' launches recorded and held against their plain
    versions, the launches of every kernel counted each step, the first
    launch of each LM kernel (flash forward and bf16 backward, SSD forward
    and backward) held against its plain version and timed, the
    collectives by kind, a rerun, one prefill; its updates held against
    the same boxes of the one-device update, and a control (its pieces
    left at their start) held the same way. Without ``meta["main"]`` (the
    f32 update check), the two steps, the counts and the updates only."""
    torch, dist, mesh = _rank_setup(rank, world, work, shape)
    import _dist_ranks as R
    from repro_torch._tree import flatten_with_path, leaves
    from repro_torch.convert import params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.layout import MeshLayout, local_of
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.fused_step import kernel as FK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import steps as TS
    from repro_torch.models import zoo as Z
    from repro_torch.optim import AdamConfig
    cfg = meta["cfg"]
    model = Z.build(cfg)
    lay = MeshLayout(mesh)
    rules = TS.rules_for_cell(cfg, "train_4k", False)
    specs = TS.param_shardings(model, mesh, rules)
    acfg = AdamConfig(moment_dtype=torch.float32)
    batch = shared["batch"]
    step = TS.build_train_step(model, mesh, rules, acfg)
    dev = torch.device("cuda")

    def run(record):
        params = params_to_mesh(shared["params"], mesh, specs, dev)
        opt = TS.shard_opt_state(params, acfg)
        proj = TS.projection_engine_for(cfg, mesh).init_state(params)
        losses, counts, ms, gloo_s, launches = [], [], [], [], []
        checks, errs, first = {}, {}, {}
        lm_first = (_lm_first_calls(torch, {"FA": FA, "SK": SK}) if record
                    else contextlib.nullcontext({}))
        with _kernel_calls(FK, record) as calls, lm_first as lm_calls:
            for i in range(meta["steps"]):
                SH.reset_collective_counts()
                for mod in (FK, FA, SK):
                    mod.reset_launch_counts()
                gathers = R._count_calls("all_gather")
                torch.cuda.synchronize()
                t = time.perf_counter()
                with R.recorded_collectives(torch.cuda.synchronize) as log, \
                        gathers:
                    loss, met, params, opt, proj = step(params, opt, proj,
                                                        batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                gloo_s.append(log.seconds)
                losses.append(float(loss))
                launches.append({
                    **FK.launch_counts(), **FA.launch_counts(),
                    **SK.launch_counts(), "flash_attention_bwd_bf16":
                    FA.bwd_launches_by_dtype()["bfloat16"]})
                c = SH.collective_counts()
                c["all_gather_calls"] = gathers.n
                c["all_reduce_calls"] = len(log.reduces)
                c["newton_evals"] = int(met["proj_newton_extra_evals"]) + 2
                c["projection_reduces"] = [
                    [list(s), op] for s, op in log.reduces
                    if len(s) in (1, 2) and s[-1] == meta["G"]
                    and (len(s) == 1 or s[0] in (2, 3))]
                counts.append(c)
                if record:      # each launch against its plain version,
                    # then dropped (the inputs it keeps are a block each)
                    ok, err = _against_plain(torch, FK, calls)
                    for k, v in ok.items():
                        checks[k] = checks.get(k, True) and v
                    for k, v in err.items():
                        errs[k] = max(errs.get(k, 0.0), v)
                    if i == 0:
                        first = _first_calls(torch, calls)
                    calls.clear()
        return (params, losses, counts, ms, gloo_s, launches, checks, errs,
                first, dict(lm_calls))

    main = meta["main"]
    torch.cuda.reset_peak_memory_stats()
    (params, losses, counts, ms, gloo_s, launches, checks, errs,
     first, lm_first) = run(main)
    peak = torch.cuda.max_memory_allocated()
    if main:
        p2, l2, *_ = run(False)
        checks["rerun_bit_equal"] = l2 == losses and all(
            torch.equal(local_of(u), local_of(v))
            for u, v in zip(leaves(params), leaves(p2)))
        del p2
    # the update against the one-device update over this rank's box (the
    # parent's file, mapped: each rank reads its boxes), as Frobenius norms
    # of their difference; both start from the shared params, so that is
    # the distance of the pieces. The control: the pieces left at their
    # start, whose distance is the one-device update's norm
    one = torch.load(meta["one_file"], mmap=True)
    floors = meta["floors"][dist.get_rank()]
    start = dict(flatten_with_path(shared["params"]))
    leaves_out = {}
    for path, x in flatten_with_path(params):
        box = _box_of(x, lay)
        mine = local_of(x).float().cpu()
        o = one[path][box].float()
        s0 = start[path][box].float().cpu()
        leaves_out[path] = {
            "diff_norm": float(torch.linalg.vector_norm(mine - o)),
            "control_norm": float(torch.linalg.vector_norm(s0 - o)),
            "max_abs_diff": float((mine - o).abs().max()),
            "scale": float(o.abs().max()), **floors[path]}
    del params, one, start
    torch.cuda.empty_cache()
    out = {"rank": dist.get_rank(), "losses": losses, "counts": counts,
           "step_ms": ms, "gloo_s": gloo_s, "launches": launches,
           "checks": checks, "kernel_max_abs_err": errs, "kernels": {},
           "leaves": leaves_out, "prefill_max_abs_diff": None,
           "peak_bytes": peak}
    if main:
        out["kernels"] = _time_recorded(torch, dist, FK, first, lay)
        del first
        lm_checks, lm_times = _lm_hold_and_time(torch, dist, FA, SK,
                                                lm_first, lay)
        checks.update(lm_checks)
        out["kernels"].update(lm_times)
        start = params_to_mesh(shared["params"], mesh, specs, dev)
        pre = TS.build_prefill_step(model, mesh, rules)(
            start, {"tokens": batch["tokens"]})
        out["prefill_max_abs_diff"] = float(
            (pre.float() - shared["prefill"].float()).abs().max())
        del start, pre
    del batch
    _rank_done(dist, work, rank, out, shared)


def _moe_rank(rank, world, work, shape, shared, meta):
    """One rank of phase 18's MoE check: for each of ``meta["cases"]``
    (a config and its impls; its params and batch in ``shared``, in the
    same order) Model.loss under the (1, 2) mesh for each impl (no
    gradient), on the reference's layout (the gspmd impl: the experts, or
    their hidden units, and MLA's heads split over model), with the
    collectives by kind, the specs of the regions split over model and
    the rank's peak memory."""
    torch, dist, mesh = _rank_setup(rank, world, work, shape)
    from repro_torch._tree import flatten_with_path
    from repro_torch.convert import params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as TS
    from repro_torch.models import zoo as Z
    from repro_torch.train.loop import local_batch, mesh_weights
    out = {"rank": dist.get_rank(), "cases": []}
    for (base, impls), full, batch in zip(meta["cases"], shared["params"],
                                          shared["batch"]):
        case = {}
        for impl in impls:
            cfg = dataclasses.replace(base, moe_impl=impl)
            model = Z.build(cfg)
            rules = TS.rules_for_cell(cfg, "train_4k", False)
            specs = TS.param_shardings(model, mesh, rules)
            params = params_to_mesh(full, mesh, specs, mesh.device_type)
            SH.reset_collective_counts()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with torch.no_grad(), SH.axis_rules(mesh, rules):
                _, tree = mesh_weights(params, specs, grad=False)
                loss, _ = model.loss(tree, local_batch(batch))
                loss = SH.data_sum(loss, "dp_loss")
            torch.cuda.synchronize()
            case[impl] = {
                "loss": float(loss), "counts": SH.collective_counts(),
                "ms": (time.perf_counter() - t) * 1e3,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "split": {p: list(v) for p, v in flatten_with_path(specs)
                          if "model" in v and p.startswith("blocks/p0_")}}
            del params, tree
            torch.cuda.empty_cache()
        out["cases"].append(case)
    _rank_done(dist, work, rank, out, shared)


def _pipe_rank(rank, world, work, shape, shared, meta):
    """One rank of phase 18's pipeline check: ``build_pipeline_fn`` over
    the data axis, one full-width MLP stage a rank."""
    torch, dist, mesh = _rank_setup(rank, world, work, shape)
    from repro_torch.dist.pipeline import build_pipeline_fn
    from repro_torch.models.layers import mlp_apply
    pipe = build_pipeline_fn(lambda W, h: h + mlp_apply(W, h), shape[0],
                             meta["n_micro"], mesh, "data")
    torch.cuda.synchronize()
    t = time.perf_counter()
    y = pipe(shared["stages"], shared["x"])
    torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "ms": (time.perf_counter() - t) * 1e3,
           "max_abs_diff": float((y - shared["want"]).abs().max()),
           "scale": float(shared["want"].abs().max())}
    del y, pipe
    _rank_done(dist, work, rank, out, shared)


def moe_mesh_check(torch, Z, C, dev, card, m):
    """Phase 18's MoE check (``lm_train_mesh_phase``): each of
    ``m["moe_cases"]`` at ``moe_depth``, full width, bf16, B 1 x S
    ``moe_seq``, its loss on a (1, 2) mesh (one spawned group for all)
    against the one-device loss run here, within ``moe_tol``; the regions
    that split over model on the reference's layout, and their sums."""
    # the MoE archs at depth 2 on (1, 2), on the reference's layout, in
    # one spawned group (each arch's params reach it by CUDA IPC)
    cases, mparams, mbatch, mones = [], [], [], []
    for arch, impls in m["moe_cases"]:
        mcfg = dataclasses.replace(C.get_config(arch),
                                   n_layers=m["moe_depth"])
        mmodel = Z.build(mcfg)
        p = _cast(torch, mmodel.init(torch.Generator(device=dev)
                                     .manual_seed(0), device=dev),
                  torch.bfloat16)
        mtok = torch.randint(0, mcfg.vocab, (1, m["moe_seq"] + 1),
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(5))
        b = {"tokens": mtok[:, :-1].contiguous(),
             "labels": mtok[:, 1:].contiguous()}
        with torch.no_grad():
            mones.append(float(mmodel.loss(p, b)[0]))
        cases.append((mcfg, impls))
        mparams.append(p)
        mbatch.append(b)
        del mmodel, mtok
    torch.cuda.empty_cache()
    mranks, mfailed, mwall = _spawn(
        _moe_rank, 2, ((1, 2), {"params": mparams, "batch": mbatch},
                       {"cases": cases}), m["timeout"])
    check(mfailed is None and len(mranks) == 2,
          f"lm_train_mesh moe: {mfailed or 'missing rank results'}")
    for j, ((mcfg, impls), mone) in enumerate(zip(cases, mones)):
        # the region each arch runs split over model, and its sum
        split = (("moe/w1", "mla/wq_b", "moe/shared/w1")
                 if mcfg.n_shared_experts else ("moe/w1", "attn/wq"))
        kind = "moe_combine" if mcfg.expert_sharding == "ep" else \
            "tp_exit_sum"
        per_rank = [dict(r["cases"][j], rank=r["rank"]) for r in mranks]
        for r in per_rank:
            losses = {i: r[i]["loss"] for i in impls}
            check(all(abs(v - mone) <= m["moe_tol"] and np.isfinite(v)
                      for v in losses.values()),
                  f"lm_train_mesh moe {mcfg.name} rank {r['rank']}: "
                  f"{losses}, one-device {mone}")
            gs = r["gspmd"]
            check(all(any(p.endswith(leaf) for p in gs["split"])
                      for leaf in split) and gs["counts"].get(kind, 0) > 0,
                  f"lm_train_mesh moe {mcfg.name} rank {r['rank']}: split "
                  f"{sorted(gs['split'])}, counts {gs['counts']}")
        emit({"phase": "lm_train_mesh", "check": "moe_mesh",
              "arch": mcfg.name, "n_layers": mcfg.n_layers, "mesh": [1, 2],
              "impls": list(impls), "seq": m["moe_seq"], "dtype": "bfloat16",
              "one_device_loss": mone, "run_s": mwall, "card": card,
              "per_rank": per_rank})
    del mparams, mbatch
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_mesh_phase(torch, Z, C, FK, dev, card, mesh_cfg=MESH):
    """Phase 18 (lm_train_mesh): the sharded production step.

    * hymba-1.5b at full width (``depth`` cuts it when set) in bf16 with
      f32 moments through ``build_train_step(model, mesh, rules)`` on a
      (2, 2) data x model mesh of 4 gloo ranks sharing the card (the
      parent's params, batch and one-device results reach them by CUDA
      IPC), two steps at every_k 1: the losses within twice the noise
      floor of the one-device step run here (the same two steps from the
      params multiplied by 1 + ``perturb`` N(0, 1), and the batch's
      gradient summed from its data halves), every piece's update within
      twice its leaf's update floor (Frobenius norms over the rank's box);
      reruns bit-equal; each rank's launches of the LM kernels those of
      the one-device step, every fused-kernel launch and the first launch
      of each LM kernel against its plain version; the collectives by
      kind: no all-gather but the FSDP weight gathers, and per plan one
      (3, G) SUM, one (2, G) SUM per Newton evaluation and one (G,) MAX;
      one prefill over the mesh within twice the prefill's floor;
    * one step in f32 at ``check_depth`` layers (perturbed by PERTURB),
      where the floor is far below the update: the loss
      within atol 1e-5 + rtol 1e-5 (tests/test_torch_mesh_step.py's),
      every update within twice its floor, and the control, a piece left
      at its start, outside it;
    * ``moe_cases`` at depth 2, full width, bf16, B 1 x S ``moe_seq`` on
      (1, 2), the loss of each impl against the one-device loss within
      ``moe_tol`` (the reference's 2e-2): deepseek-v2 with moe_impl
      "shardmap" and "gspmd" (the reference's layout: MLA by heads, the
      routed experts over model, one combine sum a layer) and mixtral-8x7b
      (its query heads and the experts' hidden units over model);
    * ``build_pipeline_fn`` over 2 ranks, one full-width hymba MLP stage a
      rank (plus its residual), against the stages in order.

    Times are gloo ranks sharing one card, through host memory: they say
    nothing of an interconnect. Returns {kernel: row} for the kernels
    line (rank 0's times, launches summed over the ranks' first step)."""
    from repro_torch._tree import flatten_with_path, leaves, tree_map
    from repro_torch.launch import steps as TS
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.core import ProjectionEngine
    from repro_torch.train import loop as TL
    m = mesh_cfg
    base = C.get_config(m["arch"])
    data, mdl = m["mesh"]

    def train_check(dtype, depth, perturb, steps, main):
        """``steps`` mesh steps of ``base`` at ``depth`` (None: whole) with
        params in ``dtype`` against the one-device steps; with ``main``,
        the path whose kernels are held, timed and counted for the kernels
        line. Returns the ranks' results."""
        # the config's leaves under the l1,2 ball at every_k 1: a family
        # the fused step takes, so fused_sharded launches its kernels every
        # step
        cfg = dataclasses.replace(base, projection_specs=tuple(
            dataclasses.replace(s, every_k=1, norm="l12")
            for s in base.projection_specs))
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        model = Z.build(cfg)
        gc.collect()
        # tensors earlier phases shared with their ranks by CUDA IPC stay
        # allocated here until collected once the ranks are gone
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        params = _cast(torch, model.init(torch.Generator(
            device=dev).manual_seed(0), device=dev), dtype)
        tok = torch.randint(0, cfg.vocab, (data, m["seq"] + 1), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(4))
        batch = {"tokens": tok[:, :-1].contiguous(),
                 "labels": tok[:, 1:].contiguous()}
        acfg = AdamConfig(moment_dtype=torch.float32)
        step = TS.build_train_step(model, None, None, acfg)

        def one_device(p):
            p = tree_map(lambda a: a.clone(), p)
            opt = adam_init(p, acfg)
            proj = TS.projection_engine_for(cfg).init_state(p)
            losses, ms = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, _, p, opt, proj = step(p, opt, proj, batch)
                losses.append(float(loss))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            del opt
            return p, losses, ms

        def accumulated(p):
            """The one-device step with the batch as ``data``
            microbatches of one row, their gradients summed in ``dtype``:
            the data axis's sum."""
            p = tree_map(lambda a: a.clone(), p)
            opt = adam_init(p, acfg)
            eng = ProjectionEngine(cfg.projection_specs, solver="fused")
            proj = eng.init_state(p)
            acc = TL.build_accum_step(model, acfg, TL.TrainConfig(
                microbatches=data), engine=eng)
            losses = []
            for i in range(steps):
                p, opt, proj, loss = acc(p, opt, proj, batch, acfg.lr,
                                         count=i + 1)
                losses.append(float(loss))
            del opt
            return p, losses

        g = torch.Generator(device=dev).manual_seed(6)
        pert = tree_map(lambda a: (a.float() * (1 + perturb * torch.randn(
            a.shape, generator=g, device=dev))).to(a.dtype), params)
        prefill = prefill_floor = None
        if main:
            prefill = TS.build_prefill_step(model)(params, {"tokens": batch[
                "tokens"]})
            prefill_floor = float((TS.build_prefill_step(model)(
                pert, {"tokens": batch["tokens"]}).float() - prefill.float())
                .abs().max())
        one, one_losses, one_ms = one_device(params)
        # each rank's floor, leaf by leaf, over the box it holds (rank r
        # sits at mesh coordinate divmod(r, model)); only these numbers
        # reach it. The floor is the larger of two same-run distances from
        # the one-device update (p after - p before, Frobenius norm over
        # the box): the update from params moved by ``perturb``, and the
        # update from the batch's gradient summed from its data-parallel
        # halves; one run is kept at a time. Beside it, the one-device
        # update's own norm: a piece that kept its start value is that far
        # away
        from repro_torch.dist.layout import _box
        from repro_torch.dist.sharding import placements
        grid = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     mesh=torch.zeros((data, mdl)))
        spec_of = dict(flatten_with_path(TS.param_shardings(
            model, grid, TS.rules_for_cell(cfg, "train_4k", False))))
        floors = [{} for _ in range(data * mdl)]

        def widen(other, other_start):
            for (path, o), f, f0, p0 in zip(
                    flatten_with_path(one), leaves(other),
                    leaves(other_start), leaves(params)):
                u = o.float() - p0.float()
                d = (f.float() - f0.float()) - u
                pl = placements(grid, spec_of[path])
                for r in range(data * mdl):
                    box = tuple(slice(lo, hi) for lo, hi in _box(
                        tuple(o.shape), pl, (data, mdl), divmod(r, mdl)))
                    e = floors[r].setdefault(path, {"floor_norm": 0.0})
                    e["floor_norm"] = max(e["floor_norm"], float(
                        torch.linalg.vector_norm(d[box])))
                    e["update_norm"] = float(torch.linalg.vector_norm(
                        u[box]))
                del d, u

        floor, floor_losses, _ = one_device(pert)
        widen(floor, pert)
        del floor, pert
        gc.collect()
        torch.cuda.empty_cache()
        micro, micro_losses = accumulated(params)
        widen(micro, params)
        del micro
        floor_losses = [b if abs(b - a) >= abs(c - a) else c
                        for a, b, c in zip(one_losses, floor_losses,
                                           micro_losses)]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        G = sum(p.num_segments for p in TS.projection_engine_for(cfg).plans(
            params)[0])
        # the one-device result goes to the ranks as a file they map (not
        # on the card: four ranks' state and the parent's params fill it)
        root = os.path.dirname(os.path.abspath(__file__))
        one_file = os.path.join(root, "build", "lm_train_mesh_one.pt")
        torch.save({p: t.cpu() for p, t in flatten_with_path(one)},
                   one_file)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        shared = {"params": params, "batch": batch, "prefill": prefill}
        ranks, failed, wall = _spawn(
            _mesh_rank, data * mdl,
            ((data, mdl), shared, {"cfg": cfg, "steps": steps, "G": G,
                                   "floors": floors, "one_file": one_file,
                                   "main": main}),
            m["timeout"])
        os.remove(one_file)
        what = f"lm_train_mesh {str(dtype).split('.')[-1]}"
        check(failed is None and len(ranks) == data * mdl,
              f"{what}: {failed or 'missing rank results'}")
        if not ranks:
            return []
        loss_floor = max(abs(a - b) for a, b in zip(floor_losses,
                                                    one_losses))
        # f32's loss floor may be 0 (the same sums in the same order): its
        # losses are held at the mesh tests' atol 1e-5, rtol 1e-5
        loss_tol = FLOOR_FACTOR * loss_floor if main else 1e-5 + 1e-5 * max(
            abs(v) for v in one_losses)
        # each rank runs every layer on its batch rows and its heads: the
        # one-device step's launches of the LM kernels
        want = _step_counts(cfg)
        if main:
            want["flash_attention_bwd_bf16"] = want["flash_attention_bwd"]
        for r in ranks:
            for name, ok in r["checks"].items():
                check(ok, f"{what} rank {r['rank']}: {name}")
            first_step = r["launches"][0]
            for k in list(FUSED_REPLACES) + list(LM_MESH_KERNELS
                                                 if main else ()):
                check(first_step.get(k, 0) > 0,
                      f"{what} rank {r['rank']}: the step never launched "
                      f"{k}")
            check({k: first_step.get(k) for k in want} == want,
                  f"{what} rank {r['rank']}: LM launches {first_step}, "
                  f"want {want}")
            loss_diff = max(abs(a - b) for a, b in zip(r["losses"],
                                                       one_losses))
            check(loss_diff <= loss_tol,
                  f"{what} rank {r['rank']}: losses {r['losses']} vs "
                  f"one-device {one_losses}, limit {loss_tol}")
            for path, lf in r["leaves"].items():
                limit = FLOOR_FACTOR * lf["floor_norm"]
                check(lf["diff_norm"] <= limit,
                      f"{what} rank {r['rank']} {path}: update {lf}")
                # the control fails where the one-device step moved the
                # piece: in f32. In bf16 the whole model's floor is as
                # large as the update (PERF.md section 6), and the control
                # is reported
                check(main or lf["update_norm"] == 0
                      or lf["control_norm"] > limit,
                      f"{what} rank {r['rank']} {path}: a piece left at "
                      f"its start passes: {lf}")
            if main:
                check(r["prefill_max_abs_diff"]
                      <= FLOOR_FACTOR * prefill_floor,
                      f"{what} rank {r['rank']}: prefill "
                      f"{r['prefill_max_abs_diff']} vs floor "
                      f"{prefill_floor}")
            for c in r["counts"]:
                check(c["all_gather_calls"] == c.get("fsdp_gather", 0),
                      f"{what} rank {r['rank']}: an all_gather that is no "
                      f"FSDP weight gather: {c}")
                pat = ([[[3, G], "SUM"]] + [[[2, G], "SUM"]]
                       * c["newton_evals"] + [[[G], "MAX"]])
                check(c["projection_reduces"] == pat,
                      f"{what} rank {r['rank']}: projection all-reduces "
                      f"{c['projection_reduces']}, want {pat}")
        moved = [(p, lf) for r in ranks for p, lf in r["leaves"].items()
                 if lf["update_norm"] > 0]
        emit({"phase": "lm_train_mesh", "arch": cfg.name,
              "n_layers": cfg.n_layers, "n_params": model.n_params(),
              "mesh": [data, mdl], "ranks": data * mdl, "batch": data,
              "seq": m["seq"], "dtype": str(dtype).split(".")[-1],
              "moments": "float32", "card": card,
              "times": "gloo through host memory, 4 ranks sharing one card",
              "run_s": wall, "one_device_losses": one_losses,
              "one_device_step_ms": one_ms, "loss_noise_floor": loss_floor,
              "loss_limit": loss_tol,
              "prefill_noise_floor": prefill_floor, "perturb": perturb,
              "G": G,
              "parent_allocated_bytes_after": torch.cuda.memory_allocated(),
              "per_rank": [{k: r[k] for k in (
                  "rank", "losses", "counts", "step_ms", "gloo_s",
                  "launches", "kernel_max_abs_err", "kernels",
                  "prefill_max_abs_diff", "peak_bytes", "checks")}
                  for r in ranks],
              "worst_leaf": max(
                  ({"path": p, **lf, "rank": r["rank"]} for r in ranks
                   for p, lf in r["leaves"].items()),
                  key=lambda e: e["diff_norm"] / max(e["floor_norm"],
                                                     1e-30)),
              "controls_caught": sum(
                  lf["control_norm"] > FLOOR_FACTOR * lf["floor_norm"]
                  for _, lf in moved),
              "controls": len(moved),
              "leaves_by_rank": [{p: {k: lf[k] for k in (
                  "diff_norm", "floor_norm", "control_norm",
                  "max_abs_diff")} for p, lf in r["leaves"].items()}
                  for r in ranks]})
        del shared, params, prefill, batch, tok
        gc.collect()
        torch.cuda.empty_cache()
        return ranks

    # the main path: the whole model in bf16; then the update check in f32
    # at ``check_depth``, one step (bf16's floor, and f32's after a second
    # step, hide a missing update: PERF.md section 6)
    ranks = train_check(torch.bfloat16, m["depth"], m["perturb"],
                        m["steps"], True)
    train_check(torch.float32, m["check_depth"], PERTURB, 1, False)

    moe_mesh_check(torch, Z, C, dev, card, m)

    # the pipeline: two full-width hymba MLP stages
    d, ff = base.d_model, base.d_ff
    g = torch.Generator(device=dev).manual_seed(7)
    stages = {"w1": torch.randn((2, d, ff), generator=g, device=dev) * d ** -.5,
              "w3": torch.randn((2, d, ff), generator=g, device=dev) * d ** -.5,
              "w2": torch.randn((2, ff, d), generator=g, device=dev) * ff ** -.5}
    x = torch.randn((m["pipe_micro"], 1, m["pipe_seq"], d), generator=g,
                    device=dev)
    from repro_torch.models.layers import mlp_apply
    want = x.clone()
    with torch.no_grad():
        for s in range(2):
            W = {k: v[s] for k, v in stages.items()}
            want = torch.stack([h + mlp_apply(W, h) for h in want])
    pranks, pfailed, pwall = _spawn(
        _pipe_rank, 2, ((2, 1), {"stages": stages, "x": x, "want": want},
                        {"n_micro": m["pipe_micro"]}), m["timeout"])
    check(pfailed is None and len(pranks) == 2,
          f"lm_train_mesh pipeline: {pfailed or 'missing rank results'}")
    for r in pranks:
        check(r["max_abs_diff"] <= 1e-5 * max(1.0, r["scale"]),
              f"lm_train_mesh pipeline rank {r['rank']}: {r}")
    emit({"phase": "lm_train_mesh", "check": "pipeline", "stages": 2,
          "microbatches": m["pipe_micro"], "d_model": d, "d_ff": ff,
          "seq": m["pipe_seq"], "run_s": pwall, "card": card,
          "per_rank": pranks})
    del stages, x, want
    torch.cuda.empty_cache()
    rows = {}
    for k in list(FUSED_REPLACES) + list(LM_MESH_KERNELS):
        fused = k in FUSED_REPLACES
        rows[k] = {
            "source": FUSED_SOURCE if fused else LM_SOURCE[k],
            "replaces": FUSED_REPLACES[k] if fused else LM_REPLACES[k],
            "launches": sum(r["launches"][0].get(k, 0) for r in ranks),
            "launches_by_rank": [r["launches"][0].get(k, 0) for r in ranks],
            **ranks[0]["kernels"].get(k, {}),
            "max_abs_err": max(
                r["kernel_max_abs_err"].get(k, 0.0) if fused
                else r["kernels"].get(k, {}).get("max_abs_err", 0.0)
                for r in ranks)}
    return rows


# phase 19: serving over a mesh. hymba-1.5b and stablelm-3b at full width,
# ``depth`` of their 32 layers (the cut keeps the run inside its time
# limit), f32 params and a bf16 cache: the decode step under the
# reference's decode rules on a (2, 2) mesh, one call at a time against
# the one-device step (``cases``: arch, cell, batch, sequence, the first
# call's per-row positions, the second call's scalar; slices of 16384
# positions at decode_32k, 131072 at long_500k); FleetEngine on a (4, 1)
# data mesh (``slots``, 2 a rank) on phase 10b's requests; the paper-width
# SAE's serve step over 4 ranks
SERVE_MESH = dict(
    depth=8, mesh=(2, 2), fleet_mesh=(4, 1), slots=8, timeout=600,
    cases=(
        ("hymba-1.5b", "decode_32k", 16, 32768,
         [32767, 16884, 8000, 30000, 16383, 16384, 1023, 0, 20000, 12000,
          16400, 32000, 100, 16000, 24576, 31000], 16900),
        ("hymba-1.5b", "long_500k", 1, 524288, [131372], 524287),
        ("stablelm-3b", "decode_32k", 2, 32768, [30000, 10000], 16384)))
BF16_ULP = 2.0 ** -7


def _seeded_cache(torch, model, B, S, first, dev, seed):
    """A bf16 decode cache whose position-indexed leaves hold seeded N(0, 1)
    values below each row's ``first`` position (zeros from there on) and
    whose other leaves (the SSM state in f32, the conv tails) are seeded
    whole."""
    from repro_torch._tree import flatten_with_path
    cache = model.init_cache(B, S, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    below = (torch.arange(S, device=dev)[None, :]
             < torch.as_tensor(first, device=dev)[:, None])      # (B, S)
    for path, leaf in flatten_with_path(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev,
                               dtype=leaf.dtype))
        if path.rsplit("/", 1)[-1] in ("k", "v"):
            leaf.mul_(below[None, :, :, None, None].to(leaf.dtype))
    return cache


def _written(calls, B, S):
    """The (row, position) pairs the calls write, in order."""
    out = set()
    for _, pos in calls:
        pos = pos.tolist() if hasattr(pos, "tolist") else pos
        for b in range(B):
            out.add((b, int(pos[b] if isinstance(pos, list) else pos) % S))
    return sorted(out)


def _cache_extract(torch, cache, pairs):
    """What the ranks compare against: each position-indexed leaf at the
    written (row, position) pairs ((L, n, ...)), the other leaves whole."""
    from repro_torch._tree import flatten_with_path
    out = {}
    for path, leaf in flatten_with_path(cache):
        rows = torch.tensor([b for b, _ in pairs], device=leaf.device)
        cols = torch.tensor([p for _, p in pairs], device=leaf.device)
        if path.rsplit("/", 1)[-1] in ("k", "v"):
            out[path] = leaf[:, rows, cols].clone()
        else:
            out[path] = leaf.clone()
    return out


def _one_device_decode(torch, model, params, cache0, calls, V, reps=None):
    """The one-device step (``build_decode_step(model)``, a new cache a
    call) through ``calls``: each call's logits over the true vocab, the
    final cache's extract, the written pairs, and with ``reps`` the
    in-place step's device ms a call (``model.decode_`` on that cache,
    ``reps`` times, CUDA events)."""
    from repro_torch.launch import steps as TS
    step = TS.build_decode_step(model)
    cache, logits = cache0, []
    for tok, pos in calls:
        lg, new = step(params, cache, tok, pos)
        if cache is not cache0:
            del cache
        cache = new
        logits.append(lg[:, :V].float())
    k = next(v["k"] for v in cache0["blocks"].values())    # (L, B, S, ...)
    pairs = _written(calls, k.shape[1], k.shape[2])
    ext = _cache_extract(torch, cache, pairs)
    tok, pos = calls[0]
    ms = None if reps is None else _event_ms(
        torch, lambda: model.decode_(params, cache, tok, pos), reps)
    del cache
    torch.cuda.empty_cache()
    return logits, ext, pairs, ms


def _serve_mesh_decode(torch, dist, mesh, lay, shared, case):
    """One case of phase 19 (a) on this rank: two calls of the mesh step
    from the shared cache laid out in pieces, held against the one-device
    step's extract; a rerun; the collectives and launches by kind."""
    import _dist_ranks as R
    from repro_torch._tree import flatten_with_path, leaves
    from repro_torch.convert import cache_to_mesh, params_to_mesh
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.layout import local_of
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import steps as TS
    from repro_torch.models import zoo as Z
    cfg, cell, calls = case["cfg"], case["cell"], shared["calls"]
    model = Z.build(cfg)
    dev = torch.device(mesh.device_type)
    rules = TS.rules_for_cell(cfg, cell, False)
    specs = TS.param_shardings(model, mesh, rules)
    params = params_to_mesh(shared["params"], mesh, specs, dev)
    cache0 = shared["cache"]
    c_specs = TS.cache_shardings(cache0, mesh, rules)
    step = TS.build_decode_step(model, mesh, rules)

    def run(record):
        cache = cache_to_mesh(cache0, mesh, c_specs, dev)
        logits, counts, ms, gloo_s = [], [], [], []
        for tok, pos in calls:
            SH.reset_collective_counts()
            for mod in (FA, SK):
                mod.reset_launch_counts()
            gathers = R._count_calls("all_gather")
            a2a = R._count_calls("all_to_all_single")
            torch.cuda.synchronize()
            t = time.perf_counter()
            with R.recorded_collectives(torch.cuda.synchronize) as log, \
                    gathers, a2a:
                lg, _ = step(params, cache, tok, pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            gloo_s.append(log.seconds)
            c = SH.collective_counts()
            c.update(all_gather_calls=gathers.n, all_to_all_calls=a2a.n,
                     all_reduce_calls=len(log.reduces),
                     lm_kernel_launches=sum(FA.launch_counts().values())
                     + sum(SK.launch_counts().values()))
            counts.append(c)
            logits.append(lg)
        return logits, cache, counts, ms, gloo_s

    torch.cuda.reset_peak_memory_stats()
    logits, cache, counts, ms, gloo_s = run(True)
    peak = torch.cuda.max_memory_allocated()
    one, ext, floors = shared["one"], shared["ext"], case["floors"]
    V = cfg.vocab
    out = {"cell": cell, "arch": cfg.name, "counts": counts,
           "call_ms": ms, "gloo_s": gloo_s, "peak_bytes": peak,
           "cache_bytes": sum(local_of(x).numel() * local_of(x)
                              .element_size() for x in leaves(cache)),
           "logits": [], "leaves": {}}
    for lg, want, fl in zip(logits, one, floors["logits"]):
        box = _box_of(lg, lay)
        got = local_of(lg).float()
        v = min(got.shape[1], max(0, V - box[1].start))   # true vocab
        w = want[box[0], box[1].start:box[1].start + v]
        err = float((got[:, :v] - w).abs().max()) if v else 0.0
        scale = float(w.abs().max()) if v else 0.0
        out["logits"].append({"max_abs_diff": err, "scale": scale,
                              "limit": max(1e-5 + 1e-5 * scale,
                                           FLOOR_FACTOR * fl)})
    pairs, flat0 = case["pairs"], dict(flatten_with_path(cache0))
    for path, x in flatten_with_path(cache):
        box = _box_of(x, lay)
        piece = local_of(x)
        name = path.rsplit("/", 1)[-1]
        fl = floors["cache"][path]
        if name in ("k", "v"):
            b0, s0 = box[1].start, box[2].start
            mine = [(j, b - b0, p - s0) for j, (b, p) in enumerate(pairs)
                    if box[1].start <= b < box[1].stop
                    and box[2].start <= p < box[2].stop]
            changed = (piece != flat0[path][box]).flatten(3).any(-1).any(0)
            allowed = torch.zeros_like(changed)          # (rows, positions)
            for _, b, p in mine:
                allowed[b, p] = True
            untouched_ok = not bool((changed & ~allowed).any())
            del changed
            if mine:
                j = torch.tensor([m[0] for m in mine], device=dev)
                g = piece[:, [m[1] for m in mine], [m[2] for m in mine]]
                w = ext[path][:, j]
            else:
                g = w = torch.zeros(0, device=dev)
        else:
            untouched_ok = True
            g, w = piece, ext[path][box]
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        scale = float(w.abs().max()) if w.numel() else 0.0
        if piece.dtype == torch.bfloat16:   # one bf16 ulp, or the floor
            excess = float((diff - BF16_ULP * torch.maximum(
                g.abs(), w.abs()) - 1e-5).max()) if w.numel() else 0.0
            ok = excess <= 0 or float(diff.max()) <= FLOOR_FACTOR * fl
        else:
            ok = float(diff.max()) <= max(1e-5 + 1e-5 * scale,
                                          FLOOR_FACTOR * fl) \
                if w.numel() else True
        out["leaves"][path] = {
            "max_abs_diff": float(diff.max()) if w.numel() else 0.0,
            "scale": scale, "floor": fl, "ok": bool(ok),
            "written_here": int(w.shape[1]) if name in ("k", "v") and
            w.numel() else None, "untouched_bit_equal": untouched_ok}
    logits2, cache2, _, ms2, gloo2 = run(False)
    out["rerun_bit_equal"] = all(
        torch.equal(local_of(a), local_of(b)) for a, b in zip(
            logits + leaves(cache), logits2 + leaves(cache2)))
    out["rerun_call_ms"], out["rerun_gloo_s"] = ms2, gloo2
    out["n_fsdp_gathers"], out["n_head_gathers"] = R.decode_gathers(
        dict(flatten_with_path(specs)), cfg)
    del params, cache, cache2, logits, logits2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_mesh_fleet(torch, dist, mesh4, shared, meta):
    """Phase 19 (b) on this rank: FleetEngine over the (4, 1) data mesh
    with phase 10b's requests (three waves and a cancel, dense; the
    compact engine's refresh and recompact mid-flight), each completion
    against the request served alone by a one-device engine of this
    rank's width (this rank takes every fourth request); captures,
    replays, collectives in and out of the step, replay and exchange
    times."""
    import _dist_ranks as R
    from repro_torch.dist import sharding as SH
    from repro_torch.models import zoo as Z
    from repro_torch.serve import EngineConfig, FleetEngine
    f = meta["fleet"]
    model = Z.build(f["cfg"])
    ecfg = EngineConfig(max_seq=f["max_seq"])
    B, world = meta["slots"], dist.get_world_size()
    rank = dist.get_rank()
    out = {}
    solo = FleetEngine(model, B // world, ecfg)
    for tag, params in (("dense", shared["fleet_params"]),
                        ("compact", shared["fleet_cm"])):
        eng = FleetEngine(model, B, ecfg, mesh=mesh4)
        if tag == "dense":
            eng.load(params)
        else:
            eng.load_compact(params)
        in_step = R._count_in_steps(eng)
        SH.reset_collective_counts()
        prompts, budgets = f[tag]["prompts"], f[tag]["budgets"]
        rids, done, cancelled = {}, [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tag == "dense":
            waves = np.array_split(np.arange(len(prompts)), f["waves"])
            for w, idx in enumerate(waves):
                for i in idx:
                    rids[eng.submit(prompts[i], budgets[i])] = int(i)
                for _ in range(f["wave_steps"]):
                    done += eng.step()
                if w == 0:
                    finished = {c.rid for c in done}
                    left = {r: len(prompts[i]) + budgets[i]
                            for r, i in rids.items() if r not in finished}
                    cancelled = max(left, key=left.get)
                    eng.cancel(cancelled)
            switches = ()
        else:
            for i, (p, n) in enumerate(zip(prompts, budgets)):
                rids[eng.submit(p, n)] = i
            switches = ((f["refresh_at"], "refresh",
                         shared["fleet_dense2"]),
                        (f["recompact_at"], "recompact",
                         shared["fleet_dense3"]))
            steps = 0
            for at, method, tree in switches:
                while steps < at:
                    done += eng.step()
                    steps += 1
                getattr(eng, method)(tree)
        done += eng.drain()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        st = eng.stats()
        got = {c.rid: c for c in done}
        mismatched = []
        for r, i in rids.items():
            if i % world != rank:
                continue
            want = _solo_tokens(solo, params, prompts[i], budgets[i],
                                switches)
            c = got[r]
            ok = (c.tokens == want[:len(c.tokens)] and c.evicted
                  if r == cancelled else
                  c.tokens == want and not c.evicted and not c.truncated)
            if not ok:
                mismatched.append(r)
        out[tag] = {
            "requests": len(rids), "completions": len(got),
            "tokens": {str(r): got[r].tokens for r in sorted(got)},
            "mismatched": mismatched, "cancelled": cancelled,
            "n_traces": eng.n_traces, "n_replays": eng.n_replays,
            "steps": st["steps"], "in_step_collectives": sum(in_step),
            "in_step_calls": len(in_step),
            "engine_out_gather": SH.collective_counts().get(
                "engine_out_gather", 0),
            "exchange_ms_per_step": st["exchange_s"] * 1e3 / st["steps"],
            "serve_s": serve_s, "wall_ms_per_step": serve_s * 1e3
            / st["steps"], "replay_ms": _replay_ms(torch, eng),
            "solo_replay_ms": _replay_ms(torch, solo),
            "solo_n_traces": solo.n_traces}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del solo
    return out


def _serve_mesh_sae(torch, mesh4, shared):
    """Phase 19 (c) on this rank: the compact SAE's serve step over 4
    ranks against the one-device step (this rank's rows)."""
    import _dist_ranks as R
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.layout import MeshLayout, local_of
    from repro_torch.sae import compact_sae, make_serve_step
    compact = compact_sae(shared["sae_params"], (shared["sae_spec"],))
    step = make_serve_step(compact, mesh=mesh4)
    SH.reset_collective_counts()
    with R._count_all() as calls:
        z, xh = step(compact.params, shared["sae_x"])
    torch.cuda.synchronize()
    errs, lay = [], MeshLayout(mesh4)
    for got, want in ((z, shared["sae_z"]), (xh, shared["sae_xh"])):
        errs.append(float((local_of(got) - want[_box_of(got, lay)]).abs()
                          .max()))
    return {"rows": int(local_of(z).shape[0]), "max_abs_diff": max(errs),
            "collectives": calls.n, "counts": SH.collective_counts(),
            "selected": compact.n_selected,
            "wall_ms": wall_ms(torch, lambda: step(compact.params,
                                                   shared["sae_x"]), 20)}


def _serve_rank(rank, world, work, shape, shared, meta):
    """One rank of phase 19 (a spawned process): (a) the decode cases on
    the (2, 2) mesh, (b) the fleet engine and (c) the SAE serve step on
    the (4, 1) data mesh."""
    torch, dist, mesh = _rank_setup(rank, world, work, shape)
    from repro_torch.dist.layout import MeshLayout
    from repro_torch.launch.mesh import make_local_mesh
    lay = MeshLayout(mesh)
    t0 = time.perf_counter()
    decode = [_serve_mesh_decode(torch, dist, mesh, lay, sh, case)
              for sh, case in zip(shared["decode"], meta["decode"])]
    t1 = time.perf_counter()
    mesh4 = make_local_mesh(*meta["fleet_mesh"], device="cuda")
    fleet = _serve_mesh_fleet(torch, dist, mesh4, shared, meta)
    t2 = time.perf_counter()
    sae = _serve_mesh_sae(torch, mesh4, shared)
    out = {"rank": dist.get_rank(), "decode": decode, "fleet": fleet,
           "sae": sae, "seconds": {"decode": t1 - t0, "fleet": t2 - t1,
                                   "sae": time.perf_counter() - t2}}
    _rank_done(dist, work, rank, out, shared)


def lm_serve_mesh_phase(torch, Z, C, K, dev, card, sae, sm=SERVE_MESH):
    """Phase 19 (lm_serve_mesh): serving over a mesh, 4 gloo ranks sharing
    the card (``_serve_rank``), the parent's tensors reaching them by CUDA
    IPC. (a) each decode case's one-device step and its noise floor (the
    same calls from params x (1 + PERTURB N(0, 1))) run here first;
    (b) phase 10b's requests and compacted model; (c) the compact SAE's
    one-device outputs (``sae``: phase 5's l1,inf params, its spec, the
    test rows). No hand-written kernel runs in this phase: the decode
    path is plain PyTorch in both packages."""
    from repro_torch._tree import flatten_with_path, tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.sae import compact_sae, make_serve_step
    from repro_torch.serve import compact_model
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    shared, meta = {"decode": []}, {"decode": [], "slots": sm["slots"],
                                    "fleet_mesh": sm["fleet_mesh"]}
    params_of, one_rows = {}, []
    for n, (arch, cell, B, S, vec, scalar) in enumerate(sm["cases"]):
        cfg = dataclasses.replace(C.get_config(arch), n_layers=sm["depth"])
        model = Z.build(cfg)
        if arch not in params_of:
            params_of[arch] = model.init(torch.Generator(
                device=dev).manual_seed(19), device=dev)
        params = params_of[arch]
        cache0 = _seeded_cache(torch, model, B, S, vec, dev, 190 + n)
        g = torch.Generator(device=dev).manual_seed(290 + n)
        calls = [(torch.randint(0, cfg.vocab, (B, 1), generator=g,
                                device=dev), torch.tensor(vec, device=dev)),
                 (torch.randint(0, cfg.vocab, (B, 1), generator=g,
                                device=dev), scalar)]
        logits, ext, pairs, one_ms = _one_device_decode(
            torch, model, params, cache0, calls, cfg.vocab, reps=5)
        gp = torch.Generator(device=dev).manual_seed(390 + n)
        pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
            a.shape, generator=gp, device=dev)), params)
        plog, pext, _, _ = _one_device_decode(torch, model, pert, cache0,
                                              calls, cfg.vocab)
        del pert
        floors = {"logits": [float((a - b).abs().max())
                             for a, b in zip(plog, logits)],
                  "cache": {p: float((pext[p].float() - ext[p].float())
                                     .abs().max()) for p in ext}}
        del plog, pext
        torch.cuda.empty_cache()
        shared["decode"].append({"params": params, "cache": cache0,
                                 "calls": calls, "one": logits,
                                 "ext": ext})
        meta["decode"].append({"cfg": cfg, "cell": cell, "pairs": pairs,
                               "floors": floors})
        one_rows.append({"arch": arch, "cell": cell, "batch": B, "seq": S,
                         "first_positions": vec, "second_position": scalar,
                         "one_device_decode_ms": one_ms,
                         "cache_bytes": sum(
                             t.numel() * t.element_size()
                             for _, t in flatten_with_path(cache0)),
                         "noise_floor": floors})
    # (b) phase 10b's requests and its compacted model, refreshed and
    # recompacted at its steps
    f = FLEET
    fcfg = dataclasses.replace(C.get_config(f["arch"]), n_layers=sm["depth"])
    rng = np.random.default_rng(11)
    dp, db = _fleet_requests(rng, f["requests"], fcfg.vocab, f["prompt"],
                             f["budget"])
    cp, cb = _fleet_requests(rng, sm["slots"], fcfg.vocab,
                             f["compact_prompt"], f["compact_budget"])
    _, raw = lm_compact_params(torch, Z, C, dev, depth=fcfg.n_layers)
    dense, _ = ProjectionEngine(fcfg.projection_specs,
                                solver="kernel").apply(raw)
    del raw
    cm = compact_model(dense, fcfg.projection_specs)
    w1 = next(p for p in cm.live if p.endswith("mlp/w1"))
    dense2 = tree_map(lambda a: a * 1.25, dense)
    dense3 = tree_map(torch.clone, dense2)
    for block in dense3["blocks"].values():
        block["mlp"]["w1"][..., int(cm.sels[w1][0])] = 0.0
    del dense
    shared.update(fleet_params=params_of[f["arch"]], fleet_cm=cm,
                  fleet_dense2=dense2, fleet_dense3=dense3)
    meta["fleet"] = {"cfg": fcfg, "max_seq": f["max_seq"],
                     "waves": f["waves"], "wave_steps": f["wave_steps"],
                     "refresh_at": f["refresh_at"],
                     "recompact_at": f["recompact_at"],
                     "dense": {"prompts": dp, "budgets": db},
                     "compact": {"prompts": cp, "budgets": cb}}
    # (c) the compact SAE on one device
    sae_params, spec, X = sae
    x = torch.from_numpy(X).to(dev)
    compact = compact_sae(sae_params, (spec,))
    z, xh = make_serve_step(compact)(compact.params, x)
    shared.update(sae_params=sae_params, sae_spec=spec, sae_x=x, sae_z=z,
                  sae_xh=xh)
    sae_scale = max(float(z.abs().max()), float(xh.abs().max()), 1.0)
    torch.cuda.synchronize()
    parent_bytes = torch.cuda.memory_allocated()
    ranks, failed, wall = _spawn(_serve_rank, 4, (sm["mesh"], shared, meta),
                                 sm["timeout"])
    check(failed is None and len(ranks) == 4,
          f"lm_serve_mesh: {failed or 'missing rank results'}")
    for r in ranks:
        tag = f"lm_serve_mesh rank {r['rank']}"
        for j, (case, row, d) in enumerate(zip(meta["decode"], one_rows,
                                               r["decode"])):
            what = f"{tag} {row['arch']} {row['cell']}"
            cfg = case["cfg"]
            for i, lg in enumerate(d["logits"]):
                check(lg["max_abs_diff"] <= lg["limit"],
                      f"{what}: call {i} logits {lg}")
            for path, lf in d["leaves"].items():
                check(lf["ok"] and lf["untouched_bit_equal"],
                      f"{what}: cache {path} {lf}")
            check(d["rerun_bit_equal"], f"{what}: a rerun is not bit-equal")
            n_attn = cfg.n_layers if set(cfg.pattern) & {
                "global", "local", "hybrid"} else 0
            n_ssm = cfg.n_layers if set(cfg.pattern) & {"ssm",
                                                          "hybrid"} else 0
            for c in d["counts"]:
                check(c.get("decode_max") == c.get("decode_sum") == n_attn
                      and c.get("fsdp_gather") == d["n_fsdp_gathers"]
                      and c.get("decode_head_gather", 0)
                      == d["n_head_gathers"]
                      and c.get("ssm_conv_gather", 0) == c.get(
                          "ssm_norm", 0) == n_ssm
                      and c.get("tp_exit_sum", 0) > 0
                      and c["all_gather_calls"] == c["fsdp_gather"]
                      + c.get("ssm_conv_gather", 0)
                      + c.get("decode_head_gather", 0)
                      and c["all_to_all_calls"] == 0
                      and c["lm_kernel_launches"] == 0,
                      f"{what}: collectives {c}")
            check(d["counts"] == ranks[0]["decode"][j]["counts"],
                  f"{what}: counts differ from rank 0's")
        for tag_f in ("dense", "compact"):
            fl = r["fleet"][tag_f]
            what = f"{tag} fleet {tag_f}"
            check(fl["completions"] == fl["requests"] and not fl[
                "mismatched"], f"{what}: continuous != solo for "
                f"{fl['mismatched']}")
            check(fl["n_traces"] == 1 and fl["n_replays"] == fl["steps"],
                  f"{what}: captures {fl['n_traces']}, replays "
                  f"{fl['n_replays']} of {fl['steps']} steps")
            check(fl["in_step_collectives"] == 0
                  and fl["engine_out_gather"] == fl["steps"],
                  f"{what}: {fl['in_step_collectives']} collectives in "
                  f"the step, {fl['engine_out_gather']} gathers for "
                  f"{fl['steps']} steps")
            check(fl["tokens"] == ranks[0]["fleet"][tag_f]["tokens"],
                  f"{what}: completions differ from rank 0's")
        s = r["sae"]
        check(s["rows"] == X.shape[0] // 4 and s["collectives"] == 0
              and s["max_abs_diff"] <= SERVE_TOL["float32"] * sae_scale,
              f"{tag} sae: {s}")
    emit({"phase": "lm_serve_mesh", "card": card, "depth": sm["depth"],
          "mesh": list(sm["mesh"]), "fleet_mesh": list(sm["fleet_mesh"]),
          "times": "gloo through host memory, 4 ranks sharing one card",
          "run_s": wall, "parent_allocated_bytes": parent_bytes,
          "params": "float32", "cache": "bfloat16",
          "kernels": "none (decode attention is plain PyTorch in both "
                     "packages)",
          "decode_one_device": one_rows,
          "per_rank": [{"rank": r["rank"], "seconds": r["seconds"],
                        "decode": [{k: d[k] for k in (
                            "arch", "cell", "call_ms", "rerun_call_ms",
                            "gloo_s", "rerun_gloo_s", "cache_bytes",
                            "peak_bytes", "counts", "logits",
                            "rerun_bit_equal")} | {"worst_leaf": max(
                                d["leaves"].items(), key=lambda kv:
                                kv[1]["max_abs_diff"] / max(
                                    kv[1]["scale"], 1e-30))}
                            for d in r["decode"]],
                        "fleet": {k: {kk: v for kk, v in fl.items()
                                      if kk != "tokens"}
                                  for k, fl in r["fleet"].items()},
                        "sae": r["sae"]} for r in ranks]})
    del shared, params_of, cm, dense2, dense3, z, xh, x
    gc.collect()
    torch.cuda.empty_cache()


def _dryrun_part(rank, world, work, dr):
    """Phase 20's work, in a process of its own (its fake and gloo groups
    meet no other phase's): (a) the dry-run's counts of DRYRUN's cell and
    the same step's on the card, (b) the production cells' records."""
    import torch
    import torch.distributed as dist
    from math import lcm
    from torch.utils.flop_counter import FlopCounterMode
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import configs as C
    from repro_torch.convert import params_to_mesh
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.fused_step import kernel as FK
    from repro_torch.kernels.l1inf import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (build_train_step, lower_cell,
                                          param_shardings,
                                          projection_engine_for,
                                          rules_for_cell, shard_opt_state)
    from repro_torch.models import zoo as Z
    from repro_torch.optim import AdamConfig
    from repro_torch.roofline.analysis import HBM_BYTES, PEAK_FLOPS
    cfg = dataclasses.replace(C.get_config(dr["arch"]), n_layers=dr["depth"])
    model = Z.build(cfg)
    Z.SHAPES["dryrun_phase"] = dict(seq=dr["seq"], batch=dr["batch"],
                                    kind="train")
    out = {}
    # (a) the dry-run's trace on meta tensors, one fake rank
    t0 = time.perf_counter()
    with dryrun.fake_group(1):
        cell = lower_cell(model, "dryrun_phase",
                          make_local_mesh(1, 1, device="cpu"), False)
    counts = cell.counts
    out["trace_s"] = time.perf_counter() - t0
    # the same step on the card, over a one-rank gloo group
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method="file://" + os.path.join(work, "rdv"))
    mesh = make_local_mesh(1, 1, device="cuda")
    rules = rules_for_cell(cfg, "dryrun_phase", False)
    acfg = AdamConfig(moment_dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.bfloat16, device="cuda")
    params = params_to_mesh(params, mesh, param_shardings(model, mesh, rules),
                            device="cuda")
    opt = shard_opt_state(params, acfg)
    proj = projection_engine_for(cfg, mesh).init_state(params)
    step = build_train_step(model, mesh, rules, acfg)
    batch = Z.make_batch(cfg, dr["batch"], dr["seq"], device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    k = lcm(*(spec.every_k for spec in cfg.projection_specs))
    # the step's state lives in ``state`` alone: a name left holding the
    # first params and moments would keep them on the card
    state = [params, opt, proj]
    del params, opt, proj

    def fire(i):
        # the i-th step at a count every every_k divides: every gate fires
        state[1].count.fill_(k * i - 1)
        state[:] = step(*state, batch)[2:]

    fire(1)                                   # warm-up
    torch.cuda.synchronize()
    gc.collect()
    for mod in (FA, SK, K, FK):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    e0.record()
    fire(2)                                   # the measured step
    e1.record()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t) * 1e3
    out["event_ms"] = e0.elapsed_time(e1)
    out["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["card_launches"] = {n: c for mod in (FA, SK, K, FK)
                            for n, c in mod.launch_counts().items() if c}
    with FlopCounterMode(display=False) as fc:
        fire(3)
    out["card_dot_flops"] = fc.get_total_flops()
    out["profile"] = _profile(torch, lambda: fire(4))
    dist.destroy_process_group()
    out.update(
        dry_launches=counts.launches(), dry_dot_flops=counts.dot_flops,
        dry_kernel_operations=counts.kernel_operations,
        dry_peak_bytes=counts.peak_bytes,
        dry_argument_bytes=counts.argument_bytes,
        dry_pieces_bytes=cell.pieces_bytes,
        dry_bytes=counts.bytes_proxy + counts.kernel_bytes,
        collectives=len(counts.collectives), every_k=k, peak=PEAK_FLOPS)
    # (b) the production cells, 256 fake ranks each
    out["cells"] = []
    for arch, shape in dr["cells"]:
        t0 = time.perf_counter()
        try:
            rec = dryrun.run_cell(arch, shape, "pod")
        except Exception as e:          # recorded; the parent fails it
            rec = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
        mem = rec.get("memory_analysis", {})
        out["cells"].append({
            "arch": arch, "shape": shape, "mesh": "pod",
            "seconds": time.perf_counter() - t0,
            "bytes_per_device": mem.get("total_bytes_per_device"),
            "argument_bytes": mem.get("argument_size_in_bytes"),
            "argument_pieces_bytes": mem.get("argument_pieces_bytes"),
            "fits_80gb": mem.get("fits_80gb"), "hbm_bytes": HBM_BYTES,
            **{key: rec.get(key) for key in (
                "status", "error", "dominant", "roofline_fraction",
                "compute_s", "memory_s", "collective_s", "flops_per_device",
                "collective_counts", "trace_s")}})
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(_jsonable(out), f)


def dryrun_phase(torch, smi, dr=DRYRUN):
    """Phase 20: launch/dryrun.py against the card (DRYRUN; the work runs
    in ``_dryrun_part``'s process): the dry-run's kernel launches by name
    equal to the card step's (the wrappers' own counts), its aten dot
    FLOPs equal to ``FlopCounterMode``'s over the card's step, its peak of
    live bytes within ``peak_tol`` of ``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats``; the step's wall ms (host clock,
    synchronised), its device busy ms (one traced step), and the counted
    FLOPs' share of the bf16 peak at each; then the production cells,
    each "ok", with the dominant term, ``roofline_fraction`` and bytes a
    device against 80 GB; in each trace the arguments' bytes (their
    storages) equal to the sum of their pieces' own bytes."""
    ranks, failed, sec = _spawn(_dryrun_part, 1, (dr,), timeout=300)
    check(failed is None and len(ranks) == 1, f"dryrun: {failed}")
    if not ranks:
        return
    r = ranks[0]
    check(r["dry_launches"] == r["card_launches"],
          f"dryrun launches {r['dry_launches']} vs the card's "
          f"{r['card_launches']}")
    check(r["dry_dot_flops"] == r["card_dot_flops"],
          f"dryrun dot FLOPs {r['dry_dot_flops']} vs the card's "
          f"{r['card_dot_flops']}")
    check(r["dry_argument_bytes"] == r["dry_pieces_bytes"],
          f"dryrun argument bytes {r['dry_argument_bytes']} vs the sum of "
          f"the pieces {r['dry_pieces_bytes']}")
    ratio = r["dry_peak_bytes"] / r["card_peak_bytes"]
    check(abs(ratio - 1) <= dr["peak_tol"],
          f"dryrun peak {r['dry_peak_bytes']} vs the card's "
          f"{r['card_peak_bytes']} ({ratio:.3f})")
    flops = r["dry_dot_flops"] + r["dry_kernel_operations"]
    device_ms = r["profile"]["device_ms"]
    share = lambda ms: flops / (ms * 1e-3 * r["peak"])
    emit({"phase": "dryrun", "arch": dr["arch"], "depth": dr["depth"],
          "seq": dr["seq"], "batch": dr["batch"], "card": smi,
          "every_k_count": r["every_k"], "trace_s": r["trace_s"],
          "launches": r["card_launches"], "dry_launches": r["dry_launches"],
          "dot_flops": r["dry_dot_flops"],
          "card_dot_flops": r["card_dot_flops"],
          "kernel_operations": r["dry_kernel_operations"],
          "counted_flops": flops, "dry_bytes": r["dry_bytes"],
          "peak_bytes_dry": r["dry_peak_bytes"],
          "peak_bytes_card": r["card_peak_bytes"], "peak_ratio": ratio,
          "argument_bytes": r["dry_argument_bytes"],
          "argument_pieces_bytes": r["dry_pieces_bytes"],
          "step_wall_ms": r["wall_ms"], "step_event_ms": r["event_ms"],
          "step_device_ms": device_ms,
          "device_idle_share": r["profile"]["device_idle_share"],
          "flops_share_of_peak_at_wall": share(r["wall_ms"]),
          "flops_share_of_peak_at_device": share(device_ms),
          "collectives": r["collectives"], "seconds": sec})
    for c in r["cells"]:
        check(c["status"] == "ok", f"dryrun {c['arch']} {c['shape']}: "
              f"{c['status']} {c.get('error')}")
        check(c["argument_bytes"] == c["argument_pieces_bytes"],
              f"dryrun {c['arch']} {c['shape']}: argument bytes "
              f"{c['argument_bytes']} vs the sum of the pieces "
              f"{c['argument_pieces_bytes']}")
        emit({"phase": "dryrun_cells", "card": smi, **c})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import _build
    from repro_torch.core import (ProjectionEngine, ProjectionSpec,
                                  project_l1inf_newton, sparsity_report)
    from repro_torch.core.hoyer import project_hoyer_ref
    from repro_torch.core.heap import project_l1inf_heap
    from repro_torch.core.l1inf import project_l1inf_sorted
    from repro_torch.core.norms import project_l12_ball
    from repro_torch.core.simplex import project_l1_ball
    from repro_torch.core.weighted import project_l1inf_weighted
    from repro_torch.kernels.l1inf import kernel as K
    from repro_torch.kernels.fused_step import kernel as FK
    from repro_torch.kernels.l1inf import ops as O
    from repro_torch.kernels.l1inf import ref
    from repro_torch.kernels.l1inf.ops import project_l1inf_kernel
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.roofline.analysis import kernel_bound_ms
    from repro_torch.sae import (SAEConfig, SAETrainConfig,
                                 make_classification, projected_step,
                                 sae_init, train_sae, train_test_split)
    from repro_torch._tree import flatten_with_path, leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    # -- 1. build --------------------------------------------------------
    # the port's sources, and beside them the empty Newton loop (phase 2's
    # floor), every nvcc started at once
    sys.path.insert(0, os.path.join(root, "scripts"))
    import torch_kernel_variants as KV
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        empty_build = pool.submit(KV.build, ["newton_loop_empty"],
                                  _build._nvcc(), _build.NVCC_FLAGS)
        libs = _build.build()
        empty_lib = ctypes.CDLL(empty_build.result()["newton_loop_empty"])
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = str(path) + ".log"
        if os.path.exists(log):
            ptxas += [l.strip() for l in open(log) if "Used" in l
                      or "spill" in l]
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": build_s,
          "libraries": sorted(libs), "ptxas": ptxas})

    # -- 2. each kernel against its plain version --------------------------
    rng = np.random.default_rng(0)
    cfg = SAEConfig(n_features=10000, n_hidden=96, n_classes=2)
    params0 = sae_init(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    enc1 = torch.zeros(SHAPES["sae_enc1"], device=dev)
    enc1[:, :cfg.n_features] = params0["enc1"]["w"].T
    inputs = {"sae_enc1": enc1}
    for name in ("fig2_wide", "fig2_tall"):
        n, m_pad = SHAPES[name]
        m = 10000 if name == "fig2_wide" else 1000
        Y = np.zeros((n, m_pad), np.float32)
        Y[:, :m] = rng.uniform(0, 1, size=(n, m))
        inputs[name] = torch.from_numpy(Y).to(dev)

    # the projections of phase 3 and the loop check: (real columns, radius)
    proj = {"sae_enc1": (cfg.n_features, 0.2), "fig2_wide": (10000, 1.0),
            "fig2_tall": (1000, 1.0)}
    bm = 128
    errs = {k: 0.0 for k in REPLACES}
    timing = {}
    loops = {}                          # shape -> newton_loop check and times
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    flush = lambda: flush_buf.fill_(1.0)          # 256 MB through L2
    flushed = {}                        # shape -> kernel times, L2 flushed
    for name, Y in inputs.items():
        n, m = Y.shape
        A = Y.abs()
        s1, m1 = K.colstats(A)
        s2, m2 = K.colstats_plain(A)
        rel = float(((s1 - s2).abs() / s2.clamp(min=1e-30)).max())
        check(rel <= 1e-5, f"colstats sum {name}: rel err {rel}")
        check(torch.equal(m1, m2), f"colstats max {name}: not exact")
        errs["colstats"] = max(errs["colstats"],
                               float((s1 - s2).abs().max()))

        u = torch.from_numpy(rng.uniform(0.05, 1.2, size=m).astype(
            np.float32)).to(dev)
        theta = (s2 * u).contiguous()
        nact = torch.tensor([(m // bm) * 2 // 3], dtype=torch.int32,
                            device=dev)
        r1 = K.mu_solve(A, theta, block_m=bm, nact_blocks=nact)
        r2 = K.mu_solve_plain(A, theta, block_m=bm, nact=nact)
        check(torch.equal(r1[3], r2[3]), f"mu_solve active set {name}")
        dmu = (r1[0] - r2[0]).abs()
        check(bool((dmu <= 1e-5 * m2).all()),
              f"mu_solve mu {name}: max err {float(dmu.max())}")
        errs["mu_solve"] = max(errs["mu_solve"], float(dmu.max()))

        mu = torch.from_numpy(rng.uniform(0, 1, size=m).astype(
            np.float32)).to(dev) * m2
        for dt in (torch.float32, torch.bfloat16):
            Yd = Y.to(dt)
            x1, x2 = K.clip_apply(Yd, mu), K.clip_apply_plain(Yd, mu)
            check(bits_equal(torch, x1, x2), f"clip_apply {name} {dt}")
            errs["clip_apply"] = max(errs["clip_apply"], float(
                (x1.float() - x2.float()).abs().max()))

        P = min(int(nact) * bm, m)
        mu_lo = mu[None, :]
        t = {
            "colstats": (time_ms(torch, lambda: K.colstats(A)),
                         time_ms(torch, lambda: K.colstats_plain(A)), None)
            + kernel_bound_ms(K.colstats_cost(n, m)),
            "mu_solve": (time_ms(torch, lambda: K.mu_solve(
                A, theta, block_m=bm, nact_blocks=nact)),
                time_ms(torch, lambda: K.mu_solve_plain(
                    A, theta, block_m=bm, nact=nact)), None)
            + kernel_bound_ms(K.mu_solve_cost(n, m, P)),
            "clip_apply": (time_ms(torch, lambda: K.clip_apply(Y, mu)),
                           time_ms(torch, lambda: K.clip_apply_plain(Y, mu)),
                           time_ms(torch, lambda: torch.clamp(
                               Y, -mu_lo, mu_lo)))
            + kernel_bound_ms(K.clip_apply_cost(n, m)),
        }
        timing[name] = t
        flushed[name] = cold = {}
        if name == "sae_enc1":
            cold.update({
                "colstats": time_cold_ms(torch, lambda: K.colstats(A),
                                         flush),
                "mu_solve": time_cold_ms(torch, lambda: K.mu_solve(
                    A, theta, block_m=bm, nact_blocks=nact), flush),
                "clip_apply": time_cold_ms(
                    torch, lambda: K.clip_apply(Y, mu), flush)})
        ncols, C = proj[name]
        loops[name] = lp = loop_phase(torch, K, O,
                                      Y[:, :ncols].contiguous(), C, flush,
                                      empty_lib)
        emit({"phase": "kernels", "shape": name, "n": n, "m": m,
              "mu_solve_prefix_cols": P,
              "colstats_sum_rel_err": rel,
              "mu_solve_max_abs_err": float(dmu.max()),
              "ms": {k: {"kernel": v[0], "kernel_l2_flushed": cold.get(k),
                         "plain": v[1], "library": v[2],
                         "bound": v[3], "bound_by": v[4]}
                     for k, v in t.items()},
              "newton_loop": lp})

    # -- 2b. the fused step's kernels against their plain versions ----------
    f32, bf16 = torch.float32, torch.bfloat16
    # (param dtype, moment dtype, mask, stat, mode, weight decay)
    variants = [(f32, f32, False, "abs", "clip", 0.0),
                (f32, f32, True, "sq", "scale", 0.01),
                (bf16, f32, True, "abs", "clip", 0.01),
                (bf16, f32, False, "sq", "scale", 0.0),
                (f32, bf16, True, "abs", "clip", 0.0)]
    ferrs = {k: 0.0 for k in FUSED_REPLACES}
    ftiming = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, (shape, transpose) in FUSED_SHAPES.items():
        L, R, C = shape
        g0, m0, p0 = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(3))
        v0 = torch.rand(shape, generator=gen, device=dev) * 1e-2
        mk0 = (torch.rand(shape, generator=gen, device=dev) > 0.3).float()
        sc = torch.tensor([0.9, 1e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                          dtype=f32, device=dev)
        red = 2 if transpose else 1
        worst = {"colsum_rel_err": 0.0}
        for pdt, mdt, use_mask, stat, mode, wd in variants:
            what = f"{name} {pdt} moments {mdt} mask={use_mask} {stat}/{mode}"
            g, p = g0.to(pdt), p0.to(pdt)
            m, v = (m0 * 0.1).to(mdt), v0.to(mdt)
            mk = mk0.to(pdt) if use_mask else None
            kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=wd,
                      transpose=transpose)
            a = FK.adam_colstats(sc, g, m, v, p, mk, stat=stat, **kw)
            b = FK.adam_colstats_plain(sc, g, m, v, p, mk, stat=stat, **kw)
            check(bits_equal(torch, a[0], b[0]) and
                  bits_equal(torch, a[1], b[1]), f"adam_colstats moments "
                  f"{what}: not bit-equal to the plain version")
            check(torch.equal(a[3], b[3]), f"adam_colstats colmax {what}")
            rel = float(((a[2] - b[2]).abs() / b[2].clamp(min=1e-30)).max())
            check(rel <= 1e-6, f"adam_colstats colsum {what}: rel {rel}")
            worst["colsum_rel_err"] = max(worst["colsum_rel_err"], rel)
            ferrs["adam_colstats"] = max(ferrs["adam_colstats"], float(
                (a[2] - b[2]).abs().max()))
            mu = (a[3] * 0.5 if mode == "clip"
                  else torch.full_like(a[3], 0.7)).contiguous()
            x1 = FK.adam_clip_apply(sc, a[0], a[1], p, mu, mk, mode=mode,
                                    **kw)
            x2 = FK.adam_clip_apply_plain(sc, a[0], a[1], p, mu, mk,
                                          mode=mode, **kw)
            check(bits_equal(torch, x1, x2), f"adam_clip_apply {what}")
            ferrs["adam_clip_apply"] = max(ferrs["adam_clip_apply"], float(
                (x1.float() - x2.float()).abs().max()))
            if mk is None:
                ident = FK.adam_clip_apply(sc, a[0], a[1], p,
                                           torch.full_like(mu, 1e30), **kw)
                check(torch.equal(ident.float().abs().amax(dim=red), a[3]),
                      f"recompute invariant {what}")
            a2 = FK.adam_colstats(sc, g, m, v, p, mk, stat=stat, **kw)
            x3 = FK.adam_clip_apply(sc, a2[0], a2[1], p, mu, mk, mode=mode,
                                    **kw)
            check(all(bits_equal(torch, u, w) for u, w in zip(a, a2))
                  and bits_equal(torch, x1, x3), f"rerun {what}")

        # times on the main path's configuration: f32, a mask, sum u^2 /
        # scale (the l12 family; the abs/clip pair moves the same bytes)
        g, m, v, p, mk = g0, m0 * 0.1, v0, p0, mk0
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0, transpose=transpose)
        a = FK.adam_colstats(sc, g, m, v, p, mk, stat="sq", **kw)
        mu = torch.full_like(a[3], 0.7)
        p1 = lambda: FK.adam_colstats(sc, g, m, v, p, mk, stat="sq", **kw)
        p2 = lambda: FK.adam_clip_apply(sc, a[0], a[1], p, mu, mk,
                                        mode="scale", **kw)
        t = {"adam_colstats": (
            time_ms(torch, p1), time_cold_ms(torch, p1, flush),
            time_ms(torch, lambda: FK.adam_colstats_plain(
                sc, g, m, v, p, mk, stat="sq", **kw)),
            kernel_bound_ms(FK.adam_colstats_cost(L, R, C, transpose,
                                                  mask=True))),
            "adam_clip_apply": (
            time_ms(torch, p2), time_cold_ms(torch, p2, flush),
            time_ms(torch, lambda: FK.adam_clip_apply_plain(
                sc, a[0], a[1], p, mu, mk, mode="scale", **kw)),
            kernel_bound_ms(FK.adam_clip_apply_cost(L, R, C, transpose,
                                                    mask=True)))}
        ftiming[name] = t
        emit({"phase": "fused", "shape": name, "stack": list(shape),
              "transpose": transpose, "variants": len(variants), **worst,
              "ms": {k: {"kernel_l2_warm": v[0], "kernel_l2_flushed": v[1],
                         "plain": v[2], "library": None, "bound": v[3][0],
                         "bound_by": v[3][1]} for k, v in t.items()}})

    # -- 3. the projection at those shapes -----------------------------------
    def reruns_equal(fn, reps=3):
        first = fn()
        return all(bits_equal(torch, first, fn()) for _ in range(reps))

    for name, (ncols, C) in proj.items():
        Y = inputs[name][:, :ncols].contiguous()
        K.reset_launch_counts()
        X1, st = project_l1inf_kernel(Y, C, return_stats=True)
        per_projection = K.launch_counts()
        check(per_projection == {"colstats": 1, "mu_solve": 1,
                                 "clip_apply": 1, "newton_loop": 1},
              f"project {name}: launches {per_projection}")
        check(bits_equal(torch, X1, project_l1inf_kernel(Y, C)),
              f"project {name}: kernel engine not the same on a rerun")
        X2 = project_l1inf_newton(Y, C)
        scale = max(float(Y.abs().max()), 1.0)
        err = float((X1 - X2).abs().max())
        ok = torch.allclose(X1, X2, atol=3e-4 * scale, rtol=3e-3)
        check(ok, f"project {name}: kernel vs newton max err {err}")
        # fault C-7: the sort-based paths' scans, rerun on the card
        rerun = {"newton": reruns_equal(lambda: project_l1inf_newton(Y, C)),
                 "sorted": reruns_equal(lambda: project_l1inf_sorted(Y, C))}
        for path, same in rerun.items():
            check(same, f"project {name}: {path} not the same on a rerun")
        colsp = float(((X1 == 0).all(dim=0)).float().mean() * 100)
        walls = {"kernel_wall_ms": wall_ms(
                     torch, lambda: project_l1inf_kernel(Y, C)),
                 "newton_wall_ms": wall_ms(
                     torch, lambda: project_l1inf_newton(Y, C))}
        check(walls["kernel_wall_ms"] < walls["newton_wall_ms"],
              f"project {name}: kernel engine {walls} slower than newton")
        emit({"phase": "project", "shape": name, "n": Y.shape[0],
              "m": Y.shape[1], "C": C, "max_abs_err": err,
              "newton_iters": int(st["newton_iters"]),
              "work_cols": int(st["work_cols"]),
              "full_cols": st["full_cols"], "colsp_pct": colsp,
              "launches": per_projection, "reruns_bit_equal": rerun,
              **walls})
    Yw = inputs["fig2_wide"][:, :10000].contiguous()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=10000).astype(
        np.float32)).to(dev)
    rerun = {"weighted": reruns_equal(lambda: project_l1inf_weighted(
                 Yw, w, 1.0)),
             "hoyer_ref": reruns_equal(lambda: project_hoyer_ref(Yw, 0.9)),
             "l1_ball": reruns_equal(lambda: project_l1_ball(Yw, 100.0)),
             "l12_ball": reruns_equal(lambda: project_l12_ball(Yw, 10.0))}
    for path, same in rerun.items():
        check(same, f"project fig2_wide: {path} not the same on a rerun")
    emit({"phase": "project", "shape": "fig2_wide", "check": "reruns",
          "reruns_bit_equal": rerun})
    # fault C-10: each solver against the paper's Algorithm 2 (the heap
    # walk, float64 on the host) at paper Fig. 2's shapes, on the numpy
    # U(0, 1) draw above and on torch's own draw
    solvers = {"sorted": project_l1inf_sorted,
               "kernel": project_l1inf_kernel,
               "newton": project_l1inf_newton}
    for name in ("fig2_wide", "fig2_tall"):
        ncols, C = proj[name]
        n = SHAPES[name][0]
        draws = {"numpy": inputs[name][:, :ncols].contiguous(),
                 "torch_rand": torch.rand(
                     (n, ncols), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))}
        for draw, Y in draws.items():
            t = time.perf_counter()
            Xh = project_l1inf_heap(Y.cpu().double().numpy(), C)
            heap_s = time.perf_counter() - t
            want = torch.from_numpy(Xh).float().to(dev)
            scale = max(float(Y.abs().max()), 1.0)
            dist = {}
            for sname, fn in solvers.items():
                got = fn(Y, C)
                dist[sname] = float((got - want).abs().max())
                check(torch.allclose(got, want, atol=3e-4 * scale,
                                     rtol=3e-3),
                      f"project {name} ({draw}): {sname} vs heap oracle max "
                      f"err {dist[sname]}")
            emit({"phase": "project", "shape": name, "draw": draw,
                  "check": "vs_heap_oracle", "C": C,
                  "live_cols": int((want != 0).any(dim=0).sum()),
                  "max_abs_err_vs_heap": dist, "heap_s": heap_s})
    Ys = torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32)).to(
        dev)
    Cs = float(0.2 * Ys.abs().amax(dim=0).sum())
    err = float((project_l1inf_newton(Ys, Cs)
                 - ref.project_l1inf_ref(Ys, Cs)).abs().max())
    check(err <= 3e-4 * max(float(Ys.abs().max()), 1.0),
          f"newton vs sort oracle (64 x 300): {err}")
    emit({"phase": "project", "shape": "small_vs_oracle", "n": 64, "m": 300,
          "max_abs_err": err})

    # -- 4. the main path: projected SAE steps through the kernels -----------
    X, y, _ = make_classification(n_samples=1000, n_features=10000,
                                  n_informative=64, seed=0)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.2, seed=0)
    Xd = torch.from_numpy(Xtr).to(dev)
    yd = torch.from_numpy(ytr).to(dev)
    spec = ProjectionSpec(pattern=r"enc1/w", norm="l1inf",
                          radius=RADIUS["l1inf"], axis=1)
    acfg = AdamConfig(lr=1e-3)
    order = np.concatenate([np.random.default_rng(0).permutation(len(Xtr))
                            for _ in range(4)])
    batches = [torch.from_numpy(order[i * 128:(i + 1) * 128]).to(dev)
               for i in range(20)]
    ones = tree_map(torch.ones_like, params0)

    def run(solver, spec=spec):
        engine = ProjectionEngine((spec,), solver=solver)
        params, opt = params0, adam_init(params0, acfg)
        state = engine.init_state(params0)
        times, losses = [], []
        for idx in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, state, loss, _ = projected_step(
                params, opt, state, Xd[idx], yd[idx], ones, cfg=cfg,
                acfg=acfg, engine=engine)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
        return params, times, losses

    K.reset_launch_counts()
    p_kernel, t_kernel, l_kernel = run("kernel")
    launches = K.launch_counts()
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
    p_newton, t_newton, l_newton = run("newton")
    scale = max(max(float(p.abs().max()) for p in leaves(p_newton)), 1.0)
    errs_leaf = {k: float((a - b).abs().max()) for (k, a), (_, b) in zip(
        flatten_with_path(p_kernel), flatten_with_path(p_newton))}
    err = max(errs_leaf.values())
    check(err <= 3e-4 * scale, f"20 kernel steps vs newton: max err {err}")
    live_k = (p_kernel["enc1"]["w"] != 0).any(dim=1)
    live_n = (p_newton["enc1"]["w"] != 0).any(dim=1)
    check(all(np.isfinite(l_kernel)), "non-finite loss")
    emit({"phase": "train", "steps": 20, "batch": 128,
          "n_features": cfg.n_features, "n_hidden": cfg.n_hidden,
          "launches": launches, "loss_first": l_kernel[0],
          "loss_last": l_kernel[-1], "loss_last_newton": l_newton[-1],
          "colsp_pct": sparsity_report(p_kernel, (spec,))["enc1/w"],
          "max_abs_err_vs_newton": err, "scale": scale,
          "max_abs_err_by_leaf": errs_leaf,
          "support_cols_differing": int((live_k != live_n).sum()),
          "step_ms_kernel_first": t_kernel[0],
          "step_ms_kernel_mean_rest": float(np.mean(t_kernel[1:])),
          "step_ms_newton_mean_rest": float(np.mean(t_newton[1:]))})

    # -- 4b. this slice's main path: the fused step ---------------------------
    def compare(p_a, p_b):
        scale = max(max(float(p.abs().max()) for p in leaves(p_b)), 1.0)
        err = max(float((a - b).abs().max()) for a, b in zip(
            leaves(p_a), leaves(p_b)))
        live_a = (p_a["enc1"]["w"] != 0).any(dim=1)
        live_b = (p_b["enc1"]["w"] != 0).any(dim=1)
        return err, scale, int((live_a != live_b).sum())

    def counts():
        return {**K.launch_counts(), **FK.launch_counts()}

    def reset_counts():
        K.reset_launch_counts()
        FK.reset_launch_counts()

    fused_launches = None
    for norm in ("l12", "bilevel"):
        radius = RADIUS[norm]
        fspec = ProjectionSpec(pattern=r"enc1/w", norm=norm, radius=radius,
                               axis=1)
        reset_counts()
        p_fused, t_fused, l_fused = run("fused", fspec)
        launched = counts()
        if norm == "l12":
            fused_launches = dict(launched)
        check(launched["adam_colstats"] == 20 and
              launched["adam_clip_apply"] == 20,
              f"{norm} fused: kernel launches {launched}, want 20 each")
        check(launched["mu_solve"] == 0, f"{norm} fused launched mu_solve")
        p_newton, t_newton, l_newton = run("newton", fspec)
        err, scale, differ = compare(p_fused, p_newton)
        check(err <= 1e-5 * scale,
              f"{norm}: 20 fused steps vs newton: max err {err}")
        check(all(np.isfinite(l_fused)), f"{norm}: non-finite loss")
        row = {"phase": "fused_train", "norm": norm, "radius": radius,
               "steps": 20, "launches": launched, "loss_first": l_fused[0],
               "loss_last": l_fused[-1], "loss_last_newton": l_newton[-1],
               "colsp_pct": sparsity_report(p_fused, (fspec,))["enc1/w"],
               "max_abs_err_vs_newton": err, "scale": scale,
               "support_cols_differing": differ,
               "step_ms_fused_first": t_fused[0],
               "step_ms_fused_mean_rest": float(np.mean(t_fused[1:])),
               "step_ms_newton_mean_rest": float(np.mean(t_newton[1:]))}
        if norm == "bilevel":
            reset_counts()
            p_kern, t_kern, _ = run("kernel", fspec)
            kl = counts()
            check(kl["colstats"] > 0 and kl["clip_apply"] > 0 and
                  kl["mu_solve"] == 0,
                  f"bilevel kernel solver launches {kl}")
            err_k, _, differ_k = compare(p_kern, p_newton)
            check(err_k <= 1e-5 * scale,
                  f"bilevel: 20 kernel-solver steps vs newton: {err_k}")
            row.update({"kernel_solver_launches": kl,
                        "kernel_solver_max_abs_err_vs_newton": err_k,
                        "kernel_solver_support_cols_differing": differ_k,
                        "step_ms_kernel_mean_rest": float(np.mean(
                            t_kern[1:]))})
        emit(row)

    # -- 5. train_sae as the JAX package runs it -----------------------------
    t = time.perf_counter()
    res = train_sae(Xtr, ytr, Xte, yte, cfg,
                    SAETrainConfig(epochs=2, projection=spec, seed=0),
                    device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    finite = all(bool(torch.isfinite(p).all()) for p in leaves(res.params))
    check(finite, "train_sae: non-finite params")
    check(res.params["enc1"]["w"].shape == (10000, 96), "train_sae shape")
    check(0 < len(res.selected) < cfg.n_features,
          f"train_sae selected {len(res.selected)} features")
    emit({"phase": "train_sae", "epochs_per_descent": 2,
          "test_accuracy": res.test_accuracy,
          "selected_features": int(len(res.selected)),
          "column_sparsity_pct": res.column_sparsity, "seconds": sec,
          "history": res.history})

    res_l1inf = res

    # -- 5b. train_sae with paper Table 1's l2,1 and masked rows ------------
    for norm in ("l12", "l1inf_masked"):
        radius = RADIUS[norm]
        reset_counts()
        t = time.perf_counter()
        res = train_sae(Xtr, ytr, Xte, yte, cfg, SAETrainConfig(
            epochs=2, lr=2e-3, seed=0, projection=ProjectionSpec(
                pattern=r"enc1/w", norm=norm, radius=radius, axis=1)),
            device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        launched = counts()
        finite = all(bool(torch.isfinite(p).all()) for p in leaves(res.params))
        check(finite, f"train_sae {norm}: non-finite params")
        check(0 < len(res.selected) < cfg.n_features,
              f"train_sae {norm} selected {len(res.selected)} features")
        if norm == "l12":
            check(launched["adam_colstats"] > 0 and
                  launched["adam_clip_apply"] > 0,
                  f"train_sae l12 never launched the fused kernels")
        emit({"phase": "train_sae_table1", "norm": norm, "radius": radius,
              "epochs_per_descent": 2, "lr": 2e-3,
              "test_accuracy": res.test_accuracy,
              "selected_features": int(len(res.selected)),
              "column_sparsity_pct": res.column_sparsity, "seconds": sec,
              "launches": launched, "history": res.history})

    # -- 5c. phase 5's result compacted and served ------------------------
    sae_serve_phase(torch, res_l1inf.params, spec, Xte, dev)

    # -- 6.-9. the LM zoo's hybrid path ---------------------------------------
    from repro_torch import configs as C
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as Sref
    from repro_torch.models import zoo as Z
    attn_row = attn_kernel_phase(torch, FA, dev, flush)
    bwd_rows, fwd_train_row = attn_bwd_phase(torch, FA, dev, flush)
    bwd_row = bwd_rows[0]
    # -- 6e. this slice: the bf16 backward kernel, and the bf16 forward's
    # lse, at the same shapes
    bf16_bwd_rows, _ = attn_bwd_phase(
        torch, FA, dev, flush, shapes=BWD_BF16_SHAPES, dname="bfloat16")
    zoo_rows = attn_zoo_phase(torch, FA, dev, flush)
    ssd_row = ssd_kernel_phase(torch, SK, Sref, dev, flush)
    ssd_bwd_row = ssd_bwd_phase(torch, SK, Sref, dev, flush)
    # this slice: the bf16-tile variant of both SSD kernels (ssd_bf16)
    tile_rows, tile_launches = ssd_tile_bf16_phase(torch, SK, Z, C, dev,
                                                   flush)
    block_launches = block_bwd_phase(torch, C, FA, SK, dev)
    # this slice's bf16 rows: stablelm-3b's global and hymba-1.5b's hybrid
    block_bwd_phase(torch, C, FA, SK, dev, blocks=BLOCK_BWD_BF16,
                    dname="bfloat16")
    lm_launches = lm_forward_phase(torch, Z, C, FA, SK, dev)
    lm_decode_phase(torch, Z, C, FA, SK, dev)

    # -- 10. hymba-1.5b projected, compacted and served ---------------------
    lm_compact_phase(torch, Z, C, K, FA, SK, dev)
    fleet_serve_phase(torch, Z, C, K, dev)

    # -- 11.-12. stablelm-3b trained on the card ---------------------------
    train_launches = lm_train_phase(torch, Z, C, FA, K, dev)
    lm_train_cpu_phase(torch, Z, C, FA, SK, dev)
    lm_resume_phase(torch, Z, C, root)

    # -- 13. this slice: hymba-1.5b and mamba2-370m trained on the card -----
    ssm_launches = lm_train_ssm_phase(torch, Z, C, FA, SK, K, dev)
    lm_train_cpu_phase(torch, Z, C, FA, SK, dev, arch=TRAIN["ssm_archs"][0])

    # -- 14.-15. the rest of the zoo: cross attention and the encoder-
    # decoder, MLA and the MoE MLP ---------------------------------------------
    zoo_launches = zoo_encdec_phase(torch, Z, C, FA, dev)
    zoo_launches.update(zoo_moe_phase(torch, Z, C, FA, K, dev))
    zoo_launches["block_cross"] = block_launches[
        ("llama-3.2-vision-90b", "cross")]
    zoo_launches["block_mla"] = block_launches[("deepseek-v2-236b", "mla")]

    # -- 16. this slice: hymba-1.5b trained in bf16 through the production
    # step (launch/steps.py), remat "full" and "dots", every_k 1, and f32
    bf16_launches, bf16_by_dtype = lm_train_bf16_phase(
        torch, Z, C, FA, SK, K, FK, dev)

    # -- 20. this slice: the dry-run (launch/dryrun.py) against the card
    # step and three production cells, in a process of its own (its fake
    # process group never meets 17-19's gloo groups); before 18, whose
    # ranks and 17's IPC memory would crowd the card
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(torch, smi)

    # -- 18. this slice: the sharded production step on a (data, model)
    # mesh of 4 ranks sharing the card, the MoE's expert parallelism and the
    # pipeline. It runs before 17: phase 17's parent keeps about 31 GB on
    # the card after its ranks exit (CUDA IPC memory that
    # torch.cuda.ipc_collect does not release), and hymba-1.5b's four
    # ranks need that room
    mesh_rows = lm_train_mesh_phase(torch, Z, C, FK, dev, smi)

    # -- 19. this slice: serving over a mesh, 4 ranks sharing the card (the
    # decode step under the reference's decode rules, FleetEngine on a data
    # mesh, the SAE's serve step); before 17, for the same reason as 18
    lm_serve_mesh_phase(torch, Z, C, K, dev, smi,
                        (res_l1inf.params, spec, Xte))

    # -- 17. the sharded and fused_sharded solvers and the compressed
    # gradient sum, 2 and 4 ranks sharing the card over gloo
    dist_ranks = dist_projection_phase(torch, C, dev, smi)

    # -- result ------------------------------------------------------------
    emit({"phase": "timing", "seconds": PHASE_SECONDS,
          "total_s": time.perf_counter() - _CLOCK[0]})
    if FAILURES:
        print(json.dumps({"failures": FAILURES}), file=sys.stderr)
        return 1
    sae = timing["sae_enc1"]
    fsae = ftiming["sae_enc1"]
    # rows 1-5 at sae_enc1: ms with inputs L2-warm, ms_l2_flushed with L2
    # flushed before each call (the one to hold against the HBM bound: the
    # inputs fit in L2); no single PyTorch call computes either fused
    # pass, so their library_ms is null
    # the loop kernel's rows: its times and bound on the projection of the
    # SAE's enc1/w and of the Fig. 2 buffers (phase 2), launches on the
    # main path (phase 4)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": sae[k][0],
         "ms_l2_flushed": flushed["sae_enc1"][k], "plain_ms": sae[k][1],
         "bound_ms": sae[k][3], "bound_by": sae[k][4],
         "library_ms": sae[k][2]} for k in sae] + [
        {"name": "newton_loop", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["newton_loop"],
         "launches": launches["newton_loop"],
         "max_abs_err": loops[shape]["max_abs_err"], "shape": shape,
         **{k: loops[shape][k] for k in (
             "ms", "ms_l2_flushed", "empty_loop_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}} for shape in SHAPES] + [
        {"name": k, "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_REPLACES[k], "launches": fused_launches[k],
         "max_abs_err": ferrs[k], "ms": fsae[k][0],
         "ms_l2_flushed": fsae[k][1], "plain_ms": fsae[k][2],
         "bound_ms": fsae[k][3][0], "bound_by": fsae[k][3][1],
         "library_ms": None}
        for k in FUSED_REPLACES] + [
        # the LM rows at hymba-1.5b's shapes (f32; flash's bf16 numbers
        # under "bfloat16"), launches per full-depth hymba forward
        {"name": k, "route": "cuda", "source": LM_SOURCE[k],
         "replaces": LM_REPLACES[k], "launches": lm_launches[k],
         "shape": "hymba_prefill", **row}
        for k, row in (("flash_attention_fwd", attn_row),
                       ("ssd_fwd", ssd_row))] + [
        # the forward (with lse) and the backward at stablelm-3b's
        # training shape, launches in the ten-step lm_train run
        {"name": k, "route": "cuda", "source": LM_SOURCE[k],
         "replaces": LM_REPLACES[k], "launches": train_launches[k], **row}
        for k, row in (("flash_attention_fwd", fwd_train_row),
                       ("flash_attention_bwd",
                        dict(bwd_row, shape=BWD_SHAPES[0][0])))] + [
        # the SSD backward at hymba-1.5b's training shape, launches in the
        # ten-step lm_train_ssm run of hymba-1.5b
        {"name": "ssd_bwd", "route": "cuda", "source": LM_SOURCE["ssd_bwd"],
         "replaces": LM_REPLACES["ssd_bwd"],
         "launches": ssm_launches["ssd_bwd"], **ssd_bwd_row}] + [
        # the flash kernels at the new kinds' shapes (phase 6c), launches
        # in the run that gives them that shape: whisper's forward (its
        # encoder's and cross attention's) and loss backward, llama-
        # vision's forward, deepseek's forward; mixtral's ten-step train
        # run beside them has their own causal shape
        {"route": "cuda", "source": LM_SOURCE[row["name"]],
         "replaces": LM_REPLACES[row["name"]],
         "launches": _zoo_launches(zoo_launches, row), **row}
        for row in zoo_rows] + [
        # this slice: the bf16 backward at stablelm-3b's training shape and
        # hymba-1.5b's (phase 6e), launches in phase 16's ten-step bf16
        # "full" run of hymba-1.5b
        {"name": "flash_attention_bwd_bf16", "route": "cuda",
         "source": LM_SOURCE["flash_attention_bwd_bf16"],
         "replaces": LM_REPLACES["flash_attention_bwd_bf16"],
         "launches": bf16_by_dtype["bfloat16"], **row}
        for row in bf16_bwd_rows] + [
        # this slice: the fused step's kernels on one rank's mlp/w1
        # column block of phase 17's fused_sharded step (rank 0's device
        # ms, the ranks timed in turn), launches summed over the ranks of
        # the step's run (bilevel and l1,2, both leaves)
        {"name": k, "route": "cuda", "source": FUSED_SOURCE,
         "replaces": FUSED_REPLACES[k],
         "launches": sum(r["launches"][k] for r in ranks),
         "launches_by_rank": [r["launches"][k] for r in ranks],
         "shape": f"hymba_mlp_w1_rank_block_D{D}",
         "path": "dist_projection", "library_ms": None,
         "max_abs_err": max(r["kernel_max_abs_err"][k] for r in ranks),
         **ranks[0]["kernels"][k]}
        for D, ranks in sorted(dist_ranks.items())
        for k in FUSED_REPLACES] + [
        # this slice: the bf16-tile SSD variants at hymba-1.5b's training
        # shape (phases 7 / 7b), launches in the depth-2 ssd_bf16 loss
        # backward that drives them
        {"name": k, "route": "cuda", "source": LM_SOURCE[
            "ssd_fwd" if "fwd" in k else "ssd_bwd"],
         "replaces": LM_REPLACES["ssd_fwd" if "fwd" in k else "ssd_bwd"],
         "launches": tile_launches[k], **row}
        for k, row in tile_rows.items()] + [
        # this slice: the kernels of phase 18's sharded bf16 train step,
        # the fused step's on one rank's block and the LM kernels on the
        # first launch's inputs (rank 0's device ms, the ranks timed in
        # turn), launches summed over the ranks' first step
        {"name": k, "route": "cuda", "shape": "hymba_bf16_mesh_2x2_rank",
         "path": "lm_train_mesh", "library_ms": None, **row}
        for k, row in mesh_rows.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
