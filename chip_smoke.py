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
               mu_solve_plain, on the engine's state after pass 1 of phase
               3's projection at each shape: theta to 1e-6, newton_iters
               equal or one apart on a last fp-rounding step (thetas within
               4 ulps, work_cols then larger by that step), the alive prefix
               and mu's support equal, mu within 1e-5 * colmax, a rerun
               bit-equal; the kernel's device ms (CUDA graph) and the plain
               loop's wall ms (it syncs once a step).
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
               Then the Newton against the sort-based oracle on a small input.
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
  6. attn_kernels — the flash attention kernel against its plain version
               (f32 atol = rtol 2e-5, bf16 3e-2: the JAX suite's tolerances)
               at hymba-1.5b's prefill (B 2, S 2048, 25 heads, 5 KV heads,
               hd 64, causal, window 1024) in f32 and bf16, and at small
               shapes: causal, non-causal, tail lengths, hd 80 / 128 / 256
               with and without a window; a rerun bit-equal. At the hymba
               shape, in f32 (CUDA cores) and bf16 (tensor cores): device
               ms (L2 warm and flushed), the plain version's ms, and
               ``scaled_dot_product_attention`` with the window mask and
               ``enable_gqa`` as the library yardstick. The kernel refuses an
               input that requires grad (fault C-6: it is forward-only).
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
               ms from a one-call profiler trace. The kernel refuses an input
               that requires grad, as flash does.
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
 10. the ``kernels`` line, the ``nvidia-smi`` line, and the result line.

TF32 is off for matmuls and cuDNN, so float32 products are full float32.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
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
             "ssd_fwd": "src/repro_torch/csrc/ssd.cu"}
LM_REPLACES = {
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:78",
    "ssd_fwd": "src/repro/kernels/ssd/kernel.py:75"}
# the device kernels of each LM wrapper, by name in a profiler trace
LM_TRACE_NAMES = ("flash_f32_kernel", "flash_bf16_kernel",
                  "ssd_chunk_state_kernel", "ssd_state_scan_kernel",
                  "ssd_chunk_output_kernel")
# (name, B, H, KV, S, head_dim, causal, window); the first is hymba-1.5b's
# prefill, the one the kernels line reports
ATTN_SHAPES = [("hymba_prefill", 2, 25, 5, 2048, 64, True, 1024),
               ("causal", 1, 8, 2, 512, 64, True, 0),
               ("non_causal", 1, 8, 8, 384, 64, False, 0),
               ("tail_hd80", 1, 8, 8, 200, 80, True, 0),
               ("tail_hd128", 1, 8, 2, 300, 128, True, 0),
               ("window_hd256", 1, 8, 4, 520, 256, True, 128)]
# (name, B, heads per group, S, P, N, chunk, dt range, dtype); the first is
# hymba-1.5b's, the one the kernels line reports
SSD_SHAPES = [("hymba", 2, 50, 2048, 64, 16, 64, (3.0, 20.0), "float32"),
              ("mamba2", 2, 32, 2048, 64, 128, 64, (3.0, 20.0), "float32"),
              ("mamba2_small_dt", 2, 32, 2048, 64, 128, 64, (0.05, 0.6),
               "float32"),
              ("small_bf16", 2, 4, 256, 64, 32, 64, (0.05, 0.6), "bfloat16")]
# the LM phases: models, batch and the cuts of the comparison phases
LM = dict(arch="hymba-1.5b", ssm_arch="mamba2-370m", batch=2, seq=2048,
          cut_depth=2, decode_prompt=1152, full_prompt=64, greedy=8)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_TOL = 2e-4
# At the reference's full-width init (ROADMAP C-5) the model amplifies f32
# rounding about a thousandfold, so the LM comparisons are held to the
# model's own noise floor, measured in the same run: how far the logits move
# when every weight is multiplied by (1 + PERTURB * N(0, 1)), about ten f32
# ulps. A comparison passes within that floor and within 1e-2 of the
# logits' scale.
PERTURB = 1e-6
LM_MAX_REL = 1e-2
FAILURES = []


def emit(obj):
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


def loop_phase(torch, K, O, Y, C):
    """The Newton loop kernel against its plain version (the host loop over
    mu_solve_plain) on the engine's state after pass 1 of projecting Y onto
    the ball of radius C: theta to atol = rtol 1e-6, newton_iters equal or
    one apart where the last step is fp rounding (thetas within 4 ulps,
    work_cols then larger by that step's prefix), active_cols_per_step and
    mu's support equal, mu within 1e-5 * colmax; a rerun bit-equal. Times:
    the kernel in a CUDA graph (``time_ms``), the plain loop on the host
    clock (``wall_ms``: it syncs once a step, so it cannot be captured)."""
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
    # bound: read the first evaluation's prefix once; 2 f32 operations an
    # element on each of 36 passes over every evaluation's prefix
    swept = int(work) - Ypad.shape[1]
    first = min(int(li["num_active"]) + bm - 1, Ypad.shape[1]) // bm * bm
    bound = max((n * first * 4 / HBM_BYTES_PER_S * 1e3, "bytes"),
                (36 * 2 * n * swept / F32_OPS_PER_S * 1e3, "operations"))
    return {"newton_iters": int(it), "newton_iters_plain": int(itp),
            "work_cols": int(work), "work_cols_plain": int(workp),
            "active_cols_per_step": int(acps),
            "num_active": int(li["num_active"]),
            "theta": float(th[0]), "theta_plain": float(thp[0]),
            "max_abs_err": dmu,
            "ms": time_ms(torch, lambda: K.newton_loop(*args, **kw)),
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
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(11)
    err, row, bf16 = 0.0, None, None
    for name, B, H, KV, S, hd, causal, window in shapes:
        kw = dict(groups=H // KV, causal=causal, window=window)
        pairs, mask = _pairs(S, causal, window)
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
            size = q.element_size()
            nbytes = 2 * q.numel() * size + 2 * k.numel() * size
            ops = 4 * hd * pairs * B * H
            peak = F32_OPS_PER_S if dname == "float32" else BF16_OPS_PER_S
            bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                        (ops / peak * 1e3, "operations"))
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
    q = torch.ones((2, 8, 32), device=dev)
    try:
        FA.flash_attention_fwd(q, q, q)
        check(False, "flash kernel took head_dim 32")
    except ValueError:
        pass
    check(refuses_grad(torch, lambda t: FA.flash_attention_fwd(t, t, t),
                       torch.ones((2, 64, 64), device=dev)),
          "flash kernel ran on an input that requires grad")
    row.update(max_abs_err=err, bfloat16=bf16)
    return row


def ssd_kernel_phase(torch, SK, Sref, dev, flush, shapes=SSD_SHAPES):
    """Phase 7; returns the kernels-line row of the first shape."""
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
        size = x.element_size()
        nbytes = (2 * x.numel() + dt.numel() + 2 * Bm.numel()) * size \
            + (2 * BH + BH * P * N) * 4
        tri = Q * (Q + 1) // 2
        ops = (S // Q) * BH * (2 * tri * (N + P) + 4 * Q * P * N)
        bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (ops / F32_OPS_PER_S * 1e3, "operations"))
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
    x = torch.ones((2, 128, 64), device=dev)
    B1 = torch.ones((2, 128, 16), device=dev)
    dt1, ad = torch.ones((2, 128), device=dev), torch.ones((2,), device=dev)
    check(refuses_grad(torch, lambda t: SK.ssd_fwd(t, dt1, -ad, ad, B1, B1),
                       x), "ssd kernel ran on an input that requires grad")
    row.update(max_abs_err=err)
    return row


def _noise_floor(torch, model, params, batch, logits, V, seed):
    """max |logits(P * (1 + PERTURB * eps)) - logits(P)| over the true
    vocab: how far weight changes of about ten f32 ulps move this model."""
    from repro_torch._tree import tree_map
    g = torch.Generator(device=logits.device).manual_seed(seed)
    pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
        a.shape, generator=g, device=a.device)), params)
    moved, _ = model.forward(pert, batch)
    return float((moved[..., :V] - logits[..., :V]).abs().max())


def _lm_counts(FA, SK):
    return {**FA.launch_counts(), **SK.launch_counts()}


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
        check(launched == {"flash_attention_fwd": cfg.n_layers,
                           "ssd_fwd": cfg.n_layers},
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
    check(launched == {"flash_attention_fwd": 0, "ssd_fwd": scfg.n_layers},
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
    check(launched == {"flash_attention_fwd": dcfg.n_layers,
                       "ssd_fwd": dcfg.n_layers},
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


def _decode_all(torch, model, params, tokens, smax):
    """Step every prompt position through decode_step; (logits (B, S, V),
    cache, mean wall ms per step)."""
    B, S = tokens.shape
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
    t0 = time.perf_counter()
    libs = _build.build()
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
                         time_ms(torch, lambda: K.colstats_plain(A)), None,
                         (n * m * 4 + 2 * m * 4) / HBM_BYTES_PER_S * 1e3,
                         "bytes"),
            "mu_solve": (time_ms(torch, lambda: K.mu_solve(
                A, theta, block_m=bm, nact_blocks=nact)),
                time_ms(torch, lambda: K.mu_solve_plain(
                    A, theta, block_m=bm, nact=nact)), None)
            + max(((n * P * 4 + P * 4 + m * 13) / HBM_BYTES_PER_S * 1e3,
                   "bytes"),
                  (36 * 2 * n * P / F32_OPS_PER_S * 1e3, "operations")),
            "clip_apply": (time_ms(torch, lambda: K.clip_apply(Y, mu)),
                           time_ms(torch, lambda: K.clip_apply_plain(Y, mu)),
                           time_ms(torch, lambda: torch.clamp(
                               Y, -mu_lo, mu_lo)),
                           (2 * n * m * 4 + m * 4) / HBM_BYTES_PER_S * 1e3,
                           "bytes"),
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
                                      Y[:, :ncols].contiguous(), C)
        errs["newton_loop"] = max(errs.get("newton_loop", 0.0),
                                  lp["max_abs_err"])
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
        mcols = R if transpose else C
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
        n_el = L * R * C
        p1 = lambda: FK.adam_colstats(sc, g, m, v, p, mk, stat="sq", **kw)
        p2 = lambda: FK.adam_clip_apply(sc, a[0], a[1], p, mu, mk,
                                        mode="scale", **kw)
        t = {"adam_colstats": (
            time_ms(torch, p1), time_cold_ms(torch, p1, flush),
            time_ms(torch, lambda: FK.adam_colstats_plain(
                sc, g, m, v, p, mk, stat="sq", **kw)),
            max(((7 * n_el * 4 + 2 * L * mcols * 4 + 16) / HBM_BYTES_PER_S
                 * 1e3, "bytes"),
                (20 * n_el / F32_OPS_PER_S * 1e3, "operations"))),
            "adam_clip_apply": (
            time_ms(torch, p2), time_cold_ms(torch, p2, flush),
            time_ms(torch, lambda: FK.adam_clip_apply_plain(
                sc, a[0], a[1], p, mu, mk, mode="scale", **kw)),
            max(((5 * n_el * 4 + L * mcols * 4 + 16) / HBM_BYTES_PER_S
                 * 1e3, "bytes"),
                (14 * n_el / F32_OPS_PER_S * 1e3, "operations")))}
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
        # reported, not checked: the sorted projection's distance to the
        # Newton's (ROADMAP fault C-10)
        sorted_err = float((project_l1inf_sorted(Y, C) - X2).abs().max())
        emit({"phase": "project", "shape": name, "n": Y.shape[0],
              "m": Y.shape[1], "C": C, "max_abs_err": err,
              "sorted_vs_newton_max_abs_err": sorted_err,
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
    # reported, not checked (ROADMAP fault C-10): the sorted projection on
    # torch's own U(0, 1) draw of the Fig. 2 shape
    Yr = torch.rand((1000, 10000), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    emit({"phase": "project", "shape": "fig2_wide", "check": "reruns",
          "reruns_bit_equal": rerun,
          "sorted_vs_newton_max_abs_err_torch_rand": float(
              (project_l1inf_sorted(Yr, 1.0)
               - project_l1inf_newton(Yr, 1.0)).abs().max())})
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

    # -- 6.-9. this slice: the LM zoo's hybrid path ----------------------------
    from repro_torch import configs as C
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as Sref
    from repro_torch.models import zoo as Z
    attn_row = attn_kernel_phase(torch, FA, dev, flush)
    ssd_row = ssd_kernel_phase(torch, SK, Sref, dev, flush)
    lm_launches = lm_forward_phase(torch, Z, C, FA, SK, dev)
    lm_decode_phase(torch, Z, C, FA, SK, dev)

    # -- 10. result ------------------------------------------------------------
    if FAILURES:
        print(json.dumps({"failures": FAILURES}), file=sys.stderr)
        return 1
    sae = timing["sae_enc1"]
    fsae = ftiming["sae_enc1"]
    # rows 1-5 at sae_enc1: ms with inputs L2-warm, ms_l2_flushed with L2
    # flushed before each call (the one to hold against the HBM bound: the
    # inputs fit in L2); no single PyTorch call computes either fused
    # pass, so their library_ms is null
    # the loop kernel's row: its time and bound on the projection of the
    # SAE's enc1/w (phase 2), launches on the main path (phase 4)
    lsae = loops["sae_enc1"]
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
         "max_abs_err": errs["newton_loop"],
         **{k: lsae[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}] + [
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
         "replaces": LM_REPLACES[k], "launches": lm_launches[k], **row}
        for k, row in (("flash_attention_fwd", attn_row),
                       ("ssd_fwd", ssd_row))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
