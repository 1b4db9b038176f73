"""The port's fused optimizer+projection step against ``repro.kernels.
fused_step`` and the JAX engine's fused branch.

Twin of ``tests/test_fused_step.py``. The same numpy inputs go through the
JAX passes (``impl="pallas"`` in interpret mode and ``impl="ref"``) and
the port's (on the CPU the wrappers run their plain versions, which
repeat the CUDA kernels' arithmetic), at that suite's tolerances: pass 1
2e-6 and pass 2 1e-6 in f32, bf16 params with f32 moments pass 1 1e-6 and
pass 2 1e-2 (one bf16 ulp). Through ``projected_update`` the port's fused
step equals its Newton step to 1e-5 (bit-equal for bf16 params), and the
whole fused step matches the JAX one at ``tests/test_torch_engine.py``'s
tolerances (params 1e-5, moments 1e-6, theta 1e-5).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card; they skip here, with the reason, when no card is present
(``python3 chip_smoke.py`` makes the same checks at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import repro.core as JC
    from repro.kernels.fused_step import (
        fused_adam_clip_apply as jclip, fused_adam_colstats as jcolstats)
    from repro.optim import AdamConfig as JAdam, adam_init as jadam_init
except ImportError:       # the card's machine has PyTorch but no JAX
    jax = None
import repro_torch.core as TC
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core.constraints import build_packed_plans
from repro_torch.kernels.fused_step import (fused_adam_clip_apply,
                                            fused_adam_colstats)
from repro_torch.kernels.fused_step import kernel as K
from repro_torch.kernels.fused_step import ref
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch._tree import flatten_with_path, leaves


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX, the reference package, on this machine")


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _tol(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


def _leaf_set(seed, shape):
    """(g, m, v, p, mask) as f32 numpy; v >= 0, mask about 70% ones."""
    rng = np.random.default_rng(seed)
    g, m, v, p, mk = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(5))
    return g, m, np.abs(v), p, (mk > -0.5).astype(np.float32)


def _jx(x, dtype=None):
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _tt(x, dtype=torch.float32):
    return torch.tensor(x).to(dtype)


# -----------------------------------------------------------------------------
# the two passes against the JAX kernels and references
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 200), (33, 130), (3, 17, 96)])
@pytest.mark.parametrize("transpose", [False, True])
def test_passes_match_jax(shape, transpose, jax_ref):
    g, m, v, p, mask = _leaf_set(0, shape)
    jkw = dict(cfg=JAdam(lr=1e-2, weight_decay=0.01), lr_t=jnp.float32(1e-2),
               b1c=jnp.float32(0.3), b2c=jnp.float32(0.05),
               mask=_jx(mask), transpose=transpose)
    tkw = dict(cfg=AdamConfig(lr=1e-2, weight_decay=0.01), lr_t=1e-2,
               b1c=0.3, b2c=0.05, mask=_tt(mask), transpose=transpose)
    jr = jcolstats(_jx(g), _jx(m), _jx(v), _jx(p), scale=jnp.float32(0.9),
                   impl="ref", **jkw)
    jq = jcolstats(_jx(g), _jx(m), _jx(v), _jx(p), scale=jnp.float32(0.9),
                   impl="pallas", interpret=True, **jkw)
    t = fused_adam_colstats(_tt(g), _tt(m), _tt(v), _tt(p), scale=0.9,
                            **tkw)
    tr = ref.adam_colstats_ref(_tt(g), _tt(m), _tt(v), _tt(p), scale=0.9,
                               **tkw)
    for a, b, c, d in zip(t, tr, jr, jq):
        assert tuple(a.shape) == tuple(c.shape)
        _tol(a, c, 2e-6)
        _tol(a, d, 2e-6)
        _tol(b, c, 2e-6)
    lead, mcols = t[2].shape
    mu = np.abs(np.random.default_rng(9).standard_normal(
        (lead, mcols))).astype(np.float32)
    xj = jclip(jr[0], jr[1], _jx(p), _jx(mu), impl="ref", **jkw)
    xq = jclip(jr[0], jr[1], _jx(p), _jx(mu), impl="pallas", interpret=True,
               **jkw)
    xt = fused_adam_clip_apply(t[0], t[1], _tt(p), _tt(mu), **tkw)
    xr = ref.adam_clip_apply_ref(t[0], t[1], _tt(p), _tt(mu), **tkw)
    _tol(xt, xj, 1e-6)
    _tol(xt, xq, 1e-6)
    _tol(xr, xj, 1e-6)


@pytest.mark.parametrize("stat,mode", [("abs", "clip"), ("sq", "scale")])
def test_bf16_params_fp32_moments_match_jax(stat, mode, jax_ref):
    g, m, v, p, _ = _leaf_set(1, (32, 160))
    bf = jnp.bfloat16
    jkw = dict(cfg=JAdam(lr=1e-2), lr_t=jnp.float32(1e-2),
               b1c=jnp.float32(0.3), b2c=jnp.float32(0.05))
    tkw = dict(cfg=AdamConfig(lr=1e-2), lr_t=1e-2, b1c=0.3, b2c=0.05)
    jq = jcolstats(_jx(g, bf), _jx(m), _jx(v), _jx(p, bf), impl="pallas",
                   interpret=True, stat=stat, **jkw)
    t = fused_adam_colstats(_tt(g, torch.bfloat16), _tt(m), _tt(v),
                            _tt(p, torch.bfloat16), stat=stat, **tkw)
    assert t[0].dtype == torch.float32            # moments stay f32
    for a, b in zip(t, jq):
        _tol(a, b, 1e-6)
    mu = np.full(tuple(t[2].shape), 0.5, np.float32)
    xq = jclip(jq[0], jq[1], _jx(p, bf), _jx(mu), impl="pallas",
               interpret=True, mode=mode, **jkw)
    xt = fused_adam_clip_apply(t[0], t[1], _tt(p, torch.bfloat16), _tt(mu),
                               mode=mode, **tkw)
    assert xt.dtype == torch.bfloat16             # params in their dtype
    _tol(xt, xq, 1e-2)


def test_bf16_moments_match_jax(jax_ref):
    g, m, v, p, mask = _leaf_set(2, (40, 72))
    bf = jnp.bfloat16
    jkw = dict(cfg=JAdam(lr=1e-2, moment_dtype=bf), lr_t=jnp.float32(1e-2),
               b1c=jnp.float32(0.3), b2c=jnp.float32(0.05),
               mask=_jx(mask), transpose=True)
    tkw = dict(cfg=AdamConfig(lr=1e-2, moment_dtype=torch.bfloat16),
               lr_t=1e-2, b1c=0.3, b2c=0.05, mask=_tt(mask), transpose=True)
    jr = jcolstats(_jx(g), _jx(m, bf), _jx(v, bf), _jx(p), impl="ref",
                   **jkw)
    t = fused_adam_colstats(_tt(g), _tt(m, torch.bfloat16),
                            _tt(v, torch.bfloat16), _tt(p), **tkw)
    assert t[0].dtype == t[1].dtype == torch.bfloat16
    for a, b in zip(t, jr):
        _tol(a, b, 1e-6)
    mu = np.full(tuple(t[2].shape), 0.3, np.float32)
    xj = jclip(jr[0], jr[1], _jx(p), _jx(mu), impl="ref", **jkw)
    _tol(fused_adam_clip_apply(t[0], t[1], _tt(p), _tt(mu), **tkw), xj,
         1e-6)


@pytest.mark.parametrize("transpose", [False, True])
def test_colstats_describe_the_rounded_update(transpose):
    """The statistics are taken on u AFTER rounding through the param
    dtype: pass 2 at the identity level reproduces pass 1's colmax
    exactly."""
    g, m, v, p, _ = _leaf_set(2, (16, 128))
    cfg = AdamConfig(lr=1e-2)
    kw = dict(cfg=cfg, lr_t=1e-2, b1c=0.3, b2c=0.05, transpose=transpose)
    pb = _tt(p, torch.bfloat16)
    m_st, v_st, colsum, colmax = fused_adam_colstats(
        _tt(g, torch.bfloat16), _tt(m), _tt(v), pb, **kw)
    u = fused_adam_clip_apply(m_st, v_st, pb,
                              torch.full(tuple(colsum.shape), 1e30), **kw)
    a = u[None].float().abs()
    red = 2 if transpose else 1
    assert torch.equal(a.amax(dim=red), colmax)
    _tol(a.sum(dim=red), colsum, 1e-4)


class _Elsewhere(torch.Tensor):
    """A tensor of ``like``'s shape and dtype on a device with neither a
    kernel nor a plain version (meta is the dry-run's now): metadata only,
    any op on it raises."""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a stand-in device")


def test_wrappers_check_their_inputs():
    g, m, v, p, _ = (torch.tensor(x)[None] for x in _leaf_set(3, (8, 16)))
    sc = torch.tensor([1.0, 1e-2, 0.3, 0.05])
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0, transpose=False)
    with pytest.raises(TypeError):
        K.adam_colstats(sc, g.double(), m, v, p, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.adam_colstats(sc, g, m, v, p.transpose(1, 2).contiguous()
                        .transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.adam_colstats(_Elsewhere(sc), *map(_Elsewhere, (g, m, v, p)),
                        **kw)
    with pytest.raises(ValueError, match="mu"):
        K.adam_clip_apply(sc, m, v, p, torch.ones(1, 7), **kw)
    with pytest.raises(TypeError, match="moments"):
        fused_adam_colstats(g, m.bfloat16(), v, p, cfg=AdamConfig(),
                            lr_t=1e-3, b1c=0.1, b2c=0.01)


# -----------------------------------------------------------------------------
# the fused projected_update against the port's Newton step
# -----------------------------------------------------------------------------

def _tree(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {"enc1": {"w": _tt(rng.standard_normal((24, 50)), dtype),
                     "b": torch.zeros(50, dtype=dtype)},
            "blocks": {"w": _tt(rng.standard_normal((3, 16, 40)), dtype)}}


def _grads(params, seed=7, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: {kk: _tt(rng.standard_normal(tuple(vv.shape)) * scale,
                        vv.dtype) for kk, vv in d.items()}
            for k, d in params.items()}


def _run(engine, acfg, steps=4, seed=0, mask=None, dtype=torch.float32):
    params = _tree(seed, dtype)
    grads = _grads(params)
    opt = adam_init(params, acfg)
    state = engine.init_state(params)
    for _ in range(steps):
        params, opt, state, stats = engine.projected_update(
            grads, opt, params, acfg, mask=mask, state=state,
            with_stats=True)
    return params, opt, state, stats


def _assert_same_run(specs, acfg, mask=None, tol=2e-6):
    pn, on, sn, _ = _run(TC.ProjectionEngine(specs), acfg, mask=mask)
    pf, of, sf, _ = _run(TC.ProjectionEngine(specs, solver="fused"), acfg,
                         mask=mask)
    for a, b in zip(leaves(pn) + leaves(on.mu), leaves(pf) + leaves(of.mu)):
        _tol(a, b, tol)
    assert set(sn) == set(sf)
    for k in sn:
        _tol(sn[k], sf[k], tol)


def _specs(mod, norm, **kw):
    return (mod.ProjectionSpec(pattern=r"enc1/w", norm=norm, radius=4.0),
            mod.ProjectionSpec(pattern=r"blocks/w", norm=norm, radius=2.0,
                               axis=1, **kw))


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
def test_fused_equals_newton(norm):
    acfg = AdamConfig(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    TC.engine_counters_reset()
    _assert_same_run(_specs(TC, norm), acfg, tol=1e-5)
    counts = TC.engine_counters()
    assert counts[f"{norm}_packed/k1/fused"] > 0
    assert counts[f"{norm}_packed/k1/newton"] > 0   # the unfused twin's runs
    TC.engine_counters_reset()


def test_fused_equals_newton_with_mask():
    mask = {k: {kk: torch.ones_like(vv) for kk, vv in d.items()}
            for k, d in _tree().items()}
    mask["enc1"]["w"][:, :12] = 0.0
    acfg = AdamConfig(lr=1e-2, weight_decay=0.05)
    _assert_same_run(_specs(TC, "bilevel"), acfg, mask=mask)
    pf, _, _, _ = _run(TC.ProjectionEngine(_specs(TC, "bilevel"),
                                           solver="fused"), acfg, mask=mask)
    assert bool((pf["enc1"]["w"][:, :12] == 0).all())


@pytest.mark.parametrize("norm", ["l1inf", "l1inf_weighted"])
def test_fused_falls_back_for_unfusable_families(norm):
    """Plain and weighted need sorted prefix sums — no streaming hook, so
    solver="fused" replays the unfused path bit for bit."""
    extra = ({"weights": tuple(np.linspace(0.5, 2.0, 50))}
             if norm == "l1inf_weighted" else {})
    specs = (TC.ProjectionSpec(pattern=r"enc1/w", norm=norm, radius=4.0,
                               **extra),)
    TC.engine_counters_reset()
    _assert_same_run(specs, AdamConfig(lr=1e-2), tol=0.0)
    assert not any(k.endswith("/fused") for k in TC.engine_counters())
    TC.engine_counters_reset()


def test_fused_every_k_gating_falls_back():
    """A gated plan (every_k > 1) cannot fuse; it solves on the unfused
    path while a k = 1 plan in the same spec list takes the kernels."""
    TC.engine_counters_reset()
    _assert_same_run(_specs(TC, "bilevel", every_k=3), AdamConfig(lr=1e-2))
    counts = TC.engine_counters()
    assert counts["bilevel_packed/k1/fused"] > 0
    assert counts["bilevel_packed/k3/newton"] > 0
    assert "bilevel_packed/k3/fused" not in counts
    TC.engine_counters_reset()


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
def test_fused_bf16_params_fp32_moments_end_to_end(norm):
    acfg = AdamConfig(lr=1e-2, moment_dtype=torch.float32)
    outs = {}
    for solver in ("newton", "fused"):
        outs[solver] = _run(TC.ProjectionEngine(_specs(TC, norm),
                                                solver=solver), acfg,
                            steps=3, seed=4, dtype=torch.bfloat16)
    for a, b in zip(leaves(outs["newton"][0]), leaves(outs["fused"][0])):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    for a, b in zip(leaves(outs["newton"][1].mu),
                    leaves(outs["fused"][1].mu)):
        assert a.dtype == torch.float32
        _tol(a, b, 2e-6)


def test_fused_warm_start_survives_solver_switch():
    """Theta threads under ONE plan key whichever solver runs: after a
    newton -> fused switch the steady-state solves stay in the bootstrap
    pair of Eq.-(19) evaluations."""
    acfg = AdamConfig(lr=1e-3)
    params = _tree(7)
    grads = _grads(params, seed=5, scale=0.01)
    opt = adam_init(params, acfg)
    en = TC.ProjectionEngine(_specs(TC, "l12"))
    ef = TC.ProjectionEngine(_specs(TC, "l12"), solver="fused")
    state = en.init_state(params)
    for _ in range(4):
        params, opt, state = en.projected_update(grads, opt, params, acfg,
                                                 state=state)
    iters = []
    for _ in range(4):
        params, opt, state, stats = ef.projected_update(
            grads, opt, params, acfg, state=state, with_stats=True)
        iters.append(stats["l12_packed/k1"])
    assert max(iters[1:]) <= 2, iters
    assert all(float(v.min()) >= 0 for v in state.values())


def test_fused_plan_virtual_layout_matches_jax(jax_ref):
    pt = _tree(0)
    pj = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), pt)
    (plan_t,), _ = build_packed_plans(pt, _specs(TC, "bilevel"))
    (plan_j,), _ = JC.build_packed_plans(pj, _specs(JC, "bilevel"))
    assert plan_t.virtual_num_cols() == plan_j.virtual_num_cols() == 98
    np.testing.assert_array_equal(plan_t.virtual_seg_ids(),
                                  plan_j.virtual_seg_ids())
    np.testing.assert_array_equal(plan_t.virtual_col_weights(),
                                  plan_j.virtual_col_weights())


def test_fused_no_specs_passthrough():
    engine = TC.ProjectionEngine((), solver="fused")
    params = _tree(5)
    grads = {k: {kk: 0.01 * torch.ones_like(vv) for kk, vv in d.items()}
             for k, d in params.items()}
    acfg = AdamConfig(lr=1e-2)
    opt = adam_init(params, acfg)
    p1, _, s1 = engine.projected_update(grads, opt, params, acfg, state={})
    p2, _ = adam_update(grads, opt, params, acfg)
    for a, b in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b)
    assert s1 == {}


# -----------------------------------------------------------------------------
# the whole fused step against the JAX engine's fused branch
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["bilevel", "l12"])
def test_fused_projected_update_matches_jax(norm, jax_ref):
    pt = _tree(2)
    P = {k: {kk: vv.numpy() for kk, vv in d.items()} for k, d in pt.items()}
    G = {k: {kk: vv.numpy() * 0.1 for kk, vv in d.items()}
         for k, d in _grads(pt, seed=20).items()}
    mask = {k: {kk: np.ones(vv.shape, np.float32) for kk, vv in d.items()}
            for k, d in P.items()}
    mask["enc1"]["w"][:, :10] = 0.0
    both = lambda t: (jax.tree_util.tree_map(jnp.asarray, t),
                      params_from_numpy(t, "cpu"))
    (pj, pt), (gj, gt), (mj, mt) = both(P), both(G), both(mask)
    aj = JAdam(lr=1e-2, weight_decay=0.1)
    at = AdamConfig(lr=1e-2, weight_decay=0.1)
    oj = jadam_init(pj, aj)
    ot = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, oj), "cpu")
    ej = JC.ProjectionEngine(_specs(JC, norm), solver="fused")
    et = TC.ProjectionEngine(_specs(TC, norm), solver="fused")
    sj, st = ej.init_state(pj), et.init_state(pt)
    for _ in range(3):
        pj, oj, sj = ej.projected_update(gj, oj, pj, aj, mask=mj, state=sj)
        pt, ot, st = et.projected_update(gt, ot, pt, at, mask=mt, state=st)
    flat = lambda t: {JC.constraints.leaf_path_str(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for tree_j, tree_t, tol in ((pj, pt, 1e-5), (oj.mu, ot.mu, 1e-6),
                                (oj.nu, ot.nu, 1e-6)):
        fj = flat(tree_j)
        for name, leaf in flatten_with_path(tree_t):
            _tol(leaf, fj[name], tol)
    for k in sj:
        _tol(st[k], sj[k], 1e-5)
    assert (pt["enc1"]["w"][:, :10] == 0).all()


# -----------------------------------------------------------------------------
# on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for "
                    "sm_90a, built with nvcc, with no interpret mode")
    return torch.device("cuda")


def _bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,transpose", [((1, 300, 96), True),
                                             ((2, 257, 130), False),
                                             ((1, 7, 33), False)])
@pytest.mark.parametrize("pdt,mdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_cuda_kernels_vs_plain(card, shape, transpose, pdt, mdt):
    g, m, v, p, mask = (torch.tensor(x, device=card)
                        for x in _leaf_set(11, shape))
    g, p, mask = g.to(pdt), p.to(pdt), mask.to(pdt)
    m, v = m.to(mdt), v.to(mdt)
    sc = torch.tensor([0.9, 1e-2, 0.3, 0.05], device=card)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, transpose=transpose)
    for mk, stat, mode in ((None, "abs", "clip"), (mask, "sq", "scale")):
        a = K.adam_colstats(sc, g, m, v, p, mk, stat=stat, **kw)
        b = K.adam_colstats_plain(sc, g, m, v, p, mk, stat=stat, **kw)
        assert _bits(a[0], b[0]) and _bits(a[1], b[1])
        torch.testing.assert_close(a[2], b[2], rtol=1e-6, atol=0)
        assert torch.equal(a[3], b[3])
        mu = a[3] * 0.5 if mode == "clip" else torch.full_like(a[3], 0.7)
        x = K.adam_clip_apply(sc, a[0], a[1], p, mu, mk, mode=mode, **kw)
        assert _bits(x, K.adam_clip_apply_plain(sc, a[0], a[1], p, mu, mk,
                                                mode=mode, **kw))
        if mk is None:     # a frozen entry counts in pass 1, not in pass 2
            ident = K.adam_clip_apply(sc, a[0], a[1], p,
                                      torch.full_like(mu, 1e30), **kw)
            red = 2 if transpose else 1
            assert torch.equal(ident.float().abs().amax(dim=red), a[3])
