"""The port's SAE (model, projected step, Algorithm 3) against ``repro.sae``.

Both sides start from the same carried parameters: the JAX package draws
them from threefry keys, which torch cannot reproduce, so the JAX draw is
converted with ``convert.params_from_numpy``. Batches come from the same
numpy generator. Tolerances: loss and gradients 1e-5 (one forward and
backward in f32); 10 projected steps 1e-4 * scale (Adam normalises the
step, so fp-order differences in the matmuls and the projection stay at
that level); ``train_sae`` must select the SAME feature support and agree
on test accuracy within one point.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.core as JC
import repro.sae as JS
from repro.optim import AdamConfig as JAdam, adam_init as jadam_init
import repro_torch.core as TC
import repro_torch.sae as TS
from repro_torch._tree import flatten_with_path
from repro_torch.convert import params_from_numpy
from repro_torch.optim import AdamConfig as TAdam, adam_init


def _carried(cfg_j, seed=0):
    pj = JS.sae_init(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 "cpu")


def _max_diff(tj, tt):
    flat_j = {JC.constraints.leaf_path_str(p): np.asarray(l)
              for p, l in jax.tree_util.tree_flatten_with_path(tj)[0]}
    return {k: float(np.abs(v.detach().numpy() - flat_j[k]).max())
            for k, v in flatten_with_path(tt)}


def test_data_generators_are_the_same_arrays():
    a = JS.make_classification(n_samples=120, n_features=40,
                               n_informative=6, seed=4)
    b = TS.make_classification(n_samples=120, n_features=40,
                               n_informative=6, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(JS.train_test_split(a[0], a[1], 0.25, seed=1),
                    TS.train_test_split(b[0], b[1], 0.25, seed=1)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(JS.make_lung_surrogate(n_samples=50, n_features=60),
                    TS.make_lung_surrogate(n_samples=50, n_features=60)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_loss_and_grads_match_jax(n_classes):
    cfg_j = JS.SAEConfig(n_features=50, n_hidden=8, n_classes=n_classes)
    cfg_t = TS.SAEConfig(n_features=50, n_hidden=8, n_classes=n_classes)
    pj, pt = _carried(cfg_j)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 50)) * 2).astype(np.float32)   # Huber both arms
    y = rng.integers(0, n_classes, size=16)
    (lj, auxj), gj = jax.value_and_grad(
        lambda p: JS.sae_loss(p, jnp.asarray(x), jnp.asarray(y), cfg_j),
        has_aux=True)(pj)
    live = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
            for k, v in pt.items()}
    lt, auxt = TS.sae_loss(live, torch.from_numpy(x), torch.from_numpy(y),
                           cfg_t)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5,
                               atol=1e-5)
    for k in ("recon", "ce"):
        np.testing.assert_allclose(float(auxt[k].detach()), float(auxj[k]),
                                   rtol=1e-5, atol=1e-5)
    grads_t = {k: {kk: vv.grad for kk, vv in v.items()}
               for k, v in live.items()}
    assert max(_max_diff(gj, grads_t).values()) <= 1e-5
    zj, xj = JS.sae_apply(pj, jnp.asarray(x))
    with torch.no_grad():
        zt, xt = TS.sae_apply(pt, torch.from_numpy(x))
        acc_t = float(TS.accuracy(pt, torch.from_numpy(x),
                                  torch.from_numpy(y)))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    assert acc_t == float(JS.accuracy(pj, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("solver,jax_solver", [("newton", "newton"),
                                               ("kernel", "pallas"),
                                               ("fused", "fused")])
def test_projected_steps_match_jax(solver, jax_solver):
    cfg_j = JS.SAEConfig(n_features=60, n_hidden=16)
    cfg_t = TS.SAEConfig(n_features=60, n_hidden=16)
    X, y, _ = JS.make_classification(n_samples=96, n_features=60,
                                     n_informative=6, class_sep=1.5, seed=2)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    pj, pt = _carried(cfg_j, seed=1)
    spec_j = JC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.3,
                               axis=1)
    spec_t = TC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.3,
                               axis=1)
    aj, at = JAdam(lr=5e-3), TAdam(lr=5e-3)
    ej = JC.ProjectionEngine((spec_j,), solver=jax_solver)
    et = TC.ProjectionEngine((spec_t,), solver=solver)

    @jax.jit
    def jstep(p, o, s, xb, yb, mask):
        (loss, _), g = jax.value_and_grad(
            lambda q: JS.sae_loss(q, xb, yb, cfg_j), has_aux=True)(p)
        p, o, s = ej.projected_update(g, o, p, aj, mask=mask, state=s)
        return p, o, s, loss

    oj, sj = jadam_init(pj, aj), ej.init_state(pj)
    ot, st = adam_init(pt, at), et.init_state(pt)
    mj = jax.tree_util.tree_map(jnp.ones_like, pj)
    mt = {k: {kk: torch.ones_like(vv) for kk, vv in v.items()}
          for k, v in pt.items()}
    rng = np.random.default_rng(0)
    for _ in range(10):
        idx = rng.permutation(len(X))[:32]
        pj, oj, sj, lj = jstep(pj, oj, sj, jnp.asarray(X[idx]),
                               jnp.asarray(y[idx]), mj)
        pt, ot, st, lt, _ = TS.projected_step(
            pt, ot, st, torch.from_numpy(X[idx]), torch.from_numpy(y[idx]),
            mt, cfg=cfg_t, acfg=at, engine=et)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    scale = max(float(np.abs(np.asarray(pj["enc1"]["w"])).max()), 1.0)
    diffs = _max_diff(pj, pt)
    assert max(diffs.values()) <= 1e-4 * scale, diffs
    key = "l1inf_packed/k1"
    np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                               rtol=1e-4, atol=1e-6)
    live_j = np.any(np.asarray(pj["enc1"]["w"]) != 0, axis=1)
    live_t = (pt["enc1"]["w"] != 0).any(dim=1).numpy()
    np.testing.assert_array_equal(live_t, live_j)


def test_train_sae_matches_jax_algorithm3():
    """The ``norm="l1inf"`` case of ``tests/test_sae.py::
    test_algorithm3_end_to_end``, from the JAX run's own initial params."""
    X, y, inf_idx = JS.make_classification(
        n_samples=400, n_features=300, n_informative=12, class_sep=1.5,
        seed=3)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = JS.train_test_split(X, y, 0.25, seed=0)
    cfg_j = JS.SAEConfig(n_features=300, n_hidden=32, n_classes=2)
    cfg_t = TS.SAEConfig(n_features=300, n_hidden=32, n_classes=2)
    rj = JS.train_sae(Xtr, ytr, Xte, yte, cfg_j, JS.SAETrainConfig(
        epochs=25, lr=2e-3, seed=0, projection=JC.ProjectionSpec(
            pattern=r"enc1/w", norm="l1inf", radius=0.35, axis=1)))
    _, p0 = _carried(cfg_j, seed=0)          # train_sae draws PRNGKey(seed)
    rt = TS.train_sae(Xtr, ytr, Xte, yte, cfg_t, TS.SAETrainConfig(
        epochs=25, lr=2e-3, seed=0, projection=TC.ProjectionSpec(
            pattern=r"enc1/w", norm="l1inf", radius=0.35, axis=1)),
        params0=p0, device="cpu")
    np.testing.assert_array_equal(rt.selected, rj.selected)
    assert abs(rt.test_accuracy - rj.test_accuracy) <= 0.01
    assert rt.column_sparsity == pytest.approx(rj.column_sparsity)
    assert [h[0] for h in rt.history] == ["descent1", "descent2"]
    np.testing.assert_allclose(np.asarray(rt.history[1][1]),
                               np.asarray(rj.history[1][1]), rtol=1e-3)
    assert rt.compaction_ratio == pytest.approx(rj.compaction_ratio,
                                                rel=1e-5)
    assert rt.test_accuracy > 0.75


@pytest.mark.parametrize("norm,radius", [("l12", 3.0),
                                         ("l1inf_masked", 0.35)])
def test_train_sae_matches_jax_other_norms(norm, radius, monkeypatch):
    """Paper Table 1's l2,1 and masked rows through ``train_sae`` (the JAX
    trainer's ``solver="fused"``: the fused step for l12, descent 1 on
    l1inf and a mask-only descent 2 for l1inf_masked), at the tolerances
    of the l1inf case above."""
    X, y, _ = JS.make_classification(
        n_samples=400, n_features=300, n_informative=12, class_sep=1.5,
        seed=3)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = JS.train_test_split(X, y, 0.25, seed=0)
    cfg_j = JS.SAEConfig(n_features=300, n_hidden=32, n_classes=2)
    cfg_t = TS.SAEConfig(n_features=300, n_hidden=32, n_classes=2)
    rj = JS.train_sae(Xtr, ytr, Xte, yte, cfg_j, JS.SAETrainConfig(
        epochs=25, lr=2e-3, seed=0, projection=JC.ProjectionSpec(
            pattern=r"enc1/w", norm=norm, radius=radius, axis=1)))
    _, p0 = _carried(cfg_j, seed=0)
    from repro_torch.kernels.fused_step import kernel as FK
    masked_calls = []           # per pass-1 call: was a mask handed in?
    pass1 = FK.adam_colstats
    monkeypatch.setattr(FK, "adam_colstats", lambda *a, **kw: (
        masked_calls.append(len(a) > 5 and a[5] is not None), pass1(
            *a, **kw))[1])
    TC.engine_counters_reset()
    rt = TS.train_sae(Xtr, ytr, Xte, yte, cfg_t, TS.SAETrainConfig(
        epochs=25, lr=2e-3, seed=0, projection=TC.ProjectionSpec(
            pattern=r"enc1/w", norm=norm, radius=radius, axis=1)),
        params0=p0, device="cpu")
    counts = TC.engine_counters()
    fused = {k for k in counts if k.endswith("/fused")}
    assert fused == ({"l12_packed/k1/fused"} if norm == "l12" else set())
    if norm == "l12":    # both descents hand their mask to the kernels
        assert masked_calls and all(masked_calls)
    np.testing.assert_array_equal(rt.selected, rj.selected)
    assert 0 < len(rt.selected) < 300
    assert abs(rt.test_accuracy - rj.test_accuracy) <= 0.01
    assert rt.column_sparsity == pytest.approx(rj.column_sparsity)
    np.testing.assert_allclose(np.asarray(rt.history[1][1]),
                               np.asarray(rj.history[1][1]), rtol=1e-3)
    assert rt.compaction_ratio == pytest.approx(rj.compaction_ratio,
                                                rel=1e-5)


def test_train_sae_default_init_and_baseline():
    X, y, _ = TS.make_classification(n_samples=200, n_features=64,
                                      n_informative=8, class_sep=1.5, seed=5)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = TS.train_test_split(X, y, 0.25, seed=1)
    res = TS.train_sae(Xtr, ytr, Xte, yte,
                       TS.SAEConfig(n_features=64, n_hidden=16),
                       TS.SAETrainConfig(epochs=25, lr=2e-3, seed=0),
                       device="cpu")
    assert res.column_sparsity == 0.0
    assert res.test_accuracy > 0.6


# -- compacted SAE serving against repro.sae.serve ---------------------------
# The cases of tests/test_sae_serve.py, on the same numpy params carried to
# the port with params_from_numpy; its tolerances: atol 1e-5 in f32, 5e-2
# in bf16 (the two GEMM widths accumulate in other orders).

SERVE = dict(rtol=0, atol=1e-5)
SERVE_BF16 = dict(rtol=0, atol=5e-2)


def _projected_np(d=256, h=24, radius=0.25, seed=0, dtype=jnp.float32):
    """JAX-projected SAE params as numpy, and the spec, in both packages."""
    cfg = JS.SAEConfig(n_features=d, n_hidden=h, n_classes=2)
    pj = jax.tree_util.tree_map(lambda p: p.astype(dtype),
                                JS.sae_init(jax.random.PRNGKey(seed), cfg))
    spec_j = JC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf",
                               radius=radius, axis=1)
    spec_t = TC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf",
                               radius=radius, axis=1)
    pj = JC.apply_constraints(pj, (spec_j,))
    return jax.tree_util.tree_map(np.asarray, pj), spec_j, spec_t


def _np(t):
    return t.float().numpy()


def test_serve_support_matches_jax_and_structural_zeros():
    P, spec_j, spec_t = _projected_np()
    sup = TS.support_selection(params_from_numpy(P, "cpu"),
                               (spec_t,))["enc1/w"]
    sup_j = JS.support_selection(P, (spec_j,))["enc1/w"]
    alive = np.any(np.asarray(P["enc1"]["w"]) != 0, axis=1)
    np.testing.assert_array_equal(sup.sel, np.nonzero(alive)[0])
    np.testing.assert_array_equal(sup.sel, sup_j.sel)
    assert (sup.col_axis, sup.n_cols) == (sup_j.col_axis, sup_j.n_cols) \
        == (0, 256)
    assert 0 < sup.n_selected < sup.n_cols


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_sae_matches_dense_and_jax(dtype):
    P, spec_j, spec_t = _projected_np(dtype=getattr(jnp, dtype))
    tol = SERVE if dtype == "float32" else SERVE_BF16
    pt = params_from_numpy(P, "cpu")
    compact = TS.compact_sae(pt, (spec_t,))
    cj = JS.compact_sae(jax.tree_util.tree_map(jnp.asarray, P), (spec_j,))
    np.testing.assert_array_equal(compact.sel, cj.sel)
    assert compact.params["sel"].dtype == torch.int32
    assert compact.params["enc1"]["w"].dtype == getattr(torch, dtype)
    assert compact.params["enc1"]["w"].shape == (compact.n_selected, 24)
    assert compact.params["dec2"]["w"].shape == (24, compact.n_selected)
    x = np.random.default_rng(1).normal(size=(32, 256)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    z_d, xh_d = TS.sae_apply(pt, xt)
    z_c, xh_c = compact.apply(compact.select(xt))
    np.testing.assert_allclose(_np(z_c), _np(z_d), **tol)
    np.testing.assert_allclose(_np(xh_c), _np(xh_d)[:, compact.sel], **tol)
    assert xh_c.shape == (32, compact.n_selected)
    z_j, xh_j = cj.apply(cj.select(jnp.asarray(x, getattr(jnp, dtype))))
    np.testing.assert_allclose(_np(z_c), np.asarray(z_j, np.float32), **tol)
    np.testing.assert_allclose(_np(xh_c), np.asarray(xh_j, np.float32),
                               **tol)


def test_serve_step_matches_dense_and_jax():
    P, spec_j, spec_t = _projected_np()
    pt = params_from_numpy(P, "cpu")
    compact = TS.compact_sae(pt, (spec_t,))
    step = TS.make_serve_step(compact)         # a plain function
    x = np.random.default_rng(2).normal(size=(8, 256)).astype(np.float32)
    z_c, xh_c = step(compact.params, torch.from_numpy(x))
    z_d, xh_d = TS.sae_apply(pt, torch.from_numpy(x))
    np.testing.assert_allclose(_np(z_c), _np(z_d), **SERVE)
    np.testing.assert_allclose(_np(xh_c), _np(xh_d)[:, compact.sel], **SERVE)
    cj = JS.compact_sae(jax.tree_util.tree_map(jnp.asarray, P), (spec_j,))
    z_j, xh_j = JS.make_serve_step(cj)(cj.params, jnp.asarray(x))
    np.testing.assert_allclose(_np(z_c), np.asarray(z_j), **SERVE)
    np.testing.assert_allclose(_np(xh_c), np.asarray(xh_j), **SERVE)
    # mesh rules that map "batch" to None are refused by both packages
    for step_of, c in ((TS.make_serve_step, compact),
                       (JS.make_serve_step, cj)):
        with pytest.raises(ValueError, match="map 'batch' to None"):
            step_of(c, mesh=object(), rules={"batch": None})


def test_serve_step_follows_refreshed_support():
    """The support rides in the param tree: a step built for one
    checkpoint serves a second with the same J but another surviving set."""
    P, _, spec_t = _projected_np()
    P2 = {"enc1": {"w": np.roll(P["enc1"]["w"], 1, axis=0),
                   "b": P["enc1"]["b"]},
          "enc2": P["enc2"], "dec1": P["dec1"],
          "dec2": {"w": np.roll(P["dec2"]["w"], 1, axis=1),
                   "b": np.roll(P["dec2"]["b"], 1)}}
    p1, p2 = params_from_numpy(P, "cpu"), params_from_numpy(P2, "cpu")
    c1, c2 = TS.compact_sae(p1, (spec_t,)), TS.compact_sae(p2, (spec_t,))
    assert c1.n_selected == c2.n_selected
    assert not np.array_equal(c1.sel, c2.sel)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(8, 256)).astype(np.float32))
    step = TS.make_serve_step(c1)
    z_c, xh_c = step(c2.params, x)
    z_d, xh_d = TS.sae_apply(p2, x)
    np.testing.assert_allclose(_np(z_c), _np(z_d), **SERVE)
    np.testing.assert_allclose(_np(xh_c), _np(xh_d)[:, c2.sel], **SERVE)


@pytest.mark.parametrize("case", ["all_dead", "none_dead"])
def test_compact_sae_edge_supports(case):
    P, spec_j, spec_t = _projected_np(radius=1e9 if case == "none_dead"
                                      else 0.25)
    if case == "all_dead":
        P["enc1"]["w"] = np.zeros_like(P["enc1"]["w"])
    pt = params_from_numpy(P, "cpu")
    compact = TS.compact_sae(pt, (spec_t,))
    if case == "none_dead":
        assert compact.n_selected == compact.n_features == 256
        np.testing.assert_array_equal(compact.sel, np.arange(256))
        assert torch.equal(compact.params["enc1"]["w"], pt["enc1"]["w"])
        assert torch.equal(compact.params["dec2"]["w"], pt["dec2"]["w"])
        return
    assert compact.n_selected == 0 and compact.compaction_ratio == 0.0
    assert compact.params["enc1"]["w"].shape == (0, 24)
    x = torch.ones((4, 256))
    z_c, xh_c = TS.make_serve_step(compact)(compact.params, x)
    z_d, _ = TS.sae_apply(pt, x)
    np.testing.assert_allclose(_np(z_c), _np(z_d), rtol=0, atol=1e-6)
    assert xh_c.shape == (4, 0)


@pytest.mark.parametrize("bad", ["hidden_axis", "no_match"])
def test_compact_sae_refusals(bad):
    P, _, _ = _projected_np()
    spec = TC.ProjectionSpec(
        pattern=r"enc1/w" if bad == "hidden_axis" else "nonexistent",
        norm="l1inf", radius=0.25, axis=0 if bad == "hidden_axis" else 1)
    with pytest.raises(ValueError, match="hidden" if bad == "hidden_axis"
                       else "enc1/w"):
        TS.compact_sae(params_from_numpy(P, "cpu"), (spec,))


def test_compact_leaf_on_stacked_leaf():
    w = np.random.default_rng(4).normal(size=(3, 16, 8)).astype(np.float32)
    w[:, 2, :] = 0.0
    w[0, 5, :] = 0.0
    spec = TC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=1e9,
                             axis=1)
    wt = params_from_numpy({"enc1": {"w": w}}, "cpu")
    sup = TS.support_selection(wt, (spec,))["enc1/w"]
    wc = TS.compact_leaf(wt["enc1"]["w"], sup)
    assert 2 not in sup.sel and 5 in sup.sel and wc.shape == (3, 15, 8)
    np.testing.assert_array_equal(wc.numpy(), w[:, sup.sel, :])


def test_train_reports_compaction_ratio():
    """train_sae's reported ratio is the width compact_sae keeps."""
    X, y, _ = TS.make_classification(n_samples=200, n_features=128,
                                     n_informative=8, class_sep=1.5, seed=7)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = TS.train_test_split(X, y, 0.25, seed=0)
    spec = TC.ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.3,
                             axis=1)
    res = TS.train_sae(Xtr, ytr, Xte, yte,
                       TS.SAEConfig(n_features=128, n_hidden=16,
                                    n_classes=2),
                       TS.SAETrainConfig(epochs=6, lr=2e-3, projection=spec,
                                         seed=0), device="cpu")
    compact = TS.compact_sae(res.params, (spec,))
    assert 0 < compact.n_selected < 128
    assert res.compaction_ratio == pytest.approx(compact.compaction_ratio)
