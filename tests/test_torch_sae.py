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
