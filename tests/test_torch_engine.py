"""The port's ProjectionEngine, packing and Adam against the JAX package.

A two-leaf plan (a 2-D ``enc1/w`` with axis 1 and a stacked (3, 16, 40)
``mlp_w1`` with axis 0: four segments in one packed buffer). Parameters,
theta state and Adam state start from the same numpy values on both sides
(``convert.params_from_numpy`` / ``opt_state_from_numpy``). Solvers are
paired newton <-> newton, kernel <-> pallas (interpret mode on the CPU),
fused <-> fused. Tolerance 5e-6, the JAX engine suite's own
(``tests/test_engine.py``), and 1e-5 after the Adam step.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.core as JC
from repro.core.constraints import leaf_path_str
from repro.optim import AdamConfig as JAdam, adam_init as jadam_init
from repro.optim import adam_update as jadam_update
import repro_torch.core as TC
from repro_torch.core import l1inf as Tl1inf
from repro_torch._tree import flatten_with_path
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamConfig as TAdam, adam_init, adam_update

SOLVERS = [("newton", "newton"), ("kernel", "pallas"), ("fused", "fused")]


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "enc1": {"w": rng.normal(size=(24, 50)).astype(np.float32),
                 "b": rng.normal(size=(50,)).astype(np.float32)},
        "blocks": {"mlp_w1": rng.normal(size=(3, 16, 40)).astype(
            np.float32)},
    }


def _specs(mod, norm="l1inf", every_k=1):
    return (mod.ProjectionSpec(pattern=r"enc1/w", norm=norm, radius=2.0,
                               axis=1, every_k=every_k),
            mod.ProjectionSpec(pattern=r"mlp_w1", norm=norm, radius=1.5,
                               axis=0, every_k=every_k))


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _assert_trees(tj, tt, tol):
    flat_j = {leaf_path_str(p): np.asarray(l, np.float32)
              for p, l in jax.tree_util.tree_flatten_with_path(tj)[0]}
    flat_t = dict(flatten_with_path(tt))
    assert set(flat_j) == set(flat_t)
    for k, v in flat_t.items():
        np.testing.assert_allclose(v.float().numpy(), flat_j[k], atol=tol,
                                   rtol=tol, err_msg=k)


def _assert_state(sj, st, tol=5e-6):
    assert set(sj) == set(st)
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   atol=tol, rtol=tol, err_msg=k)


def test_plans_match_jax():
    P = _np_params()
    pj, pt = _both(P)
    plans_j, per_j = JC.build_packed_plans(pj, _specs(JC))
    plans_t, per_t = TC.build_packed_plans(pt, _specs(TC))
    assert [p.key for p in plans_t] == [p.key for p in plans_j]
    for a, b in zip(plans_t, plans_j):
        np.testing.assert_array_equal(a.seg_ids(), b.seg_ids())
        np.testing.assert_array_equal(a.radii(), b.radii())
        assert (a.n_max, a.total_cols, a.num_segments) == \
            (b.n_max, b.total_cols, b.num_segments)
        assert [(e.index, e.col_start, e.seg_start, e.transpose)
                for e in a.entries] == \
            [(e.index, e.col_start, e.seg_start, e.transpose)
             for e in b.entries]
    assert per_t == per_j == []


@pytest.mark.parametrize("solver,jax_solver", SOLVERS)
@pytest.mark.parametrize("warm", [False, True])
def test_apply_matches_jax(solver, jax_solver, warm):
    pj, pt = _both(_np_params(1))
    ej = JC.ProjectionEngine(_specs(JC), solver=jax_solver)
    et = TC.ProjectionEngine(_specs(TC), solver=solver)
    sj, st = ej.init_state(pj), et.init_state(pt)
    if warm:       # carried theta state, overshooting on purpose
        _, sj = JC.ProjectionEngine(_specs(JC)).apply(pj, state=sj)
        sj = {k: v * 1.5 for k, v in sj.items()}
        st = {k: torch.tensor(np.asarray(v)) for k, v in sj.items()}
    oj, sj2 = ej.apply(pj, state=sj)
    ot, st2 = et.apply(pt, state=st)
    _assert_trees(oj, ot, 5e-6)
    _assert_state(sj2, st2)


@pytest.mark.parametrize("solver,jax_solver", SOLVERS)
def test_projected_update_matches_jax(solver, jax_solver):
    P = _np_params(2)
    rng = np.random.default_rng(20)
    G = {k: {kk: (rng.normal(size=vv.shape) * 0.1).astype(np.float32)
             for kk, vv in v.items()} for k, v in P.items()}
    mask = {k: {kk: np.ones(vv.shape, np.float32) for kk, vv in v.items()}
            for k, v in P.items()}
    mask["enc1"]["w"][:, :10] = 0.0
    pj, pt = _both(P)
    gj, gt = _both(G)
    mj, mt = _both(mask)
    aj, at = JAdam(lr=1e-2, weight_decay=0.1), TAdam(lr=1e-2,
                                                     weight_decay=0.1)
    oj = jadam_init(pj, aj)
    # a non-trivial carried Adam state: one unprojected step on JAX
    _, oj = jadam_update(gj, oj, pj, aj)
    ot = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, oj), "cpu")
    ej = JC.ProjectionEngine(_specs(JC), solver=jax_solver)
    et = TC.ProjectionEngine(_specs(TC), solver=solver)
    sj = ej.init_state(pj)
    st = et.init_state(pt)
    for _ in range(3):
        pj, oj, sj = ej.projected_update(gj, oj, pj, aj, mask=mj, state=sj)
        pt, ot, st = et.projected_update(gt, ot, pt, at, mask=mt, state=st)
    _assert_trees(pj, pt, 1e-5)
    _assert_trees(oj.mu, ot.mu, 1e-6)
    _assert_trees(oj.nu, ot.nu, 1e-6)
    assert int(ot.count) == int(oj.count) == 4
    _assert_state(sj, st, 1e-5)
    assert (pt["enc1"]["w"][:, :10] == 0).all()


def test_every_k_gating_matches_jax():
    pj, pt = _both(_np_params(3))
    ej = JC.ProjectionEngine(_specs(JC, every_k=2))
    et = TC.ProjectionEngine(_specs(TC, every_k=2))
    for step in (1, 2):
        oj, sj = ej.apply(pj, step=jnp.asarray(step), state=ej.init_state(pj))
        ot, st = et.apply(pt, step=torch.tensor(step),
                          state=et.init_state(pt))
        _assert_trees(oj, ot, 5e-6)
        _assert_state(sj, st)
        projected = not np.array_equal(ot["enc1"]["w"].numpy(),
                                       pt["enc1"]["w"].numpy())
        assert projected == (step % 2 == 0)


@pytest.mark.parametrize("norm", ["l1", "l1inf_sorted"])
def test_per_leaf_norms_match_jax(norm):
    pj, pt = _both(_np_params(4))
    specs_j = (JC.ProjectionSpec(pattern=r"mlp_w1", norm=norm, radius=1.5),)
    specs_t = (TC.ProjectionSpec(pattern=r"mlp_w1", norm=norm, radius=1.5),)
    oj = JC.apply_constraints(pj, specs_j)
    ot = TC.apply_constraints(pt, specs_t)
    _assert_trees(oj, ot, 5e-5)
    oj, _ = JC.ProjectionEngine(specs_j).apply(pj)
    ot, _ = TC.ProjectionEngine(specs_t).apply(pt)
    _assert_trees(oj, ot, 5e-5)


def test_counters_per_plan():
    _, pt = _both(_np_params(5))
    TC.engine_counters_reset()
    TC.ProjectionEngine(_specs(TC)).apply(pt)
    TC.ProjectionEngine(_specs(TC), solver="kernel").apply(pt)
    TC.ProjectionEngine(_specs(TC), solver="fused").apply(pt)
    assert TC.engine_counters() == {"l1inf_packed/k1/newton": 2,
                                    "l1inf_packed/k1/kernel": 1}
    TC.engine_counters_reset()
    assert TC.engine_counters() == {}


def test_solver_validation():
    with pytest.raises(ValueError):
        TC.ProjectionEngine(_specs(TC), solver="magic")
    for solver in ("sharded", "fused_sharded"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TC.ProjectionEngine(_specs(TC), solver=solver)
    with pytest.raises(ValueError):
        TC.ProjectionSpec(pattern="x", norm="bilevel")    # not ported yet


def test_fused_branch_is_not_silently_newton(monkeypatch):
    """A family that streams its statistics would take the fused step;
    until its kernels are ported the engine says so instead of quietly
    solving with Newton."""
    monkeypatch.setattr(Tl1inf._PlainSegOps, "from_colstats",
                        staticmethod(lambda s, m, w: None), raising=False)
    P = _np_params(6)
    _, pt = _both(P)
    _, gt = _both(P)
    et = TC.ProjectionEngine(_specs(TC), solver="fused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        et.projected_update(gt, adam_init(pt), pt, TAdam(),
                            state=et.init_state(pt))


def test_masks_and_reports_match_jax():
    P = _np_params(7)
    P["enc1"]["w"][3] = 0.0
    P["blocks"]["mlp_w1"][1, :, 5] = 0.0
    pj, pt = _both(P)
    specs_j, specs_t = _specs(JC), _specs(TC)
    _assert_trees(JC.column_masks(pj, specs_j),
                  TC.column_masks(pt, specs_t), 0)
    assert TC.sparsity_report(pt, specs_t) == pytest.approx(
        JC.sparsity_report(pj, specs_j))
    _assert_trees(JC.apply_masks(pj, JC.column_masks(pj, specs_j)),
                  TC.apply_masks(pt, TC.column_masks(pt, specs_t)), 0)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (None, 0.1), (0.05, 0.3)])
def test_adam_update_matches_jax(clip, wd):
    P = _np_params(8)
    rng = np.random.default_rng(80)
    G = {k: {kk: rng.normal(size=vv.shape).astype(np.float32)
             for kk, vv in v.items()} for k, v in P.items()}
    mask = {k: {kk: (rng.uniform(size=vv.shape) > 0.3).astype(np.float32)
                for kk, vv in v.items()} for k, v in P.items()}
    pj, pt = _both(P)
    gj, gt = _both(G)
    mj, mt = _both(mask)
    aj = JAdam(lr=1e-2, clip_norm=clip, weight_decay=wd)
    at = TAdam(lr=1e-2, clip_norm=clip, weight_decay=wd)
    oj, ot = jadam_init(pj, aj), adam_init(pt, at)
    for _ in range(3):
        pj, oj = jadam_update(gj, oj, pj, aj, mask=mj)
        pt, ot = adam_update(gt, ot, pt, at, mask=mt)
    _assert_trees(pj, pt, 1e-5)
    _assert_trees(oj.mu, ot.mu, 1e-6)
    _assert_trees(oj.nu, ot.nu, 1e-6)
    # the weight-decay-under-mask rule: frozen entries do not move at all
    for name, p in flatten_with_path(pt):
        frozen = dict(flatten_with_path(mt))[name] == 0
        np.testing.assert_array_equal(
            p.numpy()[frozen.numpy()],
            dict(flatten_with_path(params_from_numpy(P, "cpu")))[name]
            .numpy()[frozen.numpy()])


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("cosine_with_warmup", (1e-2, 5, 40)),
    ("step_decay", (1e-2, 0.5, 7)),
])
def test_schedules_match_jax(name, args):
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule as tsched
    fj, ft = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        np.testing.assert_allclose(float(ft(torch.tensor(step))),
                                   float(fj(jnp.asarray(step))), rtol=1e-6)
