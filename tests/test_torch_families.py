"""The port's constraint-family registry against ``repro.core.families``.

Twin of ``tests/test_family_conformance.py`` and of the family parts of
``tests/test_families.py``. Every family the port registers runs the JAX
harness's adversarial cases (n = 1, m = 1, ragged, exact ties, bf16, all
zeros) through its per-leaf projection, which is held against the JAX
family's projection and the port's own independent reference at the
harness's tolerances (5e-6, hoyer's distance metric 5e-3, bf16 5e-2),
plus feasibility, idempotence and identity inside the ball. Packable
families also run through the engine's ``newton`` and ``kernel`` solvers
(the kernel solver on the CPU takes the kernels' plain versions) against
the per-leaf path and the JAX engine. ``project_bilevel_kernel_segmented``
is held against the JAX ``project_bilevel_pallas_segmented`` in interpret
mode.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core as JC
from repro.core import families as JF
from repro.kernels.l1inf.ops import project_bilevel_pallas_segmented
import repro_torch.core as TC
from repro_torch.core import families as TF
from repro_torch.kernels.l1inf.ops import project_bilevel_kernel_segmented
from repro_torch._tree import flatten_with_path, leaves


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(a, b, tol, msg=""):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol,
                               err_msg=msg)


def _masked_feas(Y, X, C, axis, w, loose):
    Yf = Y.float()
    if float(TC.l1inf_norm(Yf, axis=axis)) <= C:
        np.testing.assert_array_equal(_f32(X), _f32(Y))
        return
    alive = TC.l1inf_column_mask(Yf, C, axis=axis).numpy()
    bc = alive[None, :] if axis in (0, -2) else alive[:, None]
    np.testing.assert_array_equal(_f32(X), _f32(Y) * bc)


# one row per registered family, as in the JAX harness (enforced below)
CASES = {
    "l1inf": dict(norms=("l1inf", "l1inf_sorted"), weights=None,
                  tie_ref=True, ref_metric="exact", tol=5e-6),
    "l1inf_weighted": dict(norms=("l1inf_weighted",),
                           weights=lambda m: tuple(
                               float(x) for x in np.linspace(0.5, 2.0, m)),
                           tie_ref=True, ref_metric="exact", tol=5e-6),
    "l1inf_masked": dict(norms=("l1inf_masked",), weights=None,
                         tie_ref=True, ref_metric="exact", tol=5e-6,
                         feas=_masked_feas),
    "bilevel": dict(norms=("bilevel",), weights=None, tie_ref=True,
                    ref_metric="exact", tol=5e-6),
    "l12": dict(norms=("l12",), weights=None, tie_ref=True,
                ref_metric="exact", tol=5e-6),
    "hoyer": dict(norms=("hoyer",), weights=None, tie_ref=False,
                  ref_metric="distance", tol=5e-3),
}

INPUTS = [
    ((32, 32), 0, "normal"),
    ((8, 200), 0, "normal"),
    ((200, 8), 1, "normal"),
    ((1, 64), 0, "normal"),
    ((50, 1), 0, "normal"),
    ((13, 37), 0, "ties"),
    ((24, 48), 1, "ties"),
    ((24, 48), 0, "bf16"),
    ((16, 24), 0, "zeros"),
]

HOYER_S = 0.75          # hoyer's "radius" is the target sparseness ratio


def _gen(shape, kind, seed):
    """The same matrix for both packages: (torch tensor, jax array)."""
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    if kind == "ties":
        Y = np.round(Y * 2.0) / 2.0          # exact ties, exact zeros
    if kind == "zeros":
        Y = np.zeros(shape, np.float32)
    Yt, Yj = torch.tensor(Y), jnp.asarray(Y)
    if kind == "bf16":
        Yt, Yj = Yt.to(torch.bfloat16), Yj.astype(jnp.bfloat16)
    return Yt, Yj


def _cols(shape, axis):
    return shape[1] if axis in (0, -2) else shape[0]


def _weights(case, m):
    fn = case["weights"]
    return None if fn is None else np.asarray(fn(m), np.float32)


def _radius(fam, Y, axis, w, frac=0.35):
    if fam.name == "hoyer":
        return HOYER_S
    wt = None if w is None else torch.tensor(w)
    return max(frac * float(fam.norm_fn(Y.float(), axis, wt)), 1e-3)


# -----------------------------------------------------------------------------
# fail-loudly coverage
# -----------------------------------------------------------------------------

def test_registry_coverage_fails_loudly():
    """Registering a torch family without a CASES row fails here, and the
    port registers exactly the JAX package's families and norms."""
    missing = set(TF.family_names()) - set(CASES)
    assert not missing, (
        f"torch families registered without conformance coverage: "
        f"{sorted(missing)} — add a CASES row in tests/test_torch_families.py")
    extra = set(CASES) - set(TF.family_names())
    assert not extra, f"CASES rows for unregistered families: {sorted(extra)}"
    covered = {n for c in CASES.values() for n in c["norms"]}
    assert TF.registered_norms() <= covered, sorted(
        TF.registered_norms() - covered)
    for name, case in CASES.items():
        fam, jfam = TF.get_family(name), JF.get_family(name)
        assert set(case["norms"]) == set(fam.norms) == set(jfam.norms)
        assert fam.uses_weights == jfam.uses_weights
        assert (fam.seg_ops is None) == (jfam.seg_ops is None)
        assert (fam.feasible is None) == (jfam.feasible is None)
        for hook in ("from_colstats", "colstats_stat", "fused_mode",
                     "fused_scale"):
            assert hasattr(fam.seg_ops, hook) == hasattr(jfam.seg_ops, hook)
    assert TF.family_names() == JF.family_names()
    assert TF.packable_norms() == JF.packable_norms()
    assert TF.registered_norms() == JF.registered_norms()


# -----------------------------------------------------------------------------
# per-leaf battery
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("fname", sorted(CASES))
def test_leaf_conformance(fname):
    fam, jfam = TF.get_family(fname), JF.get_family(fname)
    case = CASES[fname]
    for si, (shape, axis, kind) in enumerate(INPUTS):
        Y, Yj = _gen(shape, kind, seed=100 + si)
        w = _weights(case, _cols(shape, axis))
        wt = None if w is None else torch.tensor(w)
        C = _radius(fam, Y, axis, w)
        X = fam.project_leaf(Y, C, axis, wt)
        ctx = f"{fname} {shape} axis={axis} {kind}"
        assert tuple(X.shape) == shape and X.dtype == Y.dtype, ctx
        loose = kind == "bf16"
        tol = 5e-2 if loose else case["tol"]
        Xj = jfam.project_leaf(Yj, C, axis,
                               None if w is None else jnp.asarray(w))
        if case["ref_metric"] == "exact":
            _tol(X, Xj, tol, ctx + " (vs JAX)")
        Xf = X.float()
        if case.get("feas") is not None:
            case["feas"](Y, X, C, axis, wt, loose)
        elif fam.feasible is not None:
            if loose:
                assert float(fam.norm_fn(Xf, axis, wt)) >= C - 2e-2, ctx
            else:
                assert fam.feasible(Xf, C, axis, wt), ctx
        else:
            nX = float(fam.norm_fn(Xf, axis, wt))
            nY = float(fam.norm_fn(Y.float(), axis, wt))
            assert nX <= C * (1 + (3e-2 if loose else 1e-4)), ctx
            if nY > C * 1.01:           # binding: KKT puts X on the sphere
                assert nX >= C * (1 - (3e-2 if loose else 1e-3)), ctx
        if case["tie_ref"] or kind != "ties":
            Xr = fam.reference(Y, C, axis, wt)
            if case["ref_metric"] == "distance":
                Yn = _f32(Y)
                d = np.sum((Yn - _f32(X)) ** 2, axis=axis)
                for other in (Xr, Xj):
                    d_ref = np.sum((Yn - _f32(other)) ** 2, axis=axis)
                    assert np.all(d <= d_ref * (1 + tol) + 1e-6), ctx
            else:
                _tol(X, Xr, tol, ctx + " (vs reference)")
        X2 = fam.project_leaf(X, C, axis, wt)
        _tol(X2, X, tol, ctx + " (idempotence)")
        if kind == "zeros":
            np.testing.assert_array_equal(_f32(X), _f32(Y), err_msg=ctx)


@pytest.mark.parametrize("fname", sorted(CASES))
def test_leaf_identity_inside_ball(fname):
    fam = TF.get_family(fname)
    case = CASES[fname]
    Y, _ = _gen((24, 40), "normal", seed=7)
    w = _weights(case, 40)
    wt = None if w is None else torch.tensor(w)
    if fname == "hoyer":
        Y = fam.project_leaf(Y, HOYER_S, 0, wt)
        X = fam.project_leaf(Y, HOYER_S - 0.1, 0, wt)
    else:
        X = fam.project_leaf(Y, 2.0 * float(fam.norm_fn(Y, 0, wt)), 0, wt)
    np.testing.assert_array_equal(_f32(X), _f32(Y))


# -----------------------------------------------------------------------------
# packed battery: the engine's solvers, warm starts, theta against JAX
# -----------------------------------------------------------------------------

PACKABLE = tuple(f for f in sorted(CASES)
                 if TF.get_family(f).seg_ops is not None)


def _ragged_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((20, 30)) * 2).astype(np.float32),
            "b": (rng.standard_normal((3, 12, 18)) * 2).astype(np.float32),
            "c": (rng.standard_normal((20, 5)) * 2).astype(np.float32)}


def _specs_for(mod, fname, params, frac=0.3):
    fam = TF.get_family(fname)
    case = CASES[fname]
    specs = []
    for k in sorted(params):
        v = params[k]
        wt = case["weights"](v.shape[-1]) if case["weights"] else None
        wj = None if wt is None else torch.tensor(wt, dtype=torch.float32)
        nv = min(float(fam.norm_fn(torch.tensor(s), 0, wj))
                 for s in v.reshape((-1,) + v.shape[-2:]))
        kw = {"weights": wt} if wt is not None else {}
        specs.append(mod.ProjectionSpec(pattern=rf"^{k}$",
                                        norm=case["norms"][0],
                                        radius=max(frac * nv, 1e-3), **kw))
    return tuple(specs)


@pytest.mark.parametrize("fname", PACKABLE)
def test_packed_solvers_conformance(fname):
    """Every packable family through the port's newton and kernel solvers:
    matches the per-leaf path and the JAX engine, warm restarts in the
    bootstrap pair, and one theta that both solvers and JAX agree on."""
    P = _ragged_params()
    pt = {k: torch.tensor(v) for k, v in P.items()}
    pj = {k: jnp.asarray(v) for k, v in P.items()}
    specs = _specs_for(TC, fname, P)
    ref = TC.apply_constraints(pt, specs)
    oj, sj = JC.ProjectionEngine(_specs_for(JC, fname, P)).apply(pj)
    key = f"{fname}_packed/k1"
    has_kernel = TF.get_family(fname).kernel_loader is not None
    TC.engine_counters_reset()
    thetas = {}
    for sname in ("newton", "kernel"):
        eng = TC.ProjectionEngine(specs, solver=sname)
        st0 = eng.init_state(pt)
        assert set(st0) == {key}
        out, st, _ = eng.apply(pt, state=st0, with_stats=True)
        tol = 5e-4 if (sname == "kernel" and has_kernel) else 5e-6
        for r, o in zip(leaves(ref), leaves(out)):
            _tol(r, o, tol, f"{fname}/{sname}")
        for k in P:
            _tol(out[k], oj[k], tol, f"{fname}/{sname} vs JAX")
        thetas[sname] = st[key]
        _, _, stats2 = eng.apply(pt, state=st, with_stats=True)
        if not (sname == "kernel" and has_kernel):   # kernel iters = -1
            assert stats2[key] <= 2, (fname, sname, stats2)
    counts = TC.engine_counters()
    for sname in ("newton", "kernel"):
        assert counts[f"{key}/{sname}"] == 2, counts
    assert "per_leaf" not in counts, counts
    _tol(thetas["newton"], sj[key], 1e-5)
    _tol(thetas["newton"], thetas["kernel"], 1e-3 if has_kernel else 1e-6)


def test_weighted_packed_heterogeneous_weights_match_jax():
    P = _ragged_params(3)
    wa = tuple(np.linspace(0.5, 3.0, 30))
    wc = tuple(np.linspace(2.0, 1.0, 5))

    def specs(mod):
        return (mod.ProjectionSpec(pattern=r"^a$", norm="l1inf_weighted",
                                   radius=4.0, weights=wa),
                mod.ProjectionSpec(pattern=r"^c$", norm="l1inf_weighted",
                                   radius=2.0, weights=wc))
    pt = {k: torch.tensor(v) for k, v in P.items()}
    pj = {k: jnp.asarray(v) for k, v in P.items()}
    (plan_t,), _ = TC.build_packed_plans(pt, specs(TC))
    (plan_j,), _ = JC.build_packed_plans(pj, specs(JC))
    np.testing.assert_array_equal(plan_t.col_weights(), plan_j.col_weights())
    ot, st = TC.ProjectionEngine(specs(TC)).apply(pt)
    oj, sj = JC.ProjectionEngine(specs(JC)).apply(pj)
    for k in P:
        _tol(ot[k], oj[k], 5e-6, k)
    _tol(st["l1inf_weighted_packed/k1"], sj["l1inf_weighted_packed/k1"],
         1e-5)
    _tol(TC.apply_constraints(pt, specs(TC))["a"], ot["a"], 5e-6)


def test_spec_weight_validation():
    with pytest.raises(ValueError, match="does not take"):
        TC.ProjectionSpec(pattern=r"w", norm="bilevel", radius=1.0,
                          weights=(1.0,))
    with pytest.raises(ValueError, match="> 0"):
        TC.ProjectionSpec(pattern=r"w", norm="l1inf_weighted", radius=1.0,
                          weights=(1.0, -2.0))
    spec = TC.ProjectionSpec(pattern=r"a", norm="l1inf_weighted",
                             radius=1.0, weights=(1.0, 2.0))
    assert spec.weights == (1.0, 2.0)
    with pytest.raises(ValueError, match="canonical columns"):
        TC.build_packed_plans({"a": torch.ones(4, 3)}, (spec,))


# -----------------------------------------------------------------------------
# per-leaf-only families, mixed plans
# -----------------------------------------------------------------------------

def test_hoyer_is_per_leaf_only_and_unfusable():
    assert "hoyer" in TF.registered_norms()
    assert "hoyer" not in TF.packable_norms()
    with pytest.raises(ValueError, match="per-leaf only"):
        TC.project_segmented_family(torch.zeros(4, 4),
                                    torch.zeros(4, dtype=torch.int32),
                                    torch.ones(1), num_segments=1,
                                    family="hoyer")
    Yt, Yj = _gen((3, 16, 8), "normal", seed=11)
    specs = (TC.ProjectionSpec(pattern=r"^h$", norm="hoyer",
                               radius=HOYER_S),)
    plans, per_leaf = TC.build_packed_plans({"h": Yt}, specs)
    assert not plans and len(per_leaf) == 1
    TC.engine_counters_reset()
    out_n, _ = TC.ProjectionEngine(specs).apply({"h": Yt})
    out_f, _ = TC.ProjectionEngine(specs, solver="fused").apply({"h": Yt})
    assert not any(k.endswith("/fused") for k in TC.engine_counters())
    assert torch.equal(out_n["h"], out_f["h"])
    out_j = JC.apply_constraints({"h": Yj}, (JC.ProjectionSpec(
        pattern=r"^h$", norm="hoyer", radius=HOYER_S),))
    _tol(out_n["h"], out_j["h"], 5e-3)
    for sl in out_n["h"]:
        assert float(TC.hoyer_sparseness(sl).min()) >= HOYER_S - 1e-4


def test_mixed_family_packing_through_projected_update():
    """l1inf + bilevel + l12 specs plus a hoyer per-leaf rider in ONE
    projected_update, against the JAX engine: one packed solve per family
    sub-buffer, warm starts under per-plan keys."""
    from repro.optim import AdamConfig as JAdam, adam_init as jadam_init
    from repro_torch.optim import AdamConfig, adam_init
    rng = np.random.default_rng(0)
    P = {"enc": {"w": rng.standard_normal((24, 50)).astype(np.float32)},
         "mlp": {"w": rng.standard_normal((3, 16, 40)).astype(np.float32)},
         "dec": {"w": rng.standard_normal((30, 20)).astype(np.float32)},
         "hoy": {"w": rng.standard_normal((16, 10)).astype(np.float32)}}
    G = {k: {"w": rng.standard_normal(d["w"].shape).astype(np.float32)}
         for k, d in P.items()}

    def specs(mod):
        return (mod.ProjectionSpec(pattern=r"enc/w", norm="l1inf",
                                   radius=4.0),
                mod.ProjectionSpec(pattern=r"mlp/w", norm="bilevel",
                                   radius=2.0, axis=1),
                mod.ProjectionSpec(pattern=r"dec/w", norm="l12", radius=3.0),
                mod.ProjectionSpec(pattern=r"hoy/w", norm="hoyer",
                                   radius=HOYER_S))
    tt = lambda t: {k: {"w": torch.tensor(d["w"])} for k, d in t.items()}
    jj = lambda t: {k: {"w": jnp.asarray(d["w"])} for k, d in t.items()}
    pt, gt, pj, gj = tt(P), tt(G), jj(P), jj(G)
    et, ej = TC.ProjectionEngine(specs(TC)), JC.ProjectionEngine(specs(JC))
    at, aj = AdamConfig(lr=1e-2), JAdam(lr=1e-2)
    ot, oj = adam_init(pt, at), jadam_init(pj, aj)
    st, sj = et.init_state(pt), ej.init_state(pj)
    assert set(st) == {"l1inf_packed/k1", "bilevel_packed/k1",
                       "l12_packed/k1"}
    assert st["bilevel_packed/k1"].shape == (3,)
    TC.engine_counters_reset()
    for _ in range(3):
        pt, ot, st = et.projected_update(gt, ot, pt, at, state=st)
        pj, oj, sj = ej.projected_update(gj, oj, pj, aj, state=sj)
    assert TC.engine_counters() == {"l1inf_packed/k1/newton": 3,
                                    "bilevel_packed/k1/newton": 3,
                                    "l12_packed/k1/newton": 3,
                                    "per_leaf": 3}
    for name, leaf in flatten_with_path(pt):
        k = name.split("/")[0]
        _tol(leaf, pj[k]["w"], 5e-3 if k == "hoy" else 1e-5, name)
    for k in st:
        _tol(st[k], sj[k], 1e-5, k)
    assert float(TC.l1inf_norm(pt["enc"]["w"])) <= 4.0 * (1 + 1e-5)
    assert float(TC.l12_norm(pt["dec"]["w"])) <= 3.0 * (1 + 1e-5)


# -----------------------------------------------------------------------------
# the new families' entry points against JAX
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bilevel", "l12"])
@pytest.mark.parametrize("warm", [False, True])
def test_newton_stats_match_jax(name, warm):
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((40, 70)).astype(np.float32)
    tfn = {"bilevel": TC.project_bilevel_stats,
           "l12": TC.project_l12_stats}[name]
    jfn = {"bilevel": JC.project_bilevel_stats,
           "l12": JC.project_l12_stats}[name]
    for axis in (0, 1):
        C = 0.2 * float(TC.get_family(name).norm_fn(torch.tensor(Y), axis))
        Xj, sj = jfn(jnp.asarray(Y), C, axis=axis)
        th0 = sj["theta"] * 1.3 if warm else None
        if warm:
            Xj, sj = jfn(jnp.asarray(Y), C, axis=axis, theta0=th0)
        Xt, st = tfn(torch.tensor(Y), C, axis=axis, theta0=None if th0 is None
                     else torch.tensor(float(th0)))
        _tol(Xt, Xj, 5e-6)
        _tol(st["theta"], sj["theta"], 1e-5)
        assert st["iters"] == int(sj["iters"])


def test_norms_and_prox_match_jax():
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((30, 45)).astype(np.float32)
    Yt, Yj = torch.tensor(Y), jnp.asarray(Y)
    for axis in (0, 1):
        _tol(TC.l12_norm(Yt, axis), JC.l12_norm(Yj, axis), 1e-6)
        _tol(TC.linf1_norm(Yt, axis), JC.linf1_norm(Yj, axis), 1e-6)
        _tol(TC.prox_linf1(Yt, 2.0, axis), JC.prox_linf1(Yj, 2.0, axis), 5e-6)
        _tol(TC.project_l12_ball(Yt, 3.0, axis),
             JC.project_l12_ball(Yj, 3.0, axis), 5e-6)
        _tol(TC.project_l12_newton(Yt, 3.0, axis),
             JC.project_l12_ball(Yj, 3.0, axis), 5e-6)
        np.testing.assert_array_equal(
            TC.l1inf_column_mask(Yt, 2.0, axis).numpy(),
            np.asarray(JC.l1inf_column_mask(Yj, 2.0, axis)))
        w = np.linspace(0.5, 2.0, Y.shape[1 - axis]).astype(np.float32)
        _tol(TC.l1inf_weighted_norm(Yt, torch.tensor(w), axis),
             JC.l1inf_weighted_norm(Yj, jnp.asarray(w), axis), 1e-6)
        _tol(TC.project_bilevel_ref(Yt, 3.0, axis),
             JC.project_bilevel_ref(Yj, 3.0, axis), 5e-6)


# -----------------------------------------------------------------------------
# project_bilevel_kernel_segmented
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
def test_bilevel_kernel_segmented_matches_jax(warm):
    """Ragged and tied segments, an inside-ball segment and dead padding,
    against the JAX Pallas engine in interpret mode (the port's kernels
    run their plain versions on the CPU)."""
    rng = np.random.default_rng(7)
    Y1 = rng.standard_normal((13, 37)).astype(np.float32)
    Y2 = (rng.standard_normal((13, 20)) * 0.01).astype(np.float32)
    Y3 = np.round(rng.standard_normal((13, 50)) * 2.0) / 2.0
    pad = np.zeros((13, 7), np.float32)
    Yp = np.concatenate([Y1, Y2, Y3.astype(np.float32), pad], axis=1)
    sids = np.array([0] * 37 + [1] * 20 + [2] * 50 + [3] * 7, np.int32)
    C = np.array([0.2 * np.abs(Y1).max(axis=0).sum(), 100.0,
                  0.3 * np.abs(Y3).max(axis=0).sum()], np.float32)
    th0 = None
    if warm:
        _, th0 = project_bilevel_pallas_segmented(
            jnp.asarray(Yp), jnp.asarray(sids), jnp.asarray(C),
            num_segments=3, interpret=True)
        th0 = np.asarray(th0) * 1.2
    Xj, thj, stj = project_bilevel_pallas_segmented(
        jnp.asarray(Yp), jnp.asarray(sids), jnp.asarray(C), num_segments=3,
        theta0=None if th0 is None else jnp.asarray(th0), interpret=True,
        return_stats=True)
    Xt, tht, stt = project_bilevel_kernel_segmented(
        torch.tensor(Yp), torch.tensor(sids), torch.tensor(C),
        num_segments=3, theta0=None if th0 is None else torch.tensor(th0),
        return_stats=True)
    _tol(Xt, Xj, 1e-5)
    _tol(tht, thj, 1e-6)
    assert stt["newton_iters"] == int(stj["newton_iters"])
    np.testing.assert_array_equal(Xt[:, 37:57].numpy(), Y2)   # identity
    np.testing.assert_array_equal(Xt[:, 107:].numpy(), 0.0)   # padding
    _tol(Xt[:, :37], TC.project_bilevel_ref(torch.tensor(Y1), float(C[0])),
         5e-5)
