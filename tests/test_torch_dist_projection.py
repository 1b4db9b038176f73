"""The port's mesh-resident projection (``repro_torch.dist.projection``,
``ProjectionEngine(solver="sharded" | "fused_sharded", mesh=)``) on
spawned gloo rank groups on the CPU: 2 ranks (a (2, 1) data x model mesh)
and 4 ranks (2 x 2).

Each group runs once per mesh (``tests/_dist_ranks.py``): every family of
the registry through the sharded ``apply`` (a stacked FSDP leaf, row- and
column-sharded leaves, a replicated one, a leaf of 27 columns no mesh here
divides, a leaf projected over its trailing dim, a column-sharded Hoyer
leaf), the fused step for bilevel and l1,2 with the theta warm start
crossing between ``fused`` and ``fused_sharded``, the plain-l1,inf
fallback, ``projection_engine_for`` and the ``grad_reduce`` composition.
The tests hold what the ranks return:

* against the port's single-device solve at the reference's sharded-vs-
  gathered tolerances (``tests/test_multidevice.py``: params 1e-5, theta
  1e-6), moments of the fused step bit-equal (no global-norm clip; with
  it, the clip's cross-rank sum rounds otherwise);
* against JAX's gathered solve at 1e-5, and once against JAX's own
  ``project_plan_sharded`` on 4 host devices (a subprocess: theta and
  iterations);
* on the collectives: zero all-gathers, one all-to-all each way per leaf
  that is not already in its column block, and per plan one (3, G) SUM,
  one (2, G) SUM per Newton evaluation and one (G,) MAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.core as JC
from repro.core.constraints import leaf_path_str
from repro.optim import AdamConfig as JAdam, adam_init as jadam_init
import repro_torch.core as TC
from repro_torch.core.l1inf import project_l1inf_segmented
from repro_torch._tree import flatten_with_path
from repro_torch.convert import params_from_numpy
from repro_torch.optim import AdamConfig, adam_init

import _dist_ranks as R

MESHES = [(2, 1), (2, 2)]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, rank by rank, for each mesh."""
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp(f"ranks{shape[0]}x{shape[1]}")
        out[shape] = R.run_ranks("all_cases", shape[0] * shape[1], shape,
                                 work)
    return out


def _flat(tree):
    return {k: v for k, v in flatten_with_path(tree)}


def _assembled(rank_results, shape_of):
    keys = rank_results[0].keys()
    return {k: R.assemble([r[k] for r in rank_results], shape_of[k])
            for k in keys}


def _np_flat(np_tree):
    return {k: v for k, v in flatten_with_path(np_tree)}


def _port_apply(specs):
    P = R.projection_np()
    pt = params_from_numpy(P, "cpu")
    eng = TC.ProjectionEngine(specs)
    out, st, stats = eng.apply(pt, state=eng.init_state(pt),
                               with_stats=True)
    return ({k: v.numpy() for k, v in _flat(out).items()},
            {k: v.numpy() for k, v in st.items()}, stats)


def _sharded(ranks, shape):
    rs = [r["projection"] for r in ranks[shape]]
    shapes = {k: v.shape for k, v in _np_flat(R.projection_np()).items()}
    return rs, _assembled([r["pieces"] for r in rs], shapes)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_apply_matches_single_device(ranks, shape):
    """Every family, every layout: params within 1e-5, theta within 1e-6
    of the port's single-device solve; the Newton counts equal or one
    apart (summation order can move the last step)."""
    rs, got = _sharded(ranks, shape)
    want, theta, iters = _port_apply(R.projection_specs(TC))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    for r in rs:
        assert set(r["theta"]) == set(theta)
        for k in theta:
            np.testing.assert_allclose(r["theta"][k], theta[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            assert abs(r["iters"][k] - iters[k]) <= 1, (k, r["iters"][k],
                                                        iters[k])
        # every rank holds the same theta, bit for bit
        for k in theta:
            assert np.array_equal(r["theta"][k], rs[0]["theta"][k])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_apply_matches_jax(ranks, shape):
    _, got = _sharded(ranks, shape)
    P = R.projection_np()
    pj = jax.tree_util.tree_map(jnp.asarray, P)
    eng = JC.ProjectionEngine(R.projection_specs(JC))
    out, _ = eng.apply(pj, state=eng.init_state(pj))
    for p, v in jax.tree_util.tree_flatten_with_path(out)[0]:
        k = leaf_path_str(p)
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_warm_start(ranks, shape):
    """The theta state threads back in: the warm solve lands on the same
    theta in the 2 bootstrap evaluations."""
    for r in (x["projection"] for x in ranks[shape]):
        for k, th in r["theta"].items():
            np.testing.assert_allclose(r["theta_warm"][k], th, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            assert r["iters_warm"][k] == 2 <= r["iters"][k], k


@pytest.mark.parametrize("shape", MESHES)
def test_one_stacked_sum_per_newton_evaluation(ranks, shape):
    for r in (x["projection"] for x in ranks[shape]):
        assert r["allreduces"] in R.newton_calls(r["plans"], r["iters"])


@pytest.mark.parametrize("shape", MESHES)
def test_cap_exit_reevaluates_with_one_more_sum(ranks, shape):
    """A solve stopped at max_iter while theta still moves re-evaluates
    the water level once, as the reference does: one (2, G) SUM more than
    its iteration count, and the blocks and theta of the single-device
    solve under the same cap."""
    Y, sids, C = R.capped_np()
    X, theta, iters = project_l1inf_segmented(
        torch.from_numpy(Y), torch.from_numpy(sids), torch.from_numpy(C),
        num_segments=2, max_iter=2)
    full = project_l1inf_segmented(
        torch.from_numpy(Y), torch.from_numpy(sids), torch.from_numpy(C),
        num_segments=2)[1]
    assert iters == 2 and not torch.equal(full, theta)     # still moving
    for r in (x["capped"] for x in ranks[shape]):
        assert r["iters"] == 2
        assert r["allreduces"] == R.newton_calls([("k", 2)], {"k": 2},
                                                 max_iter=2)[1]
        np.testing.assert_allclose(r["theta"], theta.numpy(), rtol=1e-6,
                                   atol=1e-6)
        lo, hi = r["cols"]
        np.testing.assert_allclose(r["X"], X.numpy()[:, lo:hi], atol=1e-5,
                                   rtol=1e-5)


# leaves that do not sit in their column block: one all-to-all each way
# for a leaf sharded on every mesh dim, one in (its result stays
# column-sharded) for one replicated over a mesh dim
MOVES = {(2, 1): 2 * 3,          # blocks/w1, enc/w, tr/w
         (2, 2): 2 * 2 + 1}      # blocks/w1, enc/w; tr/w half replicated


@pytest.mark.parametrize("shape", MESHES)
def test_leaves_move_by_all_to_all_never_all_gather(ranks, shape):
    for r in (x["projection"] for x in ranks[shape]):
        assert r["comm"]["all_gather"] == 0, r["comm"]
        assert r["comm"]["all_to_all"] == MOVES[shape], r["comm"]
        assert r["comm"]["all_reduce"] == len(r["allreduces"])


@pytest.mark.parametrize("shape", MESHES)
def test_output_layouts(ranks, shape):
    """Sharded leaves come back in their own layout, a replicated leaf
    column-sharded (the reference's out_specs: no gather), and the
    replicated leaf whose columns the mesh does not divide whole."""
    rs, _ = _sharded(ranks, shape)
    for r in rs:
        pieces = r["pieces"]
        for k, pl in R.PLACEMENTS[shape].items():
            names = pieces[k][2]
            if k == "odd/w":
                assert names == ("Replicate",) * 2, names
            elif pl is None:
                assert names == ("Shard",) * 2, (k, names)
            elif k == "tr/w" and shape == (2, 2):
                assert names == ("Shard",) * 2, (k, names)
            else:
                assert names == tuple("Shard" if p[0] == "S" else
                                      "Replicate" for p in pl), (k, names)


@pytest.mark.parametrize("shape", MESHES)
def test_nondivisible_leaf_warns_and_counts_once(ranks, shape):
    """odd/w (27 columns) is replicated with a warning; its plan's theta
    equals the single-device one, so its columns counted once."""
    _, theta, _ = _port_apply(R.projection_specs(TC))
    for r in (x["projection"] for x in ranks[shape]):
        assert any("(16, 27)" in w for w in r["warnings"]), r["warnings"]
        np.testing.assert_allclose(r["theta"]["l1inf_masked_packed/k1"],
                                   theta["l1inf_masked_packed/k1"],
                                   rtol=1e-6, atol=1e-6)


def _fused_single(norm, clip_norm, grads_np=None):
    P, G = R.fused_np()
    specs = R.fused_specs(TC, norm, P)
    pt = params_from_numpy(P, "cpu")
    gt = params_from_numpy(G if grads_np is None else grads_np, "cpu")
    acfg = AdamConfig(lr=1e-3, clip_norm=clip_norm)
    eng = TC.ProjectionEngine(specs, solver="fused")
    p, o, s, it = eng.projected_update(gt, adam_init(pt, acfg), pt, acfg,
                                       state=eng.init_state(pt),
                                       with_stats=True)
    return ({k: v.numpy() for k, v in _flat(p).items()},
            {k: v.numpy() for k, v in s.items()}, it)


def _fused_shapes():
    return {k: v.shape for k, v in _np_flat(R.fused_np()[0]).items()}


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_matches_fused(ranks, shape, norm):
    """One step: params within 1e-5 and theta within 1e-6 of the single-
    device fused step, Adam moments bit-equal on every rank's block (rows
    resident), the Newton counts equal."""
    for r in (x["fused"][norm] for x in ranks[shape]):
        assert r["params"][0] <= 1e-5, r["params"]
        assert r["mu"][1] and r["nu"][1], (r["mu"], r["nu"])
        th_s, th_r = r["theta"]
        for k in th_r:
            np.testing.assert_allclose(th_s[k], th_r[k], rtol=1e-6,
                                       atol=1e-6)
        assert r["iters"][0] == r["iters"][1]


@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_with_global_norm_clip(ranks, shape):
    """The default clip (1.0): its scale is one all-reduced sum of squares
    over the ranks' pieces; params and theta within the tolerances."""
    for x in ranks[shape]:
        for norm in ("bilevel", "l12"):
            r = x["fused_clip"][norm]
            assert r["params"][0] <= 1e-5, (norm, r["params"])
            assert r["mu"][0] <= 1e-6 and r["nu"][0] <= 1e-8, norm
            th_s, th_r = r["theta"]
            for k in th_r:
                np.testing.assert_allclose(th_s[k], th_r[k], rtol=1e-6,
                                           atol=1e-6)
            assert r["allreduces"][0] == ((1,), "SUM")   # the clip's sum


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_warm_start_across_solver_switch(ranks, shape, norm):
    """Step 2 takes the single-device solver's theta: params and theta
    match the single-device step 2, in no more evaluations than cold."""
    for r in (x["fused"][norm] for x in ranks[shape]):
        assert r["step2_params"][0] <= 1e-5, r["step2_params"]
        th_s, th_r = r["step2_theta"]
        for k in th_r:
            np.testing.assert_allclose(th_s[k], th_r[k], rtol=1e-6,
                                       atol=1e-6)
        (k,) = r["iters"][0]
        assert r["step2_iters"][0][k] <= r["iters"][0][k]
        assert r["step2_iters"][0] == r["step2_iters"][1]


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_collectives(ranks, shape, norm):
    """The fused passes and the Newton on column blocks: one counter
    under fused_sharded, zero all-gathers, seven all-to-alls per moved
    leaf (g, m, v, p in; p, m, v out), the Newton's one (2, G) SUM per
    evaluation."""
    for r in (x["fused"][norm] for x in ranks[shape]):
        (key,) = r["iters"][0]
        assert r["counters"] == {f"{key}/fused_sharded": 1}
        assert r["comm"]["all_gather"] == 0
        assert r["comm"]["all_to_all"] == 7 * 2     # enc1/w, blocks/w
        (G,) = r["num_segments"]
        assert r["allreduces"] in R.newton_calls([(key, G)], r["iters"][0])


@pytest.mark.parametrize("norm", ["bilevel", "l12"])
def test_fused_sharded_matches_jax(ranks, norm):
    P, G = R.fused_np()
    pj, gj = (jax.tree_util.tree_map(jnp.asarray, t) for t in (P, G))
    acfg = JAdam(lr=1e-3, clip_norm=None)
    eng = JC.ProjectionEngine(R.fused_specs(JC, norm, P), solver="fused")
    p, _, _ = eng.projected_update(gj, jadam_init(pj, acfg), pj, acfg,
                                   state=eng.init_state(pj))
    want = {leaf_path_str(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    for shape in MESHES:
        got = _assembled([x["fused"][norm]["pieces"] for x in ranks[shape]],
                         _fused_shapes())
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-5,
                                       err_msg=(shape, k))


@pytest.mark.parametrize("shape", MESHES)
def test_plain_l1inf_falls_back_to_sharded_bit_equal(ranks, shape):
    for x in ranks[shape]:
        assert x["fused"]["fallback_bit_equal"]


@pytest.mark.parametrize("shape", MESHES)
def test_projection_engine_for_on_a_mesh(ranks, shape):
    for x in ranks[shape]:
        assert x["fused"]["engine_for"] == ("fused_sharded", True, "fused")


@pytest.mark.parametrize("shape", MESHES)
def test_grad_reduce_composes_with_fused_sharded(ranks, shape):
    """Per-rank partial gradients summed by ``compressed_psum`` inside the
    step: mode "none" bit-equal to the step on the summed gradient and
    within 1e-5 of the single-device fused step on it; the Newton's
    all-reduces unchanged by the mode; int8 within 1e-2."""
    xs = ranks[shape]
    c0 = xs[0]["fused"]["composed"]
    summed = c0["summed"]
    want, theta, iters = _fused_single("bilevel", None, summed)
    shapes = _fused_shapes()
    none = _assembled([x["fused"]["composed"]["none"]["pieces"] for x in xs],
                      shapes)
    direct = _assembled([x["fused"]["composed"]["direct_pieces"]
                         for x in xs], shapes)
    int8 = _assembled([x["fused"]["composed"]["int8"]["pieces"] for x in xs],
                      shapes)
    for k, v in want.items():
        assert np.array_equal(none[k], direct[k]), k
        np.testing.assert_allclose(none[k], v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert float(np.abs(int8[k] - v).max()) < 1e-2, k
    for x in xs:
        c = x["fused"]["composed"]
        for mode in ("none", "int8"):
            (key,) = c[mode]["iters"]
            calls = c[mode]["allreduces"]
            assert any(calls[-len(want):] == want for want in R.newton_calls(
                [(key, 4)], c[mode]["iters"])), mode
        np.testing.assert_allclose(c["none"]["theta"][key], theta[key],
                                   rtol=1e-6, atol=1e-6)


_JAX_SHARDED = r'''
import json
import numpy as np, jax, jax.numpy as jnp
import repro
from repro.core import build_packed_plans
from repro.dist.projection import project_plan_sharded
import _dist_ranks as R
import repro.core as JC

params = jax.tree_util.tree_map(jnp.asarray, R.projection_np())
plans, _ = build_packed_plans(params, R.projection_specs(JC))
leaves = jax.tree_util.tree_leaves(params)
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for plan in plans:
    fn = jax.jit(lambda *v, plan=plan: project_plan_sharded(
        list(v), plan, mesh)[1:])
    theta, iters = fn(*[leaves[e.index] for e in plan.entries])
    out[plan.key] = [np.asarray(theta).tolist(), int(iters)]
print("RESULT " + json.dumps(out))
'''


def test_sharded_matches_jax_project_plan_sharded_on_4_devices(ranks):
    """The 2 x 2 mesh's theta and Newton counts against JAX's own
    sharded solve on 4 host devices, plan by plan."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(_ROOT, "src"),
                    os.path.join(_ROOT, "tests")]))
    res = subprocess.run([sys.executable, "-c", _JAX_SHARDED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")]
    jax_out = json.loads(line[-1][len("RESULT "):])
    r = ranks[(2, 2)][0]["projection"]
    assert set(jax_out) == set(r["theta"])
    for k, (theta, iters) in jax_out.items():
        np.testing.assert_allclose(r["theta"][k], np.float32(theta),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert abs(r["iters"][k] - iters) <= 1, (k, r["iters"][k], iters)
