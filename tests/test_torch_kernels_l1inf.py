"""The port's l1,inf kernel suite against ``repro.kernels.l1inf``.

On the CPU every wrapper runs its plain version, which repeats the CUDA
kernel's arithmetic; those are held against the JAX Pallas kernels in
interpret mode (as ``tests/test_kernels_l1inf.py`` runs them), with the
JAX suite's tolerances: colstats sums rtol 1e-5 and maxes exact, mu_solve
active sets equal, mu atol 1e-5, k equal, S rtol 1e-5; clip_apply exact.
The engines (``project_l1inf_kernel`` / ``_segmented``) are held against
``project_l1inf_pallas`` / ``_segmented(interpret=True)`` with the same
``block_m``: X to atol 1e-5, theta to 1e-6 and the five work counters
equal. One exception is fp rounding in the last Newton step: the plain
versions and the Pallas interpreter sum mu_solve's payloads in different
orders, so where one engine's theta rises by a last ulp the other may
already have stopped (reproduced at (33, 257), C = 0.02 of the norm: the
port ascends 25.930731 -> 25.930733, one ulp, and takes step 8; JAX stops
at 7). ``_stats_equal`` accepts exactly that and nothing else: one extra
Newton step, final thetas within 4 ulps, and work_cols larger by that
step's prefix, with num_active, active_cols_per_step and full_cols equal.

Tests marked ``cuda`` compare each CUDA kernel with its plain version on
the card; they skip here, with the reason, when no card is present
(``python3 chip_smoke.py`` makes the same comparisons at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.l1inf import kernel as JK
    from repro.kernels.l1inf import ref as Jref
    from repro.kernels.l1inf.ops import (project_l1inf_pallas,
                                         project_l1inf_pallas_segmented)
except ImportError:       # the card's machine has PyTorch but no JAX
    jnp = None
from repro_torch.core.l1inf import project_l1inf_newton
from repro_torch.kernels.l1inf import kernel as K
from repro_torch.kernels.l1inf import ops as O
from repro_torch.kernels.l1inf import ref
from repro_torch.kernels.l1inf.ops import (project_l1inf_kernel,
                                           project_l1inf_kernel_segmented)

@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference package, on this machine")


COUNTERS = ("newton_iters", "num_active", "active_cols_per_step",
            "work_cols", "full_cols")


def _t(x):
    return torch.tensor(np.asarray(x))


# ----------------------------- plain versions --------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (512, 128), (1024, 256),
                                   (64, 384), (5, 17)])
def test_colstats_plain_vs_pallas(shape, jax_ref):
    Y = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    s, mx = K.colstats(_t(Y))
    bn = 8 if shape[0] % 8 else min(shape[0], 512)
    bm = 128 if shape[1] % 128 == 0 else shape[1]
    if shape[0] % bn == 0 and shape[1] % bm == 0:
        sj, mj = JK.colstats(jnp.asarray(Y), block_m=bm, block_n=bn,
                             interpret=True)
    else:
        sj, mj = Jref.colstats_ref(jnp.asarray(Y))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mj))


@pytest.mark.parametrize("shape", [(16, 128), (777, 128), (96, 256)])
@pytest.mark.parametrize("theta_frac", [0.01, 0.3, 0.9])
@pytest.mark.parametrize("vector", [False, True])
def test_mu_solve_plain_vs_pallas(shape, theta_frac, vector, jax_ref):
    rng = np.random.default_rng(1)
    Y = rng.uniform(0, 1, size=shape).astype(np.float32)
    med = float(np.median(Y.sum(axis=0)))
    theta = (theta_frac * med * rng.uniform(0.5, 1.5, size=shape[1])
             ).astype(np.float32) if vector else np.float32(theta_frac * med)
    out = K.mu_solve(_t(Y), _t(np.asarray(theta)), block_m=128)
    outj = JK.mu_solve(jnp.asarray(Y), jnp.asarray(theta), block_m=128,
                       interpret=True)
    mu, k, S, act = (o.numpy() for o in out)
    muj, kj, Sj, actj = (np.asarray(o) for o in outj)
    np.testing.assert_array_equal(act, actj)
    np.testing.assert_allclose(mu, muj, atol=1e-5)
    np.testing.assert_array_equal(k, kj)
    np.testing.assert_allclose(S, Sj, rtol=1e-5, atol=1e-5)
    # and the sort oracle: the defining property on active columns
    mur, _, _, actr = ref.mu_solve_ref(_t(Y), _t(np.asarray(theta)))
    np.testing.assert_array_equal(act, actr.numpy())
    np.testing.assert_allclose(mu, mur.numpy(), atol=1e-5)


@pytest.mark.parametrize("nact", [0, 1, 2])
def test_mu_solve_nact_blocks_vs_pallas(nact, jax_ref):
    rng = np.random.default_rng(17)
    Y = rng.uniform(0, 1, size=(64, 256)).astype(np.float32)
    th = (0.3 * float(np.median(Y.sum(axis=0))) * rng.uniform(
        0.5, 1.5, size=256)).astype(np.float32)
    out = K.mu_solve(_t(Y), _t(th), block_m=128,
                     nact_blocks=torch.tensor(nact, dtype=torch.int32))
    outj = JK.mu_solve(jnp.asarray(Y), jnp.asarray(th), block_m=128,
                       interpret=True,
                       nact_blocks=jnp.asarray(nact, jnp.int32))
    for o, oj in zip(out, outj):
        np.testing.assert_allclose(o.numpy().astype(np.float32),
                                   np.asarray(oj, np.float32), atol=1e-5)
    mu, k, S, act = (o.numpy() for o in out)
    assert not act[nact * 128:].any()
    assert (mu[nact * 128:] == 0).all() and (k[nact * 128:] == 1).all()
    assert (S[nact * 128:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_apply_plain_vs_pallas(dtype, jax_ref):
    rng = np.random.default_rng(2)
    Y = rng.normal(size=(256, 128)).astype(np.float32)
    mu = np.abs(rng.normal(size=128)).astype(np.float32)
    Yt = _t(Y).to(getattr(torch, dtype))
    X = K.clip_apply(Yt, _t(mu))
    Xj = JK.clip_apply(jnp.asarray(Y, getattr(jnp, dtype)), jnp.asarray(mu),
                       block_m=128, block_n=256, interpret=True)
    assert X.dtype == Yt.dtype
    np.testing.assert_array_equal(X.float().numpy(),
                                  np.asarray(Xj, np.float32))


def test_wrapper_contract_errors():
    Y = torch.ones((8, 4))
    with pytest.raises(TypeError):
        K.clip_apply(Y, torch.ones((4,), dtype=torch.float64))
    with pytest.raises(ValueError):
        K.clip_apply(Y, torch.ones((5,)))
    with pytest.raises(ValueError):
        K.mu_solve(Y, torch.ones((3,)), block_m=4)
    with pytest.raises(ValueError):
        K.mu_solve(Y, 1.0, block_m=0)


def test_launch_counts_only_move_on_the_card():
    K.reset_launch_counts()
    Y = torch.rand((16, 128))
    K.colstats(Y)
    K.mu_solve(Y, 0.5)
    K.clip_apply(Y, torch.rand(128))
    project_l1inf_kernel(Y, 1.0)               # runs K.newton_loop
    assert K.launch_counts() == {"colstats": 0, "mu_solve": 0,
                                 "clip_apply": 0, "newton_loop": 0}


# ------------------------------ the engines ----------------------------------

def _stats_equal(st, sj):
    got = {k: int(st[k]) for k in COUNTERS}
    want = {k: int(sj[k]) for k in COUNTERS}
    if got["newton_iters"] != want["newton_iters"]:
        extra = got["newton_iters"] - want["newton_iters"]
        assert abs(extra) == 1, (got, want)
        th, thj = float(st["theta"]), float(sj["theta"])
        assert abs(th - thj) <= 4 * float(np.spacing(np.float32(thj))), \
            (th, thj)
        want["newton_iters"] = got["newton_iters"]
        want["work_cols"] += extra * want["active_cols_per_step"]
    assert got == want, (got, want)


@pytest.mark.parametrize("shape,block_m", [
    ((7, 5), 128), ((100, 100), 128), ((33, 257), 128), ((2, 1000), 128),
    ((1, 300), 128), ((50, 1), 128), ((130, 257), 32), ((33, 257), 32)])
@pytest.mark.parametrize("Cfrac", [0.02, 0.5])
def test_engine_vs_pallas(shape, block_m, Cfrac, jax_ref):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    Y = rng.normal(size=shape).astype(np.float32)
    C = float(Cfrac * np.abs(Y).max(axis=0).sum())
    X, st = project_l1inf_kernel(_t(Y), C, block_m=block_m,
                                 return_stats=True)
    Xj, sj = project_l1inf_pallas(jnp.asarray(Y), C, block_m=block_m,
                                  interpret=True, return_stats=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(float(st["theta"]), float(sj["theta"]),
                               atol=1e-6, rtol=1e-6)
    _stats_equal(st, sj)


@pytest.mark.parametrize("shrink", [True, False])
def test_engine_shrink_and_work_counter_vs_pallas(shrink, jax_ref):
    rng = np.random.default_rng(14)
    scale = np.exp(rng.normal(size=(1, 512)))
    Y = (rng.uniform(0, 1, size=(40, 512)) * scale).astype(np.float32)
    C = 0.01 * float(np.abs(Y).max(axis=0).sum())
    X, st = project_l1inf_kernel(_t(Y), C, block_m=128, shrink=shrink,
                                 return_stats=True)
    Xj, sj = project_l1inf_pallas(jnp.asarray(Y), C, block_m=128,
                                  shrink=shrink, interpret=True,
                                  return_stats=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    _stats_equal(st, sj)
    if shrink:
        assert int(st["active_cols_per_step"]) < int(st["full_cols"])


def _packed(seed):
    rng = np.random.default_rng(seed)
    sizes = [(40, 50), (64, 130), (24, 33)]
    n_max = max(n for n, _ in sizes)
    cols, sids, Cs = [], [], []
    for g, (n, m) in enumerate(sizes):
        Yg = rng.normal(size=(n, m)) * rng.choice([0.3, 1.0, 4.0])
        pad = np.zeros((n_max, m), np.float32)
        pad[:n] = Yg
        cols.append(pad)
        sids += [g] * m
        Cs.append(float(0.2 * np.abs(Yg).max(axis=0).sum()))
    return (np.concatenate(cols, axis=1), np.array(sids, np.int32),
            np.array(Cs, np.float32))


@pytest.mark.parametrize("seed", [16, 3])
@pytest.mark.parametrize("warm", [None, 1.0, 7.0])
def test_segmented_engine_vs_pallas(seed, warm, jax_ref):
    Y, sids, Cs = _packed(seed)
    theta0 = None
    if warm is not None:
        _, th = project_l1inf_pallas_segmented(
            jnp.asarray(Y), sids, Cs, num_segments=3, interpret=True)
        theta0 = np.asarray(th) * np.float32(warm)
    X, th, st = project_l1inf_kernel_segmented(
        _t(Y), _t(sids), _t(Cs), num_segments=3, block_m=128,
        theta0=None if theta0 is None else _t(theta0), return_stats=True)
    Xj, thj, sj = project_l1inf_pallas_segmented(
        jnp.asarray(Y), sids, Cs, num_segments=3, block_m=128,
        theta0=None if theta0 is None else jnp.asarray(theta0),
        interpret=True, return_stats=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(thj), atol=1e-6,
                               rtol=1e-6)
    _stats_equal(st, sj)
    np.testing.assert_allclose(
        X.numpy(), ref.project_l1inf_segmented_ref(Y, sids, Cs, 3),
        atol=3e-4, rtol=3e-3)


def test_segmented_inside_zero_and_padding_vs_pallas(jax_ref):
    Y, sids, Cs = _packed(5)
    Cs = np.array([1e6, -1.0, Cs[2]], np.float32)
    sids = sids.copy()
    sids[-7:] = 3                              # padding columns
    X, th = project_l1inf_kernel_segmented(_t(Y), _t(sids), _t(Cs),
                                           num_segments=3)
    Xj, thj = project_l1inf_pallas_segmented(jnp.asarray(Y), sids, Cs,
                                             num_segments=3, interpret=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(thj), rtol=1e-6)
    np.testing.assert_array_equal(X.numpy()[:, sids == 0], Y[:, sids == 0])
    np.testing.assert_array_equal(X.numpy()[:, sids == 3], Y[:, sids == 3])
    assert (X.numpy()[:, sids == 1] == 0).all()


# ----------------------------- edge cases -------------------------------------

def test_inside_ball_identity(jax_ref):
    Y = (np.random.default_rng(6).normal(size=(33, 77)) * 0.01).astype(
        np.float32)
    X = project_l1inf_kernel(_t(Y), 1e5)
    np.testing.assert_array_equal(X.numpy(), Y)
    np.testing.assert_array_equal(
        X.numpy(), np.asarray(project_l1inf_pallas(jnp.asarray(Y), 1e5,
                                                   interpret=True)))


@pytest.mark.parametrize("C", [0.0, -2.0])
def test_nonpositive_radius(C, jax_ref):
    Y = np.random.default_rng(8).normal(size=(20, 30)).astype(np.float32)
    X, st = project_l1inf_kernel(_t(Y), C, return_stats=True)
    Xj, sj = project_l1inf_pallas(jnp.asarray(Y), C, interpret=True,
                                  return_stats=True)
    assert (X.numpy() == 0).all() and (np.asarray(Xj) == 0).all()
    np.testing.assert_allclose(float(st["theta"]), float(sj["theta"]),
                               rtol=1e-6)


def test_tie_heavy_vs_pallas(jax_ref):
    Y = np.random.default_rng(11).choice([0.0, 1.0, -1.0, 2.0, 2.0],
                                         size=(40, 96)).astype(np.float32)
    norm = float(np.abs(Y).max(axis=0).sum())
    for Cfrac in (0.1, 0.45, 0.9):
        X, st = project_l1inf_kernel(_t(Y), Cfrac * norm, return_stats=True)
        Xj, sj = project_l1inf_pallas(jnp.asarray(Y), Cfrac * norm,
                                      interpret=True, return_stats=True)
        np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
        _stats_equal(st, sj)


def test_warm_start_overshoot_vs_pallas(jax_ref):
    Y = np.random.default_rng(15).normal(size=(48, 200)).astype(np.float32)
    C = float(0.2 * np.abs(Y).max(axis=0).sum())
    X, st = project_l1inf_kernel(_t(Y), C, return_stats=True)
    for factor in (1.0, 7.0):
        th0 = float(st["theta"]) * factor
        Xw, sw = project_l1inf_kernel(_t(Y), C, theta0=th0,
                                      return_stats=True)
        Xj, sj = project_l1inf_pallas(jnp.asarray(Y), C, theta0=th0,
                                      interpret=True, return_stats=True)
        np.testing.assert_allclose(Xw.numpy(), np.asarray(Xj), atol=1e-5)
        np.testing.assert_allclose(Xw.numpy(), X.numpy(), atol=1e-5)
        _stats_equal(sw, sj)
    assert int(project_l1inf_kernel(_t(Y), C, theta0=float(st["theta"]),
                                    return_stats=True)[1]["newton_iters"]) \
        < int(st["newton_iters"])


def test_bf16_vs_pallas(jax_ref):
    Y = np.random.default_rng(12).normal(size=(37, 131)).astype(np.float32)
    Yb = _t(Y).to(torch.bfloat16)
    X = project_l1inf_kernel(Yb, 8.0)
    Xj = project_l1inf_pallas(jnp.asarray(Y, jnp.bfloat16), 8.0,
                              interpret=True)
    assert X.dtype == torch.bfloat16
    np.testing.assert_allclose(X.float().numpy(), np.asarray(Xj, np.float32),
                               atol=1e-5)
    Xn = project_l1inf_newton(Yb.float(), 8.0)
    np.testing.assert_allclose(X.float().numpy(), Xn.numpy(), atol=3e-2,
                               rtol=3e-2)


# ------------------------- the warm Newton loop -------------------------------

def _plain_loop(Y, C, **kw):
    """newton_loop_plain on the engine's state after pass 1 of projecting
    Y onto the ball of radius C (as project_l1inf_kernel hands it)."""
    Yt = _t(Y)
    Ypad, bm = O._padded(Yt, 0)
    sids = (torch.arange(Ypad.shape[1]) >= Yt.shape[1]).to(torch.int32)
    li = O._loop_inputs(Ypad, sids, torch.full((1,), C), 1, None, bm=bm,
                        n_bisect=26, n_polish=8, shrink=True)
    return K.newton_loop_plain(li["A"], li["sids"], li["colsum"], li["t1"],
                               li["Csafe"], li["num_active"],
                               num_segments=1, block_m=bm, **kw)


def _loop_vs_pallas(out, sj):
    th, _, it, work, acps = out
    _stats_equal({"theta": th[0], "newton_iters": it, "work_cols": work,
                  "active_cols_per_step": acps,
                  "num_active": sj["num_active"], "full_cols": sj["full_cols"]},
                 sj)
    np.testing.assert_allclose(float(th[0]), float(sj["theta"]), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("Cfrac", [0.05, 0.3, 0.7])
def test_newton_loop_plain_warm_ties_vs_pallas(Cfrac, jax_ref, monkeypatch):
    """The plain loop's warm solves on tie-heavy columns (values on a
    0.5 grid) against the JAX engine: theta and the counters, and every
    warm solve converged from its start (no column fell back to cold)."""
    Y = np.random.default_rng(21).choice(
        [0.0, 0.5, 1.0, -1.0, 1.5, 2.0, 2.0], size=(56, 320)).astype(
        np.float32)
    C = Cfrac * float(np.abs(Y).max(axis=0).sum())
    solves = []
    warm = K.warm_levels

    def counting(y, th, *args):
        out = warm(y, th, *args)
        live = y.sum(dim=0) > th
        solves.append((int(live.sum()), int((live & ~out[3]).sum())))
        return out
    monkeypatch.setattr(K, "warm_levels", counting)
    out = _plain_loop(Y, C)
    _, sj = project_l1inf_pallas(jnp.asarray(Y), C, interpret=True,
                                 return_stats=True)
    _loop_vs_pallas(out, sj)
    assert len(solves) == int(out[2]) - 2 and sum(n for n, _ in solves) > 0
    assert sum(c for _, c in solves) == 0, solves


def test_warm_levels_converge_or_refuse():
    """warm_levels from a start under the level reaches mu_solve_plain's
    level, counts and sums; from a start above it (its first step lowers
    the level) or with too few steps it reports the column unconverged."""
    rng = np.random.default_rng(22)
    y = _t(rng.uniform(0, 1, size=(300, 64)).astype(np.float32))
    th = y.sum(dim=0) * 0.3
    cold = K.mu_solve_plain(y, th, block_m=64, nact=torch.tensor(1))
    colmax = y.amax(dim=0)
    prev = y.sum(dim=0) * 0.2
    mup, kp, _, _ = K.mu_solve_plain(y, prev, block_m=64,
                                     nact=torch.tensor(1))
    mu, k, S, ok = K.warm_levels(y, th, prev, mup, kp, colmax, 8)
    assert bool(ok.all())
    torch.testing.assert_close(mu, cold[0], atol=1e-5, rtol=0)
    assert torch.equal(k, cold[1]) and torch.equal(S, cold[2])
    above = K.warm_levels(y, th, th, cold[0] + 0.01, kp, colmax, 8)[3]
    assert not bool(above.any())
    capped = K.warm_levels(y, th, prev, mup, kp, colmax, 1)[3]
    assert not bool(capped.any())


def test_newton_loop_plain_cold_fallback_vs_pallas(jax_ref, monkeypatch):
    """With the warm start put above every level, each warm solve refuses
    and the column takes the cold passes: the loop is then the all-cold
    loop, equal to the JAX engine's."""
    Y = np.random.default_rng(23).normal(size=(64, 400)).astype(np.float32)
    C = 0.1 * float(np.abs(Y).max(axis=0).sum())
    monkeypatch.setattr(K, "WARM_MARGIN", -1.0)
    out = _plain_loop(Y, C)
    _, sj = project_l1inf_pallas(jnp.asarray(Y), C, interpret=True,
                                 return_stats=True)
    _loop_vs_pallas(out, sj)
    assert int(out[2]) > 3


@pytest.mark.parametrize("max_newton", [2, 3, 4])
def test_engine_max_newton_cap_vs_pallas(max_newton, jax_ref):
    """The cap exit: theta still rising at max_newton; mu re-evaluated at
    the last theta (a warm solve) and the counters as the JAX engine's."""
    Y = np.random.default_rng(24).uniform(0, 1, size=(80, 500)).astype(
        np.float32)
    C = 0.01 * float(np.abs(Y).max(axis=0).sum())
    X, st = project_l1inf_kernel(_t(Y), C, max_newton=max_newton,
                                 return_stats=True)
    Xj, sj = project_l1inf_pallas(jnp.asarray(Y), C, max_newton=max_newton,
                                  interpret=True, return_stats=True)
    assert int(sj["newton_iters"]) == max_newton
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(float(st["theta"]), float(sj["theta"]),
                               atol=1e-6, rtol=1e-6)
    _stats_equal(st, sj)


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for "
                    "sm_90a, built with nvcc, with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
# every mu_solve plan: 8-lane teams of 4-16 values (n <= 128), warps of
# 8-32 values, clusters of 3 and 8 CTAs (3000, 10000 rows), and the tile
# streamed on every pass past 10240 rows
@pytest.mark.parametrize("shape", [(96, 10112), (1000, 1024), (300, 257),
                                   (7, 33), (10000, 1024), (3000, 257),
                                   (200, 300), (700, 130), (50, 129),
                                   (128, 64), (12000, 130)])
def test_cuda_kernels_vs_plain(card, shape):
    g = torch.Generator(device=card).manual_seed(0)
    Y = torch.randn(shape, generator=g, device=card)
    A = Y.abs()
    s1, m1 = K.colstats(A)
    s2, m2 = K.colstats_plain(A)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)
    assert torch.equal(m1, m2)
    theta = s2 * torch.rand(shape[1], generator=g, device=card) * 1.2
    nact = torch.tensor([max(1, shape[1] // 128 // 2)], dtype=torch.int32,
                        device=card)
    r1 = K.mu_solve(A, theta, block_m=128, nact_blocks=nact)
    r2 = K.mu_solve_plain(A, theta, block_m=128, nact=nact)
    assert torch.equal(r1[3], r2[3])
    assert bool(((r1[0] - r2[0]).abs() <= 1e-5 * m2).all())
    mu = torch.rand(shape[1], generator=g, device=card) * m2
    for dt, view in ((torch.float32, torch.int32),
                     (torch.bfloat16, torch.int16)):
        Yd = Y.to(dt)
        assert torch.equal(K.clip_apply(Yd, mu).view(view),
                           K.clip_apply_plain(Yd, mu).view(view))


@pytest.mark.cuda
def test_cuda_engine_vs_newton(card):
    g = torch.Generator(device=card).manual_seed(1)
    Y = torch.rand((1000, 1000), generator=g, device=card)
    K.reset_launch_counts()
    X = project_l1inf_kernel(Y, 1.0)
    counts = K.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    torch.testing.assert_close(X, project_l1inf_newton(Y, 1.0),
                               atol=3e-4, rtol=3e-3)


# The Newton loop kernel against its plain loop, on the engine's own state
# after pass 1: SAE enc1's packed (96, 10112), paper Fig. 2's 1000 x 10000
# and 10000 x 1000 (padded), a 3-segment buffer with a warm start, 40000
# columns of 200 rows (about 20 groups a CTA, more than its resident
# tiles: the others are staged every step), and 64 segments of 7 to 260
# columns (the per-segment state of size G, several segments a group).
LOOP_CASES = ["sae_enc1", "fig2_wide", "fig2_tall", "tall_3000",
              "segmented_warm", "many_groups", "segments_64"]


def _segments_64():
    rng = np.random.default_rng(64)
    widths = rng.integers(7, 261, size=64)
    Y = (rng.normal(size=(72, int(widths.sum())))
         * np.repeat(rng.choice([0.2, 1.0, 3.0], size=64), widths)[None, :])
    sids = np.repeat(np.arange(64), widths).astype(np.int32)
    Cs = np.array([0.15 * np.abs(Y[:, sids == g]).max(axis=0).sum()
                   for g in range(64)], np.float32)
    return Y.astype(np.float32), sids, Cs


def _loop_case(card, case):
    g = torch.Generator(device=card).manual_seed(7)
    if case in ("segmented_warm", "segments_64"):
        if case == "segmented_warm":
            Y, sids, Cs = (_t(a).to(card) for a in _packed(16))
            _, th = project_l1inf_kernel_segmented(Y, sids, Cs,
                                                   num_segments=3)
            theta0, G = th * 0.9, 3
        else:
            Y, sids, Cs = (_t(a).to(card) for a in _segments_64())
            theta0, G = None, 64
        m = sids.shape[0]                     # lane padding: segment id G
        sids = torch.cat([sids, sids.new_full((-m % 128,), G)])
    else:
        n, m, m_pad, scale, frac = {
            "sae_enc1": (96, 10000, 10112, 0.05, 0.05),
            "fig2_wide": (1000, 10000, 10112, 1.0, 1e-4),
            "fig2_tall": (10000, 1000, 1024, 1.0, 1e-3),
            "tall_3000": (3000, 600, 640, 1.0, 1e-2),
            "many_groups": (200, 40000, 40064, 1.0, 2e-3)}[case]
        Y = torch.zeros((n, m_pad), device=card)
        Y[:, :m] = torch.rand((n, m), generator=g, device=card) * scale
        sids = (torch.arange(m_pad, device=card) >= m).to(torch.int32)
        Cs = (frac * Y.abs().amax(dim=0).sum()).reshape(1)
        theta0, G = None, 1
    Ypad, bm = O._padded(Y, 0)
    li = O._loop_inputs(Ypad, sids, Cs, G, theta0, bm=bm, n_bisect=26,
                        n_polish=8, shrink=True)
    args = (li["A"], li["sids"], li["colsum"], li["t1"], li["Csafe"],
            li["num_active"])
    return args, dict(num_segments=G, block_m=bm)


def _loop_outputs_agree(got, want, colmax):
    """theta to the parity tolerances, mu's support equal and mu within
    1e-5 * colmax; newton_iters equal, or one apart only where the last
    step is fp rounding (thetas within 4 ulps), work_cols then larger by
    that step's prefix; active_cols_per_step equal."""
    th, mu, it, work, acps = got
    thp, mup, itp, workp, acpsp = want
    torch.testing.assert_close(th, thp, atol=1e-6, rtol=1e-6)
    extra = int(it) - int(itp)
    assert abs(extra) <= 1, (int(it), int(itp))
    if extra:
        ulp = torch.from_numpy(np.spacing(thp.cpu().numpy())).to(th.device)
        assert bool(((th - thp).abs() <= 4 * ulp).all()), (th, thp)
    assert int(work) == int(workp) + extra * int(acpsp)
    assert int(acps) == int(acpsp)
    assert torch.equal(mu > 0, mup > 0)
    assert bool(((mu - mup).abs() <= 1e-5 * colmax).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOOP_CASES)
def test_cuda_newton_loop_vs_plain(card, case):
    args, kw = _loop_case(card, case)
    K.reset_launch_counts()
    got = K.newton_loop(*args, **kw)
    assert K.launch_counts() == {"colstats": 0, "mu_solve": 0,
                                 "clip_apply": 0, "newton_loop": 1}
    want = K.newton_loop_plain(*args, **kw)
    _loop_outputs_agree(got, want, args[0].amax(dim=0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sae_enc1", "fig2_tall", "segments_64"])
@pytest.mark.parametrize("max_newton", [2, 3])
def test_cuda_newton_loop_cap_exit_vs_plain(card, case, max_newton):
    """The cap exit: theta still rising at max_newton, mu re-evaluated at
    the last theta (a warm solve on the card, after one extra grid.sync
    for the alive prefix)."""
    args, kw = _loop_case(card, case)
    got = K.newton_loop(*args, max_newton=max_newton, **kw)
    want = K.newton_loop_plain(*args, max_newton=max_newton, **kw)
    assert int(got[2]) == int(want[2]) == max_newton
    _loop_outputs_agree(got, want, args[0].amax(dim=0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOOP_CASES)
def test_cuda_newton_loop_rerun_bit_equal(card, case):
    args, kw = _loop_case(card, case)
    first = K.newton_loop(*args, **kw)
    second = K.newton_loop(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOOP_CASES)
def test_cuda_newton_loop_never_syncs(card, case):
    """The loop launch alone under the sync debug mode "error": its plan is
    made at the first call, after which a call makes no host sync."""
    args, kw = _loop_case(card, case)
    K.newton_loop(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = K.newton_loop(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(o.device.type == "cuda" for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True])
def test_cuda_projection_never_syncs(card, segmented):
    """colstats, mu_solve (pass 1), the loop kernel and clip_apply are
    enqueued with no host sync: the projection runs under the sync debug
    mode "error" (torch raises on any synchronising call)."""
    g = torch.Generator(device=card).manual_seed(2)
    Y = torch.rand((1000, 1000), generator=g, device=card)
    sids = (torch.arange(1000, device=card) >= 600).to(torch.int32)
    Cs = torch.full((2,), 1.0, device=card)
    run = (lambda: project_l1inf_kernel_segmented(
        Y, sids, Cs, num_segments=2)[0]) if segmented else (
        lambda: project_l1inf_kernel(Y, 1.0))
    run()                                    # builds and loads the kernels
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        X = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert K.launch_counts() == {"colstats": 1, "mu_solve": 1,
                                 "clip_apply": 1, "newton_loop": 1}
    if not segmented:
        torch.testing.assert_close(X, project_l1inf_newton(Y, 1.0),
                                   atol=3e-4, rtol=3e-3)


@pytest.mark.cuda
def test_cuda_engine_taller_than_the_loop_kernel(card):
    """Past ``l1inf_newton_loop_max_rows()`` rows (``NEWTON_LOOP_MAX_ROWS``,
    the meta branch's limit) the loop runs on the host over the streaming
    mu_solve kernel: the same projection, no loop launch."""
    assert K._lib().l1inf_newton_loop_max_rows() == K.NEWTON_LOOP_MAX_ROWS
    g = torch.Generator(device=card).manual_seed(4)
    Y = torch.rand((12000, 300), generator=g, device=card)
    K.reset_launch_counts()
    X, st = project_l1inf_kernel(Y, 1.0, return_stats=True)
    counts = K.launch_counts()
    assert counts["newton_loop"] == 0
    assert counts["mu_solve"] == int(st["newton_iters"]) >= 2
    torch.testing.assert_close(X, project_l1inf_newton(Y, 1.0), atol=3e-4,
                               rtol=3e-3)


@pytest.mark.cuda
def test_cuda_engine_without_shrinking(card):
    """shrink=False: every Newton step solves all columns; the card's
    engine (loop kernel) against the same engine on CPU copies (plain
    versions)."""
    g = torch.Generator(device=card).manual_seed(6)
    Y = torch.randn((200, 700), generator=g, device=card)
    C = 0.1 * float(Y.abs().amax(dim=0).sum())
    K.reset_launch_counts()
    X, st = project_l1inf_kernel(Y, C, shrink=False, return_stats=True)
    assert K.launch_counts()["newton_loop"] == 1
    Xp, sp = project_l1inf_kernel(Y.cpu(), C, shrink=False,
                                  return_stats=True)
    torch.testing.assert_close(X.cpu(), Xp, atol=1e-5, rtol=1e-5)
    _stats_equal(st, sp)
    assert int(st["work_cols"]) == int(st["newton_iters"]) * 768
