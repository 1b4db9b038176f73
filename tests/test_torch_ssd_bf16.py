"""The bf16-tile SSD scan (``tile_bf16``, the config's ``ssd_bf16``) against
the JAX package's ``ssd_apply(tile_bf16=True)``.

The reference computes L, G, M and the intra-chunk einsum in bf16 and the
cumsums, states, scan and inter-chunk term in f32. The port's plain
versions round at the same places (``kernels.ssd.kernel.ssd_fwd_plain``);
its backward rounds L and G where they enter a product and passes the
other roundings through (``ssd_bwd_plain``, ``csrc/ssd_bwd.cu``).

Tolerances, relative to each output's or gradient's largest magnitude in
f32 (the scale):

* against JAX's bf16-tile block: BF16_REL = 3e-2. bf16 keeps 8 bits
  (2^-8 = 3.9e-3 relative per rounding), the tiles chain four roundings,
  and the two sides round their cotangents differently (JAX's are bf16,
  the port's f32); JAX's own bf16 block sits up to 4e-2 from its f32
  block at these inputs, so this bound is under that distance;
* against a float64 oracle of the bf16-tile block (``_tile_oracle``: the
  block in float64 with the tiles rounded to bf16 where the reference
  rounds them, each rounding's derivative taken as 1): within
  ORACLE_SLACK of JAX's own distance to the same oracle, or BF16_FLOOR of
  the scale, whichever is larger (``tests/test_torch_zoo.py::ORACLE_RULE``'s
  pattern): the port may not be farther from it than the reference is.
  (The exact f32 function is no oracle here: at dt about 15 the gated
  RMSNorm's backward cancels, and the tiles' 2^-8 rounding of y moves
  some gradients by several times their scale, in JAX as in the port.)

Where JAX's gradient is NaN (large dt, ROADMAP C-11), the port is finite
and held to the float64 oracle alone, within BF16_FLOOR. Tests marked ``cuda`` hold the
bf16-tile kernels to these plain versions on the card.
"""
import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.models import ssm as JSSM
    from repro.models import zoo as JZ
except ImportError:
    jax = None

from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref
from repro_torch.models import ssm as TSSM
from repro_torch.models import zoo as TZ

BF16_REL = 3e-2
ORACLE_SLACK = 1.5
BF16_FLOOR = 2e-2


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference")


def _ssm_params(d, d_inner, N, H, dt_bias, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    return {"wz": f(d, d_inner, s=d ** -0.5), "wx": f(d, d_inner, s=d ** -0.5),
            "wB": f(d, N, s=d ** -0.5), "wC": f(d, N, s=d ** -0.5),
            "wdt": f(d, H, s=d ** -0.5),
            "dt_bias": np.full((H,), dt_bias, np.float32),
            "A_log": f(H, s=0.3), "D": np.ones((H,), np.float32),
            "conv_x": f(4, d_inner, s=0.5), "conv_B": f(4, N, s=0.5),
            "conv_C": f(4, N, s=0.5), "norm": np.ones((d_inner,), np.float32),
            "wo": f(d_inner, d, s=d_inner ** -0.5)}


def _rb(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _tile_oracle(x, dt, A_log, D, Bm, Cm, *, chunk=64, tile_bf16=True):
    """``ssd_attention(tile_bf16=True)`` in float64, written as the
    reference writes it: the exact scan (the naive recurrence) with its
    intra-chunk term swapped for the one from bf16 tiles, G = rb(rb(C)
    rb(B)^T), M = rb(G rb(L)), intra = rb(M rb(dt) rb(x)); autograd takes
    each rounding's derivative as 1. Returned in x's dtype."""
    Bb, S, H, P = x.shape
    x64, dt64 = x.double(), dt.double()
    y, _ = ref.ssd_ref(
        x64.transpose(1, 2).reshape(Bb * H, S, P),
        dt64.transpose(1, 2).reshape(Bb * H, S),
        (-torch.exp(A_log.double())).repeat(Bb), D.double().repeat(Bb),
        Bm.double(), Cm.double(), groups=H)
    y = y.reshape(Bb, H, S, P).transpose(1, 2)
    nc, Q = S // chunk, chunk
    xc, dtc = x64.reshape(Bb, nc, Q, H, P), dt64.reshape(Bb, nc, Q, H)
    Bc = Bm.double().reshape(Bb, nc, Q, -1)
    Cc = Cm.double().reshape(Bb, nc, Q, -1)
    cum = torch.cumsum(dtc * -torch.exp(A_log.double()), dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.exp(diff.masked_fill(~tri, float("-inf")))
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    exact = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", G, L, dtc, xc)
    Gt = _rb(torch.einsum("bcin,bcjn->bcij", _rb(Cc), _rb(Bc)))
    Mt = _rb(_rb(Gt[..., None] * _rb(L)) * _rb(dtc)[:, :, None])
    tile = _rb(torch.einsum("bcijh,bcjhp->bcihp", Mt, _rb(xc)))
    return (y + (tile - exact).reshape(Bb, S, H, P)).to(x.dtype)


def _port(params, u, P, chunk, dtype=torch.float32):
    """(y, grads of sum(y^2)) of the port's bf16-tile block."""
    tp = {k: torch.from_numpy(v).to(dtype).requires_grad_()
          for k, v in params.items()}
    y = TSSM.ssd_apply(tp, torch.from_numpy(u).to(dtype), headdim=P,
                       chunk=chunk, tile_bf16=True)
    (y ** 2).sum().backward()
    return y.detach().double().numpy(), {k: t.grad.double().numpy()
                                         for k, t in tp.items()}


def _oracle(params, u, P, chunk, monkeypatch):
    """The bf16-tile block in float64 (``_tile_oracle``)."""
    with monkeypatch.context() as m:
        m.setattr(TSSM, "ssd_attention", _tile_oracle)
        return _port(params, u, P, chunk, torch.float64)


def _jax(params, u, P, chunk, tile_bf16=True):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    f = lambda p: JSSM.ssd_apply(p, jnp.asarray(u), headdim=P, chunk=chunk,
                                 tile_bf16=tile_bf16)
    y = np.asarray(f(jp), np.float64)
    g = jax.grad(lambda p: jnp.sum(f(p) ** 2))(jp)
    return y, {k: np.asarray(v, np.float64) for k, v in g.items()}


def _err(a, b):
    return float(np.abs(a - b).max())


CASES = [(-1.0, 8), (-1.0, 64), (1.0, 8), (1.0, 64)]


@pytest.mark.parametrize("dt_bias,chunk", CASES)
def test_ssd_apply_tile_bf16_vs_jax_and_float64(dt_bias, chunk, jax_ref,
                                                monkeypatch):
    """Forward and every leaf's gradient within BF16_REL of JAX's bf16-tile
    block, and no farther from the float64 bf16-tile block than JAX is (beyond
    ORACLE_SLACK, or BF16_FLOOR of the scale). dt_bias 1 at chunk 64 makes
    JAX's gradient NaN for A_log, dt_bias and wdt (C-11): those leaves are
    held to the oracle alone."""
    d, d_inner, P, N, S = 32, 64, 16, 8, 128
    params = _ssm_params(d, d_inner, N, d_inner // P, dt_bias)
    u = np.random.default_rng(1).normal(size=(2, S, d)).astype(np.float32)
    y, g = _port(params, u, P, chunk)
    jy, jg = _jax(params, u, P, chunk)
    oy, og = _oracle(params, u, P, chunk, monkeypatch)
    scale = float(np.abs(oy).max())
    assert _err(y, jy) <= BF16_REL * scale
    assert _err(y, oy) <= max(ORACLE_SLACK * _err(jy, oy), BF16_FLOOR * scale)
    for k in params:
        assert np.isfinite(g[k]).all(), k
        scale = float(np.abs(og[k]).max())
        if not np.isfinite(jg[k]).all():
            assert (dt_bias, chunk) == (1.0, 64) and k in (
                "A_log", "dt_bias", "wdt"), k
            assert _err(g[k], og[k]) <= BF16_FLOOR * scale, k
            continue
        assert _err(g[k], jg[k]) <= BF16_REL * scale, k
        assert _err(g[k], og[k]) <= max(ORACLE_SLACK * _err(jg[k], og[k]),
                                        BF16_FLOOR * scale), k


def test_large_dt_gradient_finite_where_reference_is_nan(jax_ref, monkeypatch):
    """C-11 with bf16 tiles: at dt_bias 15 (dt about 15, hymba-1.5b's
    full-width init) JAX's bf16-tile gradient is NaN for A_log, dt_bias and
    wdt, where ``where(tri, exp(diff), 0)`` overflows; the port's is finite
    for every leaf and within BF16_FLOOR of the float64 bf16-tile block."""
    d, d_inner, P, N, S, chunk = 32, 64, 16, 8, 128, 64
    params = _ssm_params(d, d_inner, N, d_inner // P, dt_bias=15.0)
    u = np.random.default_rng(1).normal(size=(1, S, d)).astype(np.float32)
    _, jg = _jax(params, u, P, chunk)
    assert sorted(k for k, v in jg.items() if not np.isfinite(v).all()) == [
        "A_log", "dt_bias", "wdt"]
    _, g = _port(params, u, P, chunk)
    _, og = _oracle(params, u, P, chunk, monkeypatch)
    for k in params:
        assert np.isfinite(g[k]).all(), k
        assert _err(g[k], og[k]) <= BF16_FLOOR * float(np.abs(og[k]).max()), k


def test_tile_bf16_changes_only_the_tiles():
    """The bf16-tile forward differs from the f32 one (the tiles round) but
    its final state is bit-equal (the states and scan stay f32), and its
    saved G is the f32 G rounded from rounded operands."""
    rng = np.random.default_rng(4)
    BH, S, P, N, Q = 4, 64, 8, 16, 16
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, B, C = f(BH, S, P), f(2, S, N) * 0.5, f(2, S, N) * 0.5
    dt = torch.from_numpy(rng.uniform(0.05, 0.6, (BH, S)).astype(np.float32))
    a, d = -torch.rand(BH) - 0.5, f(BH)
    y32, st32, (_, _, G32) = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q,
                                             groups=2, return_saved=True)
    y16, st16, (_, _, G16) = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q,
                                             groups=2, return_saved=True,
                                             tile_bf16=True)
    assert torch.equal(st32, st16) and not torch.equal(y32, y16)
    assert torch.equal(G16, G16.to(torch.bfloat16).float())
    torch.testing.assert_close(y16, y32, atol=3e-2 * float(y32.abs().max()),
                               rtol=0)
    torch.testing.assert_close(G16, G32, atol=3e-2 * float(G32.abs().max()),
                               rtol=0)


def test_tile_bf16_function_on_the_cpu_is_the_plain_backward():
    """Under grad the bf16-tile scan goes through ``SSDFunction`` with the
    plain bf16-tile backward, bit for bit."""
    rng = np.random.default_rng(5)
    BH, S, P, N, Q = 4, 64, 8, 16, 16
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, B, C = f(BH, S, P), f(2, S, N) * 0.5, f(2, S, N) * 0.5
    dt = torch.from_numpy(rng.uniform(0.05, 0.6, (BH, S)).astype(np.float32))
    a, d = -torch.rand(BH) - 0.5, f(BH)
    dy = f(BH, S, P)
    args = [t.clone().requires_grad_() for t in (x, dt, a, d, B, C)]
    y, _ = K.ssd_fwd(*args, chunk=Q, groups=2, tile_bf16=True)
    (y * dy).sum().backward()
    _, _, saved = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q, groups=2,
                                  return_saved=True, tile_bf16=True)
    want = K.ssd_bwd_plain(x, dt, a, d, B, C, dy, None, saved, chunk=Q,
                           groups=2, tile_bf16=True)
    assert all(torch.equal(t.grad, w) for t, w in zip(args, want))
    f32 = K.ssd_bwd_plain(x, dt, a, d, B, C, dy, None, saved, chunk=Q,
                          groups=2)
    assert not torch.equal(f32[0], want[0])


@pytest.mark.parametrize("arch", ["mamba2_370m", "hymba_15b"])
def test_model_with_ssd_bf16_vs_jax(arch, jax_ref, monkeypatch):
    """A reduced config with ``ssd_bf16=True``: Model.loss within 1e-2 of
    JAX's, and every gradient leaf no farther from the oracle (the port's
    model with ``_tile_oracle``, float64, as its scan; the rest in f32,
    whose rounding is far below bf16's) than ORACLE_SLACK times JAX's
    distance to it, or BF16_FLOOR of its scale."""
    import dataclasses
    jcfg = dataclasses.replace(JC.get_reduced(arch), ssd_bf16=True)
    tcfg = dataclasses.replace(TC.get_reduced(arch), ssd_bf16=True)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, size=(2, 32))
    labels = rng.integers(0, jcfg.vocab, size=(2, 32))
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)})

    def grads(dtype):
        tp = tree_map(lambda x: x.to(dtype).requires_grad_(),
                      params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                               jp), "cpu"))
        tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(tok),
                             "labels": torch.from_numpy(labels)})
        tl.backward()
        return float(tl.detach()), dict(flatten_with_path(tree_map(
            lambda p: p.grad.double().numpy(), tp)))

    tl, got = grads(torch.float32)
    with monkeypatch.context() as m:
        m.setattr(TSSM, "ssd_attention", _tile_oracle)
        _, oracle = grads(torch.float32)
    assert abs(tl - float(jl)) <= 1e-2
    want = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, jg)))
    for k, g in got.items():
        w, o = want[k], oracle[k]
        assert np.isfinite(w).all() and np.isfinite(g).all(), k
        assert _err(g, o) <= max(ORACLE_SLACK * _err(w, o),
                                 BF16_FLOOR * float(np.abs(o).max())), k


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ for sm_90a, "
                    "built with nvcc, with no interpret mode")
    return torch.device("cuda")


def _inputs(BG, groups, S, P, N, dt_range, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    BH = BG * groups
    lo, hi = dt_range
    return (torch.randn((BH, S, P), generator=g, device=dev),
            torch.rand((BH, S), generator=g, device=dev) * (hi - lo) + lo,
            -torch.rand((BH,), generator=g, device=dev) * 1.5 - 0.5,
            torch.randn((BH,), generator=g, device=dev),
            torch.randn((BG, S, N), generator=g, device=dev) * 0.5,
            torch.randn((BG, S, N), generator=g, device=dev) * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 512, 64, 16, 64),
                                   (2, 4, 512, 64, 128, 64),
                                   (2, 4, 64, 8, 8, 8),
                                   (1, 3, 128, 64, 32, 64)])
def test_cuda_tile_bf16_vs_plain(card, shape):
    """Forward and backward of the bf16-tile kernels against their plain
    versions (1e-3 of each output's scale: the plain products run on
    cuBLAS, the kernel's in fmaf order, and a bf16 rounding can fall on
    the other side of a tie), one launch a call, reruns bit-equal."""
    BG, groups, S, P, N, Q = shape
    x, dt, a, d, B, C = _inputs(BG, groups, S, P, N, (0.05, 0.6), card)
    K.reset_launch_counts()
    y, st, saved = K._fwd_kernel(x, dt, a, d, B, C, Q, groups, True)
    assert K.launch_counts()["ssd_fwd_tile_bf16"] == 1
    yp, stp, savedp = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q,
                                      groups=groups, return_saved=True,
                                      tile_bf16=True)
    rel = lambda u, v: float((u - v).abs().max()) / float(v.abs().max())
    assert rel(y, yp) <= 1e-3 and rel(st, stp) <= 1e-5
    y2, st2, _ = K._fwd_kernel(x, dt, a, d, B, C, Q, groups, True)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    dy = torch.randn_like(y)
    got = K.ssd_bwd(x, dt, a, d, B, C, dy, None, saved, chunk=Q,
                    groups=groups, tile_bf16=True)
    assert K.launch_counts()["ssd_bwd_tile_bf16"] == 1
    want = K.ssd_bwd_plain(x, dt, a, d, B, C, dy, None, savedp, chunk=Q,
                           groups=groups, tile_bf16=True)
    for gk, gp in zip(got, want):
        assert torch.isfinite(gk).all() and rel(gk, gp) <= 1e-3
    again = K.ssd_bwd(x, dt, a, d, B, C, dy, None, saved, chunk=Q,
                      groups=groups, tile_bf16=True)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
def test_cuda_tile_bf16_refuses_other_chunks(card):
    x, dt, a, d, B, C = _inputs(1, 2, 128, 64, 16, (0.05, 0.6), card)
    with pytest.raises(ValueError, match="not taken by the kernel"):
        K.ssd_fwd(x, dt, a, d, B, C, chunk=32, groups=2, tile_bf16=True)
