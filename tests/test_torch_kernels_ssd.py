"""The port's SSD scan and its gradient against ``repro.kernels.ssd`` and
``repro.models.ssm``.

On the CPU the wrapper runs its plain version, which repeats the CUDA
kernel's arithmetic (the sequential in-order cumsum, the chunk loop, the
decay tile with its exponent masked before the exp); it is held against
the JAX Pallas kernel in interpret mode and against the JAX naive
recurrence ``ssd_ref``, y and the final state, on the same numpy inputs, at
the tolerance of ``tests/test_kernels_ssd.py``: atol = rtol = 2e-4.

The backward's plain version (``ssd_bwd_plain``, written out, no autograd)
is held against ``jax.vjp`` of the JAX ``ssd_ref`` for every input and the
final state's cotangent, and against torch autograd through the plain
forward at small dt, within 2e-4 of each gradient's largest entry. Under
grad, ``ssd_fwd`` and ``ssd_attention`` go through ``SSDFunction``, whose
CPU backward is that plain version.

Cases drive dt * a so hard that cum_i - cum_j for i < j passes 88 inside
a chunk, as the reference's full-width weights do (ROADMAP C-5): exp of it
is +inf in f32, and a decay tile formed as exp * 0/1-mask would be NaN. y
must stay finite and equal JAX's; the gradient must stay finite and equal
float64 autograd through the port's ``ssd_ref``, while JAX's gradient
through ``repro.models.ssm.ssd_apply`` at such dt is NaN (ROADMAP C-11:
autodiff of its where over exp).

Tests marked ``cuda`` compare the CUDA kernels with their plain versions on
the card; they skip here, with the reason, when no card is present
(``python3 chip_smoke.py`` makes the same comparisons at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd import ssd_attention as jax_ssd_attention
    from repro.kernels.ssd import ssd_fwd as jax_ssd_fwd
    from repro.kernels.ssd import ref as Jref
    from repro.models import ssm as JSSM
except ImportError:       # the card's machine has PyTorch but no JAX
    jnp = None
from repro_torch.kernels.ssd import (launch_counts, ref, reset_launch_counts,
                                     ssd_attention, ssd_fwd)
from repro_torch.kernels.ssd import kernel as K
from repro_torch.models import ssm as TSSM

TOL = 2e-4


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference package, on this machine")


def _mk(BH, S, P, N, BG, seed=0, dt_range=(0.05, 0.6)):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.normal(size=(BH, S, P))),
            f(rng.uniform(*dt_range, size=(BH, S))),
            f(-rng.uniform(0.5, 2.0, size=(BH,))),
            f(rng.normal(size=(BH,))),
            f(rng.normal(size=(BG, S, N)) * 0.5),
            f(rng.normal(size=(BG, S, N)) * 0.5))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32), (96, 32)])
@pytest.mark.parametrize("groups", [1, 4])
def test_plain_vs_pallas_and_recurrence(S, chunk, groups, jax_ref):
    BG, P, N = 2, 8, 16
    arrs = _mk(BG * groups, S, P, N, BG)
    y, st = ssd_fwd(*_t(arrs), chunk=chunk, groups=groups)
    yp, stp = jax_ssd_fwd(*_j(arrs), chunk=chunk, groups=groups,
                          interpret=True)
    yr, str_ = Jref.ssd_ref(*_j(arrs), groups=groups)
    for a, b in ((y, yp), (st, stp), (y, yr), (st, str_)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_recurrence_oracle_vs_jax(groups, jax_ref):
    arrs = _mk(2 * groups, 40, 4, 8, 2, seed=4)
    y, st = ref.ssd_ref(*_t(arrs), groups=groups)
    yr, str_ = Jref.ssd_ref(*_j(arrs), groups=groups)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_large_dt_stays_finite(groups, jax_ref):
    """dt in [3, 20] and a in [-2, -0.5] as at the reference's full width:
    within a 32-step chunk cum_i - cum_j for i < j reaches far past 88."""
    BG, S, P, N, chunk = 2, 64, 8, 16, 32
    arrs = _mk(BG * groups, S, P, N, BG, seed=9, dt_range=(3.0, 20.0))
    x, dt, a = arrs[:3]
    cum = np.cumsum((dt * a[:, None]).reshape(-1, S // chunk, chunk), -1)
    assert (cum[..., :1] - cum[..., -1:]).max() > 88 * 4
    y, st = ssd_fwd(*_t(arrs), chunk=chunk, groups=groups)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yp, stp = jax_ssd_fwd(*_j(arrs), chunk=chunk, groups=groups,
                          interpret=True)
    assert np.isfinite(np.asarray(yp)).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stp), atol=TOL,
                               rtol=TOL)


def test_ops_wrapper_vs_pallas(jax_ref):
    """Model layout: x (B, S, H, P), dt (B, S, H), A_log / D (H,), B / C
    (B, S, N), against the JAX ops wrapper."""
    Bb, S, H, P, N = 2, 64, 4, 8, 16
    rng = np.random.default_rng(3)
    f = lambda a: np.asarray(a, np.float32)
    arrs = (f(rng.normal(size=(Bb, S, H, P))),
            f(rng.uniform(0.05, 0.5, size=(Bb, S, H))),
            f(rng.uniform(-1, 0.5, size=(H,))), f(rng.normal(size=(H,))),
            f(rng.normal(size=(Bb, S, N)) * 0.5),
            f(rng.normal(size=(Bb, S, N)) * 0.5))
    y = ssd_attention(*_t(arrs), chunk=16)
    assert y.shape == (Bb, S, H, P)
    expect = jax_ssd_attention(*_j(arrs), chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(expect), atol=TOL,
                               rtol=TOL)


def _chunk_loop(x, dt, a, d, B, C, *, chunk, groups):
    """The scan as the TPU kernel runs it, one chunk after another with the
    state carried in between; the same sequential cumsum and association
    order as the plain version."""
    BH, S, P = x.shape
    N = B.shape[-1]
    Q, nc = chunk, S // chunk
    xf = x.float().reshape(BH, nc, Q, P)
    dtf = dt.float().reshape(BH, nc, Q)
    Bf = B.float().repeat_interleave(groups, dim=0).reshape(BH, nc, Q, N)
    Cf = C.float().repeat_interleave(groups, dim=0).reshape(BH, nc, Q, N)
    cum = K._cumsum_in_order(dtf * a.float()[:, None, None])
    seg = cum[..., -1]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros(()))
    M = ((Cf @ Bf.transpose(-1, -2)) * L) * dtf[..., None, :]
    ec = torch.exp(cum)
    coef = dtf * torch.exp(seg[..., None] - cum)
    dcol = d.float()[:, None, None]
    h = torch.zeros((BH, P, N), dtype=torch.float32)
    ys = []
    for c in range(nc):
        xc = xf[:, c]
        y = M[:, c] @ xc + (Cf[:, c] * ec[:, c, :, None]) @ h.transpose(1, 2)
        ys.append(y + dcol * xc)
        w = coef[:, c, :, None] * Bf[:, c]
        h = torch.exp(seg[:, c])[:, None, None] * h + xc.transpose(1, 2) @ w
    return torch.stack(ys, dim=1).reshape(BH, S, P).to(x.dtype), h


@pytest.mark.parametrize("BG,groups,S,P,N,chunk,dt_range", [
    (2, 1, 64, 64, 16, 64, (0.05, 0.6)),
    (2, 4, 256, 64, 16, 64, (3.0, 20.0)),
    (1, 50, 128, 64, 16, 64, (3.0, 20.0)),
    (2, 3, 192, 64, 128, 64, (0.05, 0.6)),
    (2, 2, 96, 8, 32, 32, (0.05, 0.6)),
    (1, 4, 96, 8, 16, 16, (3.0, 20.0))])
def test_staged_plain_vs_chunk_loop(BG, groups, S, P, N, chunk, dt_range):
    """The plain version's three stages (chunk-local state updates, the
    scan over chunks, the outputs from the state entering each chunk) are
    bit-equal on the CPU to the sequential chunk loop, y and the final
    state: the split moves no rounding, it only reorders independent
    work."""
    arrs = _t(_mk(BG * groups, S, P, N, BG, seed=13, dt_range=dt_range))
    y, st = K.ssd_fwd_plain(*arrs, chunk=chunk, groups=groups)
    y0, st0 = _chunk_loop(*arrs, chunk=chunk, groups=groups)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert torch.equal(y, y0) and torch.equal(st, st0)


def test_plain_cumsum_is_sequential():
    """The plain version's cumsum adds one rounded term at a time from the
    left, the kernel's order (bit-equal to a Python float32 loop)."""
    da = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 2, 64)).astype(np.float32)) * 7
    got = K._cumsum_in_order(da).numpy()
    want = np.empty_like(got)
    run = np.zeros(da.shape[:-1], np.float32)
    for i in range(da.shape[-1]):
        run = (run + da.numpy()[..., i]).astype(np.float32)
        want[..., i] = run
    assert np.array_equal(got, want)


def test_chunk_size_changes_only_rounding():
    arrs = _t(_mk(4, 96, 8, 8, 2, seed=6))
    y16, s16 = ssd_fwd(*arrs, chunk=16, groups=2)
    y48, s48 = ssd_fwd(*arrs, chunk=48, groups=2)
    torch.testing.assert_close(y16, y48, atol=TOL, rtol=TOL)
    torch.testing.assert_close(s16, s48, atol=TOL, rtol=TOL)


def test_cpu_run_launches_nothing():
    reset_launch_counts()
    args = [t.requires_grad_() for t in _t(_mk(2, 16, 4, 4, 2))]
    y, st = ssd_fwd(*args, chunk=8)
    (y.sum() + st.sum()).backward()
    assert all(t.grad is not None for t in args)
    assert launch_counts() == {"ssd_fwd": 0, "ssd_bwd": 0,
                               "ssd_fwd_tile_bf16": 0,
                               "ssd_bwd_tile_bf16": 0}


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


@pytest.mark.parametrize("bad", ["chunk", "groups", "dtype", "a_dtype",
                                 "device"])
def test_wrapper_checks_inputs(bad):
    x, dt, a, d, B, C = _t(_mk(4, 32, 4, 4, 2))
    kw = dict(chunk=8, groups=2)
    if bad == "chunk":
        kw["chunk"] = 12
    elif bad == "groups":
        kw["groups"] = 3
    elif bad == "dtype":
        x = x.double()
    elif bad == "a_dtype":
        a = a.bfloat16()
    else:
        x, dt, a, d, B, C = map(_Elsewhere, (x, dt, a, d, B, C))
    with pytest.raises((TypeError, ValueError)):
        ssd_fwd(x, dt, a, d, B, C, **kw)


def test_ops_hands_the_kernel_contiguous_inputs(monkeypatch):
    """The kernel takes contiguous inputs only; at batch 1 the folded
    (B * H, S, P) view of x is not contiguous unless the wrapper copies."""
    from repro_torch.kernels.ssd import ops
    seen = []

    def spy(*args, **kw):
        seen.extend(t.is_contiguous() for t in args)
        return K.ssd_fwd_plain(*args, **kw)

    monkeypatch.setattr(ops, "ssd_fwd", spy)
    Bb, S, H, P, N = 1, 32, 4, 8, 8
    ssd_attention(torch.randn(Bb, S, H, P), torch.rand(Bb, S, H),
                  torch.zeros(H), torch.ones(H), torch.randn(Bb, S, N),
                  torch.randn(Bb, S, N), chunk=16)
    assert seen and all(seen)


# ------------------------------ the backward ---------------------------------

def _cot(BH, S, P, N, seed=21):
    """dy (BH, S, P) and the final state's cotangent (BH, P, N)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, S, P)).astype(np.float32),
            rng.normal(size=(BH, P, N)).astype(np.float32))


def _plain_grads(arrs, dy, dst, chunk, groups):
    args = _t(arrs)
    _, _, saved = K.ssd_fwd_plain(*args, chunk=chunk, groups=groups,
                                  return_saved=True)
    return K.ssd_bwd_plain(*args, torch.from_numpy(dy),
                           None if dst is None else torch.from_numpy(dst),
                           saved, chunk=chunk, groups=groups)


def _close_by_scale(got, want, rel=TOL):
    """Each gradient within rel * its largest entry of the reference."""
    for name, g, w in zip(("dx", "ddt", "da", "dd", "dB", "dC"), got, want):
        g = g.detach().double().numpy() if torch.is_tensor(g) \
            else np.asarray(g, np.float64)
        w = w.detach().double().numpy() if torch.is_tensor(w) \
            else np.asarray(w, np.float64)
        assert np.isfinite(g).all(), name
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, (name, err, tol)


# (BG, groups, S, P, N, chunk): S, chunk, groups, P and N, including the
# reduced configs' 8 / 8 / 8 and the full configs' chunk 64
BWD_CASES = [(2, 1, 64, 8, 16, 16), (2, 4, 96, 8, 16, 32),
             (2, 3, 64, 8, 8, 8), (1, 2, 128, 16, 8, 64),
             (1, 4, 192, 8, 32, 64), (2, 2, 40, 4, 8, 8)]


@pytest.mark.parametrize("BG,groups,S,P,N,chunk", BWD_CASES)
def test_plain_bwd_vs_jax_vjp(BG, groups, S, P, N, chunk, jax_ref):
    """Every input's gradient, from both outputs' cotangents, against
    ``jax.vjp`` of the JAX naive recurrence."""
    arrs = _mk(BG * groups, S, P, N, BG, seed=31)
    dy, dst = _cot(BG * groups, S, P, N)
    got = _plain_grads(arrs, dy, dst, chunk, groups)
    _, vjp = jax.vjp(lambda *a: Jref.ssd_ref(*a, groups=groups), *_j(arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    _close_by_scale(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("BG,groups,S,P,N,chunk", BWD_CASES[:4])
@pytest.mark.parametrize("with_state", [True, False])
def test_plain_bwd_vs_autograd_through_plain_fwd(BG, groups, S, P, N, chunk,
                                                 with_state):
    """At small dt, against torch autograd through ``ssd_fwd_plain``; a
    missing final-state cotangent counts as zero."""
    arrs = _mk(BG * groups, S, P, N, BG, seed=32)
    dy, dst = _cot(BG * groups, S, P, N, seed=5)
    got = _plain_grads(arrs, dy, dst if with_state else None, chunk, groups)
    args = [t.requires_grad_() for t in _t(arrs)]
    y, st = K.ssd_fwd_plain(*args, chunk=chunk, groups=groups)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_state:
        loss = loss + (st * torch.from_numpy(dst)).sum()
    loss.backward()
    _close_by_scale(got, [t.grad for t in args])


@pytest.mark.parametrize("BG,groups,S,P,N,chunk", [(2, 1, 128, 8, 16, 64),
                                                   (1, 4, 128, 8, 8, 32),
                                                   (2, 3, 64, 8, 8, 8)])
def test_plain_bwd_large_dt_vs_float64(BG, groups, S, P, N, chunk):
    """dt in [3, 20], a in [-2, -0.5], as at the reference's full width:
    the gradient is finite and within 2e-4 of float64 autograd through
    the port's naive recurrence, for every input."""
    arrs = _mk(BG * groups, S, P, N, BG, seed=33, dt_range=(3.0, 20.0))
    dy, dst = _cot(BG * groups, S, P, N, seed=6)
    got = _plain_grads(arrs, dy, dst, chunk, groups)
    args = [t.double().requires_grad_() for t in _t(arrs)]
    y, st = ref.ssd_ref(*args, groups=groups)
    ((y * torch.from_numpy(dy).double()).sum()
     + (st * torch.from_numpy(dst).double()).sum()).backward()
    _close_by_scale(got, [t.grad for t in args])


def _ssm_params(d, d_inner, N, H, dt_bias, seed=0):
    """An SSD block's params as numpy f32, ``ssm_layout``'s keys."""
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


def _f64_ssd_attention(x, dt, A_log, D, Bm, Cm, *, chunk=64,
                       tile_bf16=False):
    """``ssd_attention`` (f32 tiles) through the naive recurrence in
    float64, returned in x's dtype."""
    assert not tile_bf16
    Bb, S, H, P = x.shape
    y, _ = ref.ssd_ref(
        x.transpose(1, 2).reshape(Bb * H, S, P).double(),
        dt.transpose(1, 2).reshape(Bb * H, S).double(),
        (-torch.exp(A_log.double())).repeat(Bb), D.double().repeat(Bb),
        Bm.double(), Cm.double(), groups=H)
    return y.to(x.dtype).reshape(Bb, H, S, P).transpose(1, 2)


# port against JAX at dt 15, where JAX is finite: the block's f32 rounding
# outside the scan (the gated RMSNorm's backward cancels) puts JAX's own
# gradient 8.7e-4 of the scale from float64 at these inputs (wB)
LARGE_DT_JAX_REL = 2e-3


def test_model_large_dt_gradient_finite_where_reference_is_nan(
        jax_ref, monkeypatch):
    """Fault C-11 of the reference. With dt_bias 15 (dt about 15, as
    hymba-1.5b's full-width init gives), JAX's gradient of an SSD block
    through ``repro.models.ssm.ssd_apply`` is NaN for A_log, dt_bias and
    wdt: its ``where(tri, exp(diff), 0)`` overflows for i < j and exp's VJP
    multiplies the zero cotangent by inf. The port's gradient (CPU:
    ``ssd_bwd_plain``) is finite for every leaf. With the block in float64
    around the port's f32 scan, every leaf is within 2e-4 of the all-
    float64 block's (the scan through the naive recurrence); the f32 block
    is within LARGE_DT_JAX_REL of JAX's where JAX is finite."""
    d, d_inner, P, N, S, chunk = 32, 64, 16, 8, 128, 64
    H = d_inner // P
    params = _ssm_params(d, d_inner, N, H, dt_bias=15.0)
    u = np.random.default_rng(1).normal(size=(1, S, d)).astype(np.float32)

    def jloss(p):
        return jnp.sum(JSSM.ssd_apply(p, jnp.asarray(u), headdim=P,
                                      chunk=chunk) ** 2)
    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    nan_leaves = sorted(k for k, v in jg.items()
                        if not np.isfinite(np.asarray(v)).all())
    assert nan_leaves == ["A_log", "dt_bias", "wdt"]

    def grads(dtype):
        tp = {k: torch.from_numpy(v).to(dtype).requires_grad_()
              for k, v in params.items()}
        (TSSM.ssd_apply(tp, torch.from_numpy(u).to(dtype), headdim=P,
                        chunk=chunk) ** 2).sum().backward()
        return {k: t.grad for k, t in tp.items()}

    got = grads(torch.float32)
    got64 = grads(torch.float64)          # the port's f32 scan inside
    monkeypatch.setattr(TSSM, "ssd_attention", _f64_ssd_attention)
    want = grads(torch.float64)
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
        tol = TOL * float(want[k].abs().max())
        assert float((got64[k] - want[k]).abs().max()) <= tol, k
        if k not in nan_leaves:
            w = np.asarray(jg[k])
            assert float(np.abs(g.numpy() - w).max()) <= \
                LARGE_DT_JAX_REL * float(np.abs(w).max()), k


def test_ssd_function_on_the_cpu_is_the_plain_backward():
    """Under grad, ``ssd_fwd`` on CPU tensors goes through ``SSDFunction``:
    y and the state equal the plain forward's, and the gradients equal
    ``ssd_bwd_plain``'s bit for bit; ``ssd_attention``, which discards the
    state, gets the plain backward with a zero state cotangent."""
    BG, groups, S, P, N, chunk = 2, 3, 64, 8, 8, 16
    arrs = _mk(BG * groups, S, P, N, BG, seed=34)
    dy, dst = _cot(BG * groups, S, P, N)
    args = [t.requires_grad_() for t in _t(arrs)]
    y, st = ssd_fwd(*args, chunk=chunk, groups=groups)
    assert y.grad_fn is not None and "SSDFunction" in type(y.grad_fn).__name__
    y0, st0 = K.ssd_fwd_plain(*_t(arrs), chunk=chunk, groups=groups)
    assert torch.equal(y.detach(), y0) and torch.equal(st.detach(), st0)
    ((y * torch.from_numpy(dy)).sum()
     + (st * torch.from_numpy(dst)).sum()).backward()
    want = _plain_grads(arrs, dy, dst, chunk, groups)
    assert all(torch.equal(t.grad, w) for t, w in zip(args, want))
    # the model layout: the final state's gradient is zero
    Bb, H = 2, 3
    rng = np.random.default_rng(8)
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).requires_grad_()
    x, Bm, Cm = f(Bb, S, H, P), f(Bb, S, N), f(Bb, S, N)
    dt = torch.from_numpy(rng.uniform(0.05, 0.5, size=(Bb, S, H)).astype(
        np.float32)).requires_grad_()
    A_log, D = f(H), f(H)
    ssd_attention(x, dt, A_log, D, Bm, Cm, chunk=chunk).sum().backward()
    mine = [t.grad.clone() for t in (x, dt, A_log, D, Bm, Cm)]
    for t in (x, dt, A_log, D, Bm, Cm):
        t.grad = None
    _f64_ssd_attention(x, dt, A_log, D, Bm, Cm).sum().backward()
    for g, t in zip(mine, (x, dt, A_log, D, Bm, Cm)):
        assert torch.isfinite(g).all()
        tol = TOL * float(t.grad.abs().max())
        assert float((g - t.grad).abs().max()) <= tol


@pytest.mark.parametrize("bad", ["dy", "dstate", "saved"])
def test_bwd_checks_inputs(bad):
    BG, groups, S, P, N, chunk = 2, 2, 32, 4, 4, 8
    args = _t(_mk(BG * groups, S, P, N, BG))
    _, _, saved = K.ssd_fwd_plain(*args, chunk=chunk, groups=groups,
                                  return_saved=True)
    dy = torch.zeros((BG * groups, S, P))
    dst = None
    if bad == "dy":
        dy = dy[:, :, :-1]
    elif bad == "dstate":
        dst = torch.zeros((BG * groups, P + 1, N))
    else:
        saved = (saved[0][:, :-1], saved[1], saved[2])
    with pytest.raises(ValueError):
        K.ssd_bwd(*args, dy, dst, saved, chunk=chunk, groups=groups)


def test_plain_fwd_never_takes_exp_of_a_positive_difference(monkeypatch):
    """The decay tile's exponent is masked to -inf for i < j before the
    exp: every exp of the plain forward and backward sees an argument
    <= 0 when a < 0 and dt > 0 (so no +inf, and no NaN gradient)."""
    real_exp = torch.exp
    seen = []

    def spy(t):
        seen.append(float(t.max()))
        return real_exp(t)

    arrs = _mk(4, 64, 4, 8, 2, seed=40, dt_range=(3.0, 20.0))
    monkeypatch.setattr(torch, "exp", spy)
    dy, dst = _cot(4, 64, 4, 8)
    _plain_grads(arrs, dy, dst, 32, 2)
    assert seen and max(seen) <= 0.0


# -------------------- the backward's orders of summation -----------------------
# Each sum of ssd_bwd_plain that is not a matrix product runs in the CUDA
# kernels' order (csrc/ssd_bwd.cu); each helper is held bit for bit to a
# loop over np.float32 scalars that adds in that order, one rounding at a
# time.

def _f(v):
    return [np.float32(t) for t in v]


def _seq(v):
    run = v[0]
    for t in v[1:]:
        run = np.float32(run + t)
    return run


def _fly(lanes):
    """lane 0 after xor shuffles v[l] + v[l ^ off], off = n/2 .. 1"""
    off = len(lanes) // 2
    while off:
        lanes = [np.float32(lanes[l] + lanes[l ^ off])
                 for l in range(len(lanes))]
        off //= 2
    return lanes[0]


def _oracle_block_sum(v):              # thread l holds v[l], v[l + 256], ...
    lanes = [_seq(_f(v[l::256])) if l < len(v) else np.float32(0)
             for l in range(256)]
    return _seq([_fly(lanes[32 * w:32 * w + 32]) for w in range(8)])


def _oracle_lane_sum(v):                # lane l: v[l], v[l + 32], ...
    lanes = [_seq(_f(v[l::32])) if l < len(v) else np.float32(0)
             for l in range(32)]
    return _fly(lanes)


def _oracle_warp_scan(v):
    Q = len(v)
    E = -(-Q // 32)
    w = _f(list(v) + [0.0] * (32 * E - Q))
    loc = []
    for l in range(32):
        run, part = None, []
        for e in range(E):
            run = w[E * l + e] if run is None else np.float32(run + w[E * l + e])
            part.append(run)
        loc.append(part)
    inc = [p[-1] for p in loc]
    off = 1
    while off < 32:
        inc = [inc[l] if l < off else np.float32(inc[l] + inc[l - off])
               for l in range(32)]
        off *= 2
    ex = [np.float32(0)] + inc[:-1]
    out = [np.float32(ex[l] + loc[l][e]) for l in range(32) for e in range(E)]
    return out[:Q]


def _oracle_quarters(v, width):
    n = len(v)
    bounds = [min(k * width, n) for k in range(4)] + [n]
    parts = [_seq(_f(v[lo:hi])) if hi > lo else np.float32(0)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    return np.float32(np.float32(parts[0] + parts[1])
                      + np.float32(parts[2] + parts[3]))


def _oracle_suffix(Z):                  # one column j's entries by row
    Q = len(Z)
    segs, tots = [], []
    for s0 in range(0, Q, 16):
        run, loc = np.float32(0), {}
        for i in reversed(range(s0, min(s0 + 16, Q))):
            run = np.float32(run + Z[i])
            loc[i] = run
        segs.append(loc)
        tots.append(run)
    out, carry = [None] * Q, None
    for s in reversed(range(len(segs))):
        for i, v in segs[s].items():
            out[i] = v if carry is None else np.float32(v + carry)
        carry = tots[s] if carry is None else np.float32(tots[s] + carry)
    return out


def _oracle_pair_sum(v):                # v (Nk,), Nk a multiple of 8
    NS = min(len(v), 32)
    acc = None
    for s0 in range(0, len(v), NS):
        lanes = [_seq(_f(v[s0 + l:s0 + NS:8])) for l in range(8)]
        part = _fly(lanes)
        acc = part if acc is None else np.float32(acc + part)
    return acc


ORDERS = ["block_sum", "lane_sum", "warp_scan", "quarters", "suffix_sums",
          "pair_sum", "slice_major"]


@pytest.mark.parametrize("order", ORDERS)
def test_bwd_plain_sums_in_the_kernels_order(order):
    rng = np.random.default_rng(ORDERS.index(order))
    r = lambda *shape: rng.normal(size=shape).astype(np.float32) * \
        rng.uniform(0.1, 1e3, size=shape).astype(np.float32)
    eq = lambda got, want: np.float32(got).tobytes() == \
        np.float32(want).tobytes()
    if order == "block_sum":
        for n in (256, 1024, 384):
            v = r(n)
            assert eq(K._block_sum(torch.from_numpy(v)), _oracle_block_sum(v))
    elif order == "lane_sum":
        for Q in (8, 16, 32, 64):
            v = r(Q)
            assert eq(K._lane_sum(torch.from_numpy(v)), _oracle_lane_sum(v))
    elif order == "warp_scan":
        for Q in (8, 16, 32, 64):
            v = r(Q)
            got = K._warp_scan(torch.from_numpy(v)).numpy()
            assert got.tobytes() == np.array(_oracle_warp_scan(v)).tobytes()
    elif order == "quarters":
        for n, width in ((64, 16), (8, 16), (32, 16), (64, 4)):
            v = r(n)
            assert eq(K._quarters(torch.from_numpy(v), width),
                      _oracle_quarters(v, width))
    elif order == "suffix_sums":
        for Q in (8, 32, 64):
            Z = np.tril(r(Q, Q))
            got = K._suffix_sums(torch.from_numpy(Z)).numpy()
            for j in range(Q):
                want = _oracle_suffix(Z[:, j])
                assert got[j:, j].tobytes() == np.array(want[j:]).tobytes()
    elif order == "pair_sum":
        for n in (16, 32, 64, 128):
            v = r(n)
            assert eq(K._pair_sum(torch.from_numpy(v)), _oracle_pair_sum(v))
    else:
        # the e-th entry read: slice after slice of min(N, 32) columns,
        # (P, NS) row-major
        for N in (16, 128):
            NS = min(N, 32)
            t = np.arange(64 * N, dtype=np.float32).reshape(64, N)
            got = K._slice_major(torch.from_numpy(t)).numpy()
            assert got.shape == (64 * N,)
            for e in (0, 17, 255, 64 * N - 64 * NS + 3, 64 * N - 1):
                sl, p, n = e // (64 * NS), (e % (64 * NS)) // NS, e % NS
                assert got[e] == t[p, NS * sl + n]


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ for sm_90a, "
                    "built with nvcc, with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 50, 2048, 64, 16, 64, True),
                                   (2, 32, 512, 64, 128, 64, False),
                                   (2, 4, 192, 64, 32, 64, False)])
def test_cuda_kernel_vs_plain(card, shape):
    BG, groups, S, P, N, Q, big = shape
    BH = BG * groups
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((BH, S, P), generator=g, device=card)
    lo, hi = (3.0, 20.0) if big else (0.05, 0.6)
    dt = torch.rand((BH, S), generator=g, device=card) * (hi - lo) + lo
    a = -torch.rand((BH,), generator=g, device=card) * 1.5 - 0.5
    d = torch.randn((BH,), generator=g, device=card)
    B = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    C = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    reset_launch_counts()
    y, st = ssd_fwd(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert launch_counts()["ssd_fwd"] == 1
    yp, stp = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, yp, atol=TOL, rtol=TOL)
    torch.testing.assert_close(st, stp, atol=TOL, rtol=TOL)
    y2, st2 = ssd_fwd(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,chunk", [(64, 16, 48), (96, 16, 64),
                                       (64, 256, 64)])
def test_cuda_kernel_refuses_other_shapes(card, P, N, chunk):
    """A chunk the kernels are not built for, or a P or N above the
    largest they take, raises (smaller ones are zero-padded)."""
    x, dt, a, d, B, C = (t.to(card) for t in _t(_mk(2, 192, P, N, 2)))
    with pytest.raises(ValueError, match="not taken by the kernel"):
        ssd_fwd(x, dt, a, d, B, C, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,chunk", [(32, 16, 64), (64, 8, 64),
                                       (64, 16, 32), (8, 8, 8), (16, 24, 16),
                                       (8, 128, 64)])
def test_cuda_kernel_pads_other_shapes(card, P, N, chunk):
    """Fault C-9: P below 64 and N between the kernels' sizes run
    zero-padded, and every chunk of ``KERNEL_SHAPES`` runs; y and the
    state bit-equal to the plain version, one launch a call."""
    x, dt, a, d, B, C = (t.to(card) for t in _t(_mk(4, 128, P, N, 2)))
    reset_launch_counts()
    y, st = ssd_fwd(x, dt, a, d, B, C, chunk=chunk, groups=2)
    assert launch_counts()["ssd_fwd"] == 1
    assert y.shape == (4, 128, P) and st.shape == (4, P, N)
    yp, stp = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=chunk, groups=2)
    assert torch.equal(y, yp) and torch.equal(st, stp)


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", [0, 1, 2, 3, 4, 5])
def test_cuda_gradient_arrives_through_ssd_function(card, needs_grad):
    """Fault C-6: with grad mode on, an input that requires grad goes
    through ``SSDFunction`` (one forward and one backward launch), and its
    gradient equals the plain backward's on the kernels' saved state
    within 2e-4 of its scale; in bf16 the call refuses (no bf16
    backward), and under no_grad it runs."""
    args = [t.to(card) for t in _t(_mk(4, 128, 64, 16, 2, seed=3))]
    args[needs_grad].requires_grad_(True)
    reset_launch_counts()
    y, st = ssd_fwd(*args, chunk=64, groups=2)
    assert y.requires_grad and st.requires_grad
    dy = torch.randn(y.shape, device=card, generator=torch.Generator(
        device=card).manual_seed(1))
    (y * dy).sum().backward()
    assert launch_counts() == {"ssd_fwd": 1, "ssd_bwd": 1,
                               "ssd_fwd_tile_bf16": 0,
                               "ssd_bwd_tile_bf16": 0}
    plain = [t.detach() for t in args]
    _, _, saved = K.ssd_fwd_plain(*plain, chunk=64, groups=2,
                                  return_saved=True)
    want = K.ssd_bwd_plain(*plain, dy, None, saved, chunk=64, groups=2)
    g, w = args[needs_grad].grad, want[needs_grad]
    assert torch.isfinite(g).all()
    assert float((g - w).abs().max()) <= TOL * float(w.abs().max())
    bf = [t.detach().to(torch.bfloat16) if i in (0, 1, 4, 5) else t.detach()
          for i, t in enumerate(args)]
    bf[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only in bf16"):
        ssd_fwd(*bf, chunk=64, groups=2)
    with torch.no_grad():
        y2, st2 = ssd_fwd(*bf, chunk=64, groups=2)
    assert not (y2.requires_grad or st2.requires_grad)


def _card_inputs(card, BG, groups, S, P, N, big, seed):
    BH = BG * groups
    g = torch.Generator(device=card).manual_seed(seed)
    lo, hi = (3.0, 20.0) if big else (0.05, 0.6)
    x = torch.randn((BH, S, P), generator=g, device=card)
    dt = torch.rand((BH, S), generator=g, device=card) * (hi - lo) + lo
    a = -torch.rand((BH,), generator=g, device=card) * 1.5 - 0.5
    d = torch.randn((BH,), generator=g, device=card)
    B = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    C = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    dy = torch.randn((BH, S, P), generator=g, device=card)
    dst = torch.randn((BH, P, N), generator=g, device=card)
    return (x, dt, a, d, B, C), dy, dst


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,P", [(8, 8), (64, 64)])
@pytest.mark.parametrize("N", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("groups", [1, 50])
@pytest.mark.parametrize("nc", [1, 2])
def test_cuda_bwd_vs_plain(card, nc, groups, N, chunk, P):
    """The backward kernel against its plain version on the kernels' saved
    state: one and two chunks, one and fifty heads a group, every N (8
    padded), chunk 8 at P 8 (padded) and chunk 64 at P 64, small and large
    dt in turn; every gradient finite and within 2e-4 of its scale, a
    rerun bit-equal, one launch counted a call. The final state's
    cotangent is given on even cases and None on odd ones."""
    big = (nc + groups + N) % 2 == 1
    args, dy, dst = _card_inputs(card, 2, groups, nc * chunk, P, N, big,
                                 seed=nc * 1000 + groups + N + chunk)
    if (N // 8 + groups) % 2:
        dst = None
    kw = dict(chunk=chunk, groups=groups)
    _, _, saved = K._fwd_kernel(*args, chunk, groups)
    reset_launch_counts()
    got = K.ssd_bwd(*args, dy, dst, saved, **kw)
    assert launch_counts()["ssd_bwd"] == 1
    _, _, psaved = K.ssd_fwd_plain(*args, return_saved=True, **kw)
    want = K.ssd_bwd_plain(*args, dy, dst, psaved, **kw)
    _close_by_scale([t.cpu() for t in got], [t.cpu() for t in want])
    again = K.ssd_bwd(*args, dy, dst, saved, **kw)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert launch_counts()["ssd_bwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 50, 2048, 64, 16), (1, 32, 2048, 64,
                                                            128)])
def test_cuda_bwd_training_shapes(card, shape):
    """hymba-1.5b's and mamba2-370m's training shapes (B 1), dt in
    [3, 20]: every gradient finite and within 2e-4 of its scale of the
    plain version, and ten reruns bit-equal (``chip_smoke.py`` phase 7
    also holds them to float64 autograd through ``ssd_ref``)."""
    BG, groups, S, P, N = shape
    args, dy, dst = _card_inputs(card, BG, groups, S, P, N, True, seed=7)
    kw = dict(chunk=64, groups=groups)
    _, _, saved = K._fwd_kernel(*args, 64, groups)
    got = K.ssd_bwd(*args, dy, None, saved, **kw)
    _, _, psaved = K.ssd_fwd_plain(*args, return_saved=True, **kw)
    want = K.ssd_bwd_plain(*args, dy, None, psaved, **kw)
    _close_by_scale([t.cpu() for t in got], [t.cpu() for t in want])
    for _ in range(10):
        again = K.ssd_bwd(*args, dy, None, saved, **kw)
        assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
def test_cuda_bwd_takes_unaligned_inputs(card):
    """x and dy as contiguous views that start one element into their
    storage: the wrapper hands the kernels aligned copies."""
    args, dy, dst = _card_inputs(card, 2, 2, 128, 64, 16, False, seed=9)
    x = args[0]
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
        t.shape)
    xu, dyu = off(x), off(dy)
    assert xu.data_ptr() % 16 != 0 and dyu.data_ptr() % 16 != 0
    kw = dict(chunk=64, groups=2)
    _, _, saved = K._fwd_kernel(*args, 64, 2)
    got = K.ssd_bwd(xu, *args[1:], dyu, dst, saved, **kw)
    want = K.ssd_bwd(*args, dy, dst, saved, **kw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.cuda
def test_cuda_bwd_refuses_other_shapes_and_bf16(card):
    args, dy, dst = _card_inputs(card, 2, 2, 96, 64, 16, False, seed=10)
    _, _, saved = K.ssd_fwd_plain(*args, chunk=48, groups=2,
                                  return_saved=True)
    with pytest.raises(ValueError, match="not taken by the kernel"):
        K.ssd_bwd(*args, dy, dst, saved, chunk=48, groups=2)
    _, _, saved = K.ssd_fwd_plain(*args, chunk=32, groups=2,
                                  return_saved=True)
    with pytest.raises(TypeError, match="forward-only in bf16"):
        K.ssd_bwd(*args, dy.bfloat16(), dst, saved, chunk=32, groups=2)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,P", [(8, 8), (64, 64)])
@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("groups", [1, 50])
@pytest.mark.parametrize("N", [8, 16, 32, 64, 128])
def test_cuda_kernel_edges_bit_equal(card, nc, groups, N, chunk, P):
    """One and two chunks, one and fifty heads a group, every N (8
    padded), chunk 8 at P 8 (padded) and chunk 64 at P 64: y and the state
    bit-equal to the plain version on the card, a rerun bit-equal, one
    launch counted per call."""
    BG, Q = 2, chunk
    S, BH = nc * Q, BG * groups
    g = torch.Generator(device=card).manual_seed(nc * 1000 + groups + N)
    lo, hi = (3.0, 20.0) if groups > 1 else (0.05, 0.6)
    x = torch.randn((BH, S, P), generator=g, device=card)
    dt = torch.rand((BH, S), generator=g, device=card) * (hi - lo) + lo
    a = -torch.rand((BH,), generator=g, device=card) * 1.5 - 0.5
    d = torch.randn((BH,), generator=g, device=card)
    B = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    C = torch.randn((BG, S, N), generator=g, device=card) * 0.5
    reset_launch_counts()
    y, st = ssd_fwd(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert launch_counts()["ssd_fwd"] == 1
    yp, stp = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert torch.equal(y, yp) and torch.equal(st, stp)
    y2, st2 = ssd_fwd(x, dt, a, d, B, C, chunk=Q, groups=groups)
    assert launch_counts()["ssd_fwd"] == 2
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
def test_cuda_kernel_takes_unaligned_inputs(card):
    """x and B as contiguous views that start one element into their
    storage, so not 16-byte aligned: the wrapper hands the kernels aligned
    copies, and y and the state stay bit-equal to the plain version."""
    BG, groups, S, P, N = 2, 2, 128, 64, 16
    BH = BG * groups
    x, dt, a, d, B, C = (t.to(card) for t in _t(_mk(BH, S, P, N, BG, seed=8)))
    xu = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(BH, S, P)
    Bu = torch.cat([B.new_zeros(1), B.flatten()])[1:].view(BG, S, N)
    assert xu.data_ptr() % 16 != 0 and Bu.data_ptr() % 16 != 0
    y, st = ssd_fwd(xu, dt, a, d, Bu, C, chunk=64, groups=groups)
    yp, stp = K.ssd_fwd_plain(x, dt, a, d, B, C, chunk=64, groups=groups)
    assert torch.equal(y, yp) and torch.equal(st, stp)
