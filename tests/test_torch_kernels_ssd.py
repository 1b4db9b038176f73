"""The port's SSD scan against ``repro.kernels.ssd``.

On the CPU the wrapper runs its plain version, which repeats the CUDA
kernel's arithmetic (the sequential in-order cumsum, the chunk loop, the
where-guarded decay tile); it is held against the JAX Pallas kernel in
interpret mode and against the JAX naive recurrence ``ssd_ref``, y and the
final state, on the same numpy inputs, at the tolerance of
``tests/test_kernels_ssd.py``: atol = rtol = 2e-4.

One case drives dt * a so hard that cum_i - cum_j for i < j passes 88
inside a chunk, as the reference's full-width weights do (ROADMAP C-5):
exp of it is +inf in f32, and a decay tile formed as exp * 0/1-mask would
be NaN. y must stay finite and equal JAX's.

Tests marked ``cuda`` compare the CUDA kernel with its plain version on
the card; they skip here, with the reason, when no card is present
(``python3 chip_smoke.py`` makes the same comparisons at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.ssd import ssd_attention as jax_ssd_attention
    from repro.kernels.ssd import ssd_fwd as jax_ssd_fwd
    from repro.kernels.ssd import ref as Jref
except ImportError:       # the card's machine has PyTorch but no JAX
    jnp = None
from repro_torch.kernels.ssd import (launch_counts, ref, reset_launch_counts,
                                     ssd_attention, ssd_fwd)
from repro_torch.kernels.ssd import kernel as K

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
    ssd_fwd(*_t(_mk(2, 16, 4, 4, 2)), chunk=8)
    assert launch_counts() == {"ssd_fwd": 0}


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
        x, dt, a, d, B, C = (t.to("meta") for t in (x, dt, a, d, B, C))
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
@pytest.mark.parametrize("P,N,chunk", [(32, 16, 64), (64, 8, 64),
                                       (64, 16, 32)])
def test_cuda_kernel_refuses_other_shapes(card, P, N, chunk):
    x, dt, a, d, B, C = (t.to(card) for t in _t(_mk(2, 128, P, N, 2)))
    with pytest.raises(ValueError, match="not taken by the kernel"):
        ssd_fwd(x, dt, a, d, B, C, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", [0, 1, 4])     # x, dt, B
def test_cuda_kernel_refuses_to_drop_gradients(card, needs_grad):
    """The kernels are forward-only: with grad mode on, an input that
    requires grad raises instead of giving outputs without a grad_fn;
    under no_grad the same call runs."""
    args = [t.to(card) for t in _t(_mk(2, 128, 64, 16, 2))]
    args[needs_grad].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_fwd(*args, chunk=64)
    with torch.no_grad():
        y, st = ssd_fwd(*args, chunk=64)
    assert not (y.requires_grad or st.requires_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("groups", [1, 50])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
def test_cuda_kernel_edges_bit_equal(card, nc, groups, N):
    """One and two chunks, one and fifty heads a group, every N: y and
    the state bit-equal to the plain version on the card, a rerun
    bit-equal, one launch counted per call."""
    BG, P, Q = 2, 64, 64
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
