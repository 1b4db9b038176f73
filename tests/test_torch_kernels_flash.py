"""The port's flash attention against ``repro.kernels.flash_attention``.

On the CPU the wrapper runs its plain version, which repeats the CUDA
kernel's arithmetic (tile test, -1e30 masking with p forced to 0, online
softmax); it is held against the JAX Pallas kernel in interpret mode and
against the JAX dense oracle ``attention_ref``, on the same numpy inputs,
with the tolerances of ``tests/test_kernels_flash.py``: f32 atol = rtol =
2e-5, bf16 3e-2. The sweep covers causal / non-causal / sliding window,
GQA groups 1 and 4, head_dim 16 and 80, and a length that is not a
multiple of the tile (S = 200: the plain version bounds-masks its last
tile; the Pallas kernel, which needs whole tiles, runs there with 40-row
tiles).

Tests marked ``cuda`` compare the CUDA kernel with its plain version on
the card; they skip here, with the reason, when no card is present
(``python3 chip_smoke.py`` makes the same comparisons at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.kernels.flash_attention import ref as Jref
except ImportError:       # the card's machine has PyTorch but no JAX
    jnp = None
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 launch_counts, ref,
                                                 reset_launch_counts)
from repro_torch.kernels.flash_attention import kernel as K

F32_TOL, BF16_TOL = 2e-5, 3e-2


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference package, on this machine")


def _mk(B, Sq, Skv, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, hd)).astype(np.float32))


def _flat(x):
    """(B, S, H, hd) -> (B * H, S, hd)."""
    B, S, H, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))


def _np(x):
    return np.asarray(x).astype(np.float32)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


MASKS = [(True, 0), (False, 0), (True, 24), (False, 24)]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("hd", [16, 80])
def test_plain_vs_pallas_and_ref(causal, window, H, KV, hd, jax_ref):
    """Kernel layout (BH, S, hd): the plain version against the Pallas
    kernel, both at 32-row tiles (so the tile tests skip tiles), and
    against the dense oracle."""
    B, S = 2, 96
    q, k, v = (_flat(a) for a in _mk(B, S, S, H, KV, hd))
    groups = H // KV
    out = flash_attention_fwd(_torch(q), _torch(k), _torch(v), groups=groups,
                              causal=causal, window=window, block_q=32,
                              block_kv=32).numpy()
    pallas = _np(jax_flash(
        jnp.asarray(q.reshape(B, H, S, hd).transpose(0, 2, 1, 3)),
        jnp.asarray(k.reshape(B, KV, S, hd).transpose(0, 2, 1, 3)),
        jnp.asarray(v.reshape(B, KV, S, hd).transpose(0, 2, 1, 3)),
        causal=causal, window=window, block_q=32, block_kv=32,
        interpret=True)).transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    dense = _np(Jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), groups=groups,
                                   causal=causal, window=window))
    np.testing.assert_allclose(out, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(out, dense, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_tail_length_not_a_tile_multiple(hd, causal, window, jax_ref):
    """S = 200 with the plain version's 128-row tiles (a 72-row tail tile)
    against the Pallas kernel at 40-row tiles and the dense oracle."""
    B, S, H, KV = 1, 200, 4, 1
    qm, km, vm = _mk(B, S, S, H, KV, hd, seed=1)
    out = flash_attention(_torch(qm), _torch(km), _torch(vm), causal=causal,
                          window=window).numpy()
    pallas = _np(jax_flash(jnp.asarray(qm), jnp.asarray(km), jnp.asarray(vm),
                           causal=causal, window=window, block_q=40,
                           block_kv=40, interpret=True))
    dense = _np(Jref.attention_ref(
        jnp.asarray(_flat(qm)), jnp.asarray(_flat(km)),
        jnp.asarray(_flat(vm)), groups=H // KV, causal=causal,
        window=window)).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(out, dense, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_ops_wrapper_dtypes_vs_pallas(dtype, tol, jax_ref):
    """Model layout (B, S, H, hd) in f32 and bf16 against the JAX ops
    wrapper on the same values (bf16 rounded once from the same f32)."""
    B, S, H, KV, hd = 1, 128, 4, 2, 64
    qm, km, vm = _mk(B, S, S, H, KV, hd, seed=3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = flash_attention(_torch(qm, dtype), _torch(km, dtype),
                          _torch(vm, dtype), causal=True, window=48)
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    expect = _np(jax_flash(jnp.asarray(qm, jdt), jnp.asarray(km, jdt),
                           jnp.asarray(vm, jdt), causal=True, window=48,
                           interpret=True))
    np.testing.assert_allclose(out.float().numpy(), expect, atol=tol,
                               rtol=tol)


def _hand_rolled_bf16_p(q, k, v, *, groups, causal, window):
    """Dense two-pass softmax attention on bf16 inputs with p rounded to
    bf16 before the product with v (the tensor cores' P operand) and the
    row sums taken from the unrounded p."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf = kf.repeat_interleave(groups, dim=0)
    vf = vf.repeat_interleave(groups, dim=0)
    S, Skv = q.shape[1], k.shape[1]
    s = (qf @ kf.transpose(1, 2)) * q.shape[-1] ** -0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(Skv)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    s = torch.where(mask, s, torch.full((), -1e30))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros(()))
    out = (p.bfloat16().float() @ vf) / p.sum(dim=-1, keepdim=True)
    return out.bfloat16()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_plain_bf16_rounds_p_like_the_tensor_cores(causal, window,
                                                   jax_ref):
    """On bf16 inputs the plain version rounds p to bf16 before p @ v: in
    one 128-row tile (no online rescaling) it is bit-equal to a hand-rolled
    dense version that does the same, differs from the f32-p result, and
    still meets BF16_TOL against the Pallas kernel."""
    B, S, H, KV, hd = 1, 96, 4, 2, 64
    qm, km, vm = _mk(B, S, S, H, KV, hd, seed=11)
    q, k, v = (_torch(_flat(a), torch.bfloat16) for a in (qm, km, vm))
    kw = dict(groups=H // KV, causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, block_q=128, block_kv=128, **kw)
    want = _hand_rolled_bf16_p(q, k, v, **kw)
    assert torch.equal(out, want)
    f32_p = flash_attention_fwd(q.float(), k.float(), v.float(), **kw)
    assert not torch.equal(out, f32_p.bfloat16())
    pallas = _np(jax_flash(jnp.asarray(qm, jnp.bfloat16),
                           jnp.asarray(km, jnp.bfloat16),
                           jnp.asarray(vm, jnp.bfloat16), causal=causal,
                           window=window, block_q=32, block_kv=32,
                           interpret=True))
    pallas = np.ascontiguousarray(pallas.transpose(0, 2, 1, 3).reshape(
        B * H, S, hd))
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("groups,causal,window", [(1, True, 0), (4, False, 0),
                                                  (2, True, 40)])
def test_attention_ref_vs_jax(groups, causal, window, jax_ref):
    BKV, S, hd = 2, 72, 16
    rng = np.random.default_rng(5)
    q = rng.normal(size=(BKV * groups, S, hd)).astype(np.float32)
    k = rng.normal(size=(BKV, S, hd)).astype(np.float32)
    v = rng.normal(size=(BKV, S, hd)).astype(np.float32)
    out = ref.attention_ref(_torch(q), _torch(k), _torch(v), groups=groups,
                            causal=causal, window=window).numpy()
    expect = _np(Jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), groups=groups,
                                    causal=causal, window=window))
    np.testing.assert_allclose(out, expect, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("blocks", [(16, 16), (32, 64), (128, 128), (24, 40)])
def test_plain_tiles_do_not_change_the_result(blocks):
    """The plain version's tiles (and the tiles its tile test skips) change
    only the rounding: every tiling agrees with the dense oracle."""
    bq, bkv = blocks
    q, k, v = (_torch(_flat(a)) for a in _mk(1, 100, 100, 4, 2, 16, seed=7))
    out = flash_attention_fwd(q, k, v, groups=2, causal=True, window=30,
                              block_q=bq, block_kv=bkv)
    dense = ref.attention_ref(q, k, v, groups=2, causal=True, window=30)
    torch.testing.assert_close(out, dense, atol=F32_TOL, rtol=F32_TOL)


def test_fully_masked_prefix_rows_stay_finite():
    """Row 0 with a window of 1 sees one key; every other key of its tiles
    is masked, so p must be forced to 0 after the exp (exp(0) = 1 on a
    -1e30 row max would otherwise sum garbage into l and acc)."""
    q, k, v = (_torch(_flat(a)) for a in _mk(1, 40, 40, 2, 2, 16, seed=2))
    out = flash_attention_fwd(q, k, v, causal=True, window=1, block_q=16,
                              block_kv=16)
    torch.testing.assert_close(out, v, atol=F32_TOL, rtol=F32_TOL)


def test_cpu_run_launches_nothing():
    reset_launch_counts()
    q, k, v = (_torch(_flat(a)) for a in _mk(1, 16, 16, 2, 2, 16))
    flash_attention_fwd(q, k, v)
    assert launch_counts() == {"flash_attention_fwd": 0}


@pytest.mark.parametrize("bad", ["groups", "dtype", "mixed", "hd", "device"])
def test_wrapper_checks_inputs(bad):
    q = torch.ones((4, 8, 16))
    k = torch.ones((2, 8, 16))
    args = {"groups": ((q, k, k), dict(groups=3)),
            "dtype": ((q.double(), k.double(), k.double()), {}),
            "mixed": ((q, k.bfloat16(), k), dict(groups=2)),
            "hd": ((q, torch.ones((2, 8, 8)), torch.ones((2, 8, 8))),
                   dict(groups=2)),
            "device": ((q.to("meta"), k.to("meta"), k.to("meta")),
                       dict(groups=2))}[bad]
    with pytest.raises((TypeError, ValueError)):
        flash_attention_fwd(*args[0], **args[1])


def test_ops_hands_the_kernel_contiguous_inputs(monkeypatch):
    """The kernel takes contiguous inputs only; at batch 1 the folded
    (B * H, S, hd) view of q is not contiguous unless the wrapper copies."""
    from repro_torch.kernels.flash_attention import ops
    seen = []

    def spy(q, k, v, **kw):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return K.flash_attention_fwd_plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    flash_attention(torch.randn(1, 24, 4, 16), torch.randn(1, 24, 2, 16),
                    torch.randn(1, 24, 2, 16))
    assert seen and all(seen)


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ for sm_90a, "
                    "built with nvcc, with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (50, 10, 2048, 64, True, 1024), (8, 8, 200, 80, True, 0),
    (4, 4, 130, 128, False, 0), (8, 4, 300, 256, True, 0),
    (8, 2, 64, 64, True, 1024)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_vs_plain(card, shape, dtype, tol):
    BH, BKV, S, hd, causal, window = shape
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((BH, S, hd), generator=g, device=card).to(dtype)
    k = torch.randn((BKV, S, hd), generator=g, device=card).to(dtype)
    v = torch.randn((BKV, S, hd), generator=g, device=card).to(dtype)
    kw = dict(groups=BH // BKV, causal=causal, window=window)
    reset_launch_counts()
    out = flash_attention_fwd(q, k, v, **kw)
    assert launch_counts()["flash_attention_fwd"] == 1
    plain = K.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert torch.equal(out, flash_attention_fwd(q, k, v, **kw))


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_head_dims(card):
    q = torch.ones((2, 8, 32), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_cuda_kernel_refuses_to_drop_gradients(card, needs_grad):
    """The kernel is forward-only: with grad mode on, an input that
    requires grad raises instead of giving an output without a grad_fn;
    under no_grad the same call runs."""
    g = torch.Generator(device=card).manual_seed(3)
    qkv = {n: torch.randn((4, 64, 64), generator=g, device=card)
           for n in "qkv"}
    qkv[needs_grad].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_fwd(qkv["q"], qkv["k"], qkv["v"])
    with torch.no_grad():
        out = flash_attention_fwd(qkv["q"], qkv["k"], qkv["v"])
    assert out.shape == (4, 64, 64) and not out.requires_grad


EDGE_MASKS = [(True, 0), (True, 48), (False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("causal,window", EDGE_MASKS)
@pytest.mark.parametrize("S", [64, 200, 300, 520])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_cuda_kernel_edges(card, hd, S, causal, window, dtype, tol):
    """Every head dim, lengths that are and are not a multiple of a tile,
    GQA groups 1, 4 and 5 (taken in turn), causal with and without the
    window and non-causal: the kernel against its plain version, a rerun
    bit-equal, one launch counted per call."""
    groups = (1, 4, 5)[(hd // 16 + S + window) % 3]
    BKV = 2
    g = torch.Generator(device=card).manual_seed(hd * 7 + S)
    q = torch.randn((BKV * groups, S, hd), generator=g, device=card).to(dtype)
    k = torch.randn((BKV, S, hd), generator=g, device=card).to(dtype)
    v = torch.randn((BKV, S, hd), generator=g, device=card).to(dtype)
    kw = dict(groups=groups, causal=causal, window=window)
    reset_launch_counts()
    out = flash_attention_fwd(q, k, v, **kw)
    assert launch_counts()["flash_attention_fwd"] == 1
    plain = K.flash_attention_fwd_plain(q, k, v, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert torch.equal(out, flash_attention_fwd(q, k, v, **kw))
    assert launch_counts()["flash_attention_fwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_takes_unaligned_inputs(card, dtype, tol):
    """q as a contiguous view that starts two elements into its storage,
    so not 16-byte aligned: the wrapper hands the kernel an aligned copy."""
    BH, S, hd = 4, 100, 64
    g = torch.Generator(device=card).manual_seed(3)
    buf = torch.randn((BH * S * hd + 2,), generator=g, device=card).to(dtype)
    q = buf[2:].view(BH, S, hd)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    k = torch.randn((2, S, hd), generator=g, device=card).to(dtype)
    v = torch.randn((2, S, hd), generator=g, device=card).to(dtype)
    out = flash_attention_fwd(q, k, v, groups=2, causal=True, window=32)
    plain = K.flash_attention_fwd_plain(q, k, v, groups=2, causal=True,
                                        window=32)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
