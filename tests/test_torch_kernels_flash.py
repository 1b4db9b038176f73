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

The backward: ``flash_attention_bwd_plain`` (through
``FlashAttentionFunction``, which the wrapper takes under grad) against
autograd through ``flash_attention_fwd_plain`` and against ``jax.grad`` of
``repro.models.attention.chunked_attention`` (the reference's training
attention), over head_dim 16, 64 and 80, causal / non-causal / window,
GQA groups 1, 2, 4 and 5, and lengths that are not a tile multiple; dq,
dk and dv at the forward's f32 tolerance, 2e-5 (measured: 4e-6). The
forward plain version's lse equals the dense logsumexp of the scaled,
masked logits. The backward's plain version sums each query tile's dq
parts in the kernel's turn order (its first kv tile first), over the kv
tiles that the forward's tile test keeps; on zero-padded head dims (how
the card runs a head_dim that is not a kernel's) both plain versions give
the unpadded result and exact zeros in the padded columns.

Tests marked ``cuda`` compare the CUDA kernels with their plain versions
on the card (the backward at f32 2e-5 of each gradient's scale over
every kernel head dim and a padded one, GQA 1 and 5, every mask and tail
lengths; ten reruns bit-equal, one on a second stream beside another
kernel), check that head dims up to 256 run zero-padded and larger ones
raise, that an input that requires grad gets its gradient through the
kernels in f32 and in bf16, hold the bf16 backward kernel to its plain
version at the kernel's tiles (1e-2 of each gradient's scale over every
kernel head dim, S 64, 200, 300 and 520, every mask and a window that
starts inside a 128-key tile, GQA 1, 4 and 5, query and key lengths that
differ; a rerun bit-equal; one launch a call, counted under bf16; ten
reruns bit-equal at stablelm-3b's and hymba-1.5b's training attention,
one on a second stream), and run reduced stablelm-3b's
``Model.loss`` and gradients on the card against the CPU's, and so
reduced hymba-1.5b's and mamba2-370m's (their SSD through the SSD
kernels, forward and backward); they skip here, with the reason,
when no card is present (``python3 chip_smoke.py`` makes the same
comparisons at full size).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.kernels.flash_attention import ref as Jref
    from repro.models.attention import chunked_attention
    import jax
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
    q.requires_grad_(True)
    flash_attention_fwd(q, k, v).sum().backward()
    assert launch_counts() == {"flash_attention_fwd": 0,
                               "flash_attention_bwd": 0}


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


@pytest.mark.parametrize("bad", ["groups", "dtype", "mixed", "hd", "device"])
def test_wrapper_checks_inputs(bad):
    q = torch.ones((4, 8, 16))
    k = torch.ones((2, 8, 16))
    args = {"groups": ((q, k, k), dict(groups=3)),
            "dtype": ((q.double(), k.double(), k.double()), {}),
            "mixed": ((q, k.bfloat16(), k), dict(groups=2)),
            "hd": ((q, torch.ones((2, 8, 8)), torch.ones((2, 8, 8))),
                   dict(groups=2)),
            "device": ((_Elsewhere(q), _Elsewhere(k), _Elsewhere(k)),
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


# ------------------------------ the backward ---------------------------------

BWD_CASES = [  # (B, S, H, KV, hd, causal, window)
    (1, 200, 4, 4, 16, True, 0), (2, 130, 4, 2, 64, True, 48),
    (1, 200, 8, 2, 80, False, 0), (1, 96, 4, 1, 16, False, 24),
    (2, 77, 8, 2, 80, True, 0), (1, 150, 8, 4, 64, True, 0),
    (1, 100, 2, 1, 80, True, 1), (1, 170, 10, 2, 16, True, 40),
    (2, 90, 10, 2, 64, False, 30)]


def _grads(B, S, H, KV, hd, causal, window, seed=0):
    qm, km, vm = _mk(B, S, S, H, KV, hd, seed=seed)
    dout = np.random.default_rng(seed + 1).normal(size=qm.shape).astype(
        np.float32)
    ts = [_torch(x).requires_grad_(True) for x in (qm, km, vm)]
    out = flash_attention(*ts, causal=causal, window=window, block_q=64,
                          block_kv=64)
    out.backward(_torch(dout))
    return (qm, km, vm, dout), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_plain_vs_jax_grad_of_chunked_attention(case, jax_ref):
    B, S, H, KV, hd, causal, window = case
    (qm, km, vm, dout), got = _grads(*case)
    R = H // KV

    def f(q, k, v):
        o = chunked_attention(q.reshape(B, S, KV, R, hd), k, v,
                              causal=causal, window=window, q_chunk=64,
                              kv_chunk=64)
        return jnp.sum(o.reshape(B, S, H, hd) * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(qm, km, vm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, _np(w), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_plain_vs_autograd_of_fwd_plain(case):
    """The Function's backward (the plain version) against autograd
    differentiating the forward's plain version op by op."""
    B, S, H, KV, hd, causal, window = case
    (qm, km, vm, dout), got = _grads(*case, seed=4)
    ts = [_torch(_flat(x)).requires_grad_(True) for x in (qm, km, vm)]
    with torch.enable_grad():
        out = K.flash_attention_fwd_plain(*ts, groups=H // KV, causal=causal,
                                          window=window, block_q=64,
                                          block_kv=64)
    out.backward(_torch(_flat(dout)))
    for g, t, heads in zip(got, ts, (H, KV, KV)):
        want = t.grad.numpy().reshape(B, heads, S, hd).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("blocks", [(16, 16), (64, 32), (40, 24)])
def test_bwd_plain_tiles_change_only_rounding(blocks):
    B, S, H, KV, hd = 1, 90, 4, 2, 16
    q, k, v = (_torch(_flat(a)) for a in _mk(B, S, S, H, KV, hd, seed=6))
    kw = dict(groups=2, causal=True, window=40)
    out, lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    ref_g = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    got = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw,
                                      block_q=blocks[0], block_kv=blocks[1])
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_fwd_plain_lse_is_the_row_logsumexp(causal, window):
    B, S, H, KV, hd = 1, 70, 4, 2, 16
    q, k, v = (_torch(_flat(a)) for a in _mk(B, S, S, H, KV, hd, seed=8))
    _, lse = K.flash_attention_fwd_plain(q, k, v, groups=2, causal=causal,
                                         window=window, block_q=32,
                                         block_kv=32, return_lse=True)
    s = q @ k.repeat_interleave(2, 0).transpose(1, 2) * hd ** -0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (H, S)
    torch.testing.assert_close(lse, want, atol=F32_TOL, rtol=F32_TOL)


def test_bwd_wrapper_checks_shapes():
    q = torch.ones((4, 8, 16))
    k = torch.ones((2, 8, 16))
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention_bwd(q, k, k, q, q, torch.ones(4, 7), groups=2)


def test_bwd_wrapper_checks_dtypes():
    """out and dout in q's dtype, lse in f32, on either device."""
    q = torch.ones((2, 8, 16), dtype=torch.bfloat16)
    lse = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="float32"):
        K.flash_attention_bwd(q, q, q, q, q, lse.bfloat16())
    with pytest.raises(TypeError, match="q's dtype"):
        K.flash_attention_bwd(q, q, q, q.float(), q, lse)
    dq, dk, dv = K.flash_attention_bwd(q, q, q, q, q, lse)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


@pytest.mark.parametrize("S,bq,bkv", [(200, 64, 64), (130, 32, 64),
                                      (77, 32, 32), (300, 64, 64)])
@pytest.mark.parametrize("causal,window", MASKS + [(True, 1), (True, 130)])
def test_kv_tile_range_is_the_forward_tile_test(S, bq, bkv, causal, window):
    """The backward's turn range (j_lo .. j_hi) for every query tile is
    exactly the set of kv tiles that the forward's tile test keeps."""
    nkv = -(-S // bkv)
    for i0 in range(0, S, bq):
        kept = [j for j in range(nkv)
                if not (causal and j * bkv > i0 + bq - 1)
                and not (window and i0 - (j * bkv + bkv - 1) >= window)]
        j_lo, j_hi = K._kv_tiles(i0, bq, bkv, nkv, causal, window)
        assert kept == list(range(j_lo, j_hi + 1)), (i0, kept, j_lo, j_hi)


def test_bwd_plain_sums_dq_in_turn_order():
    """dq of each query tile = (part of its first kv tile + ... + part of
    its last) * scale, the kernel's turn order, bit for bit."""
    B, S, H, KV, hd = 1, 150, 4, 2, 16
    bq = bkv = 32
    q, k, v = (_torch(_flat(a)) for a in _mk(B, S, S, H, KV, hd, seed=9))
    kw = dict(groups=2, causal=True, window=70)
    out, lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    dq = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw,
                                     block_q=bq, block_kv=bkv)[0]
    scale = hd ** -0.5
    kr = k.repeat_interleave(2, 0)
    vr = v.repeat_interleave(2, 0)
    delta = (dout * out).sum(-1, keepdim=True)
    for i0 in range(0, S, bq):
        i1 = min(i0 + bq, S)
        j_lo, j_hi = K._kv_tiles(i0, bq, bkv, -(-S // bkv), True, 70)
        part = None
        for j in range(j_lo, j_hi + 1):
            j0, j1 = j * bkv, min(j * bkv + bkv, S)
            s = (q[:, i0:i1] @ kr[:, j0:j1].transpose(1, 2)) * scale
            mask = K._mask(torch.arange(i0, i1)[:, None],
                           torch.arange(j0, j1)[None, :], True, 70)
            p = torch.where(mask, torch.exp(s - lse[:, i0:i1, None]),
                            torch.zeros(()))
            ds = p * (dout[:, i0:i1] @ vr[:, j0:j1].transpose(1, 2)
                      - delta[:, i0:i1])
            part = ds @ kr[:, j0:j1] if part is None else \
                part + ds @ kr[:, j0:j1]
        assert torch.equal(dq[:, i0:i1], part * scale), i0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 80, 96, 128, 192, 256])
def test_bwd_tiles_by_head_dim_and_dtype(hd, dtype):
    """The backward kernels' tiles (query rows, keys) at the kernel head dim
    that runs hd: the f32 kernel 64 x 64 at every head dim; the bf16 one 64
    x 128 (two 64-key strips) up to 128 and 64 x 32 at 256. The plain
    version takes them by default."""
    want = (64, 64) if dtype == torch.float32 else \
        (64, 32) if K.kernel_head_dim(hd) > 128 else (64, 128)
    assert K.bwd_tiles(hd, dtype) == want
    q, k, v = (_torch(_flat(a)).to(dtype)
               for a in _mk(1, 150, 150, 2, 1, hd, seed=hd))
    kw = dict(groups=2, causal=True, window=90)
    out, lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    dout = dout.to(dtype)
    got = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    tiled = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw,
                                        block_q=want[0], block_kv=want[1])
    assert all(torch.equal(a, b) for a, b in zip(got, tiled))


@pytest.mark.parametrize("hd,causal,window", [(64, True, 70), (64, False, 0),
                                              (80, True, 0),
                                              (256, True, 100)])
def test_bwd_plain_bf16_sums_dq_in_turn_order_at_kernel_tiles(hd, causal,
                                                             window):
    """The bf16 plain backward at the bf16 kernel's tiles (64 x 128, or 64 x
    32 at hd 256): dq of each query tile = (part of its first kv tile + ...
    + part of its last) * scale, with P and dS rounded as the tensor cores'
    operands (dS as hi + lo), then rounded to bf16 once, bit for bit."""
    B, S, H, KV = 1, 300, 4, 2
    bq, bkv = K.bwd_tiles(hd, torch.bfloat16)
    q, k, v = (_torch(_flat(a)).bfloat16()
               for a in _mk(B, S, S, H, KV, hd, seed=hd + window))
    kw = dict(groups=2, causal=causal, window=window)
    out, lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    dout = dout.bfloat16()
    dq = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)[0]
    scale = hd ** -0.5
    qf, doutf = q.float(), dout.float()
    kr = k.float().repeat_interleave(2, 0)
    vr = v.float().repeat_interleave(2, 0)
    delta = (doutf * out.float()).sum(-1, keepdim=True)
    nkv = -(-S // bkv)
    for i0 in range(0, S, bq):
        i1 = min(i0 + bq, S)
        j_lo, j_hi = K._kv_tiles(i0, bq, bkv, nkv, causal, window)
        part = None
        for j in range(j_lo, j_hi + 1):
            j0, j1 = j * bkv, min(j * bkv + bkv, S)
            s = (qf[:, i0:i1] @ kr[:, j0:j1].transpose(1, 2)) * scale
            mask = K._mask(torch.arange(i0, i1)[:, None],
                           torch.arange(j0, j1)[None, :], causal, window)
            p = torch.where(mask, torch.exp(s - lse[:, i0:i1, None]),
                            torch.zeros(()))
            ds = p * (doutf[:, i0:i1] @ vr[:, j0:j1].transpose(1, 2)
                      - delta[:, i0:i1])
            hi = ds.bfloat16().float()
            ds = hi + (ds - hi).bfloat16().float()
            part = ds @ kr[:, j0:j1] if part is None else \
                part + ds @ kr[:, j0:j1]
        want = (part * scale).bfloat16() if part is not None else \
            torch.zeros_like(dq[:, i0:i1])
        assert torch.equal(dq[:, i0:i1], want), i0


def test_kernel_head_dim_pads_to_the_next_kernel():
    got = {hd: K.kernel_head_dim(hd) for hd in (1, 16, 64, 65, 80, 81, 96,
                                                 128, 129, 192, 256)}
    assert got == {1: 64, 16: 64, 64: 64, 65: 80, 80: 80, 81: 128, 96: 128,
                   128: 128, 129: 256, 192: 256, 256: 256}
    with pytest.raises(ValueError, match="head_dim 257"):
        K.kernel_head_dim(257)


@pytest.mark.parametrize("hd", [16, 48, 96])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_plain_on_zero_padded_head_dims(hd, causal, window):
    """What the card runs for a head_dim that is not a kernel's: q, k, v,
    out and dout zero-padded to the next kernel head dim, scale
    head_dim ** -0.5. The padded columns of out, dq, dk, dv are exact
    zeros; the rest equals the unpadded plain versions' within f32
    rounding."""
    B, S, H, KV = 1, 90, 4, 2
    hdp = K.kernel_head_dim(hd)
    q, k, v = (_torch(_flat(a)) for a in _mk(B, S, S, H, KV, hd, seed=3))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    kw = dict(groups=H // KV, causal=causal, window=window, block_q=32,
              block_kv=32)
    pad = lambda t: torch.nn.functional.pad(t, (0, hdp - hd))
    out, lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    outp, lsep = K.flash_attention_fwd_plain(
        pad(q), pad(k), pad(v), return_lse=True, scale=hd ** -0.5, **kw)
    assert torch.equal(outp[..., hd:], torch.zeros_like(outp[..., hd:]))
    torch.testing.assert_close(outp[..., :hd], out, atol=F32_TOL,
                               rtol=F32_TOL)
    torch.testing.assert_close(lsep, lse, atol=F32_TOL, rtol=F32_TOL)
    want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    got = K.flash_attention_bwd_plain(pad(q), pad(k), pad(v), pad(out),
                                      pad(dout), lse, scale=hd ** -0.5, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g[..., hd:], torch.zeros_like(g[..., hd:]))
        torch.testing.assert_close(g[..., :hd], w, atol=F32_TOL,
                                   rtol=F32_TOL)


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
@pytest.mark.parametrize("hd", [16, 48, 96])
def test_cuda_kernel_pads_other_head_dims(card, hd):
    """Fault C-9: a head_dim that is not a kernel's runs zero-padded to the
    next one, with the true scale: the forward in f32 and bf16 and the
    backward against their plain versions, one launch each."""
    g = torch.Generator(device=card).manual_seed(hd)
    S, groups = 130, 5
    q = torch.randn((2 * groups, S, hd), generator=g, device=card)
    k = torch.randn((2, S, hd), generator=g, device=card)
    v = torch.randn((2, S, hd), generator=g, device=card)
    kw = dict(groups=groups, causal=True, window=48)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        args = [t.to(dtype) for t in (q, k, v)]
        out = flash_attention_fwd(*args, **kw)
        assert out.shape == args[0].shape and out.is_contiguous()
        plain = K.flash_attention_fwd_plain(*args, **kw)
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
    out, lse = K._fwd_kernel(q, k, v, groups, True, 48, True)
    dout = torch.randn(q.shape, generator=g, device=card)
    reset_launch_counts()
    got = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert launch_counts()["flash_attention_bwd"] == 1
    want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=2e-5 * float(b.abs().max()),
                                   rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_refuses_head_dims_above_256(card):
    q = torch.ones((2, 8, 264), device=card)
    with pytest.raises(ValueError, match="head_dim 264"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head_dim 264"):
        K.flash_attention_bwd(q, q, q, q, q, torch.zeros((2, 8), device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_cuda_kernel_refuses_to_drop_gradients(card, needs_grad):
    """An input that requires grad gets its gradient through the kernels
    (one forward and one backward launch), equal to the plain versions'
    within 2e-5 of the gradient's scale in f32 and 1e-2 in bf16 (the bf16
    backward kernel, counted under bf16); under no_grad the same call runs
    the forward alone."""
    g = torch.Generator(device=card).manual_seed(3)
    qkv = {n: torch.randn((4, 64, 64), generator=g, device=card)
           for n in "qkv"}
    qkv[needs_grad].requires_grad_(True)
    reset_launch_counts()
    out = flash_attention_fwd(qkv["q"], qkv["k"], qkv["v"])
    dout = torch.randn(out.shape, generator=g, device=card)
    (grad,) = torch.autograd.grad(out, qkv[needs_grad], dout)
    assert launch_counts() == {"flash_attention_fwd": 1,
                               "flash_attention_bwd": 1}
    plain_out, lse = K.flash_attention_fwd_plain(
        *(t.detach() for t in qkv.values()), return_lse=True)
    want = dict(zip("qkv", K.flash_attention_bwd_plain(
        *(t.detach() for t in qkv.values()), plain_out, dout, lse)))
    torch.testing.assert_close(grad, want[needs_grad],
                               atol=2e-5 * float(want[needs_grad].abs().max()),
                               rtol=0)
    with torch.no_grad():
        out = flash_attention_fwd(qkv["q"], qkv["k"], qkv["v"])
    assert out.shape == (4, 64, 64) and not out.requires_grad
    bf = {n: t.detach().bfloat16().requires_grad_(n == needs_grad)
          for n, t in qkv.items()}
    reset_launch_counts()
    out = flash_attention_fwd(bf["q"], bf["k"], bf["v"])
    (grad,) = torch.autograd.grad(out, bf[needs_grad], dout.bfloat16())
    assert launch_counts() == {"flash_attention_fwd": 1,
                               "flash_attention_bwd": 1}
    assert K.bwd_launches_by_dtype() == {"float32": 0, "bfloat16": 1}
    assert grad.dtype == torch.bfloat16
    plain_out, lse = K.flash_attention_fwd_plain(
        *(t.detach() for t in bf.values()), return_lse=True)
    want = dict(zip("qkv", K.flash_attention_bwd_plain(
        *(t.detach() for t in bf.values()), plain_out, dout.bfloat16(),
        lse)))
    torch.testing.assert_close(
        grad.float(), want[needs_grad].float(),
        atol=1e-2 * float(want[needs_grad].float().abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
@pytest.mark.parametrize("S", [64, 200, 300])
@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
def test_cuda_bwd_kernel_vs_plain(card, hd, S, causal, window, groups):
    """The backward kernel against its plain version on the forward
    kernel's out and lse (the forward's lse against the plain one's),
    every kernel head dim and hd 16 (zero-padded to 64), tails that are not
    a tile multiple, GQA groups 1 and 5; dq, dk, dv within 2e-5 of each
    gradient's scale, a rerun bit-equal."""
    BKV = 2
    g = torch.Generator(device=card).manual_seed(hd * 5 + S)
    q = torch.randn((BKV * groups, S, hd), generator=g, device=card)
    k = torch.randn((BKV, S, hd), generator=g, device=card)
    v = torch.randn((BKV, S, hd), generator=g, device=card)
    kw = dict(groups=groups, causal=causal, window=window)
    out, lse = K._fwd_kernel(q, k, v, groups, causal, window, True)
    _, plain_lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True,
                                               **kw)
    torch.testing.assert_close(lse, plain_lse, atol=2e-5, rtol=2e-5)
    dout = torch.randn(q.shape, generator=g, device=card)
    reset_launch_counts()
    got = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert launch_counts()["flash_attention_bwd"] == 1
    want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=2e-5 * float(b.abs().max()),
                                   rtol=0)
    again = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,groups,window,dtype", [
    (80, 1, 0, torch.float32), (64, 5, 256, torch.float32),
    (80, 1, 0, torch.bfloat16), (64, 5, 1024, torch.bfloat16)])
def test_cuda_bwd_ten_reruns_bit_equal(card, hd, groups, window, dtype):
    """The dq adds run in the turn counters' order, not the scheduler's:
    ten reruns at a size that fills the card are bit-equal, one of them on
    a second stream while matrix products run on the first. In bf16 at
    stablelm-3b's training attention (16 heads) and hymba-1.5b's (5 kv
    heads of 5 queries each, window 1024, so its items take one query head
    each and dk, dv sum over the parts), S 2048, within 1e-2 of each
    gradient's scale of the plain version."""
    S, BKV = (1024, 8) if dtype == torch.float32 else \
        (2048, 16 if groups == 1 else 5)
    g = torch.Generator(device=card).manual_seed(hd)
    q, k, v, dout = (torch.randn(s, generator=g, device=card).to(dtype)
                     for s in ((BKV * groups, S, hd), (BKV, S, hd),
                               (BKV, S, hd), (BKV * groups, S, hd)))
    kw = dict(groups=groups, causal=True, window=window)
    out, lse = K._fwd_kernel(q, k, v, groups, True, window, True)
    args = (q, k, v, out, dout, lse)
    first = K.flash_attention_bwd(*args, **kw)
    runs = [K.flash_attention_bwd(*args, **kw) for _ in range(9)]
    big = torch.randn((4096, 4096), generator=g, device=card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    busy = [big @ big for _ in range(4)]       # queued on the first stream
    with torch.cuda.stream(side):
        beside = K.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    del busy
    runs.append(beside)
    want = K.flash_attention_bwd_plain(*args, **kw)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(first, want):
        torch.testing.assert_close(
            a.float(), b.float(), atol=tol * float(b.float().abs().max()),
            rtol=0)
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(first, run))


def _reduced(arch):
    from repro_torch import configs as TC
    from repro_torch.models import zoo as TZ
    cfg = TC.get_reduced(arch)
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 49))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    return cfg, model, params, batch


def _on(params, batch, dev):
    from repro_torch._tree import tree_map
    return (tree_map(lambda a: a.detach().to(dev, copy=True)
                     .requires_grad_(), params),
            {k: t.to(dev) for k, t in batch.items()})


def _leaf_grads(params):
    from repro_torch._tree import tree_map
    return tree_map(lambda a: a.grad, params)


def _loss_and_grads_card_vs_cpu(card, model, params, batch, want):
    """Model.loss and every gradient leaf on the card (kernels) against
    the same step on the CPU (plain versions), at tests/test_torch_train.py's
    tolerances (loss 2e-5, each leaf 5e-4 of its largest entry), and the
    launch counts of the card's step against ``want``."""
    from repro_torch._tree import flatten_with_path
    from repro_torch.kernels.ssd import kernel as SK
    got = {}
    for dev in (card, "cpu"):
        p, b = _on(params, batch, dev)
        reset_launch_counts()
        SK.reset_launch_counts()
        loss, _ = model.loss(p, b)
        loss.backward()
        if dev == card:
            assert {**launch_counts(), **SK.launch_counts()} == want
        got[str(dev)] = (float(loss), dict(flatten_with_path(_leaf_grads(p))))
    (lc, gc), (lh, gh) = got[str(card)], got["cpu"]
    assert abs(lc - lh) <= 2e-5
    assert sorted(gc) == sorted(gh)
    for key, w in gh.items():
        assert torch.isfinite(gc[key]).all(), key
        tol = 5e-4 * max(float(w.abs().max()), 1e-30)
        assert float((gc[key].cpu() - w).abs().max()) <= tol, key


@pytest.mark.cuda
def test_cuda_reduced_stablelm_loss_and_grads_match_cpu(card):
    """Fault C-9: reduced stablelm-3b (head_dim 16, zero-padded to the
    kernels' 64) trains on the card: its loss and every gradient leaf
    against the same step on the CPU (plain versions)."""
    cfg, model, params, batch = _reduced("stablelm_3b")
    assert cfg.head_dim == 16
    layers = cfg.n_layers
    _loss_and_grads_card_vs_cpu(card, model, params, batch, {
        "flash_attention_fwd": (2 if cfg.remat else 1) * layers,
        "flash_attention_bwd": layers, "ssd_fwd": 0, "ssd_bwd": 0,
        "ssd_fwd_tile_bf16": 0, "ssd_bwd_tile_bf16": 0})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_15b", "mamba2_370m"])
def test_cuda_reduced_ssm_loss_and_grads_match_cpu(card, arch):
    """Faults C-6 and C-9: reduced hymba-1.5b (hybrid: flash at head_dim
    16 padded, SSD at chunk 8, P 8, N 8 padded) and mamba2-370m (SSD
    alone) train on the card: loss and every gradient leaf against the CPU
    step, each SSD and flash kernel launched once a layer forward and its
    backward once a layer."""
    cfg, model, params, batch = _reduced(arch)
    assert (cfg.ssm_chunk, cfg.ssm_headdim, cfg.ssm_state) == (8, 8, 8)
    layers = cfg.n_layers
    fwd = (2 if cfg.remat else 1) * layers
    attn = "hybrid" in cfg.pattern
    _loss_and_grads_card_vs_cpu(card, model, params, batch, {
        "flash_attention_fwd": fwd if attn else 0,
        "flash_attention_bwd": layers if attn else 0,
        "ssd_fwd": fwd, "ssd_bwd": layers,
        "ssd_fwd_tile_bf16": 0, "ssd_bwd_tile_bf16": 0})


@pytest.mark.cuda
def test_cuda_bwd_refuses_bf16(card):
    """bf16 runs through both kernels: the bf16 forward's out and lse feed
    the bf16 backward, whose gradients come back bf16 and finite; an f32
    lse is required beside bf16 q (an out or dout of another dtype than
    q's, or a bf16 lse, raises TypeError)."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((2, 64, 64), generator=g, device=card).bfloat16()
    out, lse = K._fwd_kernel(x, x, x, 1, True, 0, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    reset_launch_counts()
    grads = K.flash_attention_bwd(x, x, x, out, out, lse)
    assert all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
               for t in grads)
    assert K.bwd_launches_by_dtype() == {"float32": 0, "bfloat16": 1}
    with pytest.raises(TypeError, match="float32"):
        K.flash_attention_bwd(x, x, x, out, out, lse.bfloat16())
    with pytest.raises(TypeError, match="q's dtype"):
        K.flash_attention_bwd(x, x, x, out.float(), out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4, 5])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (True, 200), (False, 0)])
@pytest.mark.parametrize("S", [64, 200, 300, 520])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_cuda_bf16_bwd_kernel_vs_plain(card, hd, S, causal, window, groups):
    """The bf16 backward kernel against its plain version (with the
    kernel's tiles, ``bwd_tiles``: 64 x 128 up to hd 128, 64 x 32 at 256)
    on the bf16 forward kernel's out and lse (that lse against the plain
    forward's): dq, dk, dv within 1e-2 of each gradient's scale, a rerun
    bit-equal, one launch a call. S not a multiple of 128 (200, 300, 520),
    windows that start inside a 128-key tile (48, 200), GQA 1, 4 and 5
    (with few items an item takes one query head: dk and dv summed over
    the parts), every head dim."""
    BKV = 2
    g = torch.Generator(device=card).manual_seed(hd * 7 + S + groups)
    q, k, v, dout = (torch.randn(s, generator=g, device=card).bfloat16()
                     for s in ((BKV * groups, S, hd), (BKV, S, hd),
                               (BKV, S, hd), (BKV * groups, S, hd)))
    kw = dict(groups=groups, causal=causal, window=window)
    out, lse = K._fwd_kernel(q, k, v, groups, causal, window, True)
    _, plain_lse = K.flash_attention_fwd_plain(q, k, v, return_lse=True,
                                               **kw)
    torch.testing.assert_close(lse, plain_lse, atol=2e-5, rtol=2e-5)
    reset_launch_counts()
    got = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert launch_counts()["flash_attention_bwd"] == 1
    assert K.bwd_launches_by_dtype()["bfloat16"] == 1
    bq, bkv = K.bwd_tiles(hd, torch.bfloat16)
    want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw,
                                       block_q=bq, block_kv=bkv)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        torch.testing.assert_close(
            a.float(), b.float(), atol=1e-2 * float(b.float().abs().max()),
            rtol=0)
    again = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal,groups", [
    (448, 1500, False, 1), (200, 64, True, 4), (64, 520, True, 5),
    (300, 700, False, 5)])
@pytest.mark.parametrize("hd", [64, 80])
def test_cuda_bf16_bwd_kernel_vs_plain_at_other_lengths(card, hd, Sq, Skv,
                                                        causal, groups):
    """The bf16 backward kernel with query and key lengths that differ (a
    decoder's cross attention over an encoder's positions, 448 x 1500, and
    other pairs, causal and not, GQA 1, 4 and 5) against its plain version
    at the kernel's tiles: 1e-2 of each gradient's scale, a rerun
    bit-equal."""
    BKV = 2
    g = torch.Generator(device=card).manual_seed(hd + Sq + Skv)
    q, k, v, dout = (torch.randn(s, generator=g, device=card).bfloat16()
                     for s in ((BKV * groups, Sq, hd), (BKV, Skv, hd),
                               (BKV, Skv, hd), (BKV * groups, Sq, hd)))
    kw = dict(groups=groups, causal=causal, window=0)
    out, lse = K._fwd_kernel(q, k, v, groups, causal, 0, True)
    got = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        torch.testing.assert_close(
            a.float(), b.float(), atol=1e-2 * float(b.float().abs().max()),
            rtol=0)
    again = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
