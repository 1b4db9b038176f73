"""Cross attention and multi-head latent attention (MLA) of
``repro_torch.models.attention``, and ``flash_attention`` with a v head
dim below q/k's, against ``repro.models.attention``.

The same numpy params (``materialize`` of the JAX layouts, carried across
with ``convert.params_from_numpy``) and inputs through both:

* ``cross_attn_apply`` over a memory of 40 positions with 16-wide tiles
  (the 1600-image-token case, reduced: a memory that is no multiple of a
  tile) and over 1 position, at atol = rtol 2e-4
  (``tests/test_torch_zoo.py``'s forward tolerance);
* ``mla_apply`` (causal flash at q/k head dim nope + rope, v below it);
* ``mla_decode`` and ``mla_decode_`` with ``absorb`` both ways, six steps
  at a scalar position and four at per-row positions: y and the
  compressed cache (c, k_rope) at 1e-4 (the zoo's decode tolerance),
  ``mla_decode_`` bit-equal to ``mla_decode`` and the old cache left as
  it was;
* ``flash_attention`` with v's head dim below q/k's (plain path on the
  CPU): forward against a dense float64 softmax oracle and against JAX's
  ``chunked_attention`` (which takes the scale from q), and its gradients
  against ``jax.vjp`` of it, causal and not, with GQA.

On the card (``cuda``): the padded-v flash (forward and backward kernels)
against its plain version at f32 2e-5 of the scale (phase 6's flash
tolerance), and a rerun bit-equal.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models.param import materialize as j_materialize
except ImportError:       # the card's machine has PyTorch but no JAX
    jax = None
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as TA

FWD = dict(atol=2e-4, rtol=2e-4)
DEC = dict(atol=1e-4, rtol=1e-4)
D, H, HD = 64, 4, 16
MLA = dict(n_heads=4, nope=16, rope_dim=8, v_dim=16)
Q_LORA, KV_LORA = 32, 16


def _params(layout, seed=0):
    p = j_materialize(jax.random.PRNGKey(seed), layout, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mem", [40, 1])
def test_cross_attn_apply_matches_reference(mem):
    P = _params(JA.cross_attn_layout(D, H, HD, D))
    x, m = _normal((2, 24, D), 1), _normal((2, mem, D), 2)
    got = TA.cross_attn_apply(params_from_numpy(P, "cpu"),
                              torch.from_numpy(x), torch.from_numpy(m),
                              n_heads=H, head_dim=HD, q_chunk=16,
                              kv_chunk=16)
    want = JA.cross_attn_apply(jax.tree_util.tree_map(jnp.asarray, P),
                               jnp.asarray(x), jnp.asarray(m), n_heads=H,
                               head_dim=HD, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _mla_params(seed=0):
    return _params(JA.mla_layout(D, MLA["n_heads"], Q_LORA, KV_LORA,
                                 MLA["nope"], MLA["rope_dim"], MLA["v_dim"]),
                   seed)


def test_mla_apply_matches_reference():
    P = _mla_params()
    B, S = 2, 40
    x = _normal((B, S, D), 3)
    pos = np.broadcast_to(np.arange(S), (B, S))
    got = TA.mla_apply(params_from_numpy(P, "cpu"), torch.from_numpy(x),
                       positions=torch.from_numpy(pos.copy()), q_chunk=16,
                       kv_chunk=16, **MLA)
    want = JA.mla_apply(jax.tree_util.tree_map(jnp.asarray, P),
                        jnp.asarray(x), positions=jnp.asarray(pos),
                        q_chunk=16, kv_chunk=16, **MLA)
    assert got.shape == (B, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_mla_decode_matches_reference(absorb, per_row):
    P = _mla_params(1)
    B, smax = 2, 12
    tp = params_from_numpy(P, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, P)
    rng = np.random.default_rng(4)
    # a nonzero cache from the start: zeros would hide a misread row
    c0 = rng.normal(size=(B, smax, KV_LORA)).astype(np.float32)
    k0 = rng.normal(size=(B, smax, MLA["rope_dim"])).astype(np.float32)
    tc = (torch.from_numpy(c0.copy()), torch.from_numpy(k0.copy()))
    live = tuple(t.clone() for t in tc)
    jc = (jnp.asarray(c0.copy()), jnp.asarray(k0.copy()))
    for t in range(6 if not per_row else 4):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        pos = np.array([t, t + 3]) if per_row else t
        tpos = torch.from_numpy(pos) if per_row else pos
        old = tuple(a.clone() for a in tc)
        y, tc_new = TA.mla_decode(tp, torch.from_numpy(x), tc, tpos,
                                  absorb=absorb, **MLA)
        assert all(torch.equal(a, b) for a, b in zip(old, tc))
        tc = tc_new
        y_ = TA.mla_decode_(tp, torch.from_numpy(x), live, tpos,
                            absorb=absorb, **MLA)
        assert torch.equal(y, y_)
        assert all(torch.equal(a, b) for a, b in zip(tc, live))
        jy, jc = JA.mla_decode(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                               absorb=absorb, **MLA)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **DEC)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **DEC)


def test_mla_decode_absorb_equals_plain_form():
    """The matrix-absorbed decode is the same function as the plain one."""
    P = params_from_numpy(_mla_params(2), "cpu")
    rng = np.random.default_rng(5)
    cache = (torch.from_numpy(rng.normal(size=(2, 9, KV_LORA)).astype(
        np.float32)), torch.from_numpy(rng.normal(
            size=(2, 9, MLA["rope_dim"])).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 1, D)).astype(np.float32))
    a, _ = TA.mla_decode(P, x, cache, 5, absorb=False, **MLA)
    b, _ = TA.mla_decode(P, x, cache, 5, absorb=True, **MLA)
    torch.testing.assert_close(a, b, **DEC)


def _dense64(q, k, v, causal):
    """Softmax attention in float64, GQA by repeating kv heads; the scale
    from q's head dim."""
    groups = q.shape[2] // k.shape[2]
    q, k, v = (torch.from_numpy(np.asarray(t, np.float64)) for t in (q, k, v))
    k, v = (t.repeat_interleave(groups, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("KV", [4, 2])
def test_flash_attention_v_head_dim_below_qk(causal, KV):
    """q/k head dim 24, v 16 (MLA's nope + rope against v, reduced):
    forward against a float64 oracle and JAX's chunked_attention, and the
    gradients of q, k, v against jax.vjp of it."""
    B, S, Hq, hd, hv = 2, 40, 4, 24, 16
    q, k = _normal((B, S, Hq, hd), 6), _normal((B, S, KV, hd), 7)
    v, g = _normal((B, S, KV, hv), 8), _normal((B, S, Hq, hv), 9)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_q=16,
                          block_kv=16)
    assert out.shape == (B, S, Hq, hv)
    np.testing.assert_allclose(out.detach().numpy(),
                               _dense64(q, k, v, causal), atol=1e-5,
                               rtol=1e-5)
    R = Hq // KV

    def ref(qq, kk, vv):
        o = JA.chunked_attention(qq.reshape(B, S, KV, R, hd), kk, vv,
                                 causal=causal, q_chunk=16, kv_chunk=16)
        return o.reshape(B, S, Hq, hv)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    out.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **FWD)


def test_flash_attention_refuses_v_wider_than_qk():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="v head dim"):
        flash_attention(x, x, torch.zeros((1, 8, 2, 32)))


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for "
                    "sm_90a, built with nvcc, with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hv,S", [(192, 128, 300), (24, 16, 200)])
def test_cuda_flash_padded_v_matches_plain(card, hd, hv, S):
    """MLA's head dims (192 padded to the hd-256 kernel, v 128 padded to
    192) and reduced ones: the kernels' forward and gradients against the
    plain version's (autograd through the CPU path), a rerun bit-equal."""
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((1, S, 4, hd), generator=gen, device=card)
    k = torch.randn((1, S, 4, hd), generator=gen, device=card)
    v = torch.randn((1, S, 4, hv), generator=gen, device=card)
    g = torch.randn((1, S, 4, hv), generator=gen, device=card)

    def run(*ts):
        xs = [t.detach().requires_grad_() for t in ts[:3]]
        out = flash_attention(*xs, causal=True)
        out.backward(ts[3])
        return [out.detach()] + [t.grad for t in xs]

    FA.reset_launch_counts()
    got = run(q, k, v, g)
    assert FA.launch_counts() == {"flash_attention_fwd": 1,
                                  "flash_attention_bwd": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, run(q, k, v, g)))
    want = run(*(t.cpu() for t in (q, k, v, g)))
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 2e-5 * scale
