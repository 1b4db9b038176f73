"""bf16 training in the port against the JAX package, on the CPU.

* The flash backward's plain bf16 version (``flash_attention_bwd_plain``
  on bf16 inputs, through ``FlashAttentionFunction`` as the model reaches
  it) against ``jax.vjp`` of ``repro.models.attention.chunked_attention``
  on the same bf16 q, k, v and dout: dq, dk and dv each within 3e-2 of
  its scale (the bf16 tolerance of ``tests/test_kernels_flash.py``, which
  the port's bf16 forward already meets), over causal, causal + window and
  non-causal masks, GQA groups 1 and 4, head dims 64 and 80, S 200 (not a
  tile multiple) and a v head dim below q/k's (``ops.flash_attention``
  pads it). Both are also held to a float64 oracle (dense attention in
  float64 on the same bf16 values): the port's distance within twice
  JAX's plus 1e-3 of the scale. The port rounds P and dS to bf16 (the
  tensor cores' operands) where JAX keeps them in f32, and JAX rounds
  nothing but its outputs.
* The same rule at the bf16 backward kernel's tiles (64 query rows x 128
  keys at these head dims, ``kernel.bwd_tiles``), the plain version's dq
  then summed over 128-key tiles in the kernel's turn order.
* The plain bf16 forward's lse: the f32 logsumexp of the same scaled,
  masked logits (q k^T of the bf16 values, summed in f32).
* ``Model.loss`` gradients with bf16 params (reduced hymba-1.5b,
  stablelm-3b and deepseek-v2, the JAX params rounded to bf16 on both
  sides) against ``jax.value_and_grad`` of the JAX ``Model.loss``. bf16
  rounds every activation, so each side's gradient lies 10-45% (of the
  leaf's norm) from a float64 run of the port on the same bf16 values,
  JAX's as much as the port's. Each leaf is held the way ``GRAD_WIDE``
  holds its leaves in ``tests/test_torch_zoo.py``: the port's distance to
  the float64 run within ``BF16_GRAD_MULT`` times the larger of JAX's
  distance on that leaf and JAX's median over the tree. The distance is
  the leaf's relative Frobenius norm: the largest entry of a bf16
  gradient's error is one rounding event, and varies by 2x from seed to
  seed. Measured over seeds 3-7: the port's ratio at most 1.45 on every
  leaf but one (hymba's ``ssm/conv_B`` at seed 5, 2.50), so 4 leaves a
  margin of 1.6. The losses within 1e-3 of JAX's, relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import zoo as JZ
from repro.models.attention import chunked_attention
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models import attention as TA
from repro_torch.models import zoo as TZ

BF16_TOL = 3e-2
BF16_GRAD_MULT = 4.0
MASKS = [(True, 0), (True, 48), (False, 0)]


def _bf16(rng, shape):
    """numpy f32 values that are exact in bf16."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.bfloat16().float().numpy()


def _dense64_grads(q, k, v, dout, causal, window):
    """dq, dk, dv of dense softmax attention in float64 (B, S, H, hd)."""
    ts = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    qt, kt, vt = ts
    G = qt.shape[2] // kt.shape[2]
    kk, vv = (t.repeat_interleave(G, 2) for t in (kt, vt))
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kk) * qt.shape[-1] ** -0.5
    i = torch.arange(qt.shape[1])[:, None]
    j = torch.arange(kt.shape[1])[None, :]
    keep = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        keep &= i >= j
    if window:
        keep &= (i - j) < window
    p = torch.softmax(s.masked_fill(~keep, -1e300), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    o.backward(torch.from_numpy(dout).double())
    return [t.grad.numpy() for t in ts]


CASES = [(B, 200, H, KV, hd, hd_v, causal, window)
         for (causal, window) in MASKS
         for (H, KV) in [(4, 4), (8, 2)]
         for hd in (64, 80)
         for (B, hd_v) in [(2, hd)]] + [(1, 200, 4, 2, 80, 64, True, 0),
                                         (1, 200, 4, 4, 80, 48, False, 0)]


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_bwd_vs_jax_vjp_and_float64(case):
    _check_plain_bf16_bwd(case, 64, 64)


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_bwd_at_kernel_tiles_vs_jax_vjp_and_float64(case):
    """The same rule with the plain version at the bf16 kernel's tiles
    (``bwd_tiles``: 64 query rows x 128 keys at these head dims), in the
    kernel's dq turn order over them."""
    _check_plain_bf16_bwd(case, *K.bwd_tiles(case[4], torch.bfloat16))


def _check_plain_bf16_bwd(case, block_q, block_kv):
    B, S, H, KV, hd, hd_v, causal, window = case
    rng = np.random.default_rng(hd * 7 + H + hd_v)
    q, k = _bf16(rng, (B, S, H, hd)), _bf16(rng, (B, S, KV, hd))
    v, dout = _bf16(rng, (B, S, KV, hd_v)), _bf16(rng, (B, S, H, hd_v))
    ts = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, causal=causal, window=window, block_q=block_q,
                          block_kv=block_kv)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(dout).bfloat16())
    got = [t.grad.float().numpy() for t in ts]
    assert all(t.grad.dtype == torch.bfloat16 for t in ts)

    R = H // KV
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: chunked_attention(
        a.reshape(B, S, KV, R, hd), b, c, causal=causal,
        window=window).reshape(B, S, H, hd_v), jq, jk, jv)
    want = [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(dout, jnp.bfloat16))]
    oracle = _dense64_grads(q, k, v, dout, causal, window)
    for name, g, w, o in zip("qkv", got, want, oracle):
        scale = float(np.abs(o).max())
        err = float(np.abs(g - w).max())
        assert err <= BF16_TOL * scale, (name, err, scale)
        port = float(np.abs(g - o).max())
        ref = float(np.abs(w - o).max())
        assert port <= 2 * ref + 1e-3 * scale, (name, port, ref, scale)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("groups", [1, 4])
def test_plain_bf16_lse_is_the_f32_logsumexp(causal, window, groups):
    rng = np.random.default_rng(groups)
    q = torch.from_numpy(_bf16(rng, (2 * groups, 200, 80))).bfloat16()
    k = torch.from_numpy(_bf16(rng, (2, 200, 80))).bfloat16()
    v = torch.from_numpy(_bf16(rng, (2, 200, 80))).bfloat16()
    _, lse = K.flash_attention_fwd_plain(q, k, v, groups=groups,
                                         causal=causal, window=window,
                                         return_lse=True)
    assert lse.dtype == torch.float32
    kk = k.float().repeat_interleave(groups, 0)
    s = (q.float() @ kk.transpose(1, 2)) * 80 ** -0.5
    i, j = torch.arange(200)[:, None], torch.arange(200)[None, :]
    keep = torch.ones((200, 200), dtype=torch.bool)
    if causal:
        keep &= i >= j
    if window:
        keep &= (i - j) < window
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=2e-5, rtol=2e-6)


def _dense64(flash):
    """``flash_attention`` for float64 inputs: dense softmax attention in
    float64; any other dtype through ``flash``."""
    def attend(q, k, v, causal=True, window=0, **kw):
        if q.dtype != torch.float64:
            return flash(q, k, v, causal=causal, window=window, **kw)
        G = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(G, 2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        i = torch.arange(q.shape[1])[:, None]
        j = torch.arange(k.shape[1])[None, :]
        keep = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            keep &= i >= j
        if window:
            keep &= (i - j) < window
        p = torch.softmax(s.masked_fill(~keep, -1e300), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)
    return attend


def _port_grads(model, params, batch, dtype):
    tp = tree_map(lambda x: x.detach().to(dtype).requires_grad_(), params)
    loss, _ = model.loss(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    loss.backward()
    return float(loss), {p: x.grad.double().numpy()
                         for p, x in flatten_with_path(tp)}


@pytest.mark.parametrize("arch", ["hymba_15b", "stablelm_3b",
                                  "deepseek_v2_236b"])
def test_model_bf16_grads_vs_jax_and_float64(arch, monkeypatch):
    jcfg, tcfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jp = JZ.build(jcfg).init(jax.random.PRNGKey(0))
    tp = tree_map(lambda t: t.bfloat16(), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    rng = np.random.default_rng(3)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, 48))
    labels = rng.integers(0, jcfg.vocab, size=tokens.shape)
    labels[0, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    (jl, _), jg = jax.value_and_grad(JZ.build(jcfg).loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {p: np.asarray(g, np.float64) for p, g in flatten_with_path(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg))}
    model = TZ.build(tcfg)
    tl, got = _port_grads(model, tp, batch, torch.bfloat16)
    monkeypatch.setattr(TA, "flash_attention", _dense64(TA.flash_attention))
    _, oracle = _port_grads(model, tp, batch, torch.float64)
    assert abs(tl - float(jl)) <= 1e-3 * abs(float(jl))
    assert sorted(got) == sorted(want) == sorted(oracle)
    dist = {}
    for p, o in oracle.items():
        norm = max(float(np.linalg.norm(o)), 1e-30)
        dist[p] = (float(np.linalg.norm(got[p] - o)) / norm,
                   float(np.linalg.norm(want[p] - o)) / norm)
    median = float(np.median([ref for _, ref in dist.values()]))
    for p, (port, ref) in dist.items():
        assert port <= BF16_GRAD_MULT * max(ref, median), (p, port, ref,
                                                           median)
