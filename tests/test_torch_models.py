"""The port's model layers against ``repro.models``, layer by layer.

Every test draws its parameters with the JAX package's ``materialize``
(threefry keys) and carries them across with
``repro_torch.convert.params_from_numpy``; inputs are numpy arrays handed
to both. Tolerances, each with its reason:

* f32 layers that do not reach a kernel (norms, RoPE, MLP, embeddings,
  decode attention, the SSM decode step): atol = rtol = 1e-5 — XLA and
  PyTorch order the sums of a matmul or a reduction differently, which
  moves an f32 result by a few ulps;
* bf16 norms / RoPE / embeddings: atol = rtol = 1e-2, under one bf16 ulp
  (2^-7 relative) of the O(1) outputs, so a rounding on the other side of
  one tie is all that is allowed;
* ``attn_apply`` (the flash plain version on the CPU): 2e-5, the flash
  kernel's f32 tolerance in ``tests/test_kernels_flash.py``;
* ``ssd_apply`` (the SSD plain version): 2e-4, the SSD kernel's tolerance
  in ``tests/test_kernels_ssd.py``; the SSM's full-sequence scan against
  its own token-by-token decode: 3e-4 / 3e-3, as
  ``test_model_ssd_full_vs_decode_steps`` holds the JAX package.
* ``_cache_write`` is a copy: exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import param as JP
from repro.models import ssm as JS
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import param as TP
from repro_torch.models import ssm as TS

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)
FLASH = dict(atol=2e-5, rtol=2e-5)
SSD = dict(atol=2e-4, rtol=2e-4)


def _carry(layout, seed=0, dtype=jnp.float32):
    """(JAX params, the same params as torch tensors on the CPU)."""
    p = JP.materialize(jax.random.PRNGKey(seed), layout, dtype)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(x, dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# ------------------------------ layouts and init ----------------------------

def _pm_rows(layout, mod):
    flat = jax.tree_util.tree_flatten_with_path(
        layout, is_leaf=lambda x: isinstance(x, mod.PM))[0]
    return [(jax.tree_util.keystr(p), tuple(pm.shape), tuple(pm.axes),
             pm.init, pm.scale) for p, pm in flat]


@pytest.mark.parametrize("which", ["attn", "attn_bias", "ssm", "swiglu",
                                   "gelu", "layernorm", "embed", "stacked"])
def test_layouts_equal_jax(which):
    make = {
        "attn": lambda M: M.attn_layout(64, 4, 2, 16),
        "attn_bias": lambda M: M.attn_layout(64, 4, 2, 16, qkv_bias=True),
        "ssm": lambda M: M.ssm_layout(64, 128, 8, 16),
        "swiglu": lambda M: M.mlp_layout(64, 96, "swiglu"),
        "gelu": lambda M: M.mlp_layout(64, 96, "gelu"),
        "layernorm": lambda M: M.norm_layout(64, "layernorm"),
        "embed": lambda M: M.embed_layout(128, 64),
        "stacked": None}[which]
    if which == "stacked":
        jl = JP.stack_layout(JA.attn_layout(32, 2, 1, 8), 3, "layers")
        tl = TP.stack_layout(TA.attn_layout(32, 2, 1, 8), 3, "layers")
    else:
        jmod = JS if which == "ssm" else JA if which.startswith("attn") \
            else JL
        tmod = TS if which == "ssm" else TA if which.startswith("attn") \
            else TL
        jl, tl = make(jmod), make(tmod)
    assert _pm_rows(jl, JP) == _pm_rows(tl, TP)
    assert JP.count_params(jl) == TP.count_params(tl)


def test_materialize_initializers_and_stacked_fan_in():
    """Same initializers as the JAX package, including its fan-in of
    shape[0] for "scaled" leaves: a layer-stacked (32, 1600, 50) leaf draws
    at sqrt(1/32) = 0.177, the unstacked (1600, 50) one at 0.025 (ROADMAP
    fault C-5, kept as the reference has it)."""
    lay = {"s": TP.PM((1600, 50), (None, None), init="scaled"),
           "z": TP.PM((7,), (None,), init="zeros"),
           "o": TP.PM((7,), (None,), init="ones"),
           "n": TP.PM((400, 300), (None, None), init="normal", scale=0.02)}
    stacked = TP.stack_layout({"s": lay["s"]}, 32)
    g = torch.Generator().manual_seed(0)
    p = TP.materialize(g, lay, device="cpu")
    ps = TP.materialize(g, stacked, device="cpu")
    assert torch.equal(p["z"], torch.zeros(7))
    assert torch.equal(p["o"], torch.ones(7))
    assert abs(float(p["s"].std()) - 0.025) < 0.001
    assert abs(float(p["n"].std()) - 0.02) < 0.001
    assert ps["s"].shape == (32, 1600, 50)
    assert abs(float(ps["s"].std()) - np.sqrt(1 / 32)) < 0.002
    again = TP.materialize(torch.Generator().manual_seed(0), lay,
                           dtype=torch.bfloat16, device="cpu")
    assert again["s"].dtype == torch.bfloat16
    torch.testing.assert_close(again["s"].float(), p["s"], atol=1e-2,
                               rtol=1e-2)


# ------------------------------ norms, RoPE, MLP ----------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(kind, dtype):
    jp, tp = _carry(JL.norm_layout(48, kind), seed=1)
    tp = {k: v + 0.1 * torch.arange(48) for k, v in tp.items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    jx, tx = _pair(_rand(2, 5, 48, seed=2, scale=3.0), dtype)
    eps = 1e-5 if kind == "layernorm" else 1e-6
    out = TL.norm_apply(tp, tx, kind, eps)
    assert out.dtype == tx.dtype
    _close(out, JL.norm_apply(jp, jx, kind, eps),
           F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("rope_frac", [1.0, 0.25])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_interleaved(rope_frac, theta):
    """Interleaved pairs, the first rope_frac of the head dim (stablelm
    0.25 rotates 20 of 80 dims and passes the rest through)."""
    jx, tx = _pair(_rand(2, 12, 3, 80, seed=3))
    pos = np.tile(np.arange(100, 112), (2, 1)).astype(np.int32)
    out = TL.apply_rope(tx, torch.from_numpy(pos), theta, rope_frac)
    _close(out, JL.apply_rope(jx, jnp.asarray(pos), theta, rope_frac), F32)
    rot = int(80 * rope_frac) // 2 * 2
    assert torch.equal(out[..., rot:], tx[..., rot:])
    inv, n = TL.rope_freqs(80, theta, rope_frac)
    jinv, jn = JL.rope_freqs(80, theta, rope_frac)
    assert n == jn and np.array_equal(inv, np.asarray(jinv))


def test_rope_bf16_and_decode_positions():
    jx, tx = _pair(_rand(2, 1, 4, 16, seed=4), "bfloat16")
    pos = np.array([[7], [300]], np.int32)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 10000.0),
           JL.apply_rope(jx, jnp.asarray(pos), 10000.0), BF16)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_kinds(kind):
    jp, tp = _carry(JL.mlp_layout(32, 64, kind), seed=5)
    jx, tx = _pair(_rand(2, 6, 32, seed=6))
    _close(TL.mlp_apply(tp, tx, kind), JL.mlp_apply(jp, jx, kind), F32)


def test_mlp_compact_w2_is_not_ported():
    _, tp = _carry(JL.mlp_layout(32, 64, "swiglu"))
    tp["w2"] = tp["w2"][:, :8]
    tp["w2_sel"] = torch.arange(8)
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        TL.mlp_apply(tp, torch.ones(1, 2, 32), "swiglu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_and_unembed_mask(dtype):
    """embed rounds its scale to the activation dtype first; unembed masks
    the padded vocab columns (>= true_vocab) to -1e30."""
    jp, tp = _carry(JL.embed_layout(256, 40), seed=7,
                    dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tok = np.random.default_rng(8).integers(0, 200, size=(2, 9))
    scale = float(np.sqrt(40))
    e_t = TL.embed_apply(tp, torch.from_numpy(tok), scale=scale)
    e_j = JL.embed_apply(jp, jnp.asarray(tok), scale=scale)
    assert np.array_equal(_np(e_t), _np(e_j))
    lt = TL.unembed_apply(tp, e_t, true_vocab=201)
    lj = JL.unembed_apply(jp, e_j, true_vocab=201)
    assert lt.dtype == e_t.dtype and lt.shape == (2, 9, 256)
    assert bool((lt[..., 201:].float() < -1e29).all())
    _close(lt, lj, F32 if dtype == "float32" else BF16)


def test_sinusoidal_positions():
    assert np.array_equal(TL.sinusoidal_positions(20, 16).numpy(),
                          np.asarray(JL.sinusoidal_positions(20, 16)))


# ------------------------------ attention -----------------------------------

ATTN = dict(n_heads=4, n_kv=2, head_dim=16)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
@pytest.mark.parametrize("qkv_bias,rope_frac", [(False, 1.0), (True, 0.25)])
def test_attn_apply(causal, window, qkv_bias, rope_frac):
    """Full-sequence GQA through the flash plain version (16-row tiles)
    against the JAX chunked attention."""
    jp, tp = _carry(JA.attn_layout(32, 4, 2, 16, qkv_bias), seed=9)
    if qkv_bias:
        for k in ("bq", "bk", "bv"):
            tp[k] = torch.from_numpy(_rand(*tp[k].shape, seed=10))
            jp[k] = jnp.asarray(tp[k].numpy())
    B, S = 2, 40
    jx, tx = _pair(_rand(B, S, 32, seed=11))
    pos = np.tile(np.arange(S), (B, 1))
    kw = dict(ATTN, causal=causal, window=window, rope_theta=10000.0,
              rope_frac=rope_frac, q_chunk=16, kv_chunk=16)
    out = TA.attn_apply(tp, tx, positions=torch.from_numpy(pos), **kw)
    kw.update(q_chunk=8, kv_chunk=8)
    expect = JA.attn_apply(jp, jx, positions=jnp.asarray(pos), **kw)
    _close(out, expect, FLASH)


@pytest.mark.parametrize("window", [0, 8])
def test_attn_apply_sliced_window_keyword(window):
    """Both packages take the reference's ``sliced_window=`` keyword; it
    changes how the reference lowers local attention, not the function."""
    jp, tp = _carry(JA.attn_layout(32, 4, 2, 16), seed=13)
    B, S = 2, 40
    jx, tx = _pair(_rand(B, S, 32, seed=14))
    pos = np.tile(np.arange(S), (B, 1))
    kw = dict(ATTN, causal=True, window=window, q_chunk=8, kv_chunk=8,
              sliced_window=True)
    out = TA.attn_apply(tp, tx, positions=torch.from_numpy(pos), **kw)
    expect = JA.attn_apply(jp, jx, positions=jnp.asarray(pos), **kw)
    _close(out, expect, FLASH)
    kw["sliced_window"] = False
    assert torch.equal(out, TA.attn_apply(tp, tx,
                                          positions=torch.from_numpy(pos),
                                          **kw))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_attn_decode_steps(window, vector_pos):
    """Eight decode steps into a 12-slot cache: outputs and caches equal
    JAX's at every step, with one shared position or per-row positions."""
    jp, tp = _carry(JA.attn_layout(32, 4, 2, 16), seed=12)
    B, Smax = 3, 12
    jk = jv = jnp.zeros((B, Smax, 2, 16), jnp.float32)
    tk = tv = torch.zeros((B, Smax, 2, 16))
    xs = _rand(8, B, 1, 32, seed=13)
    for t in range(8):
        pos = np.array([t, t + 2, max(t - 1, 0)]) if vector_pos else t
        kw = dict(ATTN, window=window, rope_theta=10000.0)
        ty, (tk, tv) = TA.attn_decode(tp, torch.from_numpy(xs[t]), (tk, tv),
                                      torch.as_tensor(pos), **kw)
        jy, (jk, jv) = JA.attn_decode(jp, jnp.asarray(xs[t]), (jk, jv),
                                      jnp.asarray(pos), **kw)
        _close(ty, jy, F32)
        _close(tk, jk, F32)
        _close(tv, jv, F32)


@pytest.mark.parametrize("pos", [0, 5, 7, 11, -2, -9, [1, 9, 3],
                                 [-1, 8, 2], [-9, 0, 12]])
def test_cache_write_matches_jax(pos):
    """A scalar pos is dynamic_update_slice (negative counts from the end,
    then the start is clamped); a (B,) pos is a scatter that drops rows out
    of range after the same wrap."""
    cache = _rand(3, 8, 2, 4, seed=14)
    new = _rand(3, 1, 2, 4, seed=15)
    got = TA._cache_write(torch.from_numpy(cache), torch.from_numpy(new),
                          torch.as_tensor(pos))
    want = JA._cache_write(jnp.asarray(cache), jnp.asarray(new),
                           jnp.asarray(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_vector_positions(window):
    q = _rand(2, 1, 2, 3, 8, seed=16)
    k, v = _rand(2, 10, 2, 8, seed=17), _rand(2, 10, 2, 8, seed=18)
    pos = np.array([4, 9])
    got = TA.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(pos), window=window)
    want = JA.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(pos), window=window)
    _close(got, want, F32)


# ------------------------------ SSM -----------------------------------------

SSM_DIMS = dict(d=32, d_inner=64, n_state=8, headdim=8)


def _ssm_params(seed=0):
    return _carry(JS.ssm_layout(*SSM_DIMS.values()), seed=seed)


@pytest.mark.parametrize("S,chunk", [(24, 8), (32, 16)])
def test_ssd_apply_vs_jax(S, chunk):
    """The full-sequence SSD block through the SSD plain version against the
    JAX block's jnp chunked scan."""
    jp, tp = _ssm_params(seed=1)
    ju, tu = _pair(_rand(2, S, 32, seed=19, scale=0.5))
    out = TS.ssd_apply(tp, tu, headdim=8, chunk=chunk)
    _close(out, JS.ssd_apply(jp, ju, headdim=8, chunk=chunk), SSD)


def test_ssd_apply_large_dt_finite():
    """Scaled-up input weights push softplus(dt) to 3..20 as at hymba's full
    width: the block's output stays finite and equals JAX's."""
    jp, tp = _ssm_params(seed=2)
    tp["wdt"] = tp["wdt"] * 40.0 + 0.3
    jp["wdt"] = jnp.asarray(tp["wdt"].numpy())
    ju, tu = _pair(_rand(2, 32, 32, seed=20))
    out = TS.ssd_apply(tp, tu, headdim=8, chunk=16)
    assert torch.isfinite(out).all()
    _close(out, JS.ssd_apply(jp, ju, headdim=8, chunk=16), SSD)


def test_ssd_decode_steps_vs_jax_and_full():
    """The recurrent step against JAX's, cache included, and the port's
    full-sequence block against its own step-by-step decode."""
    jp, tp = _ssm_params(seed=3)
    S = 24
    ju, tu = _pair(_rand(2, S, 32, seed=21, scale=0.5))
    jc = JS.ssm_init_cache(2, 64, 8, 8, jnp.float32)
    tc = TS.ssm_init_cache(2, 64, 8, 8, torch.float32, device="cpu")
    ys = []
    for t in range(S):
        ty, tc = TS.ssd_decode(tp, tu[:, t:t + 1], tc, headdim=8)
        jy, jc = JS.ssd_decode(jp, ju[:, t:t + 1], jc, headdim=8)
        _close(ty, jy, F32)
        for key in tc:
            _close(tc[key], jc[key], F32)
        ys.append(ty)
    full = TS.ssd_apply(tp, tu, headdim=8, chunk=8)
    torch.testing.assert_close(full, torch.cat(ys, dim=1), atol=3e-4,
                               rtol=3e-3)


def test_ssd_bf16_tiles_are_not_ported():
    _, tp = _ssm_params()
    with pytest.raises(NotImplementedError, match="ssd_bf16"):
        TS.ssd_apply(tp, torch.zeros(1, 8, 32), headdim=8, chunk=8,
                     tile_bf16=True)
