"""The port's LM zoo against ``repro.models`` / ``repro.configs``.

* Every config's fields equal the JAX package's, and every ported config's
  full-size layout has the JAX parameter count (no allocation).
* Reduced hymba (hybrid), mamba2 (ssm), stablelm (global, LayerNorm,
  partial RoPE, untied unembed; also with absolute sinusoidal positions)
  and gemma3 (5 local : 1 global, GeGLU, embedding scale; also at 8
  layers, so two blocks sit outside the stacked cycle) run ``forward`` at B 2, S 48 (longer than the reduced window of
  16) on the JAX package's params carried across, and their logits are
  held against JAX ``forward`` at atol = rtol = 2e-4: the loosest kernel
  tolerance on the path (SSD, ``tests/test_kernels_ssd.py``).
* Six ``decode_step``s against JAX's, logits and every cache leaf, at
  1e-4: f32 decode reaches no kernel, but its error compounds over the
  depth and the steps. A leaf whose scale passes 1e2 (the SSM ``state``
  of reduced hymba and mamba2, up to 8.1e3 by step 6 under the large dt
  of fault C-5) carries f32 rounding of that size in its small elements
  too, on either side: each package's distance to a float64 run of the
  port's own decode is held instead, the port's within twice JAX's plus
  1e-6 of the leaf's scale.
* The port's ``forward`` against its own step-by-step decode over all 48
  positions, at 3e-4 / 3e-3 (the JAX suite's full-vs-decode tolerance in
  ``tests/test_kernels_ssd.py``).
* Reduced whisper-small (the encoder-decoder: ``enc``, ``dec_cross``),
  llama-3.2-vision (``cross``), mixtral-8x7b (``local`` with the MoE MLP)
  and deepseek-v2 (``mla`` with MoE and shared experts), with their
  memory inputs (frames, image embeddings) drawn in numpy: forward and the
  MoE auxiliaries against JAX's; six decode steps against JAX's with
  every cross-attention cache filled with the same nonzero numbers on both
  sides (deepseek also with ``mla_absorb``), the cross caches never
  written; ``decode_step_`` bit-equal to ``decode_step``; forward against
  the port's own decode with ck / cv filled from the memory (MoE capacity
  raised so that the forward drops nothing, as decode drops nothing); and
  ``Model.loss`` with its gradients against ``jax.value_and_grad`` at
  ``tests/test_torch_train.py``'s bounds; reduced llama-vision's
  self-attention q / k and norm leaves and its embedding, whose f32
  rounding in the reference exceeds them, held to JAX within a wider cap
  and to a float64 run of the port. Reduced whisper-small, chaotic in f32
  at the reference's init, has every gradient leaf held to that float64
  run (``ORACLE_RULE``), and a planted fault (one leaf's gradient scaled
  by 1.01, or one dropped) fails the rule.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import transformer as JT
from repro.models import zoo as JZ
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models import zoo as TZ

FWD = dict(atol=2e-4, rtol=2e-4)
DEC = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=3e-4, rtol=3e-3)
B, S = 2, 48
PORTED = ["hymba_15b", "mamba2_370m", "stablelm_3b", "gemma3_4b",
          "gemma_7b", "qwen25_32b", "llama32_vision_90b", "whisper_small",
          "mixtral_8x7b", "deepseek_v2_236b"]
# cross attention and the encoder-decoder, MLA, the MoE MLP
MEMORY_MOE = ["whisper_small", "llama32_vision_90b", "mixtral_8x7b",
              "deepseek_v2_236b"]
# Model.loss against jax.value_and_grad: tests/test_torch_train.py's bounds
LOSS_ATOL = 2e-5
GRAD_REL = 5e-4
# the gradient leaves whose f32 rounding in the reference itself exceeds
# GRAD_REL of their scale: reduced llama-vision's self-attention sits near
# an argmax, and JAX's gradients of its q / k projections, their norm and
# the embedding lie 2e-4 to 7.5e-4 of their scale from a float64 run (the
# port's 3.4e-4 to 8.8e-4, its distance to JAX up to 1.6e-3)
GRAD_WIDE = {"llama32_vision_90b":
             r"blocks/p\d+_global/(attn/w[qk]|attn_norm/scale)$|embed/table$"}
# reduced whisper-small at the reference's init is chaotic in f32 (C-5):
# JAX's own gradient leaves lie up to 5.3e-4 (frame seed 2), 4.8e-4 (5) and
# 2.4e-3 (7) of their scale from a float64 run, so no direct bound against
# JAX both holds and means something. Each leaf is held to the float64
# oracle instead: the port's distance within ORACLE_RULE times the larger
# of JAX's distance on that leaf and JAX's median distance over the tree.
# Measured worst ratio: 2.11 (seed 2, enc_blocks/mlp/w1), 0.91 (5), 0.80
# (7), so 3.5 leaves a margin of 1.66 or more at all three seeds.
ORACLE_RULE = {"whisper_small": 3.5}


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "projection_specs":
            v = tuple(dataclasses.astuple(s) for s in v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_fields_equal_jax(arch):
    assert _fields(TC.get_config(arch)) == _fields(JC.get_config(arch))
    assert _fields(TC.get_reduced(arch)) == _fields(JC.get_reduced(arch))
    for prop in ("d_inner", "vocab_padded"):
        assert getattr(TC.get_config(arch), prop) == \
            getattr(JC.get_config(arch), prop)
    assert TC.get_config(arch).sub_quadratic() == \
        JC.get_config(arch).sub_quadratic()


def test_registry_names_equal_jax():
    assert TC.ARCH_IDS == JC.ARCH_IDS and TC.ALIASES == JC.ALIASES
    assert TC.get_config("hymba-1.5b") == TC.get_config("hymba_15b")
    assert TZ.SHAPES == JZ.SHAPES
    for arch in JC.ARCH_IDS:
        for shape in JZ.SHAPES:
            assert TZ.cell_supported(TC.get_config(arch), shape) == \
                JZ.cell_supported(JC.get_config(arch), shape)


@pytest.mark.parametrize("arch", PORTED)
def test_full_size_param_counts_equal_jax(arch):
    assert TZ.build(TC.get_config(arch)).n_params() == \
        JZ.build(JC.get_config(arch)).n_params()


def test_hymba_full_size():
    """hymba-1.5b at full width: 1.59 B parameters, 6.4 GB in f32."""
    n = TZ.build(TC.get_config("hymba-1.5b")).n_params()
    assert 1.58e9 < n < 1.60e9


def _setup(arch, **over):
    jcfg = JC.get_reduced(arch) if not over else JZ.reduce_config(
        JC.get_config(arch), **over)
    tcfg = TC.get_reduced(arch) if not over else TZ.reduce_config(
        TC.get_config(arch), **over)
    jp = JZ.build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, size=(B, S))
    return jcfg, tcfg, jp, tp, tokens


CASES = [("hymba_15b", {}), ("mamba2_370m", {}), ("stablelm_3b", {}),
         ("gemma3_4b", {}), ("gemma3_4b", {"n_layers": 8}),
         # absolute sinusoidal positions instead of RoPE
         ("stablelm_3b", {"rope_theta": 0.0})]


@pytest.mark.parametrize("arch,over", CASES)
def test_forward_vs_jax(arch, over):
    jcfg, tcfg, jp, tp, tokens = _setup(arch, **over)
    assert sorted(TZ.build(tcfg).layout) == sorted(JZ.build(jcfg).layout)
    logits, aux = TZ.build(tcfg).forward(tp, {"tokens":
                                              torch.from_numpy(tokens)})
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    assert aux == {} and logits.shape == (B, S, tcfg.vocab_padded)
    assert torch.isfinite(logits[..., :tcfg.vocab]).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD)


def test_forward_sliced_window_vs_jax():
    """A local-attention model with ``sliced_window=True``: the full block
    hands the config's lever to ``attn_apply`` as the reference does, and
    the logits match the reference's."""
    jcfg, tcfg, jp, tp, tokens = _setup("gemma3_4b", sliced_window=True)
    assert tcfg.sliced_window and jcfg.sliced_window
    logits, _ = TZ.build(tcfg).forward(tp, {"tokens":
                                            torch.from_numpy(tokens)})
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("arch,over", CASES[:4] + CASES[5:])
def test_decode_steps_vs_jax(arch, over):
    jcfg, tcfg, jp, tp, tokens = _setup(arch, **over)
    model = TZ.build(tcfg)
    tc = model.init_cache(B, 16, torch.float32, device="cpu")
    jc = JT.init_cache(jcfg, B, 16, jnp.float32)
    # the float64 oracle: the port's decode on the same params in float64
    p64 = tree_map(lambda a: a.double() if a.is_floating_point() else a, tp)
    oc = model.init_cache(B, 16, torch.float64, device="cpu")

    def flat(tree, as_np):
        return dict((jax.tree_util.keystr(p), as_np(a)) for p, a in
                    jax.tree_util.tree_flatten_with_path(tree)[0])
    for t in range(6):
        tok = torch.from_numpy(tokens[:, t:t + 1])
        tl, tc = model.decode(tp, tc, tok, t)
        _, oc = model.decode(p64, oc, tok, t)
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.asarray(t), jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DEC)
        jflat = flat(jc, np.asarray)
        tflat = flat(tc, lambda a: a.numpy())
        oflat = flat(oc, lambda a: a.numpy())
        assert sorted(jflat) == sorted(tflat) == sorted(oflat)
        for key, want in jflat.items():
            scale = float(np.abs(oflat[key]).max())
            if scale < 1e2:
                np.testing.assert_allclose(tflat[key], want, **DEC)
                continue
            port = float(np.abs(tflat[key] - oflat[key]).max())
            ref = float(np.abs(want - oflat[key]).max())
            assert port <= 2 * ref + 1e-6 * scale, (t, key, port, ref, scale)


def test_decode_vector_positions_vs_jax():
    """Per-row positions (continuous batching): row 1 runs two steps ahead
    of row 0."""
    jcfg, tcfg, jp, tp, tokens = _setup("hymba_15b")
    model = TZ.build(tcfg)
    tc = model.init_cache(B, 16, torch.float32, device="cpu")
    jc = JT.init_cache(jcfg, B, 16, jnp.float32)
    for t in range(4):
        pos = np.array([t, t + 2], np.int32)
        tl, tc = model.decode(tp, tc, torch.from_numpy(tokens[:, t:t + 1]),
                              torch.from_numpy(pos))
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.asarray(pos), jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DEC)


@pytest.mark.parametrize("arch,over", CASES)
def test_forward_vs_own_decode(arch, over):
    _, tcfg, _, tp, tokens = _setup(arch, **over)
    model = TZ.build(tcfg)
    full, _ = model.forward(tp, {"tokens": torch.from_numpy(tokens)})
    cache = model.init_cache(B, S, torch.float32, device="cpu")
    steps = []
    for t in range(S):
        lg, cache = model.decode(tp, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]), t)
        steps.append(lg)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **SELF)
    has_kv = set(tcfg.pattern) != {"ssm"}
    assert TT.cache_max_len(cache, tcfg) == (S if has_kv else tcfg.enc_seq)


def test_decode_leaves_the_old_cache_alone():
    _, tcfg, _, tp, tokens = _setup("hymba_15b")
    model = TZ.build(tcfg)
    cache = model.init_cache(B, 8, torch.float32, device="cpu")
    _, new = model.decode(tp, cache, torch.from_numpy(tokens[:, :1]), 0)
    blk = cache["blocks"]["p0_hybrid"]
    assert all(float(v.abs().max()) == 0 for v in blk.values())
    assert float(new["blocks"]["p0_hybrid"]["k"].abs().max()) > 0


def test_make_batch_and_init_shapes():
    cfg = TC.get_reduced("hymba_15b")
    g = torch.Generator().manual_seed(0)
    batch = TZ.make_batch(cfg, 2, 16, generator=g, device="cpu")
    assert batch["tokens"].shape == (2, 16) and batch["labels"].shape == (2, 16)
    assert int(batch["tokens"].max()) < cfg.vocab
    params = TZ.build(cfg).init(torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16, device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JZ.build(JC.get_reduced("hymba_15b")).init(
            jax.random.PRNGKey(0)))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert tshapes == jshapes
    assert params["blocks"]["p0_hybrid"]["attn"]["wq"].dtype == torch.bfloat16


# ------------------ cross attention, encoder-decoder, MLA, MoE ----------------

def _memory_batch(cfg, tokens, seed=2):
    """tokens plus the memory inputs a config reads, numpy from a seed:
    frames (B, enc_seq, d) for an encoder-decoder, image_embeds (B,
    n_img_tokens, d) for a vision model."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": tokens}
    if cfg.encdec:
        batch["frames"] = rng.normal(
            size=(tokens.shape[0], cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.n_img_tokens:
        batch["image_embeds"] = rng.normal(
            size=(tokens.shape[0], cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _aux_close(aux, jaux):
    assert sorted(aux) == sorted(jaux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v.detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", MEMORY_MOE)
def test_memory_and_moe_forward_vs_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    assert TZ.build(tcfg).layout.keys() == JZ.build(jcfg).layout.keys()
    batch = _memory_batch(jcfg, tokens)
    logits, aux = TZ.build(tcfg).forward(tp, _to_torch(batch))
    want, jaux = JT.forward(jp, _to_jax(batch), jcfg)
    assert logits.shape == (B, S, tcfg.vocab_padded)
    assert torch.isfinite(logits[..., :tcfg.vocab]).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD)
    _aux_close(aux, jaux)
    assert bool(aux) == bool(tcfg.n_experts)


def _cross_fill(cfg, cache, rng):
    """The same nonzero numbers in every cross-attention cache leaf (ck /
    cv): a numpy draw per leaf, keyed by its path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith("['ck']") or key.endswith("['cv']"):
            out[key] = rng.normal(size=leaf.shape).astype(np.float32)
    return out


def _set_leaves(cache, values, as_leaf):
    flat, treedef = jax.tree_util.tree_flatten_with_path(cache)
    new = [as_leaf(values[jax.tree_util.keystr(p)])
           if jax.tree_util.keystr(p) in values else leaf for p, leaf in flat]
    return jax.tree_util.tree_unflatten(treedef, new)


def _port_cache_like(tc, values):
    """The port's cache (nested dicts of tensors) with the leaves named in
    ``values`` (jax keystr paths) copied in."""
    flat = jax.tree_util.tree_flatten_with_path(tc)[0]
    for p, leaf in flat:
        key = jax.tree_util.keystr(p)
        if key in values:
            leaf.copy_(torch.from_numpy(values[key]))
    return tc


@pytest.mark.parametrize("arch,absorb", [(a, False) for a in MEMORY_MOE]
                         + [("deepseek_v2_236b", True)])
def test_memory_and_moe_decode_vs_jax(arch, absorb):
    """Six ``decode_step``s against JAX's, logits and every cache leaf at
    1e-4, the cross caches filled with the same nonzero numbers on both
    sides (``absorb``: MLA's matrix-absorbed decode)."""
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    if absorb:
        jcfg = dataclasses.replace(JC.get_reduced(arch), mla_absorb=True)
        tcfg = dataclasses.replace(TC.get_reduced(arch), mla_absorb=True)
    model = TZ.build(tcfg)
    tc = model.init_cache(B, 16, torch.float32, device="cpu")
    jc = JT.init_cache(jcfg, B, 16, jnp.float32)
    fill = _cross_fill(jcfg, jc, np.random.default_rng(7))
    assert bool(fill) == bool(jcfg.encdec or jcfg.n_img_tokens)
    jc = _set_leaves(jc, fill, lambda a: jnp.asarray(a.copy()))
    tc = _port_cache_like(tc, fill)

    def flat(tree, as_np):
        return dict((jax.tree_util.keystr(p), as_np(a)) for p, a in
                    jax.tree_util.tree_flatten_with_path(tree)[0])
    for t in range(6):
        tok = torch.from_numpy(tokens[:, t:t + 1])
        tl, tc = model.decode(tp, tc, tok, t)
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.asarray(t), jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DEC)
        jflat, tflat = flat(jc, np.asarray), flat(tc, lambda a: a.numpy())
        assert sorted(jflat) == sorted(tflat)
        for key, want in jflat.items():
            np.testing.assert_allclose(tflat[key], want, err_msg=key, **DEC)
        for key, want in fill.items():          # read, never written
            np.testing.assert_array_equal(tflat[key], want)


@pytest.mark.parametrize("arch", MEMORY_MOE)
def test_memory_and_moe_decode_in_place_bit_equal(arch):
    """``decode_step_`` (in place) bit-equal to ``decode_step`` (on a
    copy), logits and cache, over four steps with per-row positions."""
    _, tcfg, _, tp, tokens = _setup(arch)
    model = TZ.build(tcfg)
    cache = model.init_cache(B, 16, torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    for _, leaf in flatten_with_path(cache):
        leaf.copy_(torch.from_numpy(rng.normal(size=leaf.shape)
                                    .astype(np.float32)))
    live = tree_map(torch.clone, cache)
    for t in range(4):
        pos = torch.tensor([t, t + 3])
        tok = torch.from_numpy(tokens[:, t:t + 1])
        want, cache = model.decode(tp, cache, tok, pos)
        got = model.decode_(tp, live, tok, pos)
        assert torch.equal(got, want)
        for (pa, a), (pb, b) in zip(flatten_with_path(live),
                                    flatten_with_path(cache)):
            assert pa == pb and torch.equal(a, b), pa


def _fill_from_memory(model, params, cache, memory):
    """Each cross-attention layer's ck / cv from the memory through its own
    wk / wv, as a serving prefill would fill them."""
    cfg = model.cfg
    for key, blk in params["blocks"].items():
        if "cross" not in blk:
            continue
        for c in range(blk["cross"]["wk"].shape[0]):
            for name, w in (("ck", "wk"), ("cv", "wv")):
                cache["blocks"][key][name][c].copy_(torch.einsum(
                    "bsd,dhk->bshk", memory, blk["cross"][w][c]))
    return cache


@pytest.mark.parametrize("arch", MEMORY_MOE)
def test_memory_and_moe_forward_vs_own_decode(arch):
    """The port's forward against its own decode over all 48 positions at
    3e-4 / 3e-3, the cross caches filled from the memory (the encoder's
    output, or the image embeddings) through each layer's wk / wv; MoE
    capacity raised so the forward drops nothing, as decode (capacity 8
    for B tokens) drops nothing."""
    over = {"capacity_factor": 8.0} if "_8x7b" in arch or "deepseek" in arch \
        else {}
    _, tcfg, _, tp, tokens = _setup(arch, **over)
    model = TZ.build(tcfg)
    batch = _to_torch(_memory_batch(tcfg, tokens))
    full, aux = model.forward(tp, batch)
    if tcfg.n_experts:
        assert float(aux["dropped_frac"]) == 0.0
    memory = (TT._encode(tp, batch["frames"], tcfg) if tcfg.encdec
              else batch.get("image_embeds"))
    cache = model.init_cache(B, S, torch.float32, device="cpu")
    if memory is not None:
        cache = _fill_from_memory(model, tp, cache, memory)
    steps = []
    for t in range(S):
        lg, cache = model.decode(tp, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]), t)
        steps.append(lg)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **SELF)


def _dense64(flash):
    """``flash_attention`` for float64 inputs: dense softmax attention in
    float64 (the oracle's), any other dtype through ``flash``."""
    def attend(q, k, v, causal=True, window=0, **kw):
        if q.dtype != torch.float64:
            return flash(q, k, v, causal=causal, window=window, **kw)
        groups = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(groups, 2) for t in (k, v))
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


def _grads(model, params, batch, dtype):
    tp = tree_map(lambda x: x.detach().to(dtype).requires_grad_(), params)
    tb = {k: v if not v.is_floating_point() else v.to(dtype)
          for k, v in _to_torch(batch).items()}
    loss, metrics = model.loss(tp, tb)
    loss.backward()
    return loss.detach(), metrics, {p: x.grad.double().numpy()
                                    for p, x in flatten_with_path(tp)}


def _hold_to_oracle(got, want, oracle, rule):
    """Every leaf's distance to the float64 ``oracle`` (of the oracle
    leaf's largest entry): the port's within ``rule`` times the larger of
    JAX's on that leaf and JAX's median over the tree."""
    dist = {}
    for path, g in got.items():
        scale = max(float(np.abs(oracle[path]).max()), 1e-30)
        dist[path] = (float(np.abs(g - oracle[path]).max()) / scale,
                      float(np.abs(want[path] - oracle[path]).max()) / scale)
    median = float(np.median([ref for _, ref in dist.values()]))
    for path, (port, ref) in dist.items():
        assert port <= rule * max(ref, median), (path, port, ref, median)


_LOSS_RUNS = {}


def _loss_case(arch):
    """The port's and JAX's ``Model.loss`` and gradients on one batch, and
    (for GRAD_WIDE and ORACLE_RULE configs) the port's float64 gradients
    with dense float64 attention; kept for the tests that reuse them."""
    if arch in _LOSS_RUNS:
        return _LOSS_RUNS[arch]
    from repro_torch.models import attention as TA
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, jcfg.vocab, size=tokens.shape)
    labels[0, :3] = -1
    batch = dict(_memory_batch(jcfg, tokens), labels=labels)
    (jl, jmet), jg = jax.value_and_grad(JZ.build(jcfg).loss, has_aux=True)(
        jp, _to_jax(batch))
    model = TZ.build(tcfg)
    tl, tmet, got = _grads(model, tp, batch, torch.float32)
    want = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, jg)))
    oracle = None
    if arch in GRAD_WIDE or arch in ORACLE_RULE:
        flash = TA.flash_attention
        TA.flash_attention = _dense64(flash)
        try:
            _, _, oracle = _grads(model, tp, batch, torch.float64)
        finally:
            TA.flash_attention = flash
    _LOSS_RUNS[arch] = (jl, jmet, tl, tmet, got, want, oracle)
    return _LOSS_RUNS[arch]


@pytest.mark.parametrize("arch", MEMORY_MOE)
def test_memory_and_moe_loss_and_grads_vs_jax(arch):
    """``Model.loss`` (with the MoE auxiliaries: 0.01 lb_loss + 1e-3
    z_loss) and its gradients against ``jax.value_and_grad`` of the JAX
    ``Model.loss``: the loss within 2e-5, the auxiliaries at 1e-5, and each
    gradient leaf within 5e-4 of its largest entry (tests/test_torch_
    train.py's bounds). The leaves GRAD_WIDE names, whose f32 rounding in
    the reference is larger than that, are held to JAX within 2e-3 of
    their scale, and to a float64 run of the port (dense float64 attention
    in place of flash): JAX's distance to it within 1e-3 of the scale, the
    port's within twice JAX's plus 1e-6 of the scale. Reduced whisper's
    leaves are all held to that float64 run by ``ORACLE_RULE`` instead."""
    jl, jmet, tl, tmet, got, want, oracle = _loss_case(arch)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert sorted(tmet) == sorted(jmet)
    _aux_close({k: v for k, v in tmet.items() if k != "ce"},
               {k: v for k, v in jmet.items() if k != "ce"})
    assert sorted(want) == sorted(got)
    if arch in ORACLE_RULE:
        _hold_to_oracle(got, want, oracle, ORACLE_RULE[arch])
        return
    wide = re.compile(GRAD_WIDE.get(arch, r"(?!)"))
    for path, g in got.items():
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        if not wide.search(path):
            assert err <= GRAD_REL * scale, (path, err, scale)
            continue
        port = float(np.abs(g - oracle[path]).max())
        ref = float(np.abs(w - oracle[path]).max())
        assert err <= 4 * GRAD_REL * scale, (path, err, scale)
        assert ref <= 2 * GRAD_REL * scale, (path, ref, scale)
        assert port <= 2 * ref + 1e-6 * scale, (path, err, port, ref, scale)


@pytest.mark.parametrize("fault", ["scaled", "dropped"])
def test_whisper_oracle_rule_fails_a_planted_fault(fault):
    """ORACLE_RULE is sharp: the port's ``cross/wk`` gradient scaled by
    1.01, or ``enc_norm``'s bias gradient dropped (zeroed), fails it."""
    _, _, _, _, got, want, oracle = _loss_case("whisper_small")
    bad = dict(got)
    path = ("blocks/p0_dec_cross/cross/wk" if fault == "scaled"
            else "enc_norm/bias")
    bad[path] = got[path] * 1.01 if fault == "scaled" else 0 * got[path]
    with pytest.raises(AssertionError, match=path):
        _hold_to_oracle(bad, want, oracle, ORACLE_RULE["whisper_small"])
