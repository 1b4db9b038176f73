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
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import transformer as JT
from repro.models import zoo as JZ
from repro_torch import configs as TC
from repro_torch._tree import tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models import zoo as TZ

FWD = dict(atol=2e-4, rtol=2e-4)
DEC = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=3e-4, rtol=3e-3)
B, S = 2, 48
PORTED = ["hymba_15b", "mamba2_370m", "stablelm_3b", "gemma3_4b",
          "gemma_7b", "qwen25_32b"]
UNPORTED = ["llama32_vision_90b", "whisper_small", "mixtral_8x7b",
            "deepseek_v2_236b"]


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


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_kinds_raise(arch):
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        TZ.build(TC.get_reduced(arch))


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
