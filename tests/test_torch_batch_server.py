"""The port's ``BatchServer`` (``train/serve.py``) and its in-place decode
step, on the CPU.

* The reference's BatchServer cases (``tests/test_zoo_serve.py``): ragged
  prompts equal to each prompt served alone, compact serving equal to
  dense, hot refresh and recompact with one step build.
* The bf16 cache (``tests/test_fleet_engine.py``): the cache follows the
  checkpoint dtype, the engine's bf16 decode equals a hand cohort loop
  token for token, and an explicit ``cache_dtype`` wins.
* ``decode_step_`` gives logits and a cache bit-equal to ``decode_step``
  at scalar and per-row positions, a negative row and an out-of-range
  row (dropped) included, and agrees with JAX there; ``decode_step`` still
  leaves its input cache untouched.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced as j_reduced
from repro.models.transformer import decode_step as j_decode
from repro.models.transformer import init_cache as j_init_cache
from repro.models.zoo import build as j_build
from repro_torch._tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.constraints import ProjectionSpec
from repro_torch.models.transformer import (decode_step, decode_step_,
                                            init_cache)
from repro_torch.models.zoo import build
from repro_torch.train import BatchServer, ServeConfig

DEC = dict(atol=1e-4, rtol=1e-4)
W1 = "blocks/p0_global/mlp/w1"


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread, so a decode loop's many small ops
    do not wait on a thread pool that other test workers load too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(model, seed=0, dtype=torch.float32):
    return model.init(torch.Generator().manual_seed(seed), dtype=dtype,
                      device="cpu")


def _kill_columns(leaf, frac, seed):
    """Zero a random fraction of the last axis (simulated projected
    training), in place."""
    rng = np.random.default_rng(seed)
    dead = rng.choice(leaf.shape[-1], int(leaf.shape[-1] * frac),
                      replace=False)
    leaf[..., torch.from_numpy(dead)] = 0.0


def _mlp_setup():
    """Reduced gemma (pure MLP) with 3/4 of w1's and 1/2 of w2's columns
    dead, under a w2 spec as well as the config's w1 spec."""
    cfg = dataclasses.replace(get_reduced("gemma_7b"), n_layers=2)
    specs = cfg.projection_specs + (ProjectionSpec(
        pattern="blocks/.*/mlp/w2$", norm="l1inf", radius=64.0, axis=0,
        every_k=10),)
    cfg = dataclasses.replace(cfg, projection_specs=specs)
    model = build(cfg)
    params = _init(model)
    mlp = params["blocks"]["p0_global"]["mlp"]
    _kill_columns(mlp["w1"], 0.75, seed=0)
    _kill_columns(mlp["w2"], 0.5, seed=1)
    return cfg, model, params


def _tiny(n_layers=2):
    cfg = dataclasses.replace(
        get_reduced("gemma_7b"), n_layers=n_layers, d_model=64, d_ff=128,
        n_heads=2, n_kv_heads=1, head_dim=32)
    model = build(cfg)
    return cfg, model, _init(model)


def test_ragged_prompts_match_per_prompt_outputs():
    """A ragged batch gives each row the output of its prompt served
    alone."""
    cfg = dataclasses.replace(get_reduced("gemma_7b"), n_layers=2)
    model = build(cfg)
    server = BatchServer(model, batch_slots=3, scfg=ServeConfig(max_seq=32))
    server.load(_init(model))
    ragged = server.generate([[1, 2, 3], [4, 5], [7]], max_new=6)
    for i, prompt in enumerate([[1, 2, 3], [4, 5], [7]]):
        alone = server.generate([prompt], max_new=6)
        assert ragged[i] == alone[0], f"row {i} diverges from solo serving"
    assert server.n_traces == 1


def test_batch_server_compact_matches_dense():
    """load_compact serves the compacted checkpoint and reproduces the
    dense server's outputs exactly."""
    cfg, model, params = _mlp_setup()
    dense = BatchServer(model, batch_slots=2, scfg=ServeConfig(max_seq=32))
    dense.load(params)
    compact = BatchServer(model, batch_slots=2, scfg=ServeConfig(max_seq=32))
    compact.load_compact(params=params)
    assert compact.compact is not None
    prompts = [[1, 2, 3], [4, 5]]
    assert dense.generate(prompts, max_new=6) == \
        compact.generate(prompts, max_new=6)


def test_hot_refresh_and_recompact_never_retrace():
    """Hot refresh and live re-compaction keep all shapes, so the step is
    built once across load -> refresh -> recompact, and the served tree is
    the engine's own (the refreshed values land in the same tensors)."""
    cfg, model, params = _mlp_setup()
    server = BatchServer(model, batch_slots=2, scfg=ServeConfig(max_seq=32))
    server.load_compact(params=params)
    served = [a.data_ptr() for a in leaves(server.params)]
    prompts = [[1, 2, 3], [4, 5]]
    out0 = server.generate(prompts, max_new=4)
    assert server.n_traces == 1

    params2 = tree_map(lambda a: a * 1.5, params)
    server.refresh(params2)
    server.generate(prompts, max_new=4)
    assert server.n_traces == 1

    victim = int(server.compact.sels[W1][0])
    params2["blocks"]["p0_global"]["mlp"]["w1"][:, :, victim] = 0.0
    live_before = server.compact.live[W1]
    server.recompact(params2)
    assert server.compact.live[W1] == live_before - 1
    assert server.compact.slot_width(W1) == live_before  # slot frozen
    assert server.compact.params is server.params
    out2 = server.generate(prompts, max_new=4)
    assert server.n_traces == 1, "re-compaction must not rebuild the step"
    assert [a.data_ptr() for a in leaves(server.params)] == served

    dense = BatchServer(model, batch_slots=2, scfg=ServeConfig(max_seq=32))
    dense.load(params2)
    assert out2 == dense.generate(prompts, max_new=4)
    assert out0 is not None


def test_bf16_cache_dtype_and_decode_parity():
    """The cache follows the checkpoint dtype, the engine's bf16 decode
    reproduces a hand cohort loop token for token, and an explicit
    cache_dtype wins."""
    cfg, model, params = _tiny(n_layers=1)
    bf16 = tree_map(lambda a: a.to(torch.bfloat16)
                    if a.is_floating_point() else a, params)
    srv = BatchServer(model, batch_slots=2, scfg=ServeConfig(max_seq=32))
    srv.load(bf16)
    prompts = [[1, 2, 3], [4, 5]]
    outs = srv.generate(prompts, max_new=5)
    assert {a.dtype for a in leaves(srv.engine._cache)} == {torch.bfloat16}

    # hand cohort loop: scalar-pos decode_step on a bf16 cache
    B = 2
    cache = init_cache(cfg, B, 32, torch.bfloat16, device="cpu")
    lens = [len(p) for p in prompts]
    out = [list(p) for p in prompts]
    feed = [p[0] for p in prompts]
    n_new = [0, 0]
    for pos in range(max(lens) + 5 - 1):
        logits, cache = decode_step(bf16, cache,
                                    torch.tensor(feed)[:, None], pos, cfg)
        nxt = logits[:, -1, :].argmax(dim=-1).tolist()
        for i in range(B):
            if pos + 1 < lens[i]:
                feed[i] = out[i][pos + 1]
            elif n_new[i] < 5:
                out[i].append(nxt[i])
                feed[i] = nxt[i]
                n_new[i] += 1
    assert outs == out

    srv32 = BatchServer(model, batch_slots=2,
                        scfg=ServeConfig(max_seq=32,
                                         cache_dtype=torch.float32))
    srv32.load(bf16)
    srv32.generate(prompts, max_new=2)
    assert {a.dtype for a in leaves(srv32.engine._cache)} == {torch.float32}


# --------------------------- the in-place decode -----------------------------

POSITIONS = [3, -2, 20, [0, 5], [-1, 4], [3, 16], [-20, 15]]


@functools.lru_cache(maxsize=1)
def _hymba():
    """Reduced hymba's config, JAX params and the port's copy (read-only:
    every test writes only its own caches)."""
    cfg = get_reduced("hymba_15b")
    jp = j_build(j_reduced("hymba_15b")).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _filled_cache(cfg, seed):
    """A cache of random values (as after some steps), B 2, Smax 16."""
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda a: torch.randn(a.shape, generator=g),
                    init_cache(cfg, 2, 16, torch.float32, device="cpu"))


@pytest.mark.parametrize("pos", POSITIONS)
def test_decode_step_inplace_bit_equal(pos):
    """decode_step_ writes into the cache exactly what decode_step
    returns, and returns the same logits, bit for bit: a scalar pos
    (negative: from the end; past the end: clamped) and (B,) positions
    (negative: from the end; out of range: the row writes nothing)."""
    cfg, _, tp = _hymba()
    cache = _filled_cache(cfg, seed=1)
    before = tree_map(torch.clone, cache)
    tok = torch.tensor([[5], [9]])
    p = torch.tensor(pos) if isinstance(pos, list) else pos
    want, new = decode_step(tp, cache, tok, p, cfg)
    for a, b in zip(leaves(cache), leaves(before)):
        assert torch.equal(a, b), "decode_step touched its input cache"
    got = decode_step_(tp, cache, tok, p, cfg)
    assert torch.equal(got, want)
    for (path, a), b in zip(flatten_with_path(cache), leaves(new)):
        assert torch.equal(a, b), path
    if isinstance(pos, list) and max(pos) >= 16:
        row = pos.index(max(pos))
        k_now = cache["blocks"]["p0_hybrid"]["k"][:, row]
        assert torch.equal(k_now, before["blocks"]["p0_hybrid"]["k"][:, row])


@pytest.mark.parametrize("pos", POSITIONS[3:])
def test_decode_step_inplace_vs_jax(pos):
    """The in-place step at per-row positions with a wrapped and a dropped
    row against JAX's decode_step (a scatter with mode="drop")."""
    cfg, jp, tp = _hymba()
    cache = _filled_cache(cfg, seed=2)
    # copies: a CPU jax array may alias the numpy buffer it came from
    jc = jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda a: a.numpy().copy(), cache))
    tok = np.array([[5], [9]], np.int32)
    want, jnew = j_decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                          j_reduced("hymba_15b"))
    got = decode_step_(tp, cache, torch.from_numpy(tok).long(),
                       torch.tensor(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEC)
    jflat = dict((jax.tree_util.keystr(k), np.asarray(v)) for k, v in
                 jax.tree_util.tree_flatten_with_path(jnew)[0])
    tflat = dict((jax.tree_util.keystr(k), v.numpy()) for k, v in
                 jax.tree_util.tree_flatten_with_path(cache)[0])
    assert sorted(jflat) == sorted(tflat)
    for key, want_leaf in jflat.items():
        np.testing.assert_allclose(tflat[key], want_leaf, **DEC,
                                   err_msg=key)


def test_model_decode_inplace_entry_point():
    """Model.decode_ is decode_step_ through the zoo's Model, and keeps
    the cache's tensors (addresses) while it writes them."""
    cfg, _, tp = _hymba()
    model = build(cfg)
    cache = model.init_cache(2, 16, torch.float32, device="cpu")
    ptrs = [a.data_ptr() for a in leaves(cache)]
    ref = model.init_cache(2, 16, torch.float32, device="cpu")
    tok = torch.tensor([[5], [9]])
    for t in range(3):
        got = model.decode_(tp, cache, tok, torch.tensor([t, t + 1]))
        want, ref = model.decode(tp, ref, tok, torch.tensor([t, t + 1]))
        assert torch.equal(got, want)
    assert [a.data_ptr() for a in leaves(cache)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(leaves(cache), leaves(ref)))
