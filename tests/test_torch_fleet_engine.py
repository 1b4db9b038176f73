"""The port's continuous-batching engine (``serve/engine.py``).

* The reference's engine cases (``tests/test_fleet_engine.py``) against
  the port: mid-flight admission equal to solo serving, the truncation
  flag, the re-compaction scheduler's hysteresis and its drive of the
  engine, mid-flight recompaction bit-exact, the in-place cache (where
  the reference asserts donation: the cache keeps its tensors and the step
  writes them), cancel, latency stats and submit validation. The solo
  reference runs at the same batch width: a GEMM of another M may sum in
  another order, on the CPU as on the card.
* Parity with ``repro.serve.FleetEngine``: the same prompts, budgets and
  calls (a cancel and a truncation included) through both engines give
  equal greedy tokens, flags and ``stats()`` counters, for a tiny gemma
  (``global``), reduced mamba2-370m (``ssm``) and reduced hymba-1.5b
  (``hybrid``, which exercises ``_reset_recurrent``), dense and compact,
  reduced mixtral-8x7b (``local`` with the MoE MLP, capacity-routed at
  every step) and deepseek-v2 (``mla`` over the compressed cache, MoE with
  shared experts), dense,
  and for the KV-only kind also a bf16 cache (an ``ssm`` or ``hybrid``
  step of the reference hands its conv tails back in the activation
  dtype, so its bf16 cache does not stay bf16; the port's in-place cache
  keeps its dtype). JAX's top-2 logit gap at every emitted step exceeds
  the decode parity tolerance, 1e-4 of the logits' scale, so equal tokens
  are not luck.
* ``_request_key`` bit-equal to the reference's; the counter-based sampler
  at temperature > 0: continuous == solo, and its frequencies over 20k
  draws at vocab 8 within 4 standard errors of softmax(logits / T).
* Both engines refuse an encoder-decoder or vision model (their memory
  caches need a per-request prefill) with the same message.
* On the card (``cuda``): a reduced hybrid engine captures once across
  admit / cancel / refresh / recompact, equals the CPU engine's tokens and
  reruns bit-equal; so does a reduced MoE engine (mixtral, deepseek)
  across admit / evict / refresh; the sampler's bits equal the CPU's; a staged admission
  buffer is not reused before its copy has run.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_reduced
    from repro.models.transformer import decode_step as j_decode
    from repro.models.transformer import init_cache as j_init_cache
    from repro.models.zoo import build as j_build
    import repro.serve as JS
    from repro.serve.engine import _request_key as j_request_key
except ImportError:       # the card's machine has PyTorch but no JAX
    jax = None
from repro_torch._tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models.zoo import build
from repro_torch.serve import (EngineConfig, FleetEngine, LatencyStats,
                               RecompactScheduler, compact_model)
from repro_torch.serve.engine import (_request_key, gumbel_sample,
                                      sample_bits)

W1 = "blocks/p0_global/mlp/w1"
GAP = 1e-4           # the decode parity tolerance, of the logits' scale


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread, so a decode loop's many small ops
    do not wait on a thread pool that other test workers load too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(get, n_layers=2):
    return dataclasses.replace(
        get("gemma_7b"), n_layers=n_layers, d_model=64, d_ff=128,
        n_heads=2, n_kv_heads=1, head_dim=32)


def _tiny(n_layers=2):
    """A gemma variant small enough for a single core: the block layout
    (p0_global MLP) the compact specs match, tiny widths."""
    cfg = _tiny_cfg(get_reduced, n_layers)
    model = build(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0),
                                  device="cpu")


def _kill_w1_columns(params, cols):
    """Zero the given w1 hidden columns (simulated projected training)."""
    out = tree_map(torch.clone, params)
    out["blocks"]["p0_global"]["mlp"]["w1"][:, :, list(cols)] = 0.0
    return out


def _solo(model, params, prompt, max_new, B, max_seq=32, sample_seed=None,
          **ecfg):
    """Solo reference: ``prompt`` alone in a fresh engine of width B."""
    eng = FleetEngine(model, B, EngineConfig(max_seq=max_seq, **ecfg))
    eng.load(params)
    eng.submit(prompt, max_new, sample_seed=sample_seed)
    return eng.drain()[0].tokens


def test_midflight_admission_matches_solo():
    """Requests admitted into freed slots mid-flight produce the tokens of
    solo generation: slot reuse leaks nothing of the previous occupant."""
    cfg, model, params = _tiny()
    eng = FleetEngine(model, 2, EngineConfig(max_seq=32))
    eng.load(params)
    prompts = [[1, 2, 3], [4, 5], [7], [8, 9, 3, 1], [3, 1]]
    budgets = [6, 2, 2, 5, 3]          # heavy-tailed: slots churn
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    got = {c.rid: c for c in eng.drain()}
    assert eng.n_traces == 1
    assert eng.stats()["busy_slots"] == 0 and eng.stats()["queue"] == 0
    for p, n, r in zip(prompts, budgets, rids):
        assert len(got[r].generated) == n
        assert got[r].tokens == _solo(model, params, p, n, B=2), \
            f"rid {r} diverges from solo serving"


def test_truncation_flag_at_cache_boundary():
    """A row whose prompt is long relative to max_seq gets fewer than
    max_new tokens, and says so."""
    cfg, model, params = _tiny(n_layers=1)
    eng = FleetEngine(model, 2, EngineConfig(max_seq=8))
    eng.load(params)
    r0 = eng.submit([1, 2, 3, 4, 5], 6)
    r1 = eng.submit([1, 2], 6)
    got = {c.rid: c for c in eng.drain()}
    # row 0: emits at pos 4..7 then runs out of cache depth -> 4 of 6
    assert len(got[r0].tokens) == 5 + 4 and got[r0].truncated
    # row 1: emits at pos 1..6 -> full budget, no flag
    assert len(got[r1].tokens) == 2 + 6 and not got[r1].truncated
    assert got[r1].tokens == _solo(model, params, [1, 2], 6, B=2, max_seq=8)


def test_scheduler_hysteresis_no_thrash():
    """A live/slot ratio hovering at the threshold fires the scheduler
    once; re-firing needs a further ``hysteresis`` drop."""
    sched = RecompactScheduler(threshold=0.9, hysteresis=0.05)
    assert not sched.decide(0.95)
    assert sched.decide(0.89)
    hover = [0.895, 0.885, 0.89, 0.887, 0.893, 0.886]
    assert not any(sched.decide(r) for r in hover), "thrash at threshold"
    assert sched.decide(0.83)
    assert sched.fires == 2
    assert sched.reslot_recommended(0.4)
    assert not sched.reslot_recommended(0.6)


def test_scheduler_drives_engine_recompact():
    """refresh upgrades itself to a recompact exactly when the scheduler
    fires, and the lifecycle builds the step once."""
    cfg, model, params = _tiny()
    params = _kill_w1_columns(params, range(96))      # 32/128 live
    sched = RecompactScheduler(threshold=0.99, hysteresis=1 / 32)
    eng = FleetEngine(model, 2, EngineConfig(max_seq=32), scheduler=sched)
    eng.load_compact(params=params)
    assert eng.compact.live[W1] == 32
    eng.submit([1, 2, 3], 4)
    eng.drain()
    assert eng.n_traces == 1

    victim = int(eng.compact.sels[W1][0])
    params2 = _kill_w1_columns(params, [victim])
    assert eng.refresh(params2) is True
    assert sched.fires == 1 and eng.compact.live[W1] == 31

    assert eng.refresh(params2) is False
    assert sched.fires == 1
    eng.submit([4, 5], 4)
    eng.drain()
    assert eng.n_traces == 1


def test_midflight_recompact_bit_exact():
    """Recompacting between steps with requests in flight is bit-exact:
    the solo run that switches checkpoints at the same local depth gives
    the same tokens."""
    cfg, model, params = _tiny()
    params = _kill_w1_columns(params, range(96))
    cm = compact_model(params, cfg.projection_specs)
    victim = int(cm.sels[W1][0])
    params2 = _kill_w1_columns(tree_map(lambda a: a * 1.25, params),
                               [victim])

    switch_at = 3
    eng = FleetEngine(model, 3, EngineConfig(max_seq=32))
    eng.load_compact(params=params)
    prompts = [[1, 2, 3], [4, 5], [8, 9, 3, 1]]
    rids = [eng.submit(p, 6) for p in prompts]
    for _ in range(switch_at):
        eng.step()
    eng.recompact(params2)
    assert eng.compact.live[W1] == 31
    got = {c.rid: c.tokens for c in eng.drain()}
    assert eng.n_traces == 1, "mid-flight recompact must not rebuild"

    for p, r in zip(prompts, rids):
        solo = FleetEngine(model, 3, EngineConfig(max_seq=32))
        solo.load_compact(params=params)
        solo.submit(p, 6)
        for _ in range(switch_at):
            solo.step()
        solo.recompact(params2)
        assert solo.drain()[0].tokens == got[r], f"rid {r} diverges"


def test_cache_and_slots_are_written_in_place():
    """The step writes the cache and the slot state in place (the port's
    counterpart of donation): every tensor keeps its address across
    steps, and a reference taken before a step sees that step's writes."""
    cfg, model, params = _tiny(n_layers=1)
    eng = FleetEngine(model, 2, EngineConfig(max_seq=16))
    eng.load(params)
    eng.submit([1, 2, 3], 2)
    eng.step()
    ptrs = [a.data_ptr() for a in leaves(eng._cache) + leaves(eng._slots)]
    old_k = eng._cache["blocks"]["p0_global"]["k"]
    old_pos = eng._slots["pos"]
    snap = old_k.clone()
    eng.step()
    assert not torch.equal(old_k, snap), "the step did not write the cache"
    assert int(old_pos[0]) == 2
    eng.flush()
    assert [a.data_ptr() for a in leaves(eng._cache) +
            leaves(eng._slots)] == ptrs


def test_cancel_evicts_and_frees_slot():
    """cancel() retires an in-flight request (evicted, partial tokens) and
    its slot is re-admitted with no rebuild."""
    cfg, model, params = _tiny(n_layers=1)
    eng = FleetEngine(model, 1, EngineConfig(max_seq=32))
    eng.load(params)
    r0 = eng.submit([1, 2, 3], 8)
    r1 = eng.submit([4, 5], 3)          # queued behind the only slot
    for _ in range(4):
        eng.step()
    assert eng.cancel(r0)
    comps = {c.rid: c for c in eng.drain()}
    assert comps[r0].evicted and len(comps[r0].generated) < 8
    assert not comps[r1].evicted and len(comps[r1].generated) == 3
    assert comps[r1].tokens == _solo(model, params, [4, 5], 3, B=1)
    assert eng.n_traces == 1
    assert not eng.cancel(r1)           # already finished


def test_latency_stats_and_report():
    """LatencyStats percentiles and the engine's latency_report shape."""
    s = LatencyStats.from_samples([0.1, 0.2, 0.3])
    assert s.count == 3 and abs(s.p50 - 0.2) < 1e-12
    assert LatencyStats.from_samples([]).count == 0
    cfg, model, params = _tiny(n_layers=1)
    eng = FleetEngine(model, 2, EngineConfig(max_seq=16))
    eng.load(params)
    eng.submit([1, 2], 3)
    eng.drain()
    rep = eng.latency_report()
    assert rep["ttft"]["count"] == 1
    assert rep["per_token"]["count"] == 2      # 3 tokens -> 2 gaps
    assert rep["ttft"]["p50"] > 0


def test_submit_validation():
    """Prompt length and budget validation fail loudly at submit; mesh
    rules that map "batch" to None (as the reference refuses them, at its
    first step), a checkpoint on two devices and one on another device
    are refused."""
    cfg, model, params = _tiny(n_layers=1)
    eng = FleetEngine(model, 1, EngineConfig(max_seq=8))
    eng.load(params)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(9)), 4)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1], 0)
    with pytest.raises(ValueError, match="map 'batch' to None"):
        FleetEngine(model, 1, EngineConfig(), mesh=object(),
                    rules={"batch": None})
    if jax is not None:
        jm = j_build(_tiny_cfg(j_reduced, 1))
        jeng = JS.FleetEngine(jm, 1, JS.EngineConfig(max_seq=8),
                              mesh=object(), rules={"batch": None})
        jeng.load(jm.init(jax.random.PRNGKey(0)))
        with pytest.raises(ValueError, match="map 'batch' to None"):
            jeng.step()
    with pytest.raises(RuntimeError, match="no checkpoint"):
        FleetEngine(model, 1, EngineConfig()).step()
    meta = tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="serves on cpu"):
        eng.load(meta)
    meta["embed"]["table"] = params["embed"]["table"]
    with pytest.raises(ValueError, match="span devices"):
        eng.load(meta)


def test_load_of_other_shapes_rebuilds_once_and_keeps_rows():
    """A load of a tree with other shapes (dense -> compact) rebuilds the
    step once; rows in flight keep going and finish as a solo run that
    switches at the same depth."""
    cfg, model, params = _tiny()
    params = _kill_w1_columns(params, range(96))
    eng = FleetEngine(model, 2, EngineConfig(max_seq=32))
    eng.load(params)
    rid = eng.submit([1, 2, 3], 6)
    for _ in range(3):
        eng.step()
    eng.load_compact(params=params)
    got = eng.drain()[0]
    assert eng.n_traces == 2
    assert got.rid == rid
    # compact and dense are bit-equal on the CPU, so the switch is exact
    assert got.tokens == _solo(model, params, [1, 2, 3], 6, B=2)


# --------------------------- parity with repro.serve -------------------------

def _parity_setup(arch, compact):
    """(jax cfg, port cfg, numpy params) for a parity case; compact cases
    get 3/4 of their w1 columns dead."""
    if arch == "gemma":
        jcfg, tcfg = _tiny_cfg(j_reduced), _tiny_cfg(get_reduced)
    else:
        jcfg, tcfg = j_reduced(arch), get_reduced(arch)
    P = jax.tree_util.tree_map(
        np.array, j_build(jcfg).init(jax.random.PRNGKey(3)))
    if compact and tcfg.d_ff:
        w1 = next(iter(P["blocks"].values()))["mlp"]["w1"]
        dead = np.random.default_rng(4).choice(w1.shape[-1],
                                               3 * w1.shape[-1] // 4,
                                               replace=False)
        w1[..., dead] = 0.0
    return jcfg, tcfg, P


PROMPTS = [[5, 9, 17, 3], [11, 2], [30, 31, 32, 33, 34, 35, 36, 37, 38],
           [7], [64, 1, 99], [12, 13, 14, 15, 16], [8, 8]]
BUDGETS = [6, 3, 12, 2, 12, 4, 7]
SMAX = 12


def _drive(eng, seed_offset=0):
    """The parity scenario: five requests into three slots, a cancel after
    four steps, two more requests, drain (at max_seq 12 the fifth request
    truncates)."""
    rids = [eng.submit(p, n, sample_seed=i + seed_offset)
            for i, (p, n) in enumerate(zip(PROMPTS[:5], BUDGETS[:5]))]
    done = []
    for _ in range(4):
        done += eng.step()
    assert eng.cancel(rids[2])
    rids += [eng.submit(p, n, sample_seed=5 + i + seed_offset)
             for i, (p, n) in enumerate(zip(PROMPTS[5:], BUDGETS[5:]))]
    done += eng.drain()
    comps = {c.rid: c for c in done}
    return [(comps[r].tokens, comps[r].truncated, comps[r].evicted)
            for r in rids], eng.stats()


def _jax_min_gap(jcfg, step, jp, tokens, plen, dtype, smax):
    """JAX's smallest top-2 logit gap over the logits' scale at the steps
    that emitted ``tokens[plen:]`` (teacher-forced through the jitted
    ``step``, B 1)."""
    cache = j_init_cache(jcfg, 1, smax, dtype)
    worst = np.inf
    for p in range(len(tokens) - 1):
        lg, cache = step(jp, cache, jnp.asarray([[tokens[p]]], jnp.int32),
                         jnp.asarray(p))
        if p >= plen - 1:
            v = np.sort(np.asarray(lg[0, -1, :jcfg.vocab], np.float64))
            worst = min(worst, (v[-1] - v[-2]) / np.abs(v).max())
    return worst


PARITY = [("gemma", False, None), ("gemma", True, None),
          ("gemma", False, "bf16"), ("gemma", True, "bf16"),
          ("mamba2_370m", False, None), ("mamba2_370m", True, None),
          ("hymba_15b", False, None), ("hymba_15b", True, None),
          ("mixtral_8x7b", False, None), ("deepseek_v2_236b", False, None)]


@pytest.mark.parametrize("arch,compact,cache", PARITY)
def test_engine_parity_with_jax(arch, compact, cache):
    """The same calls through repro.serve.FleetEngine and the port's give
    equal greedy tokens, truncated / evicted flags and stats()."""
    jcfg, tcfg, P = _parity_setup(arch, compact)
    jdt = jnp.bfloat16 if cache else None
    tdt = torch.bfloat16 if cache else None
    jeng = JS.FleetEngine(j_build(jcfg), 3,
                          JS.EngineConfig(max_seq=SMAX, cache_dtype=jdt))
    teng = FleetEngine(build(tcfg), 3,
                       EngineConfig(max_seq=SMAX, cache_dtype=tdt))
    jp = jax.tree_util.tree_map(jnp.asarray, P)
    tp = params_from_numpy(P, "cpu")
    if compact:
        jeng.load_compact(params=jp)
        teng.load_compact(params=tp)
    else:
        jeng.load(jp)
        teng.load(tp)
    want, jstats = _drive(jeng)
    got, tstats = _drive(teng)
    assert got == want
    assert tstats == jstats
    assert any(t for _, t, _ in got) and any(e for _, _, e in got)
    for path, leaf in flatten_with_path(teng._cache):
        if not path.endswith("state"):
            assert leaf.dtype == (tdt or torch.float32), path
    step = jax.jit(lambda p, c, t, pos: j_decode(p, c, t, pos, jcfg))
    for (tokens, _, _), p in zip(want, PROMPTS):
        if len(tokens) > len(p):
            gap = _jax_min_gap(jcfg, step, jeng.params, tokens, len(p),
                               jdt or jnp.float32, SMAX)
            assert gap > GAP, (tokens, gap)


@pytest.mark.parametrize("arch", ["whisper_small", "llama32_vision_90b"])
def test_memory_models_refused_by_both_engines(arch):
    with pytest.raises(ValueError) as jerr:
        JS.FleetEngine(j_build(j_reduced(arch)), 2, JS.EngineConfig())
    with pytest.raises(ValueError) as terr:
        FleetEngine(build(get_reduced(arch)), 2, EngineConfig())
    assert str(terr.value) == str(jerr.value)
    assert "decoder-only" in str(terr.value)


def test_request_key_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 40, size=(1000, 2))
    for seed, sample_seed in seeds.tolist():
        assert np.array_equal(_request_key(seed, sample_seed),
                              j_request_key(seed, sample_seed))
        assert _request_key(seed, sample_seed).dtype == np.uint32


# --------------------------- sampling ---------------------------------------

def test_sampled_continuous_matches_solo():
    """At temperature > 0 each request draws from its own key and
    positions: mid-flight admission gives the tokens of the request served
    alone, and the draw is not the greedy one."""
    cfg, model, params = _tiny()
    prompts = [[1, 2, 3], [4, 5], [7], [8, 9, 3, 1], [3, 1]]
    budgets = [6, 2, 4, 5, 3]
    ecfg = EngineConfig(max_seq=32, temperature=1.5, seed=7)
    eng = FleetEngine(model, 2, ecfg)
    eng.load(params)
    rids = [eng.submit(p, n, sample_seed=10 + i)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    got = {c.rid: c.tokens for c in eng.drain()}
    greedy = FleetEngine(model, 2, EngineConfig(max_seq=32))
    greedy.load(params)
    for p, n in zip(prompts, budgets):
        greedy.submit(p, n)
    greedy_tokens = [c.tokens for c in greedy.drain()]
    for i, (p, n, r) in enumerate(zip(prompts, budgets, rids)):
        assert got[r] == _solo(model, params, p, n, B=2, temperature=1.5,
                               seed=7, sample_seed=10 + i)
    assert [got[r] for r in rids] != greedy_tokens


LOGITS = np.array([0.0, 0.5, 1.0, -0.3, 2.0, 0.1, -1.0, 0.7], np.float32)


@pytest.mark.parametrize("stream", ["keys", "positions"])
def test_sampler_frequencies_match_softmax(stream):
    """20k Gumbel-max draws at vocab 8, T 0.8 — across request keys, or
    along one request's positions — hit each token within 4 standard
    errors of softmax(logits / T)."""
    n, T = 20000, 0.8
    if stream == "keys":
        key = np.stack([_request_key(3, i) for i in range(n)])
        pos = np.zeros(n, np.int64)
    else:
        key = np.tile(_request_key(3, 0), (n, 1))
        pos = np.arange(n)
    lg = torch.from_numpy(np.tile(LOGITS, (n, 1)))
    draws = gumbel_sample(lg, torch.from_numpy(key.astype(np.int64)),
                          torch.from_numpy(pos), T).numpy()
    p = np.exp(LOGITS / T - (LOGITS / T).max())
    p /= p.sum()
    freq = np.bincount(draws, minlength=8) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * se), (freq, p)


def test_sample_bits_are_uint32_and_spread():
    """The hash keeps every lane in [0, 2**32) (no sign bit, so the shifts
    are logical) and spreads over it: each of the top two bits is set in
    about half of 10^5 values."""
    key = torch.tensor([[0xFFFFFFFF, 0x80000000]] * 10000)
    pos = torch.arange(10000)
    bits = sample_bits(key, pos, 10)
    assert bits.dtype == torch.long
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    for shift in (31, 30):
        share = float(((bits >> shift) & 1).float().mean())
        assert abs(share - 0.5) < 0.01, (shift, share)


# --------------------------- on the card -------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine captures its step into "
                    "a CUDA graph only on the card")
    return torch.device("cuda")


def _hybrid_setup():
    cfg = get_reduced("hymba_15b")
    params = build(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    w1 = params["blocks"]["p0_hybrid"]["mlp"]["w1"]
    w1[..., ::2] = 0.0
    params2 = tree_map(lambda a: a * 1.25, params)
    params3 = tree_map(torch.clone, params2)
    params3["blocks"]["p0_hybrid"]["mlp"]["w1"][..., 1] = 0.0
    return cfg, params, params2, params3


def _lifecycle(model, dev, params, params2, params3):
    """Admit (more requests than slots), cancel, refresh, recompact on a
    compact engine; returns (tokens per rid, engine)."""
    eng = FleetEngine(model, 3, EngineConfig(max_seq=24))
    to = lambda t: tree_map(lambda a: a.to(dev), t)
    eng.load_compact(params=to(params))
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    done = []
    for _ in range(3):
        done += eng.step()
    eng.cancel(rids[0])
    for _ in range(3):
        done += eng.step()
    eng.refresh(to(params2))
    for _ in range(3):
        done += eng.step()
    eng.recompact(to(params3))
    done += eng.drain()
    return {c.rid: (c.tokens, c.evicted) for c in done}, eng


@pytest.mark.cuda
def test_cuda_engine_one_capture_matches_cpu(card):
    cfg, params, params2, params3 = _hybrid_setup()
    model = build(cfg)
    want, _ = _lifecycle(model, "cpu", params, params2, params3)
    got, eng = _lifecycle(model, card, params, params2, params3)
    assert eng.n_traces == 1
    assert eng.n_replays == eng.stats()["steps"]
    assert got == want
    again, eng2 = _lifecycle(model, card, params, params2, params3)
    assert again == got
    for a, b in zip(leaves(eng._cache), leaves(eng2._cache)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_sample_bits_equal_cpu(card):
    key = torch.from_numpy(np.stack([_request_key(1, i) for i in range(64)])
                           .astype(np.int64))
    pos = torch.arange(64) * 977
    cpu = sample_bits(key, pos, 32001)
    assert torch.equal(sample_bits(key.to(card), pos.to(card), 32001).cpu(),
                       cpu)


@pytest.mark.cuda
def test_cuda_staged_admission_waits_for_its_copy(card):
    """Three admissions staged back to back while the engine's stream is
    held up: the third reuses the first's pinned buffer only after that
    buffer's copy has run, so every slot gets its own prompt."""
    cfg, params, _, _ = _hybrid_setup()
    eng = FleetEngine(build(cfg), 3, EngineConfig(max_seq=24, pipeline=False))
    eng.load(tree_map(lambda a: a.to(card), params))
    eng._ensure_ready()
    eng._run_step(None)                 # capture
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of the stream
    width = eng._admit.shape[1]
    for slot, prompt in enumerate(PROMPTS[:3]):
        admit = np.zeros((3, width), np.int64)
        admit[:, 2] = 1
        admit[slot, 0] = 1
        admit[slot, 2] = len(prompt)
        admit[slot, 3] = 4
        admit[slot, 6:6 + len(prompt)] = prompt
        eng._run_step(admit)
    torch.cuda.synchronize()
    slots = eng._slots["prompt"].cpu()
    for slot, prompt in enumerate(PROMPTS[:3]):
        assert slots[slot, :len(prompt)].tolist() == prompt, slot


def _moe_lifecycle(model, dev, params, params2):
    """Admit (more requests than slots, so slots are evicted and reused),
    a refresh mid-flight, drain; returns (tokens per rid, engine)."""
    eng = FleetEngine(model, 3, EngineConfig(max_seq=24))
    to = lambda t: tree_map(lambda a: a.to(dev), t)
    eng.load(to(params))
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    done = []
    for _ in range(4):
        done += eng.step()
    eng.refresh(to(params2))
    done += eng.drain()
    assert sorted(c.rid for c in done) == sorted(rids)
    return {c.rid: (c.tokens, c.evicted) for c in done}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_236b"])
def test_cuda_moe_engine_one_capture_matches_cpu(card, arch):
    """The MoE decode step (router, sort-based dispatch, combine) is
    captured once and replayed across admit / evict / refresh: tokens equal
    to the CPU engine's, a rerun bit-equal."""
    cfg = get_reduced(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    params2 = tree_map(lambda a: a * 1.25 if a.is_floating_point() else a,
                       params)
    want, _ = _moe_lifecycle(model, "cpu", params, params2)
    got, eng = _moe_lifecycle(model, card, params, params2)
    assert eng.n_traces == 1
    assert eng.n_replays == eng.stats()["steps"]
    assert got == want
    again, eng2 = _moe_lifecycle(model, card, params, params2)
    assert again == got
    for a, b in zip(leaves(eng._cache), leaves(eng2._cache)):
        assert torch.equal(a, b)
