"""The decode step over a mesh under the reference's decode rules
(``repro_torch.launch.steps.build_decode_step(model, mesh, rules)`` with
``rules_for_cell(cfg, "decode_32k" | "long_500k", False)``) on one spawned
gloo group of 4 ranks on the CPU (``tests/_dist_ranks.py``), which builds
the (2, 2) and (4, 1) (data, model) meshes over the same ranks.

Cases: reduced gemma-7b, hymba-1.5b, stablelm-3b, mamba2-370m,
deepseek-v2 (MLA, plain and absorbed) and whisper-small (its cross
memory split by heads), f32 params and cache, the cells' batch and
sequence shrunk to (8, 64) and (1, 64) as ``tests/test_multidevice.py``
shrinks them. The cache is filled from a seed below each row's first
position; two calls, a per-row position vector (rows in the last slice,
hymba's window straddling a slice boundary, rows whose positions leave
whole slices masked) and then a scalar.

Held:

* against the port's one-device step (``build_decode_step(model)``):
  each call's logits and every cache leaf after both calls within atol
  1e-5 + rtol 1e-5 (``tests/test_torch_mesh_step.py``'s), widened for a
  leaf whose scale passes 1e2 by 1e-6 of that scale (the zoo's term,
  ``tests/test_torch_zoo.py``, for the SSM state under fault C-5's large
  dt);
* against JAX's jitted sharded decode step on forced host devices
  (``tests/_jax_decode_mesh.py``, one subprocess: the (2, 2) mesh for
  both cells and (4, 1) for ``long_500k``, where the sequence splits four
  ways; the port's (4, 1) ``decode_32k`` run, a batch split only, to
  JAX's (2, 2)): the logits within 1e-5, the cache within the zoo's
  decode bound (``tests/test_torch_zoo.py``'s DEC, 1e-4), widened the
  same way;
* the collectives of each call by kind, the same on every rank: one
  ``decode_max`` and one ``decode_sum`` per self-attention layer where
  the cache's sequence is split (none where it is not), the FSDP gathers
  (one per param leaf split over data, and per layer of a stacked leaf:
  each layer gathers its own; the encoder's, which decode never runs,
  none) and tensor-parallel sums of the forward, the SSM's norm sum and
  conv gather per layer where the model axis splits it, the experts'
  combine sum per MoE layer where it splits them, the head-split
  weights of an attention layer gathered over model where its kv heads
  are whole (``decode_head_gather``: the decode rules give the model axis
  to the cache's sequence), and nothing else: every all_gather is one of
  those (no gather of the cache), no all-to-all;
* the cache's layout (``cache_shardings``) and that every piece keeps its
  storage (written in place); reruns bit-equal; a whole cache refused;
* a planted fault in the split-softmax combine (a shard's partial
  dropped; each shard weighed at its own max, so a wholly masked slice
  weighs in) fails the one-device check.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.launch import steps as TS
from repro_torch.models import zoo as TZ

import _dist_ranks as R

NAMES = list(R.DECODE_CASES)
CELLS = list(R.DECODE_CELLS)
MESHES = [(2, 2), (4, 1)]
JAX_MESHES = {"decode_32k": [(2, 2)], "long_500k": [(2, 2), (4, 1)]}
FAULTS = [("drop", "stablelm_3b", "decode_32k"),
          ("local_max", "hymba_15b", "long_500k")]
ATOL = RTOL = 1e-5
DEC = 1e-4
BIG_LEAF, BIG_REL = 1e2, 1e-6
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_KINDS = ("global", "local", "hybrid", "dec_cross", "mla")


@pytest.fixture(scope="module")
def inputs():
    return {(n, c): R.decode_inputs(n, c) for n in NAMES for c in CELLS}


@pytest.fixture(scope="module")
def jax_proc(inputs, tmp_path_factory):
    """JAX's sharded decode steps, started first so that they run while
    the ranks do."""
    work = tmp_path_factory.mktemp("jaxdecode")
    d, cases = {}, []
    for (name, cell), (params_np, cache_np, tok) in inputs.items():
        key = f"{name}.{cell}"
        for k, v in flatten_with_path(params_np):
            d[f"{key}/params/{k}"] = v
        for k, v in flatten_with_path(cache_np):
            d[f"{key}/cache/{k}"] = v
        d[f"{key}/tokens"] = tok
        arch, over = R.DECODE_CASES[name]
        cases.append({"key": key, "arch": arch, "over": over, "cell": cell,
                      "seq": R.DECODE_CELLS[cell][1],
                      "pos": R.DECODE_POS[cell],
                      "meshes": JAX_MESHES[cell]})
    np.savez(work / "in.npz", **d)
    (work / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_ROOT, "tests", "_jax_decode_mesh.py"),
         str(work / "in.npz"), str(work / "cases.json"),
         str(work / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, work / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(inputs, jax_proc, tmp_path_factory):
    """Rank 0's results and every rank's counts."""
    work = tmp_path_factory.mktemp("decode_mesh")
    res = R.run_ranks("decode_group", 4, (2, 2), work, inputs=inputs,
                      shapes=MESHES, faults=FAULTS)
    out = dict(res[0])
    out["counts_by_rank"] = {k: [r[k]["counts"] for r in res]
                             for k in res[0] if isinstance(k, tuple)
                             and k[0] != "fault"}
    return out


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, path = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return np.load(path)


def _one_device(name, cell, params_np, cache_np, tok):
    model = TZ.build(R.decode_config(name))
    step = TS.build_decode_step(model)
    params = tree_map(torch.from_numpy, params_np)
    cache = tree_map(torch.from_numpy, cache_np)
    logits = []
    for t, pos in zip(tok, R._decode_positions(cell)):
        lg, cache = step(params, cache, torch.from_numpy(t), pos)
        logits.append(lg.numpy())
    return {"logits": logits,
            "cache": {k: v.numpy() for k, v in flatten_with_path(cache)}}


@pytest.fixture(scope="module")
def one_device(inputs):
    return {k: _one_device(*k, *v) for k, v in inputs.items()}


def _excess(got, want, atol=ATOL, rtol=RTOL):
    """How far ``got`` lies outside atol + rtol |want| (<= 0 inside; NaN
    counts as outside)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ex = np.abs(got - want) - (atol + rtol * np.abs(want))
    return float("inf") if np.isnan(ex).any() else float(ex.max())


def _widen(leaf):
    """1e-6 of a leaf's scale where that passes 1e2 (the SSM state under
    fault C-5's large dt carries f32 rounding of that size in its small
    elements too), else 0."""
    scale = float(np.abs(leaf).max())
    return BIG_REL * scale if scale > BIG_LEAF else 0.0


def one_device_rule(got, want):
    """Every call's logits within 1e-5 of the one-device step's."""
    return all(_excess(g, w) <= 0 for g, w in zip(got, want))


CASES = [(n, c, s) for n in NAMES for c in CELLS for s in MESHES]
IDS = [f"{n}-{c}-{s[0]}x{s[1]}" for n, c, s in CASES]


@pytest.mark.parametrize("name,cell,shape", CASES, ids=IDS)
def test_decode_matches_one_device(ranks, one_device, name, cell, shape):
    got, want = ranks[(shape, name, cell)], one_device[(name, cell)]
    assert one_device_rule(got["logits"], want["logits"])
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        assert _excess(got["cache"][k], w) <= _widen(w), (k, _excess(
            got["cache"][k], w), float(np.abs(w).max()))


@pytest.mark.parametrize("name,cell,shape", CASES, ids=IDS)
def test_decode_matches_jax(ranks, jax_out, name, cell, shape):
    got = ranks[(shape, name, cell)]
    js = shape if shape in JAX_MESHES[cell] else (2, 2)
    tag = f"{name}.{cell}/{js[0]}x{js[1]}"
    for i, lg in enumerate(got["logits"]):
        assert _excess(lg, jax_out[f"{tag}/logits{i}"]) <= 0, i
    for k, g in got["cache"].items():
        w = jax_out[f"{tag}/cache/{k}"]
        assert _excess(g, w, atol=DEC, rtol=DEC) <= _widen(w), k


def _layers(cfg):
    p = cfg.pattern
    return [p[i % len(p)] for i in range(cfg.n_layers)]


@pytest.mark.parametrize("name,cell,shape", CASES, ids=IDS)
def test_collectives_by_kind(ranks, name, cell, shape):
    data, model = shape
    cfg = R.decode_config(name)
    kinds = _layers(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_ssm = sum(k in ("ssm", "hybrid") for k in kinds)
    seq_ways = model if cell == "decode_32k" else data * model
    got = ranks[(shape, name, cell)]
    by_rank = ranks["counts_by_rank"][(shape, name, cell)]
    assert all(c == by_rank[0] for c in by_rank)
    n_fsdp, n_head = R.decode_gathers(got["param_specs"], cfg)
    for c in got["counts"]:
        allowed = {"fsdp_gather", "tp_exit_sum", "ssm_norm",
                   "ssm_conv_gather", "decode_max", "decode_sum",
                   "decode_head_gather", "moe_combine", "all_gather_calls",
                   "all_to_all_calls", "all_reduce_calls"}
        assert set(c) <= allowed, set(c) - allowed
        assert c.get("decode_max", 0) == c.get("decode_sum", 0) == (
            n_attn if seq_ways > 1 else 0)
        assert c.get("fsdp_gather", 0) == (n_fsdp if data > 1 else 0)
        assert c.get("decode_head_gather", 0) == (n_head if model > 1
                                                  else 0)
        assert c.get("ssm_conv_gather", 0) == c.get("ssm_norm", 0) == (
            n_ssm if model > 1 else 0)
        assert c.get("moe_combine", 0) == (cfg.n_layers if model > 1 and
                                           cfg.n_experts else 0)
        assert (c.get("tp_exit_sum", 0) > 0) == (model > 1)
        assert c["all_gather_calls"] == c.get("fsdp_gather", 0) + c.get(
            "ssm_conv_gather", 0) + c.get("decode_head_gather", 0)
        assert c["all_to_all_calls"] == 0
        assert c["all_reduce_calls"] == sum(c.get(k, 0) for k in (
            "tp_exit_sum", "ssm_norm", "decode_max", "decode_sum",
            "moe_combine"))


@pytest.mark.parametrize("cell", CELLS)
def test_cache_layout(ranks, cell):
    """The reference's decode rules laid out: k / v split over the batch
    (decode_32k) and the sequence ("model"; every axis at long_500k), the
    SSM state by heads over model, the conv tails whole, MLA's c / kr by
    sequence, the cross memory by heads."""
    seq = "model" if cell == "decode_32k" else ("data", "model")
    b = "data" if cell == "decode_32k" else None
    sp = ranks[((2, 2), "hymba_15b", cell)]["specs"]
    assert sp["blocks/p0_hybrid/k"] == (None, b, seq, None, None)
    assert sp["blocks/p0_hybrid/state"] == (None, b, "model", None, None)
    assert sp["blocks/p0_hybrid/conv_x"] == (None, b, None, None)
    sp = ranks[((2, 2), "deepseek_plain", cell)]["specs"]
    assert sp["blocks/p0_mla/c"] == (None, b, seq, None)
    sp = ranks[((2, 2), "whisper_small", cell)]["specs"]
    assert sp["blocks/p0_dec_cross/ck"] == (None, b, None, "model", None)


def test_reruns_bit_equal_in_place_and_whole_cache_refused(ranks):
    for key in ranks["counts_by_rank"]:
        assert ranks[key]["rerun_equal"] is True, key
        assert ranks[key]["in_place"] is True, key
    assert "cache_to_mesh" in ranks["whole_cache_refused"]


@pytest.mark.parametrize("kind,name,cell", FAULTS)
def test_planted_fault_fails(ranks, one_device, kind, name, cell):
    want = one_device[(name, cell)]["logits"]
    assert one_device_rule(ranks[((2, 2), name, cell)]["logits"], want)
    assert not one_device_rule(ranks[("fault", kind, name, cell)]["logits"],
                               want)
