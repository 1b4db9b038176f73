"""The mesh step on the reference's per-device layout where the port once
replicated a region over model: each region computes on the rank's share
(``repro_torch.models``) with the counted collectives of
``repro_torch.dist.sharding``, on spawned gloo groups on the CPU (one per
mesh for the module, ``tests/_dist_ranks.py``), f32, the reduced
configs' projection specs at every_k 1 so that every step projects:

* mixtral-8x7b on (1, 2): the query heads split and the kv heads whole
  (its overrides), each rank slicing the kv head of its query heads; the
  MoE's hidden units split over model (``expert_sharding="tp"``);
* deepseek-v2 on (1, 2): MLA by heads, the routed experts over model
  (``"ep"``) and the shared experts column / row parallel;
* llama-3.2-vision with one kv head (which does not divide the model
  axis: two ranks share it), cut to one global and one cross layer, on
  (1, 2): cross attention by heads;
* hymba-1.5b at d_model 48 and SSM head dim 32 (3 SSM heads, which do not
  divide the model axis: the inner width splits through a head) on (1, 2):
  the SSM's pieces gathered over model at use (``ssm_model_gather``).

Every case runs on a data axis of 1 (one gloo group of 2 ranks, one JAX
subprocess): there the MoE's routing, capacity and drops are the
one-device ones; the FSDP gathers beside the model axis are held on
(2, 2) by ``tests/test_torch_mesh_step.py`` and phase 18 of
``chip_smoke.py``.

Held, after two steps of ``build_train_step(model, mesh, rules)``, against
the port's one-device step and JAX's sharded step on the same mesh
(``tests/_jax_mesh_step.py`` on forced host devices): the losses
within ``tests/test_torch_mesh_step.py``'s atol / rtol 1e-5 of both; the
first moments and the params at that file's bounds (MOMENT_REL of each
leaf's scale; PARAM_ATOL + 1e-5 relative against the port's one-device
step, PARAM_ATOL + STEP_REL of the scale against JAX's), or, leaf by
leaf, within FLOOR_FACTOR times the step's own noise floor: the distance
of the one-device step from the same step on params x (1 + PERTURB N(0,
1)), ``chip_smoke.py``'s floor (against JAX: that, plus the distance
between the port's one-device step and JAX's sharded step). Where a
gradient element lies near Adam's eps (1e-8) its update takes any value
in [-lr, lr] under any reordering, and the next step's gradients move
with it: measured, mixtral's expert moments move 4.0e-4 of their scale
on the mesh, 2.2e-4 in JAX's own sharded step and 3.5e-3 between the two
packages' one-device steps; llama-vision's (at 5 layers), 3.5e-2, 2.2e-2
and 3.8e-2. A planted fault (a moment leaf halved, as a dropped sum over
model of two equal parts would leave it) fails the rule.

Also: the collectives by kind (each region's kind present; every
all_gather an FSDP gather or the SSM's model gather, none of a projected
leaf), reruns bit-equal, the prefill and two decode steps at the zoo's
forward tolerance (1e-5), and, on meta tensors (a fake group of 4 ranks),
the step's live gathered weights: one layer cycle's at the step's peak
and at most, not the model's (remat "full", 8 layers).
"""
import dataclasses
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.launch import steps as TS
from repro_torch.optim import AdamConfig, adam_init

import _dist_ranks as R

# name: (arch, config changes, mesh)
CASES = {
    "mixtral_8x7b": ("mixtral_8x7b", {}, (1, 2)),
    "deepseek_v2_236b": ("deepseek_v2_236b", {}, (1, 2)),
    "llama32_vision_90b": ("llama32_vision_90b", {
        "n_kv_heads": 1, "pattern": ("global", "cross"), "n_layers": 2},
        (1, 2)),
    "hymba_odd": ("hymba_15b", {"d_model": 48, "ssm_headdim": 32}, (1, 2)),
}
MESHES = sorted({m for _, _, m in CASES.values()})
ATOL = RTOL = 1e-5
STEP_REL = 3e-4
MOMENT_REL = 3e-4
PARAM_ATOL = 1e-4
PERTURB, FLOOR_FACTOR = 1e-6, 2.0          # chip_smoke.py's
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_name(name):
    arch, over, _ = CASES[name]
    return f"{arch}#{name}" if over else arch


@pytest.fixture(scope="module")
def inputs():
    return {n: R._step_inputs(arch, every_k=1, over=over)
            for n, (arch, over, _) in CASES.items()}


@pytest.fixture(scope="module")
def jax_procs(inputs, tmp_path_factory):
    """JAX's sharded steps, one subprocess a mesh, started first so that
    they run while the ranks do."""
    work = tmp_path_factory.mktemp("jax_tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    procs = {}
    for shape in MESHES:
        d = {}
        for name, (_, over, mesh) in CASES.items():
            if mesh != shape:
                continue
            model, params_np, tok, labels = inputs[name]
            key = _jax_name(name)
            for k, v in flatten_with_path(params_np):
                d[f"{key}/params/{k}"] = v
            d[f"{key}/tokens"], d[f"{key}/labels"] = tok, labels
            for k, v in R.extra_batch(model.cfg, tok).items():
                d[f"{key}/{k}"] = v
            if over:
                d[f"{key}/config"] = np.asarray(json.dumps(over))
        tag = f"{shape[0]}x{shape[1]}"
        np.savez(work / f"in{tag}.npz", **d)
        procs[shape] = (subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "tests", "_jax_mesh_step.py"),
             str(work / f"in{tag}.npz"), str(work / f"out{tag}.npz"),
             str(shape[0]), str(shape[1]), "1"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            work / f"out{tag}.npz")
    return procs


@pytest.fixture(scope="module")
def ranks(inputs, jax_procs, tmp_path_factory):
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}")
        cases = {n: (m.cfg, p, t, l) for n, (m, p, t, l) in inputs.items()
                 if CASES[n][2] == shape}
        res = R.run_ranks("mesh_cases", shape[0] * shape[1], shape, work,
                          inputs=cases)
        for r in res[1:]:
            for n in cases:
                assert r[n]["losses"] == res[0][n]["losses"]
        out.update(res[0])
    return out


@pytest.fixture(scope="module")
def jax_out(jax_procs):
    out = {}
    for shape, (proc, path) in jax_procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        o = np.load(path)
        for name, (_, _, mesh) in CASES.items():
            if mesh != shape:
                continue
            key = _jax_name(name)
            pick = lambda pre: {k[len(key) + len(pre) + 2:]: o[k]
                                for k in o.files
                                if k.startswith(f"{key}/{pre}/")}
            out[name] = {"losses": list(o[f"{key}/losses"]),
                         "params": pick("params")}
    return out


def _port_one_device(model, params_np, tok, labels, perturb=0.0):
    """Two one-device steps (from params x (1 + ``perturb`` N(0, 1))
    when given), one prefill and two decode steps."""
    acfg = AdamConfig(moment_dtype=torch.float32)
    g = np.random.default_rng(9)
    p = tree_map(lambda a: torch.from_numpy(
        (a * (1 + perturb * g.standard_normal(a.shape))).astype(a.dtype)
        if perturb else a.copy()), params_np)
    opt = adam_init(p, acfg)
    proj = TS.projection_engine_for(model.cfg, None).init_state(p)
    step = TS.build_train_step(model, None, None, acfg)
    extra = {k: torch.from_numpy(v)
             for k, v in R.extra_batch(model.cfg, tok).items()}
    batch = dict(extra, tokens=torch.from_numpy(tok).long(),
                 labels=torch.from_numpy(labels).long())
    losses = []
    for _ in range(2):
        loss, _, p, opt, proj = step(p, opt, proj, batch)
        losses.append(float(loss))
    start = tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    pre = TS.build_prefill_step(model)(start, dict(extra,
                                                   tokens=batch["tokens"]))
    dec = TS.build_decode_step(model)
    cache = model.init_cache(tok.shape[0], 8, dtype=torch.float32,
                             device="cpu")
    lg, cache = dec(start, cache, batch["tokens"][:, :1], 0)
    lg2, _ = dec(start, cache, batch["tokens"][:, 1:2], 1)
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in flatten_with_path(p)},
            "mu": {k: v.numpy() for k, v in flatten_with_path(opt.mu)},
            "prefill": pre.numpy(), "decode": [lg.numpy(), lg2.numpy()]}


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's one-device results, each with its noise floor
    (``floor``: the perturbed run's moments and params)."""
    out = {}
    for n, v in inputs.items():
        out[n] = _port_one_device(*v)
        out[n]["floor"] = _port_one_device(*v, perturb=PERTURB)
    return out


def _excess(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def _dist(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def noise_rule(got, want, bound, floor):
    """One leaf's ``got`` within ``bound`` of ``want``, or within
    FLOOR_FACTOR times ``floor``."""
    err = _dist(got, want)
    return err <= bound or err <= FLOOR_FACTOR * floor


def _floor(one, what, leaf):
    """The one-device step's noise floor on a leaf: its distance from the
    same step on perturbed params."""
    return _dist(one["floor"][what][leaf], one[what][leaf])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_one_device(ranks, one_device, name):
    got, want = ranks[name], one_device[name]
    assert _excess(got["losses"], want["losses"]) <= 0
    for k, w in want["mu"].items():
        bound = MOMENT_REL * max(float(np.abs(w).max()), 1e-30)
        assert noise_rule(got["mu"][k], w, bound, _floor(want, "mu", k)), k
    for k, w in want["params"].items():
        bound = PARAM_ATOL + 1e-5 * float(np.abs(w).max())
        assert noise_rule(got["params"][k], w, bound,
                          _floor(want, "params", k)), k


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_jax_sharded(ranks, one_device, jax_out, name):
    got, jax, one = ranks[name], jax_out[name], one_device[name]
    assert _excess(got["losses"], jax["losses"]) <= 0
    for k, w in jax["params"].items():
        bound = PARAM_ATOL + STEP_REL * float(np.abs(w).max())
        floor = _floor(one, "params", k) + _dist(
            one["params"][k], w) / FLOOR_FACTOR
        assert noise_rule(got["params"][k], w, bound, floor), k


def test_noise_rule_fails_a_planted_fault(ranks, one_device):
    """A moment leaf halved (a dropped sum over model of two equal parts)
    fails the rule; the true result passes it."""
    name, k = "mixtral_8x7b", "blocks/p0_local/moe/w1"
    got, want = ranks[name], one_device[name]
    bound = MOMENT_REL * float(np.abs(want["mu"][k]).max())
    floor = _floor(want, "mu", k)
    assert noise_rule(got["mu"][k], want["mu"][k], bound, floor)
    assert not noise_rule(0.5 * got["mu"][k], want["mu"][k], bound, floor)


# the kinds each case's regions add (a sum over model of the partial
# outputs or gradients, the experts' combine, the SSM's gather)
KINDS = {"mixtral_8x7b": {"tp_enter_grad_sum", "tp_exit_sum"},
         "deepseek_v2_236b": {"tp_enter_grad_sum", "tp_exit_sum",
                              "moe_combine"},
         "llama32_vision_90b": {"tp_enter_grad_sum", "tp_exit_sum"},
         "hymba_odd": {"ssm_model_gather", "tp_exit_sum"}}
# (leaf, its spec) of the region each case runs split over model
SPLIT = {"mixtral_8x7b": [("blocks/p0_local/moe/w1", (None, None, "data",
                                                       "model")),
                          ("blocks/p0_local/attn/wq", (None, "data", "model",
                                                       None)),
                          ("blocks/p0_local/attn/wk", (None, "data", None,
                                                       None))],
         "deepseek_v2_236b": [("blocks/p0_mla/moe/w1", (None, "model", "data",
                                                        None)),
                              ("blocks/p0_mla/mla/wk_b", (None, None,
                                                          "model", None)),
                              ("blocks/p0_mla/moe/shared/w2", (None, "model",
                                                               "data"))],
         "llama32_vision_90b": [("blocks/p1_cross/cross/wk", (None, "data",
                                                              "model", None)),
                                ("blocks/p0_global/attn/wk", (None, "data",
                                                              None, None))],
         "hymba_odd": [("blocks/p0_hybrid/ssm/wx", (None, "data", "model")),
                       ("blocks/p0_hybrid/ssm/A_log", (None, None))]}


@pytest.mark.parametrize("name", list(CASES))
def test_regions_split_and_collectives_by_kind(ranks, name):
    got = ranks[name]
    for leaf, spec in SPLIT[name]:
        assert got["specs"][leaf] == spec, (leaf, got["specs"][leaf])
    for c in got["counts"]:
        assert KINDS[name] <= set(c), KINDS[name] - set(c)
        # every all_gather is an FSDP gather or the SSM's gather over
        # model: none of a projected leaf, none in the update
        assert c["all_gather_calls"] == c.get("fsdp_gather", 0) + c.get(
            "ssm_model_gather", 0)
        assert "decode_head_gather" not in c


def test_reruns_bit_equal(ranks):
    for shape in MESHES:
        first = sorted(n for n in CASES if CASES[n][2] == shape)[0]
        assert ranks[first]["rerun_equal"] is True, first


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_one_device(ranks, one_device, name):
    got, want = ranks[name], one_device[name]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_gathered_weights_live_one_cycle_at_a_time(monkeypatch):
    """On meta tensors, rank 0 of a (2, 2) mesh over a fake group of 4:
    reduced stablelm-3b at 8 layers, remat "full", its train step at B 8 x
    S 64. Each gathered weight is tracked from its all_gather until its
    storage dies: the live gathered bytes at the step's peak, and at most,
    are at most one layer cycle's (the weights split over data, whole),
    while the step gathers the whole model's (and, under remat, again in
    the backward)."""
    from repro_torch.configs import get_reduced
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import zoo as TZ
    from repro_torch.roofline import counter as RC

    live = {"now": 0, "max": 0, "at_peak": 0, "total": 0}
    gather = SH._gather_dim

    def drop(nb):
        live["now"] -= nb

    def tracked(x, group, n, dim):
        out = gather(x, group, n, dim)
        nb = out.untyped_storage().nbytes()
        live["now"] += nb
        live["total"] += nb
        live["max"] = max(live["max"], live["now"])
        weakref.finalize(out.untyped_storage(), drop, nb)
        return out

    track = RC.Counter._track

    def track_peak(self, t):
        before = self.counts.peak_bytes
        track(self, t)
        if self.counts.peak_bytes > before:
            live["at_peak"] = live["now"]

    monkeypatch.setattr(SH, "_gather_dim", tracked)
    monkeypatch.setattr(RC.Counter, "_track", track_peak)
    monkeypatch.setitem(TZ.SHAPES, "train_4k",
                        dict(seq=64, batch=8, kind="train"))
    cfg = dataclasses.replace(get_reduced("stablelm_3b"), n_layers=8,
                              remat=True)
    model = TZ.build(cfg)
    with dryrun.fake_group(4):
        mesh = make_local_mesh(2, 2, device="cpu")
        specs = dict(flatten_with_path(TS.param_shardings(
            model, mesh, TS.rules_for_cell(cfg, "train_4k", False))))
        _, step, args = TS.cell_step(model, "train_4k", mesh, False,
                                     dtype=torch.float32)
        pieces = dict(flatten_with_path(args[0]))
        with RC.Counter(arguments=args):
            step(*args)
    # one cycle's weights split over data, whole (2 data ranks)
    cycle = sum(2 * p.to_local().numel() * 4 // cfg.n_layers
                for k, p in pieces.items()
                if k.startswith("blocks/") and "data" in specs[k])
    model_bytes = cycle * cfg.n_layers
    assert live["at_peak"] <= live["max"] <= cycle
    assert live["total"] >= 2 * model_bytes > 8 * live["max"]
