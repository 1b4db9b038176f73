"""The sharded production step (``repro_torch.launch.steps`` and
``repro_torch.train.loop`` with a mesh) on spawned gloo rank groups on the
CPU: meshes (2, 1), (1, 2) and (2, 2) over ("data", "model"), one group
per mesh for the whole module (``tests/_dist_ranks.py``), reduced
stablelm-3b, hymba-1.5b and gemma-7b (the reference's own cases,
``tests/test_multidevice.py:33-89``), f32, their projection specs at
every_k 1 so that every step projects (``fused_sharded``).

Held, after two steps of ``build_train_step(model, mesh, rules)``:

* against the port's one-device step: the losses within atol 1e-5 /
  rtol 1e-5; the Adam first moments (linear in the gradients) within
  MOMENT_REL = 3e-4 of each leaf's scale (measured 1.1e-4: the tensor-
  parallel sums reorder gradients that cancel, as the two packages'
  one-device steps do, which ``tests/test_torch_launch.py`` holds at
  1e-4); every param within PARAM_ATOL = 1e-4 plus 1e-5 relative, a tenth
  of one Adam step at lr 1e-3 (measured 6.4e-5 on one element of 4096):
  where a gradient is near Adam's eps (1e-8) the update's derivative in
  it is lr / eps = 1e5, so a 1e-10 change of a cancelling sum moves that
  element by a fraction of a step (the reference's own sharded test,
  ``tests/test_multidevice.py:33-89``, allows 5e-2);
* against JAX's one-device step and, on (2, 2), JAX's own sharded step (a
  subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  on ``jax.make_mesh(..., axis_types=Auto)``, ``tests/_jax_mesh_step.py``):
  the losses within atol / rtol 1e-5, or, where JAX's sharded loss is
  farther from its one-device loss, within JAX's own distance
  (``mesh_rule``, ``ORACLE_RULE``'s pattern, and
  ``test_mesh_rule_fails_a_planted_fault``); every param within
  PARAM_ATOL plus STEP_REL = 3e-4 of the leaf's scale
  (``tests/test_torch_launch.py``'s port-vs-JAX step bound);
* the collectives by kind, equal in both steps: FSDP gathers (and their
  gradient reduces) only with a data axis, tensor-parallel sums only with
  a model axis; every ``all_gather`` is an FSDP gather (none of a
  projected leaf); per step the projection's all-reduces are one (3, G)
  SUM, one (2, G) SUM per Newton evaluation and one (G,) MAX;
* reruns bit-equal (losses and every piece); remat "full" on reduced
  stablelm-3b as without it;
* one prefill step (last-token logits) and two decode steps over the mesh
  against the one-device steps at the zoo's forward tolerance (1e-5);
* two steps of ``train(mesh=)`` against the one-device ``train()``, and
  its checkpoint restored by the one-device port and by JAX: the leaves
  the mesh run ended with, bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.checkpoint import restore_tree as jax_restore_tree
from repro.launch import steps as JS
from repro.models import zoo as JZ
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jax_adam_init
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.checkpoint import restore_tree
from repro_torch.launch import steps as TS
from repro_torch.optim import AdamConfig, adam_init
from repro_torch.train import train

import _dist_ranks as R

MESHES = [(2, 1), (1, 2), (2, 2)]
ARCHS = ["gemma_7b", "hymba_15b", "stablelm_3b"]
EVERY_K = 1
ATOL = RTOL = 1e-5
STEP_REL = 3e-4
MOMENT_REL = 3e-4
PARAM_ATOL = 1e-4
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs():
    return {a: R._step_inputs(a, every_k=EVERY_K) for a in ARCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """Every mesh's results from rank 0 (the others return the same
    losses; rank 0 holds the whole leaves)."""
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
        cases = {a: (m.cfg, p, t, l) for a, (m, p, t, l) in inputs.items()}
        m, p, t, l = inputs["stablelm_3b"]
        cases["stablelm_3b_remat"] = (dataclasses.replace(m.cfg, remat=True),
                                      p, t, l)
        res = R.run_ranks(
            "mesh_cases", shape[0] * shape[1], shape, work, inputs=cases,
            train_dir=str(work / "ckpt") if shape == (2, 2) else None)
        for r in res[1:]:
            for a in ARCHS:
                assert r[a]["losses"] == res[0][a]["losses"]
        out[shape] = res[0]
        if shape == (2, 2):
            out["ckpt"] = str(work / "ckpt")
    return out


def _port_one_device(model, params_np, tok, labels):
    acfg = AdamConfig(moment_dtype=torch.float32)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    opt = adam_init(p, acfg)
    proj = TS.projection_engine_for(model.cfg, None).init_state(p)
    step = TS.build_train_step(model, None, None, acfg)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(labels).long()}
    losses = []
    for _ in range(2):
        loss, _, p, opt, proj = step(p, opt, proj, batch)
        losses.append(float(loss))
    start = tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    pre = TS.build_prefill_step(model)(start, {"tokens": batch["tokens"]})
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
    return {a: _port_one_device(*v) for a, v in inputs.items()}


def _jax_cfg(arch):
    cfg = JC.get_reduced(arch)
    return dataclasses.replace(cfg, projection_specs=tuple(
        dataclasses.replace(s, every_k=EVERY_K)
        for s in cfg.projection_specs))


def _jax_tree(flat, template):
    leaves = jax.tree_util.tree_leaves_with_path(template)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(flat["/".join(str(k.key) for k in p)])
         for p, _ in leaves])


@pytest.fixture(scope="module")
def jax_one(inputs):
    """JAX's one-device production step, two steps from the same params."""
    out = {}
    for arch, (_, params_np, tok, labels) in inputs.items():
        cfg = _jax_cfg(arch)
        m = JZ.build(cfg)
        params = _jax_tree(dict(flatten_with_path(params_np)),
                           jax.eval_shape(m.init, jax.random.PRNGKey(0)))
        acfg = JAdamConfig(moment_dtype=jnp.float32)
        opt = jax_adam_init(params, acfg)
        proj = JS.projection_engine_for(cfg, None).init_state(params)
        step = jax.jit(JS.build_train_step(m, None, JS.rules_for_cell(
            cfg, "train_4k", False), acfg))
        batch = {"tokens": jnp.asarray(tok, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32)}
        losses = []
        for _ in range(2):
            loss, _, params, opt, proj = step(params, opt, proj, batch)
            losses.append(float(loss))
        out[arch] = {"losses": losses, "params": {
            "/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}}
    return out


@pytest.fixture(scope="module")
def jax_sharded(inputs, tmp_path_factory):
    """JAX's sharded step on a (2, 2) mesh of 4 host devices."""
    work = tmp_path_factory.mktemp("jaxmesh")
    d = {}
    for arch, (_, params_np, tok, labels) in inputs.items():
        for k, v in flatten_with_path(params_np):
            d[f"{arch}/params/{k}"] = v
        d[f"{arch}/tokens"], d[f"{arch}/labels"] = tok, labels
    np.savez(work / "in.npz", **d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "tests", "_jax_mesh_step.py"),
         str(work / "in.npz"), str(work / "out.npz"), "2", "2",
         str(EVERY_K)], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    o = np.load(work / "out.npz")
    return {a: {"losses": list(o[f"{a}/losses"]),
                "params": {k[len(a) + 8:]: o[k] for k in o.files
                           if k.startswith(f"{a}/params/")}}
            for a in ARCHS}


def _excess(got, want, atol=ATOL, rtol=RTOL):
    """How far ``got`` lies outside atol + rtol |want| (<= 0 inside)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def mesh_rule(got, want, jax_sharded=None, jax_one=None):
    """The port's mesh result within atol/rtol 1e-5 of ``want``, or, where
    JAX's own sharded result lies farther from its one-device one, within
    that distance (``ORACLE_RULE``'s pattern)."""
    floor = 0.0
    if jax_sharded is not None:
        floor = float(np.max(np.abs(np.asarray(jax_sharded, np.float64)
                                    - np.asarray(jax_one, np.float64))))
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    return _excess(got, want) <= 0 or err <= floor


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_matches_one_device(ranks, one_device, shape, arch):
    """The losses, the first moments and every param of the port's mesh
    step against its one-device step."""
    got, want = ranks[shape][arch], one_device[arch]
    assert _excess(got["losses"], want["losses"]) <= 0
    for k, w in want["mu"].items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got["mu"][k] - w).max()) <= MOMENT_REL * scale, (
            shape, arch, k)
    for k, w in want["params"].items():
        assert _excess(got["params"][k], w, atol=PARAM_ATOL) <= 0, (
            shape, arch, k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_matches_jax(ranks, jax_one, jax_sharded, shape, arch):
    """The loss against JAX's one-device loss (and on (2, 2) its sharded
    loss) under ``mesh_rule``; every param within STEP_REL of each leaf's
    scale of JAX's one-device and sharded params."""
    got, one = ranks[shape][arch], jax_one[arch]
    sharded = jax_sharded[arch]
    assert mesh_rule(got["losses"], one["losses"], sharded["losses"],
                     one["losses"])
    if shape == (2, 2):
        assert mesh_rule(got["losses"], sharded["losses"],
                         sharded["losses"], one["losses"])
    for ref in (one, sharded):
        for k, w in ref["params"].items():
            scale = float(np.abs(w).max())
            err = float(np.abs(got["params"][k] - w).max())
            assert err <= PARAM_ATOL + STEP_REL * scale, (shape, arch, k,
                                                          err)


def test_mesh_rule_fails_a_planted_fault(ranks, jax_one, jax_sharded):
    """A loss moved by 1e-3 (a dropped tensor-parallel sum moves it by
    far more) fails ``mesh_rule``; the true result passes it."""
    got = ranks[(2, 2)]["stablelm_3b"]["losses"]
    one, sh = (jax_one["stablelm_3b"]["losses"],
               jax_sharded["stablelm_3b"]["losses"])
    assert mesh_rule(got, one, sh, one)
    assert not mesh_rule([x + 1e-3 for x in got], one, sh, one)


def _projection_reduces(shapes, G):
    return [s for s in shapes if s in (((3, G), "SUM"), ((2, G), "SUM"),
                                       ((G,), "MAX"))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_collectives_by_kind(ranks, shape, arch):
    data, model = shape
    c0, c1 = ranks[shape][arch]["counts"]
    evals = ranks[shape][arch]["evals"]
    assert {k: v for k, v in c0.items() if k != "all_reduce_shapes"} == {
        k: v for k, v in c1.items() if k != "all_reduce_shapes"}
    for c, extra in zip((c0, c1), evals):
        kinds = set(c) - {"all_reduce_shapes", "all_gather_calls"}
        fsdp = {"fsdp_gather", "fsdp_grad_reduce", "dp_grad_sum",
                "dp_count", "dp_loss"}
        tp = {"tp_enter_grad_sum", "tp_exit_sum", "ce_max", "ce_stats"}
        assert (fsdp <= kinds) == (data > 1) and not (data == 1 and
                                                       kinds & fsdp)
        assert (tp <= kinds) == (model > 1) and not (model == 1 and
                                                      kinds & tp)
        assert c["fsdp_gather"] == c["fsdp_grad_reduce"] if data > 1 else \
            True
        # every all_gather is an FSDP weight gather: none of a projected
        # leaf, none in the update
        assert c["all_gather_calls"] == c.get("fsdp_gather", 0)
        # one plan, G segments: (3, G), then (2, G) per Newton evaluation
        # (extra + 2 of them), then (G,) MAX
        G = {"gemma_7b": 2, "hymba_15b": 4, "stablelm_3b": 2}[arch]
        proj = _projection_reduces([(tuple(s), op) for s, op in
                                    c["all_reduce_shapes"]], G)
        assert proj == ([((3, G), "SUM")] + [((2, G), "SUM")] * (extra + 2)
                        + [((G,), "MAX")]), (shape, arch, proj)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_with_remat_matches_one_device(ranks, one_device, shape):
    """Remat "full" around each layer cycle (its recompute re-enters the
    forward's mesh rules, so its tensor-parallel sums run again): the
    losses and params as without remat, within the same bounds."""
    got, want = ranks[shape]["stablelm_3b_remat"], one_device["stablelm_3b"]
    assert _excess(got["losses"], want["losses"]) <= 0
    for k, w in want["params"].items():
        assert _excess(got["params"][k], w, atol=PARAM_ATOL) <= 0, k


def test_reruns_bit_equal(ranks):
    for shape in MESHES:
        assert ranks[shape][ARCHS[0]]["rerun_equal"] is True


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_and_decode_match_one_device(ranks, one_device, shape, arch):
    got, want = ranks[shape][arch], one_device[arch]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_train_over_the_mesh_and_its_checkpoint(ranks, tmp_path):
    """Two steps of ``train(mesh=)`` on (2, 2) against ``train()`` on one
    device (same seed, same batches): losses and params within 1e-5. Its
    checkpoint holds the full leaves: restored by the one-device port and
    by JAX, they are the mesh run's final params bit for bit."""
    got = ranks[(2, 2)]["train"]
    model, batcher, tcfg = R.train_loop_config(str(tmp_path / "one"))
    one = train(model, batcher, tcfg, resume=False, device="cpu")
    assert _excess(got["losses"], one["losses"]) <= 0
    for k, v in flatten_with_path(one["params"]):
        assert _excess(got["params"][k], v.numpy(), atol=PARAM_ATOL) <= 0, k
    ckpt = ranks["ckpt"]
    template = {"params": tree_map(torch.zeros_like, one["params"]),
                "opt": one["opt_state"], "proj": one["proj_state"]}
    state, step = restore_tree(template, ckpt)
    assert step == 2
    for k, v in flatten_with_path(state["params"]):
        assert np.array_equal(v.numpy(), got["params"][k]), k
    jcfg = JC.get_reduced("stablelm_3b")
    jm = JZ.build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jstate, jstep = jax_restore_tree({"params": jparams}, ckpt)
    assert jstep == 2
    for p, v in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        k = "/".join(str(e.key) for e in p)
        assert np.array_equal(np.asarray(v), got["params"][k]), k
