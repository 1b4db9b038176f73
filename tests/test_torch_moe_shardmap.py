"""Manual expert parallelism (``repro_torch.models.moe_shardmap``) on
spawned gloo rank groups on the CPU (``tests/_dist_ranks.py``), reduced
deepseek-v2 at capacity_factor 8.0 (no token drops), as the reference's
``tests/test_moe_and_serve.py::test_moe_shardmap_matches_gspmd``:

* on a (1, 2) data x model mesh: ``moe_impl="shardmap"`` (the experts
  split over model, each rank bucketing the tokens routed to its own, one
  sum over model) against ``"gspmd"`` on the same mesh (the reference's
  GSPMD layout, the experts split over model too: each rank runs its own
  experts on the one-device routing, one combine sum over model) within
  the reference's 2e-2, and against
  the port's one-device loss within 1e-5; every gradient leaf of the two
  impls within 1e-5 of its scale; JAX's one-device loss within 2e-2;
* on (2, 2) (data 2: each data rank routes its own rows, its capacity
  and auxiliary losses from them, as the reference's shard_map does):
  shardmap within the reference's 2e-2 of gspmd;
* on one device ``moe_apply_shardmap`` is ``moe_apply``, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import zoo as JZ
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.models import moe as MOE
from repro_torch.models import moe_shardmap as MS
from repro_torch.models import zoo as TZ

import _dist_ranks as R


@pytest.fixture(scope="module")
def case():
    model, params_np, tok, labels = R._step_inputs("deepseek_v2_236b")
    return dataclasses.replace(model.cfg, capacity_factor=8.0), params_np, \
        tok, labels


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, case):
    cfg, params_np, tok, labels = case
    out = {}
    for shape in ((1, 2), (2, 2)):
        work = tmp_path_factory.mktemp(f"moe{shape[0]}x{shape[1]}")
        res = R.run_ranks("moe_shardmap_loss", shape[0] * shape[1], shape,
                          work, model_cfg=cfg, params_np=params_np, tok=tok,
                          labels=labels)
        for r in res[1:]:
            assert r["shardmap"]["loss"] == res[0]["shardmap"]["loss"]
        out[shape] = res[0]
    return out


def _one_device_loss(cfg, params_np, tok, labels):
    model = TZ.build(cfg)
    loss, _ = model.loss(tree_map(torch.from_numpy, params_np),
                         {"tokens": torch.from_numpy(tok).long(),
                          "labels": torch.from_numpy(labels).long()})
    return float(loss)


def test_shardmap_matches_gspmd_and_one_device(ranks, case):
    cfg, params_np, tok, labels = case
    got = ranks[(1, 2)]
    sm, gs = got["shardmap"], got["gspmd"]
    assert sm["w1_spec"] == gs["w1_spec"] == (None, "model", "data", None)
    assert abs(sm["loss"] - gs["loss"]) < 2e-2
    one = _one_device_loss(cfg, params_np, tok, labels)
    assert abs(sm["loss"] - one) <= 1e-5 + 1e-5 * abs(one)
    for k, w in gs["grads"].items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(sm["grads"][k] - w).max()) <= 1e-5 * scale, k


def test_shardmap_collectives(ranks):
    """Per layer one combine sum over model and one stacked auxiliary sum;
    the gspmd impl one combine sum and no auxiliary sum (its routing and
    auxiliaries are the one-device ones, whole on every rank)."""
    sm, gs = ranks[(1, 2)]["shardmap"], ranks[(1, 2)]["gspmd"]
    n_moe = 2                    # reduced deepseek: two MoE layers
    assert sm["counts"]["moe_combine"] == n_moe
    assert sm["counts"]["moe_aux"] == n_moe
    assert gs["counts"]["moe_combine"] == n_moe
    assert "moe_aux" not in gs["counts"]


def test_shardmap_matches_jax(ranks, case):
    cfg, params_np, tok, labels = case
    jcfg = dataclasses.replace(JC.get_reduced("deepseek_v2_236b"),
                               capacity_factor=8.0)
    jm = JZ.build(jcfg)
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = dict(flatten_with_path(params_np))
    leaves = jax.tree_util.tree_leaves_with_path(tmpl)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tmpl),
        [jnp.asarray(flat["/".join(str(k.key) for k in p)])
         for p, _ in leaves])
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(tok, jnp.int32),
                         "labels": jnp.asarray(labels, jnp.int32)})
    assert abs(ranks[(1, 2)]["shardmap"]["loss"] - float(jl)) < 2e-2


def test_shardmap_on_a_data_and_model_mesh(ranks):
    got = ranks[(2, 2)]
    assert abs(got["shardmap"]["loss"] - got["gspmd"]["loss"]) < 2e-2


def test_one_device_falls_back_to_moe_apply(case):
    cfg, params_np, _, _ = case
    moe = tree_map(torch.from_numpy,
                   params_np["blocks"][next(iter(params_np["blocks"]))]["moe"])
    layer0 = tree_map(lambda t: t[0], moe)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_kind)
    y, aux = MS.moe_apply_shardmap(layer0, x, **kw)
    y0, aux0 = MOE.moe_apply(layer0, x, **kw)
    assert torch.equal(y, y0)
    assert all(torch.equal(aux[k], aux0[k]) for k in aux0)
