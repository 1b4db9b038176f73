"""The port's production steps (``repro_torch.launch``) against
``repro.launch``.

* Warm start: ``build_train_step`` on reduced stablelm-3b (every_k 1, so
  every step projects) as ``tests/test_engine.py::test_production_step_
  warm_start_steady_state`` runs the reference's: more than 2 extra Newton
  evaluations at step 1, at most 2 from step 4, read from the step's
  metrics.
* One step of ``build_train_step`` against the reference's jitted step on
  the same params and batch:
  - f32, at ``tests/test_torch_train.py``'s bounds (loss 1e-6, Adam
    moments 1e-4 and params 3e-4 of each leaf's scale, theta 1e-5), the
    extra evaluations equal;
  - bf16 params with f32 moments (``AdamConfig(moment_dtype=float32)``,
    the reference's production setting) on both routes of
    ``solver="fused"``: hymba's own spec (l1,inf, every_k 10: the Newton,
    off its step at step 1, so the port solves nothing there and the
    reference's gated solve keeps theta at 0) and an l1,2 spec at every_k
    1 on stablelm (the fused Adam+projection step, ``adam_colstats`` /
    ``adam_clip_apply``'s plain versions, with bf16 p and f32 moments).
    The loss within 1e-3 of JAX's, relative (measured 3.3e-5); params
    bf16 and moments f32; the moments equal to Adam's first moments of the
    port's own bf16 gradient of ``Model.loss`` (0.1 x clip x g, 0.001 x
    (clip x g)^2, within 1e-6 of the scale) and within BF16_MOMENT of each
    leaf's scale of JAX's (measured 0.23: bf16 gradients lie 10-45% from a
    float64 run in both packages, which ``tests/test_torch_flash_bf16.py``
    holds leaf by leaf); every param moved by at most lr plus half a bf16
    ulp, on both sides; the l1,2 theta within 1e-4 of JAX's, relative
    (measured 1.1e-6), the extra evaluations equal, and every projected
    slice within its ball.
* ``build_prefill_step`` and ``build_decode_step`` against the
  reference's (logits at the zoo's forward tolerance, the new cache).
* ``rules_for_cell`` equal to the reference's; ``lower_cell`` (the
  dry-run's trace of a cell on meta tensors) counting the reference's
  dot FLOPs within [0.5, 1.01]. The steps over a mesh are held in
  ``tests/test_torch_mesh_step.py``.
* ``launch/train.py``'s ``main`` on reduced stablelm-3b for 2 steps on
  ``--device cpu`` prints the reference's lines (numbers aside: the two
  packages draw their initial params from different generators).
"""
import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.data.pipeline import LMBatcher as JBatcher
from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.launch import steps as JS
from repro.models import zoo as JZ
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jax_adam_init
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path, leaves, tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.models import zoo as TZ
from repro_torch.optim import AdamConfig, adam_init

LOSS_ATOL = 1e-6
MOMENT_REL = 1e-4
STEP_REL = 3e-4
BF16_LOSS_REL = 1e-3
BF16_MOMENT = 0.5


def _every(cfg, k, norm=None):
    return dataclasses.replace(cfg, projection_specs=tuple(
        dataclasses.replace(s, every_k=k, **({"norm": norm} if norm else {}))
        for s in cfg.projection_specs))


def _np_tree(tree):
    return dict(flatten_with_path(jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), tree)))


def _t_tree(tree):
    return {k: v.detach().float().numpy() for k, v in flatten_with_path(tree)}


def _rel(got, want):
    """{leaf: max |got - want| / max |want|}."""
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
            for k, w in want.items()}


def _case(arch, every_k=1, norm=None, dtype=jnp.float32):
    jcfg = _every(JC.get_reduced(arch), every_k, norm)
    tcfg = _every(TC.get_reduced(arch), every_k, norm)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    if dtype == jnp.bfloat16:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = tree_map(lambda t: t.bfloat16(), tp)
    if dtype == jnp.float32:    # tests/test_torch_train.py's step batch
        batch = {k: np.asarray(v) for k, v in JBatcher(
            JSynthetic(jcfg.vocab, seed=1), 4, 16).get(0).items()}
    else:       # one where the reference's hymba gradient is finite (C-11)
        tok = np.random.default_rng(4).integers(0, jcfg.vocab, size=(2, 17))
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return jcfg, tcfg, jm, tm, jp, tp, batch


def _one_step(arch, every_k=1, norm=None, dtype=jnp.float32):
    jcfg, tcfg, jm, tm, jp, tp, batch = _case(arch, every_k, norm, dtype)
    jacfg = JAdamConfig(lr=1e-3, moment_dtype=jnp.float32)
    acfg = AdamConfig(lr=1e-3, moment_dtype=torch.float32)
    jproj = JS.projection_engine_for(jcfg, None).init_state(jp)
    jl, jmet, jn, jo, jpr = jax.jit(JS.build_train_step(
        jm, None, None, jacfg))(jp, jax_adam_init(jp, jacfg), jproj,
                                {k: jnp.asarray(v, jnp.int32)
                                 for k, v in batch.items()})
    start = tree_map(lambda t: t.clone(), tp)
    tproj = TS.projection_engine_for(tcfg, None).init_state(tp)
    tl, tmet, tn, to, tpr = TS.build_train_step(tm, None, None, acfg)(
        tp, adam_init(tp, acfg), tproj,
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return (jl, jmet, jn, jo, jpr), (tl, tmet, tn, to, tpr), (start, tm,
                                                              tcfg, batch)


def test_production_step_warm_start_steady_state():
    """As the reference's: cold at step 1 (more than 2 extra Newton
    evaluations), warm from step 4 (at most 2)."""
    cfg = _every(TC.get_reduced("stablelm_3b"), 1)
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = TZ.make_batch(cfg, 2, 16, generator=torch.Generator()
                          .manual_seed(0), device="cpu")
    acfg = AdamConfig(lr=1e-4)
    opt = adam_init(params, acfg)
    proj = TS.projection_engine_for(cfg, None).init_state(params)
    assert proj
    step = TS.build_train_step(model, None, None, acfg)
    extra = []
    for _ in range(6):
        loss, metrics, params, opt, proj = step(params, opt, proj, batch)
        extra.append(int(metrics["proj_newton_extra_evals"]))
        assert torch.isfinite(loss)
    assert extra[0] > 2, extra
    assert max(extra[3:]) <= 2, extra


def test_train_step_f32_matches_reference():
    (jl, jmet, jn, jo, jpr), (tl, tmet, tn, to, tpr), _ = _one_step(
        "stablelm_3b")
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert float(tmet["ce"]) == float(tl)
    assert int(tmet["proj_newton_extra_evals"]) == int(
        jmet["proj_newton_extra_evals"])
    assert int(to.count) == int(jo.count) == 1
    for name, got, want, rel in (("mu", to.mu, jo.mu, MOMENT_REL),
                                 ("nu", to.nu, jo.nu, MOMENT_REL),
                                 ("params", tn, jn, STEP_REL)):
        for leaf, err in _rel(_t_tree(got), _np_tree(want)).items():
            assert err <= rel, (name, leaf, err)
    assert sorted(tpr) == sorted(jpr) and tpr
    for key, theta in jpr.items():
        np.testing.assert_allclose(tpr[key].numpy(), np.asarray(theta),
                                   atol=1e-5, rtol=1e-5)


def _own_moments(model, start, batch, acfg_clip):
    """Adam's first moments from the port's own bf16 gradient of
    ``Model.loss`` at ``start``: (0.1 c g, 0.001 (c g)^2), c the clip."""
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(), start)
    loss, _ = model.loss(tp, {k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    loss.backward()
    g = {k: v.grad for k, v in flatten_with_path(tp)}
    norm = float(torch.sqrt(sum(torch.sum(x.float() ** 2)
                                for x in g.values())))
    c = min(1.0, acfg_clip / max(norm, 1e-12))
    cg = {k: (v.float() * c).bfloat16().float() for k, v in g.items()}
    return ({k: 0.1 * v for k, v in cg.items()},
            {k: 0.001 * v * v for k, v in cg.items()})


@pytest.mark.parametrize("arch,every_k,norm", [("hymba_15b", 10, None),
                                               ("stablelm_3b", 1, "l12")])
def test_train_step_bf16_matches_reference(arch, every_k, norm):
    (jl, jmet, jn, jo, jpr), (tl, tmet, tn, to, tpr), (start, tm, tcfg,
                                                       batch) = _one_step(
        arch, every_k, norm, jnp.bfloat16)
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_REL * abs(float(jl))
    assert all(t.dtype == torch.bfloat16 for t in leaves(tn))
    assert all(t.dtype == torch.float32 for t in leaves(to.mu) + leaves(to.nu))
    mu, nu = _own_moments(tm, start, batch, 1.0)
    for name, got, want, own in (("mu", to.mu, jo.mu, mu),
                                 ("nu", to.nu, jo.nu, nu)):
        got_np = _t_tree(got)
        for leaf, err in _rel(got_np, _np_tree(want)).items():
            assert err <= BF16_MOMENT, (name, leaf, err)
        for leaf, err in _rel(got_np, {k: v.numpy()
                                       for k, v in own.items()}).items():
            assert err <= 1e-6, (name, leaf, err)
    lr = 1e-3
    starts = _t_tree(start)
    projected = re.compile(tcfg.projection_specs[0].pattern)
    for side, tree in (("port", _t_tree(tn)), ("jax", _np_tree(jn))):
        for leaf, p in tree.items():
            if every_k == 1 and projected.search(leaf):
                continue        # projected: held to its ball below
            s0 = starts[leaf]
            moved = np.abs(p - s0) - 2.0 ** -8 * np.maximum(np.abs(p),
                                                          np.abs(s0))
            assert float(moved.max()) <= lr * (1 + 1e-3), (side, leaf)
    assert sorted(tpr) == sorted(jpr) and tpr
    if every_k > 1:     # off its step: the port solves nothing
        assert int(tmet["proj_newton_extra_evals"]) == 0
        for key, theta in jpr.items():
            assert not np.asarray(theta).any() and not tpr[key].any()
    else:
        assert int(tmet["proj_newton_extra_evals"]) == int(
            jmet["proj_newton_extra_evals"])
        for key, theta in jpr.items():
            np.testing.assert_allclose(tpr[key].numpy(), np.asarray(theta),
                                       rtol=1e-4)
        from repro_torch.core.norms import l12_norm
        spec = tcfg.projection_specs[0]
        for path, leaf in flatten_with_path(tn):
            if path.endswith("mlp/w1"):
                for sl in leaf.float().reshape((-1,) + leaf.shape[-2:]):
                    assert float(l12_norm(sl, axis=spec.axis)) <= (
                        spec.radius * (1 + 2 ** -7))


@pytest.mark.parametrize("arch", ["hymba_15b", "stablelm_3b"])
def test_prefill_and_decode_steps_match_reference(arch):
    """Last-token logits at the zoo's forward tolerance (2e-4); four
    decode steps' logits and every cache leaf at its decode tolerance
    (1e-4; reduced hymba's SSM state, which passes 1 in scale, at 1e-4 of
    its scale)."""
    jcfg, tcfg, jm, tm, jp, tp, _ = _case(arch)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, size=(2, 24))
    want = JS.build_prefill_step(jm, None, None)(
        jp, {"tokens": jnp.asarray(tokens)})
    got = TS.build_prefill_step(tm, None, None)(
        tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    jcache = jm.init_cache(2, 32, jnp.float32)
    tcache = tm.init_cache(2, 32, torch.float32, device="cpu")
    jstep = JS.build_decode_step(jm, None, None)
    tstep = TS.build_decode_step(tm, None, None)
    for t in range(4):
        tok = tokens[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), t)
        tl, new = tstep(tp, tcache, torch.from_numpy(tok), t)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for (path, got_leaf), want_leaf in zip(
            flatten_with_path(tcache), jax.tree_util.tree_leaves(jcache)):
        w = np.asarray(want_leaf)
        np.testing.assert_allclose(
            got_leaf.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=path)


@pytest.mark.parametrize("arch", ["stablelm_3b", "hymba_15b", "gemma_7b",
                                  "deepseek_v2_236b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_rules_for_cell_matches_reference(arch, shape):
    """The per-cell rules equal the reference's (decode moves the model
    axis onto the cache sequence; batch 1 takes every axis; the config's
    overrides last), single-pod and multi-pod."""
    for multi_pod in (False, True):
        assert TS.rules_for_cell(TC.get_reduced(arch), shape, multi_pod) \
            == JS.rules_for_cell(JC.get_reduced(arch), shape, multi_pod)


def test_lower_cell_matches_reference_dot_flops(monkeypatch):
    """``lower_cell`` traces reduced stablelm-3b's train, prefill and
    decode cells (B 2 x S 32, no mesh) on meta tensors and returns each
    step's kind and counts: aten dot FLOPs between 0.5x and 1.01x of the
    reference's ``parse_hlo`` of its cell compiled on a (1, 1) mesh
    (measured 0.88, 0.91 and 1.0: the reference's dots hold the attention
    products, which the port's flash kernels count as their operations,
    2 forward and 2 backward launches a train step), nothing allocated."""
    from repro.roofline.hlo_parse import parse_hlo
    for name, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                       ("decode_32k", "decode")):
        monkeypatch.setitem(TZ.SHAPES, name, dict(seq=32, batch=2,
                                                  kind=kind))
        monkeypatch.setitem(JZ.SHAPES, name, dict(seq=32, batch=2,
                                                  kind=kind))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    launches = {"train_4k": {"flash_attention_fwd": 2,
                             "flash_attention_bwd": 2},
                "prefill_32k": {"flash_attention_fwd": 2},
                "decode_32k": {}}
    for name, want_launches in launches.items():
        cell = JS.lower_cell(JZ.build(JC.get_reduced("stablelm_3b")), name,
                             mesh, False)
        want = parse_hlo(cell.compile().as_text()).dot_flops
        got = TS.lower_cell(TZ.build(TC.get_reduced("stablelm_3b")), name,
                            None, False)
        assert got.kind == cell.kind
        assert 0.5 <= got.counts.dot_flops / want <= 1.01, (name, want)
        assert got.counts.launches() == want_launches
        assert got.counts.peak_bytes > got.counts.argument_bytes > 0


def test_projection_engine_for_matches_jax_policy():
    """The engine policy beside the reference's: "fused" with no mesh or a
    one-rank mesh, "fused_sharded" holding the mesh on more ranks (a
    stand-in with ``size()`` here; tests/test_torch_dist_projection.py
    runs it on real 2- and 4-rank meshes)."""
    import types
    jcfg, cfg = JC.get_reduced("stablelm_3b"), TC.get_reduced("stablelm_3b")
    one = jax.make_mesh((1,), ("data",))
    for jmesh, n in ((None, None), (one, 1)):
        mesh = None if n is None else types.SimpleNamespace(size=lambda: n)
        assert TS.projection_engine_for(cfg, mesh).solver == \
            JS.projection_engine_for(jcfg, jmesh).solver == "fused"
    four = types.SimpleNamespace(size=lambda: 4)
    eng = TS.projection_engine_for(cfg, four)
    assert (eng.solver, eng.mesh) == ("fused_sharded", four)
    assert eng.specs == cfg.projection_specs
    assert TS.projection_engine_for(cfg, four, False).specs == ()


def _lines(text):
    """Printed lines with every number replaced by #."""
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)
            for line in text.strip().splitlines()]


def test_train_cli_prints_the_reference_lines(capsys, monkeypatch):
    """``launch/train.py``'s ``main`` on reduced stablelm-3b for 2 steps,
    the port on ``--device cpu``: the reference's lines (its ``main`` on
    the same flags), numbers aside, and the same parameter count."""
    from repro.launch import train as JT
    from repro_torch.launch import train as TT
    flags = ["--arch", "stablelm_3b", "--reduced", "--steps", "2",
             "--batch", "2", "--seq", "16", "--resume", "none"]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    JT.main()
    want = capsys.readouterr().out
    TT.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want), (got, want)
    assert got.splitlines()[0] == want.splitlines()[0]
