"""The port's LM training path against ``repro.train`` / ``repro.models``.

* ``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
  JAX ``Model.loss`` on the JAX params carried across, for reduced
  stablelm-3b (global attention), mamba2-370m (SSD) and hymba-1.5b
  (hybrid); labels with ignored (-1) entries. Loss within 2e-5 (about 4
  f32 ulps of a loss near 4.9), each gradient leaf within 5e-4 of its
  largest entry (measured: 1.2e-4; the backward sums in another order in
  every layer, and SSD's gradient is the port's written-out backward,
  ``ssd_bwd_plain`` on the CPU, where JAX differentiates its scan).
* One ``build_accum_step`` step (1 and 2 microbatches, every_k 1 so the
  Newton projection runs) against the reference's: loss within 1e-6,
  Adam moments within 1e-4 of each leaf's scale, params within 3e-4 of
  each leaf's scale, the JAX suite's projection tolerance (Adam's first
  step is lr * g / (|g| + eps), which rounding moves for entries whose
  gradient is near its own rounding error; measured 2.2e-5), theta
  within 1e-5.
* The loop: crash-resume on the port alone (bit-equal on the CPU; the
  reference's test uses atol 1e-6), the theta state riding in the
  checkpoint, a checkpoint without ``proj`` leaves cold-starting, and the
  cross-package resume: JAX trains 3 steps and checkpoints, both packages
  resume from that directory to step 6; losses within 1e-4, params within
  3e-4 of each leaf's scale, as the step above.
* ``remat`` off, "full" and "dots": the same loss and gradients (bit-equal
  on the CPU); "dots" keeps the products' outputs alive from the forward to
  the backward, so more bytes than "full" and fewer than no remat.
* The step updates in place bit-equal to the functional update, and the
  host-side every_k gate gives the device gate's params and theta.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.core import ProjectionEngine as JEngine
from repro.data.pipeline import LMBatcher as JBatcher
from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.models import zoo as JZ
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as jax_adam_init
from repro.train import loop as JL
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path, leaves, tree_map
from repro_torch.checkpoint import restore, save
from repro_torch.convert import params_from_numpy
from repro_torch.core import ProjectionEngine
from repro_torch.data import LMBatcher, SyntheticLM
from repro_torch.models import zoo as TZ
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.train import TrainConfig, build_accum_step, train

LOSS_ATOL = 2e-5
GRAD_REL = 5e-4
STEP_REL = 3e-4


def _every(cfg, k):
    return dataclasses.replace(cfg, projection_specs=tuple(
        dataclasses.replace(s, every_k=k) for s in cfg.projection_specs))


def _np_tree(tree):
    return dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, tree)))


def _close_by_scale(got, want, rel, what):
    """Every leaf of ``got`` (torch) within rel * max|leaf| of ``want``."""
    want = dict(want)
    for k, t in flatten_with_path(got):
        w = want[k]
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(t.detach().numpy() - w).max())
        assert err <= tol, (what, k, err, tol)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(2, 49))
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1
    return tok[:, :-1], labels


@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_370m", "hymba_15b"])
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tok, labels = _batch(jcfg.vocab)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)})
    tp = tree_map(lambda x: x.requires_grad_(),
                  params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu"))
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(tok),
                            "labels": torch.from_numpy(labels)})
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    assert float(tmet["ce"]) == float(tl)
    _close_by_scale(tree_map(lambda p: p.grad, tp), _np_tree(jg), GRAD_REL,
                    "grad")


def test_loss_ignores_minus_one_labels():
    tcfg = TC.get_reduced("stablelm_3b")
    tm = TZ.build(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tok, labels = _batch(tcfg.vocab, seed=3)
    tok, labels = torch.from_numpy(tok), torch.from_numpy(labels)
    full, _ = tm.loss(tp, {"tokens": tok, "labels": labels})
    logits, _ = tm.forward(tp, {"tokens": tok})
    keep = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[keep], labels[keep])
    torch.testing.assert_close(full, want, atol=1e-6, rtol=1e-6)
    none, _ = tm.loss(tp, {"tokens": tok,
                           "labels": torch.full_like(labels, -1)})
    assert float(none) == 0.0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_accum_step_matches_reference(microbatches):
    jcfg = _every(JC.get_reduced("stablelm_3b"), 1)
    tcfg = _every(TC.get_reduced("stablelm_3b"), 1)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = JBatcher(JSynthetic(jcfg.vocab, seed=1), 4, 16).get(0)

    jacfg = JAdamConfig(lr=1e-3)
    jeng = JEngine(jcfg.projection_specs, solver="fused")
    jstep = JL.build_accum_step(
        jm, jacfg, JL.TrainConfig(microbatches=microbatches), engine=jeng)
    jn, jo, jproj, jl = jstep(jp, jax_adam_init(jp, jacfg),
                              jeng.init_state(jp),
                              jax.tree_util.tree_map(jnp.asarray, batch),
                              1e-3)

    acfg = AdamConfig(lr=1e-3)
    eng = ProjectionEngine(tcfg.projection_specs, solver="fused")
    step = build_accum_step(tm, acfg, TrainConfig(microbatches=microbatches),
                            engine=eng)
    tb = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}
    tn, to, tproj, tl = step(tp, adam_init(tp, acfg), eng.init_state(tp),
                             tb, 1e-3, count=1)
    assert abs(float(tl) - float(jl)) <= 1e-6
    assert int(to.count) == int(jo.count) == 1
    _close_by_scale(to.mu, _np_tree(jo.mu), 1e-4, "mu")
    _close_by_scale(to.nu, _np_tree(jo.nu), 1e-4, "nu")
    _close_by_scale(tn, _np_tree(jn), STEP_REL, "params")
    for key, theta in jproj.items():
        np.testing.assert_allclose(tproj[key].numpy(), np.asarray(theta),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("solver", ["fused", "kernel"])
def test_accum_step_projects_stacked_experts_like_reference(solver):
    """Reduced mixtral-8x7b: one projected step (every_k 1) against the
    reference's, at the bounds of the step above. Its spec puts the l1,inf
    ball on ``moe/w1``, a 4-D stacked expert leaf (cycles, E, d, d_ff):
    every (d, d_ff) slice is projected on its own, through the Newton
    (``"fused"``) or the l1,inf kernels' plain versions (``"kernel"``), and
    the loss carries the MoE auxiliaries."""
    jcfg = _every(JC.get_reduced("mixtral_8x7b"), 1)
    tcfg = _every(TC.get_reduced("mixtral_8x7b"), 1)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["blocks"]["p0_local"]["moe"]["w1"].ndim == 4
    batch = JBatcher(JSynthetic(jcfg.vocab, seed=1), 4, 16).get(0)
    jacfg = JAdamConfig(lr=1e-3)
    jeng = JEngine(jcfg.projection_specs, solver="fused")
    jstep = JL.build_accum_step(jm, jacfg, JL.TrainConfig(), engine=jeng)
    jn, jo, jproj, jl = jstep(jp, jax_adam_init(jp, jacfg),
                              jeng.init_state(jp),
                              jax.tree_util.tree_map(jnp.asarray, batch),
                              1e-3)
    acfg = AdamConfig(lr=1e-3)
    eng = ProjectionEngine(tcfg.projection_specs, solver=solver)
    step = build_accum_step(tm, acfg, TrainConfig(), engine=eng)
    tb = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}
    tn, to, tproj, tl = step(tp, adam_init(tp, acfg), eng.init_state(tp),
                             tb, 1e-3, count=1)
    assert abs(float(tl) - float(jl)) <= 1e-6
    _close_by_scale(to.mu, _np_tree(jo.mu), 1e-4, "mu")
    _close_by_scale(tn, _np_tree(jn), STEP_REL, "params")
    assert sorted(tproj) == sorted(jproj) and tproj
    for key, theta in jproj.items():
        np.testing.assert_allclose(tproj[key].numpy(), np.asarray(theta),
                                   atol=1e-5, rtol=1e-5)
    # the projection bit: every expert slice of w1 within the radius
    from repro_torch.core.l1inf import l1inf_norm
    radius = tcfg.projection_specs[0].radius
    w1 = tn["blocks"]["p0_local"]["moe"]["w1"]
    norms = [float(l1inf_norm(m, axis=0)) for m in w1.reshape(
        (-1,) + w1.shape[-2:])]
    assert max(norms) <= radius * (1 + 1e-5) and min(norms) > 0.5 * radius


@pytest.mark.parametrize("norm,solver", [("l1inf", "newton"),
                                         ("l12", "fused")])
def test_step_updates_in_place_bit_equal_to_functional(norm, solver):
    """The donated step: the unfused Adam update written into the
    caller's tensors (projected leaves, and the fused step's, come back
    new), every value bit-equal to the functional update + projection."""
    cfg = TC.get_reduced("stablelm_3b")
    cfg = dataclasses.replace(cfg, projection_specs=tuple(
        dataclasses.replace(s, every_k=1, norm=norm)
        for s in cfg.projection_specs))
    tm = TZ.build(cfg)
    p = tm.init(torch.Generator().manual_seed(0), device="cpu")
    acfg = AdamConfig(lr=1e-3)
    opt = adam_init(p, acfg)
    g = tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator()
                                       .manual_seed(x.numel())), p)
    eng = ProjectionEngine(cfg.projection_specs, solver=solver)
    fp, fo, fs = eng.projected_update(g, opt, p, acfg, state=None)
    before = dict(flatten_with_path(p))
    ip, io, is_ = eng.projected_update(g, opt, p, acfg, state=None,
                                       count=1, inplace=True)
    for a, b in zip(leaves(fp) + leaves(fo.mu) + leaves(fo.nu),
                    leaves(ip) + leaves(io.mu) + leaves(io.nu)):
        assert torch.equal(a, b)
    assert all(torch.equal(fs[k], is_[k]) for k in fs)
    if solver == "newton":   # the unprojected leaves are the caller's
        for path, leaf in flatten_with_path(ip):
            assert (leaf is before[path]) == (not path.endswith("mlp/w1"))
    q = tm.init(torch.Generator().manual_seed(1), device="cpu")
    new_q, new_opt = adam_update(g, adam_init(q, acfg), q, acfg,
                                 inplace=True)
    assert new_q is q and int(new_opt.count) == 1


@pytest.mark.parametrize("count", [1, 3])
def test_host_gate_equals_device_gate(count):
    """every_k 3: off its step a host-gated plan is not solved and keeps
    theta; on it, the projection equals the device-gated one."""
    cfg = _every(TC.get_reduced("stablelm_3b"), 3)
    p = TZ.build(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    eng = ProjectionEngine(cfg.projection_specs, solver="newton")
    theta0 = {k: v + 0.5 for k, v in eng.init_state(p).items()}
    dev_p, dev_s = eng.apply(p, step=torch.tensor(count), state=theta0)
    host_p, host_s = eng.apply(p, step=count, state=theta0)
    for a, b in zip(leaves(dev_p), leaves(host_p)):
        assert torch.equal(a, b)
    for k in dev_s:
        assert torch.equal(dev_s[k], host_s[k])


REMATS = {"none": dict(remat=False), "full": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}


def _remat_case(arch="stablelm_3b"):
    base = TC.get_reduced(arch)
    p = TZ.build(base).init(torch.Generator().manual_seed(0), device="cpu")
    tok, labels = _batch(base.vocab, seed=5)
    return base, p, {"tokens": torch.from_numpy(tok),
                     "labels": torch.from_numpy(labels)}


@pytest.mark.parametrize("arch", ["stablelm_3b", "hymba_15b"])
def test_remat_matches_no_remat(arch):
    """No remat, "full" and "dots": loss and every gradient bit-equal."""
    base, p, batch = _remat_case(arch)
    out = []
    for over in REMATS.values():
        m = TZ.build(dataclasses.replace(base, **over))
        q = tree_map(lambda x: x.detach().clone().requires_grad_(), p)
        loss, _ = m.loss(q, batch)
        loss.backward()
        out.append((loss.detach(), [x.grad for x in leaves(q)]))
    for loss, grads in out[1:]:
        assert torch.equal(out[0][0], loss)
        for a, b in zip(out[0][1], grads):
            assert torch.equal(a, b)


def _kept_bytes(model, params, batch):
    """Bytes of the storages that the forward's ops made and that are
    still alive when the loss is out: what the graph keeps for the
    backward (the checkpoint's saved products included, which saved-
    tensor hooks outside a checkpoint cannot see)."""
    import gc
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    made = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    s = t.untyped_storage()
                    made[s.data_ptr()] = (StorageWeakRef(s), s.nbytes())
            return out

    with Record():
        loss, _ = model.loss(params, batch)
    gc.collect()
    kept = sum(n for ref, n in made.values() if not ref.expired())
    del loss
    return kept


def test_remat_dots_keeps_the_products():
    """Alive between the forward and the backward: "dots" keeps more than
    "full" (the products' outputs) and less than no remat (everything)."""
    base, p, batch = _remat_case()
    kept = {}
    for name, over in REMATS.items():
        q = tree_map(lambda x: x.detach().clone().requires_grad_(), p)
        kept[name] = _kept_bytes(TZ.build(dataclasses.replace(base, **over)),
                                 q, batch)
    assert kept["full"] < kept["dots"] < kept["none"], kept


def _quiet(**kw):
    return dict(log_every=100, **kw)


def test_crash_resume_bitwise(tmp_path):
    """Train 6 steps; 'crash'; resume from the step-3 checkpoint: final
    params equal to an uninterrupted run (deterministic data, optimizer
    and, on the CPU, arithmetic)."""
    cfg = TC.get_reduced("mamba2_370m")
    model = TZ.build(cfg)
    batcher = LMBatcher(SyntheticLM(cfg.vocab, seed=1), 2, 16)
    full = train(model, batcher, TrainConfig(
        steps=6, ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
        with_projection=False, **_quiet()), resume=False, device="cpu")
    d2 = str(tmp_path / "b")
    train(model, batcher, TrainConfig(steps=3, ckpt_dir=d2, ckpt_every=3,
                                      with_projection=False, **_quiet()),
          resume=False, device="cpu")
    resumed = train(model, batcher, TrainConfig(
        steps=6, ckpt_dir=d2, ckpt_every=3, with_projection=False,
        **_quiet()), resume=True, device="cpu")
    assert len(resumed["losses"]) == 3
    assert resumed["losses"] == full["losses"][3:]
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_train_loop_checkpoints_theta_state(tmp_path):
    """A resume restores the projection theta state instead of silently
    cold-starting Newton."""
    cfg = _every(TC.get_reduced("stablelm_3b"), 1)
    model = TZ.build(cfg)
    batcher = LMBatcher(SyntheticLM(cfg.vocab, seed=1), 2, 16)
    ckpt_dir = str(tmp_path / "ck")
    tcfg = TrainConfig(steps=2, ckpt_every=100, ckpt_dir=ckpt_dir,
                       **_quiet())
    out1 = train(model, batcher, tcfg, resume=False, device="cpu")
    assert any(float(v.max()) > 0 for v in out1["proj_state"].values())
    flat, step = restore(ckpt_dir)
    assert step == 2
    assert any(k.startswith("proj/") for k in flat), sorted(flat)
    for k, v in out1["proj_state"].items():
        np.testing.assert_array_equal(flat[f"proj/{k}"], v.numpy())
    out2 = train(model, batcher, dataclasses.replace(tcfg, steps=4),
                 resume=True, device="cpu")
    assert len(out2["losses"]) == 2             # steps 2..3 only
    assert all(np.isfinite(l) for l in out2["losses"])
    assert len(out2["step_metrics"]) == 2
    assert out2["step_metrics"][-1]["step"] == 3.0


def test_train_loop_restores_pre_engine_checkpoint(tmp_path, capsys):
    """Checkpoints without the proj state restore (cold Newton start)."""
    cfg = TC.get_reduced("stablelm_3b")
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ckpt_dir = str(tmp_path / "old")
    save({"params": params, "opt": adam_init(params, AdamConfig(lr=3e-4))},
         ckpt_dir, 1)
    batcher = LMBatcher(SyntheticLM(cfg.vocab, seed=1), 2, 16)
    out = train(model, batcher, TrainConfig(steps=3, ckpt_dir=ckpt_dir,
                                            **_quiet()),
                resume=True, device="cpu")
    assert len(out["losses"]) == 2              # resumed from step 1
    assert all(np.isfinite(l) for l in out["losses"])
    assert "cold-starting Newton" in capsys.readouterr().out


def test_resume_from_jax_checkpoint_matches_reference(tmp_path):
    """JAX trains 3 steps and checkpoints; JAX and the port each resume
    from that directory to step 6 (every_k 2, so theta rides across)."""
    jcfg = _every(JC.get_reduced("stablelm_3b"), 2)
    tcfg = _every(TC.get_reduced("stablelm_3b"), 2)
    src = str(tmp_path / "jax")
    jb = JBatcher(JSynthetic(jcfg.vocab, seed=1), 2, 16)
    kw = dict(ckpt_every=100, log_every=100)
    JL.train(JZ.build(jcfg), jb, JL.TrainConfig(steps=3, ckpt_dir=src, **kw),
             resume=False)
    for name in ("a", "b"):
        os.makedirs(tmp_path / name)
        for entry in os.listdir(src):
            os.symlink(os.path.join(src, entry), tmp_path / name / entry)
    jout = JL.train(JZ.build(jcfg), jb, JL.TrainConfig(
        steps=6, ckpt_dir=str(tmp_path / "a"), **kw), resume=True)
    tout = train(TZ.build(tcfg), LMBatcher(SyntheticLM(tcfg.vocab, seed=1),
                                           2, 16),
                 TrainConfig(steps=6, ckpt_dir=str(tmp_path / "b"), **kw),
                 resume=True, device="cpu")
    assert len(tout["losses"]) == len(jout["losses"]) == 3
    np.testing.assert_allclose(tout["losses"], jout["losses"], atol=1e-4)
    _close_by_scale(tout["params"], _np_tree(jout["params"]), STEP_REL,
                    "params")
    for key, theta in jout["proj_state"].items():
        np.testing.assert_allclose(tout["proj_state"][key].numpy(),
                                   np.asarray(theta), atol=1e-4, rtol=1e-4)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The reverse direction: a port train state restores in the JAX
    package's ``restore_tree`` with the same leaves."""
    from repro.checkpoint import restore_tree as jax_restore_tree
    cfg = _every(TC.get_reduced("stablelm_3b"), 1)
    model = TZ.build(cfg)
    out = train(model, LMBatcher(SyntheticLM(cfg.vocab, seed=1), 2, 16),
                TrainConfig(steps=2, ckpt_dir=str(tmp_path), **_quiet()),
                resume=False, device="cpu")
    jm = JZ.build(_every(JC.get_reduced("stablelm_3b"), 1))
    jp = jm.init(jax.random.PRNGKey(0))
    template = {"params": jp, "opt": jax_adam_init(jp, JAdamConfig()),
                "proj": JEngine(jm.cfg.projection_specs).init_state(jp)}
    got, step = jax_restore_tree(template, str(tmp_path))
    assert step == 2 and int(got["opt"].count) == 2
    want = {"params": out["params"], "opt": out["opt_state"],
            "proj": out["proj_state"]}
    from repro.checkpoint.ckpt import _flatten as jax_flatten
    from repro_torch.checkpoint.ckpt import _flatten
    jflat = {k: np.asarray(v) for k, v in jax_flatten(got)}
    tflat = _flatten(want)
    assert sorted(jflat) == sorted(k for k, _ in tflat)
    for key, leaf in tflat:
        np.testing.assert_array_equal(jflat[key], leaf.numpy())


def test_train_refuses_unported_on_the_card():
    """Nothing refuses any more: SSD blocks train on the card
    (``tests/test_torch_kernels_flash.py`` holds reduced hymba-1.5b's and
    mamba2-370m's loss and gradients on the card to the CPU's) and the
    sharded loop is ported (``tests/test_torch_mesh_step.py``). So on a
    machine without CUDA ``train`` on the card, its default device, fails
    in ``resolve_device``, with or without a mesh, before any step, and
    never falls back to the CPU."""
    hymba = TZ.build(TC.get_reduced("hymba_15b"))
    batcher = LMBatcher(SyntheticLM(128, seed=1), 2, 16)
    if not torch.cuda.is_available():
        for mesh in (None, object()):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                train(hymba, batcher, TrainConfig(steps=1), mesh=mesh)
