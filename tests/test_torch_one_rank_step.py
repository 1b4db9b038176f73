"""The production train step on a one-rank mesh: (1, 1) over ("data",
"model"), one spawned gloo rank (``tests/_dist_ranks.py``). There the
engine is the one-device one (``projection_engine_for``), so the step
runs it on the ``DTensor`` pieces and wraps params, mu and nu back as
their inputs (``launch/steps.py::_one_rank_update``).

Reduced stablelm-3b and hymba-1.5b, f32, two steps of
``build_train_step(model, mesh, rules)`` from the same params and batch:
at every_k 1 both steps project (``solver="fused"``); at every_k 2 step 1
is off the gate and step 2 fires it (the gated Newton).

Held:

* against the port's one-device step (``build_train_step(model)``): the
  losses, the optimizer counts, every param, both Adam moments and the
  projection's theta state, bit for bit (one rank reduces nothing, so the
  sums run in the same order); every returned param, mu and nu leaf a
  ``DTensor`` with its input's placements and shape;
* the every_k gate: theta solved at both steps at every_k 1, at step 2
  only at every_k 2;
* against JAX's sharded step on a (1, 1) mesh of one host device
  (``tests/_jax_mesh_step.py`` in a subprocess), at the bounds
  ``tests/test_torch_mesh_step.py`` holds a mesh step to JAX's: the
  losses within atol / rtol 1e-5, every param within PARAM_ATOL +
  STEP_REL of the leaf's scale.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.launch import steps as TS
from repro_torch.optim import AdamConfig, adam_init

import _dist_ranks as R

CASES = {f"{arch}@{k}": (arch, k) for arch in ("hymba_15b", "stablelm_3b")
         for k in (1, 2)}
ATOL = RTOL = 1e-5
STEP_REL = 3e-4
PARAM_ATOL = 1e-4
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs():
    return {name: R._step_inputs(arch, every_k=k)
            for name, (arch, k) in CASES.items()}


@pytest.fixture(scope="module")
def one_rank(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("one_rank")
    cases = {n: (m.cfg, p, t, l) for n, (m, p, t, l) in inputs.items()}
    return R.run_ranks("one_rank_steps", 1, (1, 1), work, inputs=cases)[0]


def _one_device(model, params_np, tok, labels):
    acfg = AdamConfig(moment_dtype=torch.float32)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    opt = adam_init(p, acfg)
    proj = TS.projection_engine_for(model.cfg, None).init_state(p)
    step = TS.build_train_step(model, None, None, acfg)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(labels).long()}
    losses, counts = [], []
    for _ in range(2):
        loss, _, p, opt, proj = step(p, opt, proj, batch)
        losses.append(float(loss))
        counts.append(int(opt.count))
    np_of = lambda t: {k: v.numpy().copy() for k, v in flatten_with_path(t)}
    return {"losses": losses, "counts": counts, "params": np_of(p),
            "mu": np_of(opt.mu), "nu": np_of(opt.nu), "proj": np_of(proj)}


@pytest.fixture(scope="module")
def jax_one_rank(inputs, tmp_path_factory):
    """JAX's sharded step on a (1, 1) mesh of one host device."""
    work = tmp_path_factory.mktemp("jax_one_rank")
    d = {}
    for name, (_, params_np, tok, labels) in inputs.items():
        for k, v in flatten_with_path(params_np):
            d[f"{name}/params/{k}"] = v
        d[f"{name}/tokens"], d[f"{name}/labels"] = tok, labels
    np.savez(work / "in.npz", **d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "tests", "_jax_mesh_step.py"),
         str(work / "in.npz"), str(work / "out.npz"), "1", "1", "1"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    o = np.load(work / "out.npz")
    out = {}
    for name in CASES:
        pre = f"{name}/params/"
        out[name] = {"losses": list(o[f"{name}/losses"]),
                     "params": {k[len(pre):]: o[k] for k in o.files
                                if k.startswith(pre)}}
    return out


@pytest.mark.parametrize("name", CASES)
def test_one_rank_step_bit_equal_to_one_device(one_rank, inputs, name):
    got, want = one_rank[name], _one_device(*inputs[name])
    assert got["laid_out"] == [True, True]
    assert got["counts"] == want["counts"] == [1, 2]
    assert got["losses"] == want["losses"]
    got = dict(got, proj=got["thetas"][-1])
    for what in ("params", "mu", "nu", "proj"):
        assert got[what].keys() == want[what].keys()
        for k, w in want[what].items():
            assert np.array_equal(got[what][k], w), (name, what, k)


@pytest.mark.parametrize("name", CASES)
def test_one_rank_step_gate(one_rank, name):
    """The projection's theta after each step: at every_k 1 both steps
    solve (theta > 0 in every segment); at every_k 2 step 1 keeps the
    initial 0 and step 2 solves."""
    fired = [all((v > 0).all() for v in t.values())
             for t in one_rank[name]["thetas"]]
    idle = [all((v == 0).all() for v in t.values())
            for t in one_rank[name]["thetas"]]
    k = CASES[name][1]
    assert fired == ([True, True] if k == 1 else [False, True])
    assert idle == ([False, False] if k == 1 else [True, False])


@pytest.mark.parametrize("name", CASES)
def test_one_rank_step_matches_jax_one_rank_mesh(one_rank, jax_one_rank,
                                                 name):
    got, ref = one_rank[name], jax_one_rank[name]
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=ATOL,
                               rtol=RTOL)
    assert ref["params"].keys() == got["params"].keys()
    for k, w in ref["params"].items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got["params"][k] - w).max())
        assert err <= PARAM_ATOL + STEP_REL * scale, (name, k, err)

