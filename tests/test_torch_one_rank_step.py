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
  STEP_REL of the leaf's scale;
* the Adam moments (fault C-13): JAX's own (1, 1) sharded moments equal
  its one-device moments bit for bit (stablelm-3b, the arch of the leaf
  C-13 named; measured for gemma-7b and hymba-1.5b too), as the port's
  (1, 1) moments equal
  its one-device ones, so the distance between the two packages' mesh
  moments after two steps (up to 1e-3 of a leaf's scale) is the distance
  between their one-device steps. It comes from the first step's state:
  the second step run by the port's (1, 1) mesh step from JAX's state
  after its first step gives moments within MOMENT_REL of JAX's second
  ones, every leaf (measured 1.1e-4); a leaf halved fails that.
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
MOMENT_REL = 3e-4
C13 = "stablelm_3b@1"           # the case of fault C-13's leaf
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
    d[f"{C13}/one"] = np.asarray(True)     # its one-device step too
    np.savez(work / "in.npz", **d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "tests", "_jax_mesh_step.py"),
         str(work / "in.npz"), str(work / "out.npz"), "1", "1", "1",
         "full"], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    o = np.load(work / "out.npz")
    out = {}
    for name in CASES:
        pick = lambda pre: {k[len(name) + len(pre) + 2:]: o[k]
                            for k in o.files
                            if k.startswith(f"{name}/{pre}/")}
        out[name] = {"losses": list(o[f"{name}/losses"]),
                     "params": pick("params"), "mu": pick("mu"),
                     "one_mu": pick("one/mu"),
                     "state1": {w: pick(f"state1/{w}")
                                for w in ("params", "mu", "nu", "proj")},
                     "count1": int(o[f"{name}/state1/count"])}
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



def test_jax_mesh_moments_equal_its_one_device(jax_one_rank):
    """C-13's measurement: JAX's (1, 1) sharded moments after two steps
    are its one-device moments, bit for bit (stablelm-3b, the leaf's
    arch)."""
    ref = jax_one_rank[C13]
    assert ref["mu"].keys() == ref["one_mu"].keys() and ref["mu"]
    for k, w in ref["one_mu"].items():
        assert np.array_equal(ref["mu"][k], w), k


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for part in head:
            d = d.setdefault(part, {})
        d[last] = torch.from_numpy(np.array(v))
    return out


def _mesh_step_from(model, state, count, tok, labels):
    """The port's production step on a (1, 1) mesh (one rank of a fake
    process group: a one-rank mesh moves nothing) from a given state:
    its first moments, whole, as numpy."""
    from repro_torch.convert import params_to_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adam import AdamState
    acfg = AdamConfig(moment_dtype=torch.float32)
    rules = TS.rules_for_cell(model.cfg, "train_4k", False)
    with dryrun.fake_group(1):
        mesh = make_local_mesh(1, 1, device="cpu")
        specs = TS.param_shardings(model, mesh, rules)
        put = lambda w: params_to_mesh(_nest(state[w]), mesh, specs, "cpu")
        opt = AdamState(count=torch.tensor(count, dtype=torch.int32),
                        mu=put("mu"), nu=put("nu"))
        proj = {k: torch.from_numpy(np.array(v))
                for k, v in state["proj"].items()}
        batch = {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(labels).long()}
        _, _, _, opt, _ = TS.build_train_step(model, mesh, rules, acfg)(
            put("params"), opt, proj, batch)
        return {k: v.to_local().numpy().copy()
                for k, v in flatten_with_path(opt.mu)}


def _moments_rule(got, want):
    """Every leaf within MOMENT_REL of its scale."""
    return all(float(np.abs(got[k] - w).max())
               <= MOMENT_REL * max(float(np.abs(w).max()), 1e-30)
               for k, w in want.items())


def test_mesh_moments_from_jax_state_match_jax(inputs, jax_one_rank):
    """C-13: the second step of the port's (1, 1) mesh step, run from
    JAX's sharded state after its first, gives JAX's second moments
    within MOMENT_REL of each leaf's scale (stablelm-3b); a leaf halved
    (a gradient part lost) fails the rule."""
    model, _, tok, labels = inputs[C13]
    ref = jax_one_rank[C13]
    got = _mesh_step_from(model, ref["state1"], ref["count1"], tok, labels)
    assert got.keys() == ref["mu"].keys()
    assert _moments_rule(got, ref["mu"])
    leaf = max(got, key=lambda k: float(np.abs(ref["mu"][k]).max()))
    assert not _moments_rule(dict(got, **{leaf: 0.5 * got[leaf]}),
                             ref["mu"])
