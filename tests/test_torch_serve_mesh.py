"""Serving over a mesh: ``repro_torch.sae.serve.make_serve_step(compact,
mesh=)``, ``repro_torch.train.serve.BatchServer(mesh=)`` and
``repro_torch.serve.engine.FleetEngine(mesh=)``, on one spawned gloo group
of 4 ranks on the CPU (``tests/_dist_ranks.py``) that builds the (2, 2)
(data, model) mesh, the batch split 2 ways, and the (4, 1) mesh, split 4
ways, over the same ranks.

The reference's cases (``tests/test_multidevice.py:690-790``), run by JAX
in one subprocess on an (8,) mesh of forced host devices
(``tests/_jax_serve_mesh.py``):

* the compacted SAE (512 features, 32 hidden, l1,inf radius 0.2 on the
  feature axis) served on a (64, 512) batch: z and xhat_sel equal to
  JAX's sharded step and to the port's one-device step within atol 1e-5
  (the reference's), the rank holding its B / D rows;
* ``BatchServer`` serving the compacted reduced gemma-7b (2 layers, dead
  w1 / w2 columns): tokens equal to JAX's mesh and one-device servers and
  to the port's one-device server.

And the port's own: a dense reduced hymba-1.5b ``BatchServer`` with more
prompts than slots (its SSM state and conv tails zeroed at admission, on
each rank's rows), and a compact engine through refresh, cancel (one
request in flight, one queued) and recompact mid-flight: every
completion equal to the one-device engine's under the same calls, one
build (``n_traces``) each.

Collectives: none inside any step (the step's calls counted), and
exactly one ``engine_out_gather`` a step outside it; the SAE step none at
all. Refusals: rules that map "batch" to None, and a batch the ranks do
not divide, raise ``ValueError`` as the reference does.
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
from repro.core import ProjectionSpec as JSpec
from repro.core import apply_constraints as japply
from repro.models import zoo as JZ
from repro.sae import SAEConfig, sae_init
from repro_torch._tree import flatten_with_path, tree_map
from repro_torch.core import ProjectionSpec
from repro_torch.models import zoo as TZ
from repro_torch.sae import compact_sae, make_serve_step

import _dist_ranks as R

MESHES = [(2, 2), (4, 1)]
ATOL = 1e-5
PROMPTS = [[1, 2, 3], [4, 5], [7], [8, 9]]
HYBRID_PROMPTS = [[1 + i, 2 + i, 3][:1 + i % 3] for i in range(12)]
LIFE_PROMPTS = [[3 + i, 1, 4 + 2 * i][:1 + i % 3] + [5] * (i % 4)
                for i in range(10)]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return {"/".join(str(k.key) for k in p): np.array(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _lm_params():
    """The reference's checkpoint: reduced gemma-7b at 2 layers drawn by
    JAX (PRNGKey(0)), 75% of w1's and 50% of w2's hidden columns zeroed
    (rng 0); then a refreshed copy (live weights times 1.01) and one with
    four more w1 columns dead (a smaller support, for the recompact)."""
    cfg = dataclasses.replace(JC.get_reduced("gemma_7b"), n_layers=2)
    params = _np_tree(JZ.build(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name, frac in (("w1", 0.75), ("w2", 0.5)):
        key = f"blocks/p0_global/mlp/{name}"
        arr = params[key].copy()
        dead = rng.choice(arr.shape[2], int(arr.shape[2] * frac),
                          replace=False)
        arr[:, :, dead] = 0.0
        params[key] = arr
    p2 = {k: (v * np.float32(1.01)).astype(v.dtype) for k, v in
          params.items()}
    p3 = dict(p2)
    w1 = p3["blocks/p0_global/mlp/w1"].copy()
    live = np.nonzero(np.abs(w1).sum(axis=(0, 1)))[0]
    w1[:, :, live[:4]] = 0.0
    p3["blocks/p0_global/mlp/w1"] = w1
    return params, p2, p3


@pytest.fixture(scope="module")
def inputs():
    scfg = SAEConfig(n_features=512, n_hidden=32, n_classes=2)
    sp = japply(sae_init(jax.random.PRNGKey(0), scfg), (JSpec(
        pattern=r"enc1/w", norm="l1inf", radius=0.2, axis=1),))
    x = np.random.default_rng(0).normal(size=(64, 512)).astype(np.float32)
    p1, p2, p3 = _lm_params()
    hcfg = R.hybrid_config()
    hp = tree_map(lambda a: a.numpy(), TZ.build(hcfg).init(
        torch.Generator().manual_seed(0), device="cpu"))
    return {"sae": dict(params=_nest(_np_tree(sp)), radius=0.2, x=x),
            "lm": dict(params=_nest(p1), prompts=PROMPTS, max_new=6),
            "hybrid": dict(params=hp, prompts=HYBRID_PROMPTS, max_new=5),
            "life": dict(checkpoints=tuple(_nest(p) for p in (p1, p2, p3)),
                         prompts=LIFE_PROMPTS, max_new=7)}


@pytest.fixture(scope="module")
def jax_proc(inputs, tmp_path_factory):
    """The reference's serving on 8 host devices, started first so that
    it runs while the ranks do."""
    work = tmp_path_factory.mktemp("jaxserve")
    d = {f"sae/params/{k}": v for k, v in
         flatten_with_path(inputs["sae"]["params"])}
    d.update({f"lm/params/{k}": v for k, v in
              flatten_with_path(inputs["lm"]["params"])})
    d["sae/x"], d["sae/radius"] = inputs["sae"]["x"], 0.2
    d["sae/hidden"] = 32
    rows = inputs["lm"]["prompts"]
    pad = np.full((len(rows), max(map(len, rows))), -1, np.int64)
    for i, r in enumerate(rows):
        pad[i, :len(r)] = r
    d["lm/prompts"], d["lm/max_new"] = pad, inputs["lm"]["max_new"]
    np.savez(work / "in.npz", **d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_ROOT, "tests", "_jax_serve_mesh.py"),
         str(work / "in.npz"), str(work / "out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, work / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(inputs, jax_proc, tmp_path_factory):
    """Every rank's results."""
    work = tmp_path_factory.mktemp("serve_mesh")
    return R.run_ranks("serve_group", 4, (2, 2), work, shapes=MESHES,
                       **inputs)


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, path = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return np.load(path)


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's one-device serving of every case."""
    s = inputs["sae"]
    compact = compact_sae(tree_map(torch.from_numpy, s["params"]), (
        ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.2,
                       axis=1),))
    z, xh = make_serve_step(compact)(compact.params,
                                     torch.from_numpy(s["x"]))
    return {"sae": {"z": z.numpy(), "xh": xh.numpy(), "sel": compact.sel},
            "lm": R.batch_serve(None, R.lm_serve_config(), compact=True,
                                **inputs["lm"]),
            "hybrid": R.batch_serve(None, R.hybrid_config(), compact=False,
                                    **inputs["hybrid"]),
            "life": R.engine_lifecycle(None, R.lm_serve_config(),
                                       **inputs["life"])}


def _tokens(padded):
    return [[int(t) for t in row if t >= 0] for row in padded]


@pytest.mark.parametrize("shape", MESHES)
def test_sae_serve_step_matches_jax_and_one_device(ranks, jax_out,
                                                   one_device, shape):
    ways = shape[0]
    for r in ranks:
        got = r[shape]["sae"]
        assert got["rows"] == (64 // ways, 2)
        np.testing.assert_array_equal(got["sel"], jax_out["sae/sel"])
        for k in ("z", "xh"):
            np.testing.assert_allclose(got[k], jax_out[f"sae/{k}"], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(got[k], one_device["sae"][k],
                                       rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["z"], jax_out["sae/z_d"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got["xh"], jax_out["sae/xh_d"][
            :, jax_out["sae/sel"]], rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
def test_sae_serve_step_runs_no_collective(ranks, jax_out, shape):
    assert not bool(jax_out["sae/collectives"])
    for r in ranks:
        got = r[shape]["sae"]
        assert got["calls"] == 0 and got["counts"] == {}
        assert "map 'batch' to None" in got["batch_none"]
        assert "does not divide" in got["indivisible"]


@pytest.mark.parametrize("shape", MESHES)
def test_batch_server_matches_jax_and_one_device(ranks, jax_out,
                                                 one_device, shape):
    want = one_device["lm"]["tokens"]
    assert _tokens(jax_out["lm/tokens_mesh"]) == want
    assert _tokens(jax_out["lm/tokens_one"]) == want
    for r in ranks:
        assert r[shape]["lm"]["tokens"] == want
        assert r[shape]["lm"]["n_traces"] == 1


@pytest.mark.parametrize("shape", MESHES)
def test_hybrid_batch_server_matches_one_device(ranks, one_device, shape):
    """More prompts than slots: freed rows re-admitted on their ranks, the
    recurrent leaves of each rank's admitted rows zeroed."""
    for r in ranks:
        assert r[shape]["hybrid"]["tokens"] == one_device["hybrid"]["tokens"]


@pytest.mark.parametrize("shape", MESHES)
def test_engine_lifecycle_matches_one_device(ranks, one_device, shape):
    """Refresh, cancel and recompact mid-flight on the mesh: the
    completions of the one-device engine under the same calls, one build
    each."""
    want = one_device["life"]
    assert any(ev for _, _, ev, _ in want["done"])
    for r in ranks:
        got = r[shape]["life"]
        assert got["done"] == want["done"]
        assert got["n_traces"] == want["n_traces"] == 1


@pytest.mark.parametrize("shape", MESHES)
def test_one_gather_a_step_and_none_inside(ranks, jax_out, shape):
    """No collective inside any step; one ``engine_out_gather`` a step,
    outside it (the reference's compiled step holds none either)."""
    assert not bool(jax_out["lm/collectives"])
    for r in ranks:
        for case in ("lm", "hybrid"):
            got = r[shape][case]
            assert got["in_step"] and not any(got["in_step"]), case
            assert got["gathers"] == got["steps"] == len(got["in_step"])
        assert not any(r[shape]["life"]["in_step"])
