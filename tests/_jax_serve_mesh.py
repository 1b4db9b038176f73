"""The reference's batch-sharded serving on a forced 8-device host mesh,
run as a subprocess by ``tests/test_torch_serve_mesh.py`` (XLA_FLAGS must
be set before JAX starts): ``python _jax_serve_mesh.py IN.npz OUT.npz``.

The cases of ``tests/test_multidevice.py:690-790`` on the given inputs:

* ``sae/``: ``repro.sae.serve.make_serve_step(compact, mesh=)`` of the
  compacted SAE (``sae/params/<path>``, its l1,inf spec at radius
  ``sae/radius``, axis 1) on ``sae/x`` over an (8,) "data" mesh: z and
  xhat_sel (``sae/z``, ``sae/xh``), the dense ``sae_apply`` (``sae/z_d``,
  ``sae/xh_d``), the support (``sae/sel``) and whether the compiled step
  holds a collective (``sae/collectives``);
* ``lm/``: ``BatchServer`` over the same mesh serving the compacted
  reduced gemma-7b (2 layers, its projection specs plus ``blocks/.*/mlp/
  w2$`` l1,inf at radius 64, axis 0; params ``lm/params/<path>``) on the
  prompts ``lm/prompts`` (-1 padded) for ``lm/max_new`` tokens, and the
  same on one device: ``lm/tokens_mesh``, ``lm/tokens_one`` (-1 padded)
  and ``lm/collectives``.
"""
import dataclasses
import re
import sys

import numpy as np

import repro  # noqa: F401  (installs the jax compat shims first)
import jax
import jax.numpy as jnp

from repro.configs import get_reduced
from repro.core import ProjectionSpec
from repro.models.zoo import build
from repro.sae import SAEConfig, compact_sae, sae_apply, sae_init
from repro.sae.serve import make_serve_step
from repro.train.serve import BatchServer, ServeConfig

_OPS = ("all-gather", "all-reduce", "all-to-all", "collective-permute")


def _tree(flat, template, prefix):
    paths = ["/".join(str(k.key) for k in p)
             for p, _ in jax.tree_util.tree_leaves_with_path(template)]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(flat[f"{prefix}/{p}"]) for p in paths])


def _has_collective(hlo):
    return any(re.search(op, hlo) for op in _OPS)


def _padded(rows):
    out = np.full((len(rows), max(map(len, rows))), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def lm_config():
    cfg = dataclasses.replace(get_reduced("gemma_7b"), n_layers=2)
    return dataclasses.replace(cfg, projection_specs=cfg.projection_specs
                               + (ProjectionSpec(pattern="blocks/.*/mlp/w2$",
                                                 norm="l1inf", radius=64.0,
                                                 axis=0, every_k=10),))


def main(src, dst):
    inp = np.load(src)
    mesh = jax.make_mesh((8,), ("data",))
    out = {}
    d = int(inp["sae/x"].shape[1])
    template = jax.eval_shape(lambda: sae_init(
        jax.random.PRNGKey(0), SAEConfig(n_features=d, n_hidden=int(
            inp["sae/hidden"]), n_classes=2)))
    params = _tree(inp, template, "sae/params")
    spec = ProjectionSpec(pattern=r"enc1/w", norm="l1inf",
                          radius=float(inp["sae/radius"]), axis=1)
    compact = compact_sae(params, (spec,))
    x = jnp.asarray(inp["sae/x"])
    step = make_serve_step(compact, mesh=mesh)
    out["sae/z"], out["sae/xh"] = map(np.asarray, step(compact.params, x))
    out["sae/z_d"], out["sae/xh_d"] = map(np.asarray, sae_apply(params, x))
    out["sae/sel"] = np.asarray(compact.sel)
    out["sae/collectives"] = np.asarray(_has_collective(
        step.lower(compact.params, x).compile().as_text()))

    model = build(lm_config())
    params = _tree(inp, jax.eval_shape(model.init, jax.random.PRNGKey(0)),
                   "lm/params")
    prompts = [[int(t) for t in row if t >= 0] for row in inp["lm/prompts"]]
    max_new = int(inp["lm/max_new"])
    for tag, m in (("mesh", mesh), ("one", None)):
        srv = BatchServer(model, batch_slots=8,
                          scfg=ServeConfig(max_seq=32), mesh=m)
        srv.load_compact(params=params)
        out[f"lm/tokens_{tag}"] = _padded(srv.generate(prompts,
                                                       max_new=max_new))
        if m is not None:
            out["lm/collectives"] = np.asarray(_has_collective(
                srv.engine.step_hlo()))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
