"""JAX's sharded decode step on a forced host-device mesh, run as a
subprocess by ``tests/test_torch_decode_mesh.py`` (XLA_FLAGS must be set
before JAX starts): ``python _jax_decode_mesh.py IN.npz CASES.json
OUT.npz``.

CASES lists each case as {"key", "arch", "over", "cell", "pos", "meshes"}:
the reduced config of ``arch`` with the ``over`` fields replaced, the
decode rules of ``cell`` (``rules_for_cell``), the two calls' positions
(a per-row vector, then a scalar, given to JAX as that value at every
row: one compile a mesh) and the (data, model) meshes, each over
the first data * model host devices with Auto axes (ROADMAP C-2). IN holds
per case the params (``<key>/params/<path>``), the cache
(``<key>/cache/<path>``) and the two calls' tokens (``<key>/tokens``).
OUT holds per case and mesh (``<key>/<data>x<model>/...``) each call's
logits of ``repro.launch.steps.build_decode_step(model, mesh, rules)``
jitted under ``param_shardings`` / ``cache_shardings`` (``lower_cell``'s
decode shardings; the cache donated) and the cache after both calls.
"""
import dataclasses
import json
import sys

import numpy as np

import repro  # noqa: F401  (installs the jax compat shims first)
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

from repro import configs as JC
from repro.dist.sharding import logical_spec
from repro.launch import steps as JS
from repro.models import zoo as JZ


def _paths(tree):
    return ["/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _fill(template, inp, prefix):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(inp[f"{prefix}/{p}"]) for p in _paths(template)])


def main(src, cases, dst):
    inp = np.load(src)
    with open(cases) as f:
        cases = json.load(f)
    out = {}
    for case in cases:
        key = case["key"]
        over = {k: tuple(v) if isinstance(v, list) else v
                for k, v in case["over"].items()}
        cfg = dataclasses.replace(JC.get_reduced(case["arch"]), **over)
        m = JZ.build(cfg)
        params = _fill(jax.eval_shape(m.init, jax.random.PRNGKey(0)), inp,
                       f"{key}/params")
        tok = inp[f"{key}/tokens"]
        B, S = tok.shape[1], case["seq"]
        cache0 = _fill(jax.eval_shape(lambda: m.init_cache(B, S,
                                                           jnp.float32)),
                       inp, f"{key}/cache")
        rules = JS.rules_for_cell(cfg, case["cell"], False)
        vec, scalar = case["pos"]
        for data, model in case["meshes"]:
            mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(
                data, model), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
            p_sh = JS.param_shardings(m, mesh, rules)
            c_sh = JS.cache_shardings(cache0, mesh, rules)
            tok_sh = NamedSharding(mesh, P(rules["batch"], None))
            out_sh = (NamedSharding(mesh, logical_spec(("batch", "vocab"),
                                                       rules)), c_sh)
            step = JS.build_decode_step(m, mesh, rules)
            put = jax.device_put
            params_m = put(params, p_sh)
            cache = put(jax.tree_util.tree_map(jnp.copy, cache0), c_sh)
            tag = f"{key}/{data}x{model}"
            # the scalar call as the same vector at every row (one
            # compile; dynamic_update_slice and the per-row scatter write
            # the same in-range positions)
            pos_sh = NamedSharding(mesh, P(None))
            jitted = jax.jit(step, in_shardings=(p_sh, c_sh, tok_sh, pos_sh),
                             out_shardings=out_sh, donate_argnums=(1,))
            with mesh:
                for i, pos in enumerate((vec, [scalar] * B)):
                    logits, cache = jitted(
                        params_m, cache,
                        put(jnp.asarray(tok[i], jnp.int32), tok_sh),
                        put(jnp.asarray(pos, jnp.int32), pos_sh))
                    out[f"{tag}/logits{i}"] = np.asarray(logits)
            for p, leaf in zip(_paths(cache),
                               jax.tree_util.tree_leaves(cache)):
                out[f"{tag}/cache/{p}"] = np.asarray(leaf)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3])
