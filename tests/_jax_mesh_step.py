"""JAX's sharded production step on a forced host-device mesh, run as a
subprocess by ``tests/test_torch_mesh_step.py`` (XLA_FLAGS must be set
before JAX starts): ``python _jax_mesh_step.py IN.npz OUT.npz DATA MODEL
EVERY_K`` (the reduced configs' projection specs at EVERY_K; a case
named ``<arch>@<k>`` takes every_k k instead).

IN holds, per arch, the params (``<arch>/params/<path>``), tokens and
labels; OUT, per arch, the loss of each of two steps of
``repro.launch.steps.build_train_step(model, mesh, rules)`` jitted on
inputs placed under the reference's shardings (``lower_cell``'s), and the
params after them.
"""
import dataclasses
import sys

import numpy as np

import repro  # noqa: F401  (installs the jax compat shims first)
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro import configs as JC
from repro.launch import steps as JS
from repro.models import zoo as JZ
from repro.optim import AdamConfig, adam_init


def _tree(flat, template):
    leaves = jax.tree_util.tree_leaves_with_path(template)
    paths = ["/".join(str(k.key) for k in p) for p, _ in leaves]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(flat[p]) for p in paths]), paths


def main(src, dst, data, model, every_k):
    inp = np.load(src)
    archs = sorted({k.split("/")[0] for k in inp.files})
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for arch in archs:
        base, _, k = arch.partition("@")
        cfg = JC.get_reduced(base)
        cfg = dataclasses.replace(cfg, projection_specs=tuple(
            dataclasses.replace(s, every_k=int(k) if k else every_k)
            for s in cfg.projection_specs))
        m = JZ.build(cfg)
        flat = {k[len(arch) + 8:]: inp[k] for k in inp.files
                if k.startswith(f"{arch}/params/")}
        params, paths = _tree(flat, jax.eval_shape(
            m.init, jax.random.PRNGKey(0)))
        batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"], jnp.int32),
                 "labels": jnp.asarray(inp[f"{arch}/labels"], jnp.int32)}
        rules = JS.rules_for_cell(cfg, "train_4k", False)
        acfg = AdamConfig(moment_dtype=jnp.float32)
        p_sh = JS.param_shardings(m, mesh, rules)
        o_sh = JS.opt_shardings(p_sh, mesh)
        b_sh = JS.batch_shardings(batch, mesh, rules)
        engine = JS.projection_engine_for(cfg, mesh)
        opt = adam_init(params, acfg)
        proj = engine.init_state(params)
        pr_sh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()),
                                       proj)
        step = jax.jit(JS.build_train_step(m, mesh, rules, acfg))
        put = jax.device_put
        params, opt, proj = put(params, p_sh), put(opt, o_sh), put(proj,
                                                                   pr_sh)
        batch = put(batch, b_sh)
        losses = []
        with mesh:
            for _ in range(2):
                loss, _, params, opt, proj = step(params, opt, proj, batch)
                losses.append(float(loss))
        out[f"{arch}/losses"] = np.asarray(losses)
        for p, leaf in zip(paths, jax.tree_util.tree_leaves(params)):
            out[f"{arch}/params/{p}"] = np.asarray(leaf)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]))
