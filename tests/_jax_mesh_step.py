"""JAX's sharded production step on a forced host-device mesh, run as a
subprocess by ``tests/test_torch_mesh_step.py`` (XLA_FLAGS must be set
before JAX starts): ``python _jax_mesh_step.py IN.npz OUT.npz DATA MODEL
EVERY_K [full]`` (the reduced configs' projection specs at EVERY_K; a
case named ``<arch>@<k>`` takes every_k k instead; a case named
``<arch>#<i>`` is the reduced config with the ``ArchConfig`` changes of
its ``<arch>#<i>/config`` entry, a JSON object).

IN holds, per arch, the params (``<arch>/params/<path>``), tokens, labels
and any other batch leaf (``<arch>/image_embeds``, ``<arch>/frames``);
OUT, per arch, the loss of each of two steps of
``repro.launch.steps.build_train_step(model, mesh, rules)`` jitted on
inputs placed under the reference's shardings (``lower_cell``'s), and the
params after them; with ``full``, also the first Adam moments after them
(``<arch>/mu/<path>``), the sharded step's state after its first step
(``<arch>/state1/{params,mu,nu}/<path>``, ``<arch>/state1/count``,
``<arch>/state1/proj/<plan>``) and, for a case whose IN holds an
``<arch>/one`` entry, the same two steps of the one-device step
(``build_train_step(model, None, rules)``) from the same inputs
(``<arch>/one/losses``, ``<arch>/one/params/<path>``,
``<arch>/one/mu/<path>``).
"""
import contextlib
import dataclasses
import json
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


def _run(m, mesh, rules, acfg, params, batch):
    """Two steps of the production step (on ``mesh``, or one device when
    None): (losses, params, mu, the state after the first step)."""
    cfg = m.cfg
    engine = JS.projection_engine_for(cfg, mesh)
    opt = adam_init(params, acfg)
    proj = engine.init_state(params)
    step = jax.jit(JS.build_train_step(m, mesh, rules, acfg))
    if mesh is not None:
        p_sh = JS.param_shardings(m, mesh, rules)
        o_sh = JS.opt_shardings(p_sh, mesh)
        b_sh = JS.batch_shardings(batch, mesh, rules)
        pr_sh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()),
                                       proj)
        put = jax.device_put
        params, opt, proj = put(params, p_sh), put(opt, o_sh), put(proj,
                                                                   pr_sh)
        batch = put(batch, b_sh)
    losses, state1 = [], None
    for _ in range(2):
        loss, _, params, opt, proj = step(params, opt, proj, batch)
        losses.append(float(loss))
        state1 = state1 or jax.tree_util.tree_map(np.asarray,
                                                  (params, opt, proj))
    return losses, params, opt.mu, state1


def main(src, dst, data, model, every_k, full=False):
    inp = np.load(src)
    archs = sorted({k.split("/")[0] for k in inp.files})
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for arch in archs:
        base, _, k = arch.partition("@")
        base = base.partition("#")[0]
        cfg = JC.get_reduced(base)
        cfg = dataclasses.replace(cfg, projection_specs=tuple(
            dataclasses.replace(s, every_k=int(k) if k else every_k)
            for s in cfg.projection_specs))
        if f"{arch}/config" in inp.files:
            cfg = dataclasses.replace(cfg, **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in json.loads(str(inp[f"{arch}/config"])).items()})
        m = JZ.build(cfg)
        flat = {k[len(arch) + 8:]: inp[k] for k in inp.files
                if k.startswith(f"{arch}/params/")}
        params, paths = _tree(flat, jax.eval_shape(
            m.init, jax.random.PRNGKey(0)))
        batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"], jnp.int32),
                 "labels": jnp.asarray(inp[f"{arch}/labels"], jnp.int32)}
        for extra in ("image_embeds", "frames"):
            if f"{arch}/{extra}" in inp.files:
                batch[extra] = jnp.asarray(inp[f"{arch}/{extra}"])
        rules = JS.rules_for_cell(cfg, "train_4k", False)
        acfg = AdamConfig(moment_dtype=jnp.float32)
        runs = {"": mesh}
        if full and f"{arch}/one" in inp.files:
            runs["one/"] = None
        for pre, where in runs.items():
            with where if where is not None else contextlib.nullcontext():
                losses, ps, mu, state1 = _run(m, where, rules, acfg, params,
                                              batch)
            out[f"{arch}/{pre}losses"] = np.asarray(losses)
            for p, leaf, mo in zip(paths, jax.tree_util.tree_leaves(ps),
                                   jax.tree_util.tree_leaves(mu)):
                out[f"{arch}/{pre}params/{p}"] = np.asarray(leaf)
                if full:
                    out[f"{arch}/{pre}mu/{p}"] = np.asarray(mo)
            if full and not pre:
                p1, o1, proj1 = state1
                out[f"{arch}/state1/count"] = np.asarray(o1.count)
                for what, tree in (("params", p1), ("mu", o1.mu),
                                   ("nu", o1.nu)):
                    for p, leaf in zip(paths, jax.tree_util.tree_leaves(tree)):
                        out[f"{arch}/state1/{what}/{p}"] = leaf
                for key, theta in proj1.items():
                    out[f"{arch}/state1/proj/{key}"] = theta
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]), len(sys.argv) > 6 and sys.argv[6] == "full")
