"""JAX's per-device shapes of every param leaf and every decode-cache
leaf of every runnable (arch x shape x mesh) cell, run as a subprocess by
``tests/test_torch_layout.py`` (XLA_FLAGS must force 512 host devices
before JAX starts): ``python _jax_layout.py OUT.json``.

For each cell, the reference's ``param_shardings`` / ``cache_shardings``
under ``rules_for_cell`` (``lower_cell``'s) on the production mesh,
(16, 16) over ("data", "model") or (2, 16, 16) over ("pod", "data",
"model"), and each leaf's ``NamedSharding.shard_shape``. Nothing is
allocated or compiled. OUT maps "arch|shape|mesh" to {"params": {path:
shape}, "cache": {path: shape}}.
"""
import json
import sys

import repro  # noqa: F401  (installs the jax compat shims first)
import jax
from jax.sharding import AxisType

from repro.configs import ARCH_IDS, get_config
from repro.launch import steps as JS
from repro.models import zoo as JZ


def _shapes(tree, shardings):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))
    return {"/".join(str(k.key) for k in p): list(s.shard_shape(l.shape))
            for (p, l), s in zip(leaves, shs)}


def main(dst):
    meshes = {
        "pod": jax.make_mesh((16, 16), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2),
        "multipod": jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                                  axis_types=(AxisType.Auto,) * 3)}
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = JZ.build(cfg)
        params = model.abstract_params()
        for shape in JZ.SHAPES:
            if not JZ.cell_supported(cfg, shape)[0]:
                continue
            for name, mesh in meshes.items():
                rules = JS.rules_for_cell(cfg, shape, name == "multipod")
                rec = {"params": _shapes(
                    params, JS.param_shardings(model, mesh, rules))}
                if JZ.SHAPES[shape]["kind"] == "decode":
                    cache = JZ.input_specs(cfg, shape)["cache"]
                    rec["cache"] = _shapes(
                        cache, JS.cache_shardings(cache, mesh, rules))
                out[f"{arch}|{shape}|{name}"] = rec
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
