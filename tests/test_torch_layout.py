"""The port's per-device layout of every cell against the reference's.

For every runnable (arch x shape) cell on the production meshes, pod
(16, 16) and multipod (2, 16, 16): every param leaf's piece after
``convert.params_to_mesh(..., launch.steps.param_shardings(...))`` and
every decode-cache leaf's piece after ``convert.cache_to_mesh(...,
cache_shardings(...))`` (meta tensors, rank 0 of a fake process group of
256 or 512 ranks, ``launch.dryrun.fake_group``) has the shape of JAX's
``NamedSharding.shard_shape`` under ``repro.launch.steps``'
``param_shardings`` / ``cache_shardings`` and ``rules_for_cell`` (one
subprocess, ``tests/_jax_layout.py``, on 512 forced host devices, ~3 s).
A planted fault, one region's model axis dropped again (the MoE's, or
MLA's), fails the comparison.

The per-device param bytes of the four archs whose regions the port once
replicated over model (mixtral-8x7b, deepseek-v2, llama-3.2-vision,
hymba-1.5b at ``train_4k`` on pod) equal the reference's, counted at 2
bytes an element (bf16) from its shard shapes.

Each piece owns its storage (a slice along dim 0 is contiguous, and a
piece kept as one would hold the whole leaf): stablelm-3b's ``train_4k``
arguments on 256 fake ranks (params, f32 moments, theta state, batch)
each hold their own bytes, and the dry-run's argument bytes
(``roofline.counter.Counter``'s, from ``launch.steps.cell_step``) are
their sum.
"""
import functools
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import convert
from repro_torch._tree import flatten_with_path, unflatten_like
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist.sharding import Spec
from repro_torch.launch import dryrun
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import zoo as TZ
from repro_torch.roofline.counter import Counter

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": 256, "multipod": 512}
# param bytes a device at train_4k on pod (2 bytes an element, bf16), the
# reference's
REFERENCE_PARAM_BYTES = {"mixtral_8x7b": 429_662_208,
                         "deepseek_v2_236b": 2_551_818_240,
                         "llama32_vision_90b": 1_110_065_152,
                         "hymba_15b": 42_555_392}


@pytest.fixture(scope="module")
def jax_layout(tmp_path_factory):
    out = tmp_path_factory.mktemp("layout") / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(_ROOT, "tests", "_jax_layout.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _local_shapes(tree):
    return {p: list(x.to_local().shape) for p, x in flatten_with_path(tree)}


def port_layout(shardings=TS.param_shardings):
    """{"arch|shape|mesh": {"params": {path: local shape}, "cache": ...}}
    of every runnable cell, rank 0's pieces; ``shardings(model, mesh,
    rules)`` gives the param specs."""
    out = {}
    for mesh_kind, world in MESHES.items():
        with dryrun.fake_group(world):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                        device="cpu")
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                model = TZ.build(cfg)
                params = model.abstract_params()
                by_rules = {}
                for shape, sh in TZ.SHAPES.items():
                    if not TZ.cell_supported(cfg, shape)[0]:
                        continue
                    rules = TS.rules_for_cell(cfg, shape,
                                              mesh_kind == "multipod")
                    key = json.dumps(rules, sort_keys=True)
                    if key not in by_rules:
                        by_rules[key] = _local_shapes(convert.params_to_mesh(
                            params, mesh, shardings(model, mesh, rules),
                            device="meta"))
                    rec = {"params": by_rules[key]}
                    if sh["kind"] == "decode":
                        cache = TZ.input_specs(cfg, shape)["cache"]
                        rec["cache"] = _local_shapes(convert.cache_to_mesh(
                            cache, mesh, TS.cache_shardings(cache, mesh,
                                                            rules),
                            device="meta"))
                    out[f"{arch}|{shape}|{mesh_kind}"] = rec
    return out


@pytest.fixture(scope="module")
def port():
    return port_layout()


def mismatches(got, want):
    """[(cell, kind, path, port shape, JAX shape)] where they differ (a
    cell or leaf on one side only counts too)."""
    bad = [(cell, None, None, None, None) for cell in set(got) ^ set(want)]
    for cell in set(got) & set(want):
        for kind in set(got[cell]) | set(want[cell]):
            g, w = got[cell].get(kind, {}), want[cell].get(kind, {})
            for path in set(g) | set(w):
                if g.get(path) != w.get(path):
                    bad.append((cell, kind, path, g.get(path), w.get(path)))
    return bad


def test_every_cell_lays_out_as_the_reference(port, jax_layout):
    assert len(port) == 68
    bad = mismatches(port, jax_layout)
    assert not bad, bad[:10]


def _dropped(region, shardings):
    """``shardings`` with the model axis dropped from one region's
    leaves again (a planted fault)."""
    def drop(spec):
        return Spec(*(None if a == "model" else tuple(
            x for x in a if x != "model") if isinstance(a, tuple) else a
            for a in spec))

    def patched(model, mesh, rules):
        flat = flatten_with_path(shardings(model, mesh, rules))
        return unflatten_like(model.layout, [
            drop(s) if f"/{region}/" in p else s for p, s in flat])

    return patched


@pytest.mark.parametrize("region,archs", [
    ("moe", {"deepseek_v2_236b", "mixtral_8x7b"}),
    ("mla", {"deepseek_v2_236b"})])
def test_planted_dropped_region_fails(jax_layout, region, archs):
    """Dropping the model axis from one region again (as the port once
    did for the dense MoE and MLA) fails the comparison, at the cells of
    the archs that have the region and only there."""
    got = port_layout(_dropped(region, TS.param_shardings))
    bad = mismatches(got, jax_layout)
    assert bad and {b[0].split("|")[0] for b in bad} == archs


def _param_bytes(shapes):
    return 2 * sum(functools.reduce(lambda a, b: a * b, s, 1)
                   for s in shapes.values())


@pytest.mark.parametrize("arch", sorted(REFERENCE_PARAM_BYTES))
def test_param_bytes_a_device_equal_the_reference(port, jax_layout, arch):
    key = f"{arch}|train_4k|pod"
    assert _param_bytes(port[key]["params"]) == _param_bytes(
        jax_layout[key]["params"]) == REFERENCE_PARAM_BYTES[arch]


def test_pieces_own_their_storage_and_arguments_sum_them():
    """stablelm-3b ``train_4k`` on 256 fake ranks: every argument piece's
    storage holds its own bytes (none keeps a whole leaf), and the
    dry-run's argument bytes are their sum."""
    model = TZ.build(get_config("stablelm_3b"))
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        kind, _, args = TS.cell_step(model, "train_4k", mesh, False)
        every = [getattr(t, "_local_tensor", t) for t in tree_leaves(args)
                 if isinstance(t, torch.Tensor)]
        counted = Counter(arguments=args).counts.argument_bytes
    assert kind == "train" and len(every) > 3
    own = [t.numel() * t.element_size() for t in every]
    assert [t.untyped_storage().nbytes() for t in every] == own
    assert counted == sum(own) == 280_201_348
