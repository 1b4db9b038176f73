"""The port's sharding rules (``repro_torch.dist.sharding``), param specs
and per-cell shardings (``repro_torch.launch.steps``) against
``repro.dist.sharding`` / ``repro.launch.steps``.

The rules, ``logical_spec`` and ``fit_spec`` equal the reference's entry
for entry (a ``Spec`` is a tuple, as a ``PartitionSpec`` is);
``Model.param_specs`` equals the reference's ``PartitionSpec``s leaf for
leaf for every reduced config; ``cache_shardings`` and
``batch_shardings`` equal the reference's specs. ``param_shardings`` fits
the reference's specs to a mesh, leaf for leaf in every region.
``shard`` is a no-op outside a context and on a
None mesh. The meshes here are stand-ins with a name and a size per dim
(``mesh_dim_names``, ``mesh.shape``), which is all the specs read; the
collectives run on real gloo meshes in ``tests/test_torch_mesh_step.py``.
"""
import types

import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P
from repro import configs as JC
from repro.dist import sharding as JSH
from repro.models import zoo as JZ
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path
from repro_torch.dist import sharding as SH
from repro_torch.launch import steps as TS
from repro_torch.models import zoo as TZ



def _mesh(**axes):
    """(port stand-in, reference stand-in) of a mesh with these axes."""
    port = types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 mesh=torch.zeros(tuple(axes.values())))
    return port, types.SimpleNamespace(shape=dict(axes))


def _archs():
    from repro_torch.configs import ARCH_IDS
    return sorted(ARCH_IDS)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_match_reference(multi_pod):
    assert SH.default_rules(multi_pod) == JSH.default_rules(multi_pod)


@pytest.mark.parametrize("names", [("batch", "seq", "embed"),
                                   ("fsdp", "heads", None),
                                   ("experts", "fsdp", "mlp"),
                                   ("cache_batch", "cache_seq", "kv_heads",
                                    None), ("unknown", None)])
def test_logical_spec_matches_reference(names):
    for rules in (SH.default_rules(), SH.default_rules(True), None,
                  {"heads": ("data", "model")}):
        got = SH.logical_spec(names, rules)
        assert isinstance(got, tuple) and tuple(got) == tuple(
            JSH.logical_spec(names, rules))


@pytest.mark.parametrize("axes,shape", [
    (("data", "model", None), (8, 6, 3)),
    (("data", "model"), (3, 25)),            # neither divides: replicate
    ((("data", "model"), None), (16, 5)),
    ((("pod", "data"), "model"), (8, 8)),   # "pod" absent: replicate
    (("model", None, "data"), (4, 1, 2)),
])
def test_fit_spec_matches_reference(axes, shape):
    for sizes in ({"data": 2, "model": 4}, {"data": 4, "model": 1},
                  {"data": 2, "model": 2}):
        port, ref = _mesh(**sizes)
        assert tuple(SH.fit_spec(port, axes, shape)) == tuple(
            JSH.fit_spec(ref, axes, shape))


def test_param_specs_match_reference_for_every_config():
    """``Model.param_specs`` equals the reference's PartitionSpec tree leaf
    for leaf for every reduced config, under the default rules and under
    each config's train-cell rules."""
    for arch in _archs():
        jm, tm = JZ.build(JC.get_reduced(arch)), TZ.build(
            TC.get_reduced(arch))
        for rules in (SH.default_rules(),
                      TS.rules_for_cell(tm.cfg, "train_4k", False)):
            want = jax.tree_util.tree_leaves_with_path(
                jm.param_specs(rules), is_leaf=lambda x: isinstance(x, P))
            got = flatten_with_path(tm.param_specs(rules))
            assert len(got) == len(want), arch
            for (path, spec), (jpath, jspec) in zip(got, want):
                jp = "/".join(str(k.key) for k in jpath)
                assert path == jp and tuple(spec) == tuple(jspec), (
                    arch, path, spec, jspec)


@pytest.mark.parametrize("arch", ["stablelm_3b", "hymba_15b", "mamba2_370m",
                                  "gemma_7b"])
def test_cache_and_batch_shardings_match_reference(arch):
    """The decode cache's and a batch's specs under each decode cell's
    rules equal the reference's ``fit_spec`` results."""
    jcfg, tcfg = JC.get_reduced(arch), TC.get_reduced(arch)
    port, ref = _mesh(data=2, model=2)
    jm = JZ.build(jcfg)
    for shape in ("decode_32k", "long_500k"):
        rules = TS.rules_for_cell(tcfg, shape, False)
        jcache = jax.eval_shape(lambda: jm.init_cache(4, 16))
        tcache = TZ.build(tcfg).init_cache(4, 16, device="cpu")
        got = flatten_with_path(TS.cache_shardings(tcache, port, rules))
        want = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map_with_path(
                lambda p, l: JSH.fit_spec(ref, _ref_cache_axes(p, l, rules),
                                          l.shape), jcache),
            is_leaf=lambda x: isinstance(x, P))
        assert [tuple(s) for _, s in got] == [tuple(s) for s in want]
    batch = {"tokens": torch.zeros((4, 8)), "frames": torch.zeros((4, 8, 2))}
    got = TS.batch_shardings(batch, port, SH.default_rules())
    assert tuple(got["tokens"]) == ("data", None)
    assert tuple(got["frames"]) == ("data", None, None)
    one = TS.batch_shardings({"tokens": torch.zeros((1, 8))}, port,
                             SH.default_rules())
    assert tuple(one["tokens"]) == (None, None)


def _ref_cache_axes(path, leaf, rules):
    """The mesh axes ``repro.launch.steps.cache_shardings`` gives a leaf
    (its ``one``, without the NamedSharding)."""
    cb, cs = rules["cache_batch"], rules["cache_seq"]
    name = str(path[-1].key)
    if name in ("k", "v"):
        axes = [cb, cs, rules.get("kv_heads"), None]
    elif name in ("ck", "cv"):
        axes = [cb, None, rules.get("heads"), None]
    elif name in ("c", "kr"):
        axes = [cb, cs, None]
    elif name == "state":
        axes = [cb, rules.get("mlp"), None, None]
    elif name.startswith("conv"):
        axes = [cb, None, None]
    else:
        axes = [None] * leaf.ndim
    if leaf.ndim == len(axes) + 1:
        axes = [None] + axes
    return axes


def test_param_shardings_keep_regions_consistent():
    """Every leaf takes the reference's spec fit to the mesh, whatever its
    region (``tests/test_torch_layout.py`` holds the full configs to
    JAX's per-device shapes). stablelm: attention, MLP and the vocab split
    over model, weights over data (FSDP). hymba (heads and kv heads
    replicated by its overrides): its attention replicates over model, its
    SSM (16 heads, split by whole heads) and MLP split. deepseek: MLA's
    head projections, the routed experts (either ``moe_impl``) and the
    shared experts split over model, MLA's down projections do not.
    mixtral (kv heads replicated by its overrides): the query heads and
    the experts' hidden units split over model."""
    import dataclasses
    port, _ = _mesh(data=2, model=2)

    def specs(cfg):
        m = TZ.build(cfg)
        return dict(flatten_with_path(TS.param_shardings(
            m, port, TS.rules_for_cell(cfg, "train_4k", False))))

    s = specs(TC.get_reduced("stablelm_3b"))
    assert tuple(s["blocks/p0_global/attn/wq"]) == (None, "data", "model",
                                                     None)
    assert tuple(s["blocks/p0_global/attn/wk"]) == (None, "data", "model",
                                                     None)
    assert tuple(s["blocks/p0_global/mlp/w2"]) == (None, "model", "data")
    assert tuple(s["embed/table"]) == ("model", None)
    h = specs(TC.get_reduced("hymba_15b"))
    assert tuple(h["blocks/p0_hybrid/attn/wq"]) == (None, "data", None, None)
    assert tuple(h["blocks/p0_hybrid/ssm/wx"]) == (None, "data", "model")
    assert tuple(h["blocks/p0_hybrid/ssm/wo"]) == (None, "model", "data")
    assert tuple(h["blocks/p0_hybrid/ssm/wB"]) == (None, "data", None)
    assert tuple(h["blocks/p0_hybrid/mlp/w1"]) == (None, "data", "model")
    ds = TC.get_reduced("deepseek_v2_236b")
    for cfg in (ds, dataclasses.replace(ds, moe_impl="shardmap")):
        d = specs(cfg)
        assert tuple(d["blocks/p0_mla/moe/w1"]) == (None, "model", "data",
                                                     None)
        assert tuple(d["blocks/p0_mla/moe/shared/w1"]) == (None, "data",
                                                            "model")
        assert tuple(d["blocks/p0_mla/mla/wq_b"]) == (None, None, "model",
                                                       None)
        assert tuple(d["blocks/p0_mla/mla/wo"]) == (None, "model", None,
                                                     "data")
        assert tuple(d["blocks/p0_mla/mla/wkv_a"]) == (None, "data", None)
    mx = specs(TC.get_reduced("mixtral_8x7b"))
    assert tuple(mx["blocks/p0_local/attn/wq"]) == (None, "data", "model",
                                                     None)
    assert tuple(mx["blocks/p0_local/attn/wk"]) == (None, "data", None, None)
    assert tuple(mx["blocks/p0_local/moe/w1"]) == (None, None, "data",
                                                    "model")
    # a 3-way model axis divides no reduced head count: every attention
    # and SSM region replicates over model, and no spec ever raises
    odd, _ = _mesh(data=2, model=3)
    for arch in _archs():
        cfg = TC.get_reduced(arch)
        flat = dict(flatten_with_path(TS.param_shardings(
            TZ.build(cfg), odd, TS.rules_for_cell(cfg, "train_4k", False))))
        assert all("model" not in v for k, v in flat.items()
                   if "/ssm/" in k or "/attn/" in k), arch


def test_shard_is_a_no_op_outside_a_context():
    x = torch.ones(4, 3)
    assert SH.shard(x, "batch", None) is x
    with SH.axis_rules(None, SH.default_rules()):
        assert SH.shard(x, "batch", None) is x
        assert SH.current_rules() == (None, SH.default_rules())
        assert SH.active_axis("model") is None
        # the explicit collectives are identities without a mesh
        assert SH.tp_enter(x) is x and SH.tp_exit(x) is x
        assert SH.gather_over(x, "data", 0) is x
    assert SH.current_rules() is None


def test_axis_rules_nest():
    port, _ = _mesh(data=2, model=2)
    with SH.axis_rules(port, {"a": 1}):
        with SH.axis_rules(None, None):
            assert SH.current_rules() == (None, None)
        assert SH.current_rules()[1] == {"a": 1}
        assert SH.active_axis("model") is port
        assert SH.active_axis("pod") is None
    assert SH.current_rules() is None


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    port, _ = _mesh(data=2, model=2)
    assert SH.placements(port, ("data", "model", None)) == (Shard(0),
                                                             Shard(1))
    assert SH.placements(port, (None, "data")) == (Shard(1), Replicate())
    assert SH.placements(port, (("data", "model"),)) == (Shard(0), Shard(0))
    assert SH.placements(port, ()) == (Replicate(), Replicate())


def test_remat_recompute_runs_under_the_forward_rules():
    """Remat's recompute runs where the backward runs (on the card,
    autograd's device thread, where the thread-local rules are empty): the
    checkpointed cycle re-enters the forward's (mesh, rules), so its
    collectives match the forward's on every rank. The backward here runs
    on a fresh thread."""
    import dataclasses
    import threading
    from repro_torch.models import transformer as TT
    port, _ = _mesh(data=2, model=2)
    cfg = dataclasses.replace(TC.get_reduced("stablelm_3b"), remat=True)
    seen = []

    def cycle(x):
        seen.append(SH.current_rules())
        return x * x

    x = torch.ones(3, requires_grad=True)
    with SH.axis_rules(port, {"r": 1}):
        y = TT._remat(cfg)(cycle, x)
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join()
    assert len(seen) == 2 and seen[0] == seen[1] == (port, {"r": 1})
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    x.grad = None
    # without a mesh the checkpoint runs the cycle as it is
    seen.clear()
    y = TT._remat(cfg)(cycle, x)
    y.sum().backward()
    assert seen == [None, None]
