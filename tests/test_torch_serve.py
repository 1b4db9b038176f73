"""The port's compact serving (``repro_torch.serve``, ``scatter_residual``
and the compact ``mlp_apply``) against ``repro.serve`` — the cases of
``tests/test_zoo_serve.py`` that need no MoE block and no ``BatchServer``.

Both packages start from the same numpy params: the JAX init with a
fraction of the constrained columns set to zero (simulated projected
training), carried to the port through ``convert.params_from_numpy``.

* Supports, ratios, slot widths and sel indices equal JAX's exactly.
* On the CPU torch's GEMM gives the same bits at every output width, so
  the port's compact forward and decode must equal its own dense ones bit
  for bit (ROADMAP C-1: XLA's does not, so JAX's own test of this fails
  under jax 0.9). Against JAX: forward atol = rtol 2e-4 and decode 1e-4,
  ``tests/test_torch_zoo.py``'s tolerances.
* ``cuda`` tests: ``scatter_residual`` reruns bit-equal on the card (its
  ``index_add_`` adds with atomics), and a small compact forward whose
  shapes the card's kernels take, on the card against the CPU at 2e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_reduced
    from repro.core.constraints import ProjectionSpec as JSpec
    from repro.core.constraints import leaf_path_str
    from repro.models import layers as JL
    from repro.models.transformer import (decode_step as j_decode,
                                          forward as j_forward,
                                          init_cache as j_init_cache)
    from repro.models.zoo import build as j_build
    import repro.serve as JS
except ImportError:       # the card's machine has PyTorch but no JAX
    jax = None
from repro_torch._tree import flatten_with_path, leaves
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.constraints import ProjectionSpec as TSpec
from repro_torch.core.l1inf import compact_columns
from repro_torch.models import layers as TL
from repro_torch.models.transformer import (decode_step as t_decode,
                                            forward as t_forward,
                                            init_cache as t_init_cache)
from repro_torch.models.zoo import build, reduce_config
import repro_torch.serve as TS

FWD = dict(atol=2e-4, rtol=2e-4)
DEC = dict(atol=1e-4, rtol=1e-4)
W1 = "blocks/p0_global/mlp/w1"


def _kill_columns(arr, frac, axis, seed=0):
    """Zero a random fraction of columns — simulated projected training."""
    rng = np.random.default_rng(seed)
    arr = np.array(arr)
    dead = rng.choice(arr.shape[axis], int(arr.shape[axis] * frac),
                      replace=False)
    idx = [slice(None)] * arr.ndim
    idx[axis] = dead
    arr[tuple(idx)] = 0.0
    return arr


def _cfgs(arch, w2_spec):
    out = []
    for get, Spec in ((j_reduced, JSpec), (t_reduced, TSpec)):
        cfg = get(arch)
        if arch == "gemma_7b":
            cfg = dataclasses.replace(cfg, n_layers=2)
        specs = cfg.projection_specs
        if w2_spec:
            specs = specs + (Spec(pattern="blocks/.*/mlp/w2$", norm="l1inf",
                                  radius=64.0, axis=0, every_k=10),)
        out.append(dataclasses.replace(cfg, projection_specs=specs))
    return out


def _setup(arch="gemma_7b", w2_spec=True, seed=0):
    """(jax cfg, port cfg, numpy params) with w1 (and w2) columns killed."""
    jcfg, tcfg = _cfgs(arch, w2_spec)
    P = jax.tree_util.tree_map(
        np.array, j_build(jcfg).init(jax.random.PRNGKey(seed)))
    block = next(iter(P["blocks"].values()))
    block["mlp"]["w1"] = _kill_columns(block["mlp"]["w1"], 0.75, 2, seed)
    if w2_spec:
        block["mlp"]["w2"] = _kill_columns(block["mlp"]["w2"], 0.5, 2,
                                           seed + 1)
    return jcfg, tcfg, P


def _jax(P):
    return jax.tree_util.tree_map(jnp.asarray, P)


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _fwd_pair(jcfg, tcfg, jp, tp, tok):
    lj, _ = j_forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    lt, _ = t_forward(tp, {"tokens": torch.from_numpy(tok).long()}, tcfg)
    return np.asarray(lj), lt


def _assert_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("w2_spec", [False, True])
def test_compact_model_matches_jax(w2_spec):
    jcfg, tcfg, P = _setup(w2_spec=w2_spec)
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    ct = TS.compact_model(params_from_numpy(P, "cpu"), tcfg.projection_specs)
    assert ct.compaction_ratios() == cj.compaction_ratios()
    assert ct.skipped == cj.skipped and ct.live == cj.live
    assert set(ct.sels) == set(cj.sels)
    for k in cj.sels:
        np.testing.assert_array_equal(ct.sels[k], cj.sels[k])
        assert ct.slot_width(k) == cj.slot_width(k)
    flat_j = {leaf_path_str(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(cj.params)[0]}
    flat_t = dict(flatten_with_path(ct.params))
    assert set(flat_t) == set(flat_j)
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert (v.dtype == torch.int32) == k.endswith("_sel"), k
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    mlp = ct.params["blocks"]["p0_global"]["mlp"]
    assert mlp["w1"].shape == mlp["w3"].shape == (2, 64, 32)
    assert mlp["w1_sel"].shape == (2, 32)
    assert ("w2_sel" in mlp) == w2_spec


@pytest.mark.parametrize("w2_spec", [False, True])
def test_compact_forward_and_decode(w2_spec):
    """Hidden-unit (w1/w3/w2 rows) and residual-output (w2 columns,
    scatter-back) compaction: the port's compact forward and decode equal
    its dense ones bit for bit, and JAX's compact ones within tolerance."""
    jcfg, tcfg, P = _setup(w2_spec=w2_spec)
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    pt = params_from_numpy(P, "cpu")
    ct = TS.compact_model(pt, tcfg.projection_specs)
    tok = _tokens(tcfg)
    lj, lc = _fwd_pair(jcfg, tcfg, cj.params, ct.params, tok)
    _, ld = _fwd_pair(jcfg, tcfg, _jax(P), pt, tok)
    _assert_bits(lc, ld)
    np.testing.assert_allclose(lc.numpy(), lj, **FWD)

    cache_j = j_init_cache(jcfg, 2, 16, jnp.float32)
    cache_c = t_init_cache(tcfg, 2, 16, torch.float32, "cpu")
    cache_d = t_init_cache(tcfg, 2, 16, torch.float32, "cpu")
    t = np.asarray([[3], [5]], np.int32)
    for pos in range(4):
        oj, cache_j = j_decode(cj.params, cache_j, jnp.asarray(t),
                               jnp.asarray(pos), jcfg)
        oc, cache_c = t_decode(ct.params, cache_c, torch.from_numpy(t).long(),
                               pos, tcfg)
        od, cache_d = t_decode(pt, cache_d, torch.from_numpy(t).long(), pos,
                               tcfg)
        _assert_bits(oc, od)
        np.testing.assert_allclose(oc.numpy(), np.asarray(oj), **DEC)


def test_jax_compact_tree_carried_across():
    """A JAX compact tree (int32 sel leaves included) carried across with
    ``params_from_numpy`` serves the port's forward."""
    jcfg, tcfg, P = _setup()
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    carried = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, cj.params), "cpu")
    sel = carried["blocks"]["p0_global"]["mlp"]["w2_sel"]
    assert sel.dtype == torch.int32
    lj, lt = _fwd_pair(jcfg, tcfg, cj.params, carried, _tokens(tcfg, seed=1))
    np.testing.assert_allclose(lt.numpy(), lj, **FWD)


def test_hybrid_compact_skips_ssm_and_matches_jax():
    """hymba's specs constrain mlp/w1 and ssm/wx: w1 compacts, ssm/wx (no
    rule) stays dense and is reported."""
    jcfg, tcfg, P = _setup("hymba_15b", w2_spec=False, seed=2)
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    pt = params_from_numpy(P, "cpu")
    ct = TS.compact_model(pt, tcfg.projection_specs)
    assert ct.skipped == cj.skipped == ("blocks/p0_hybrid/ssm/wx",)
    assert ct.compaction_ratios() == cj.compaction_ratios() == {
        "blocks/p0_hybrid/mlp/w1": 0.25}
    tok = _tokens(tcfg, S=48, seed=3)
    lj, lc = _fwd_pair(jcfg, tcfg, cj.params, ct.params, tok)
    _, ld = _fwd_pair(jcfg, tcfg, _jax(P), pt, tok)
    _assert_bits(lc, ld)
    np.testing.assert_allclose(lc.numpy(), lj, **FWD)


def test_scatter_residual_matches_dense_gemm():
    """scatter_residual(h @ w2[:, sel], sel, d) == h @ w2 bit for bit when
    the killed columns are exact zeros; JAX's scatter within 1e-6."""
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    w2 = rng.normal(size=(16, 24)).astype(np.float32)
    w2[:, ::3] = 0.0
    sel = np.flatnonzero(np.any(w2 != 0, axis=0)).astype(np.int32)
    ht, w2t = torch.from_numpy(h), torch.from_numpy(w2)
    compact = TL.scatter_residual(ht @ w2t[:, sel], torch.from_numpy(sel),
                                  24)
    _assert_bits(compact, ht @ w2t)
    want = JL.scatter_residual(jnp.asarray(h) @ jnp.asarray(w2[:, sel]),
                               jnp.asarray(sel), 24)
    np.testing.assert_allclose(compact.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_scatter_residual_adds_duplicate_padded_slots():
    """A re-compacted sel pads its tail with one dead column, repeated:
    the duplicates add exact zeros (``.add`` semantics, fault C-1)."""
    y = torch.tensor([[1.5, -2.0, 0.0, 0.0]])
    sel = torch.tensor([4, 1, 0, 0], dtype=torch.int32)
    out = TL.scatter_residual(y, sel, 6)
    _assert_bits(out, torch.tensor([[0.0, -2.0, 0.0, 0.0, 1.5, 0.0]]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        JL.scatter_residual(jnp.asarray(y.numpy()),
                            jnp.asarray(sel.numpy()), 6)))


@pytest.mark.parametrize("arch", ["mamba2_370m", "gemma_7b"])
def test_unmatched_or_refused_specs(arch):
    """mamba2's spec matches ssm/wx, which no rule covers: skipped, params
    unchanged. A spec pruning w1's other axis has no exactness argument
    and is refused."""
    jcfg, tcfg = _cfgs(arch, w2_spec=False)
    if arch == "gemma_7b":
        tcfg = dataclasses.replace(tcfg, projection_specs=(TSpec(
            pattern="blocks/.*/mlp/w1$", norm="l1inf", radius=64.0, axis=1,
            every_k=10),))
    P = jax.tree_util.tree_map(
        np.array, j_build(jcfg).init(jax.random.PRNGKey(0)))
    pt = params_from_numpy(P, "cpu")
    if arch == "gemma_7b":
        with pytest.raises(ValueError, match="exactness"):
            TS.compact_model(pt, tcfg.projection_specs)
        return
    ct = TS.compact_model(pt, tcfg.projection_specs)
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    assert ct.skipped == cj.skipped and any("ssm/wx" in p
                                            for p in ct.skipped)
    assert not ct.sels
    assert all(a is b for a, b in zip(leaves(pt), leaves(ct.params)))


def test_support_selection_matches_jax_on_stacked_leaves():
    """A stacked leaf keeps the union of its slices' supports."""
    w = np.random.default_rng(4).normal(size=(3, 16, 8)).astype(np.float32)
    w[:, 2, :] = 0.0
    w[0, 5, :] = 0.0
    P = {"enc1": {"w": w}}
    sj = JS.support_selection(_jax(P), (JSpec(pattern="enc1/w",
                                              radius=1e9, axis=1),))
    st = TS.support_selection(params_from_numpy(P, "cpu"),
                              (TSpec(pattern="enc1/w", radius=1e9, axis=1),))
    assert set(st) == set(sj) == {"enc1/w"}
    a, b = st["enc1/w"], sj["enc1/w"]
    np.testing.assert_array_equal(a.sel, b.sel)
    assert (a.col_axis, a.n_cols, a.n_selected, a.ratio) == \
        (b.col_axis, b.n_cols, b.n_selected, b.ratio) == (1, 16, 15, 15 / 16)
    assert compact_columns(params_from_numpy(P, "cpu")["enc1"]["w"], a.sel,
                           axis=a.col_axis).shape == (3, 15, 8)


def test_refresh_and_recompact_match_jax():
    """Hot refresh (new values, same support) and live re-compaction (one
    more dead unit) keep every shape; the served forward equals the dense
    one bit for bit and JAX's within tolerance; the sels equal JAX's."""
    jcfg, tcfg, P = _setup()
    cj = JS.compact_model(_jax(P), jcfg.projection_specs)
    ct = TS.compact_model(params_from_numpy(P, "cpu"), tcfg.projection_specs)
    shapes = lambda t: [tuple(a.shape) for a in leaves(t)]

    P2 = jax.tree_util.tree_map(lambda a: a * np.float32(1.5), P)
    rj = JS.refresh_model(cj, _jax(P2))
    rt = TS.refresh_model(ct, params_from_numpy(P2, "cpu"))
    assert shapes(rt.params) == shapes(ct.params)
    tok = _tokens(tcfg, seed=5)
    lj, lr = _fwd_pair(jcfg, tcfg, rj.params, rt.params, tok)
    _, ld = _fwd_pair(jcfg, tcfg, _jax(P2), params_from_numpy(P2, "cpu"),
                      tok)
    _assert_bits(lr, ld)
    np.testing.assert_allclose(lr.numpy(), lj, **FWD)

    victim = int(ct.sels[W1][0])
    P3 = jax.tree_util.tree_map(np.array, P2)
    P3["blocks"]["p0_global"]["mlp"]["w1"][:, :, victim] = 0.0
    kj = JS.recompact_model(rj, _jax(P3))
    kt = TS.recompact_model(rt, params_from_numpy(P3, "cpu"))
    assert kt.live[W1] == ct.live[W1] - 1 == kj.live[W1]
    assert kt.slot_width(W1) == ct.slot_width(W1)
    for k in kj.sels:
        np.testing.assert_array_equal(kt.sels[k], kj.sels[k])
    assert shapes(kt.params) == shapes(ct.params)
    lj, lk = _fwd_pair(jcfg, tcfg, kj.params, kt.params, tok)
    _, ld = _fwd_pair(jcfg, tcfg, _jax(P3), params_from_numpy(P3, "cpu"),
                      tok)
    _assert_bits(lk, ld)
    np.testing.assert_allclose(lk.numpy(), lj, **FWD)


def test_recompact_monotonicity():
    """Support growth raises (recompact and refresh); recompacting an
    unchanged support is the identity."""
    _, tcfg, P = _setup(w2_spec=False)
    pt = params_from_numpy(P, "cpu")
    cm = TS.compact_model(pt, tcfg.projection_specs)
    same = TS.recompact_model(cm, pt)
    np.testing.assert_array_equal(same.sels[W1], cm.sels[W1])
    for a, b in zip(leaves(cm.params), leaves(same.params)):
        _assert_bits(a, b)
    grown = jax.tree_util.tree_map(np.array, P)
    w1 = grown["blocks"]["p0_global"]["mlp"]["w1"]
    dead = next(j for j in range(w1.shape[2])
                if j not in set(cm.sels[W1].tolist()))
    w1[:, :, dead] = 1.0
    gt = params_from_numpy(grown, "cpu")
    with pytest.raises(ValueError, match="monotonicity"):
        TS.recompact_model(cm, gt)
    with pytest.raises(ValueError, match="slot set"):
        TS.refresh_model(cm, gt)


def test_recompact_full_support_w2_scatters():
    """A w2 compacted with every residual column alive (slot width = d)
    and recompacted after one column dies keeps width d but is permuted
    (live columns first, a dead one padded last): the forward still
    scatters it back and equals the dense forward bit for bit."""
    _, tcfg, P = _setup(w2_spec=False)         # w1 killed, w2 full support
    tcfg = _cfgs("gemma_7b", w2_spec=True)[1]
    W2 = "blocks/p0_global/mlp/w2"
    cm = TS.compact_model(params_from_numpy(P, "cpu"), tcfg.projection_specs)
    d = tcfg.d_model
    assert cm.live[W2] == cm.slot_width(W2) == d
    P2 = jax.tree_util.tree_map(np.array, P)
    P2["blocks"]["p0_global"]["mlp"]["w2"][:, :, 3] = 0.0
    pt2 = params_from_numpy(P2, "cpu")
    rc = TS.recompact_model(cm, pt2)
    assert rc.live[W2] == d - 1 and rc.slot_width(W2) == d
    assert rc.sels[W2][-1] == 3
    tok = _tokens(tcfg)
    lc, _ = t_forward(rc.params, {"tokens": torch.from_numpy(tok).long()},
                      tcfg)
    ld, _ = t_forward(pt2, {"tokens": torch.from_numpy(tok).long()}, tcfg)
    _assert_bits(lc, ld)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: scatter_residual's atomics and the "
                    "compact forward through the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_scatter_residual_rerun_bit_equal(card):
    g = torch.Generator(device=card).manual_seed(0)
    y = torch.randn((4, 2048, 1200), generator=g, device=card)
    sel = torch.randperm(1600, generator=g, device=card)[:1200]
    sel[1000:] = sel[999]          # padded slots: one column, repeated
    y[..., 999:] = 0.0             # ... whose contributions are zeros
    first = TL.scatter_residual(y, sel.to(torch.int32), 1600)
    for _ in range(3):
        assert torch.equal(first, TL.scatter_residual(
            y, sel.to(torch.int32), 1600))


@pytest.mark.cuda
def test_cuda_compact_forward_matches_cpu(card):
    """A reduced hymba at shapes the card's kernels take (head_dim 64, SSD
    P 64 / N 16 / chunk 64), 3/4 of its hidden units dead, compacted: its
    forward on the card (flash and SSD kernels) against the same forward
    on the CPU (plain versions)."""
    cfg = reduce_config(t_reduced("hymba_15b"), head_dim=64, ssm_headdim=64,
                        ssm_chunk=64, ssm_state=16)
    P = {k: v.numpy() for k, v in flatten_with_path(build(cfg).init(
        torch.Generator().manual_seed(3), device="cpu"))}
    w1 = "blocks/p0_hybrid/mlp/w1"
    P[w1] = _kill_columns(P[w1], 0.75, 2, 3)
    tree = {}
    for path, leaf in P.items():
        node = tree
        for key in path.split("/")[:-1]:
            node = node.setdefault(key, {})
        node[path.split("/")[-1]] = leaf
    tok = _tokens(cfg, S=128, seed=6)
    out = {}
    for dev in ("cpu", "cuda"):
        cm = TS.compact_model(params_from_numpy(tree, dev),
                              cfg.projection_specs)
        assert cm.live[w1] == cfg.d_ff // 4
        assert cm.params["blocks"]["p0_hybrid"]["mlp"]["w1_sel"].device \
            .type == dev
        out[dev], _ = t_forward(
            cm.params, {"tokens": torch.from_numpy(tok).long().to(dev)}, cfg)
    np.testing.assert_allclose(out["cuda"].cpu().numpy(), out["cpu"].numpy(),
                               **FWD)
