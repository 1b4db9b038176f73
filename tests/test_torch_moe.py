"""``repro_torch.models.moe`` against ``repro.models.moe``.

The same numpy params (the JAX init, carried across with
``convert.params_from_numpy``) and the same numpy input through both
``moe_apply``s:

* y at atol = rtol 2e-4 (``tests/test_torch_zoo.py``'s forward tolerance:
  the combine sums a token's k slots in ascending expert id where the
  reference scatter-adds them, and the GEMMs sum in another order), the
  three auxiliaries at rtol 1e-5 / atol 1e-6 (means over T * k
  assignments in f32), and the routing equal: each token's top-k experts
  and the capacity keep mask;
* a capacity factor small enough that assignments drop: the same ones
  dropped, ``dropped_frac`` equal and above 0;
* shared experts (deepseek's always-on dense path);
* a bf16 input and bf16 experts with the f32 router of both layouts
  (y within 3e-2 of its scale, the JAX suite's bf16 flash tolerance taken
  of the output's scale: an output near zero is the difference of expert
  outputs rounded to bf16 at their own size; the routing, computed in f32
  from the same bf16 input, equal);
* the reference's ``test_moe_expert_compact_exact`` on the port: reduced
  mixtral with w1 and w2 columns killed, compacted, its forward bit-equal
  to the dense one on the CPU;
* a rerun bit-equal, and the gradient of every input through both.

* no backward that adds into a row (an index, gather or scatter-add, which
  CUDA runs with atomics) in the graph of y and the auxiliaries.

On the card (``cuda``): ``moe_apply``'s forward and backward rerun
bit-equal at mixtral's width (no atomics in the dispatch or the combine),
agree with the CPU's within 2e-4 of the output's scale, and the forward
captures into a CUDA graph (no host sync) whose replay equals an eager
call.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro.models.param import materialize as j_materialize
except ImportError:       # the card's machine has PyTorch but no JAX
    jax = None
from repro_torch._tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.constraints import ProjectionSpec
from repro_torch.models import moe as TM
from repro_torch.models.param import materialize
from repro_torch.models.zoo import build
import repro_torch.serve as TS

FWD = dict(atol=2e-4, rtol=2e-4)
AUX = dict(atol=1e-6, rtol=1e-5)
BF16 = 3e-2
D, FF = 64, 96


def _case(E=8, top_k=2, shared=0, dtype="float32", seed=0):
    """(numpy params of moe_layout, layout kwargs)."""
    kw = dict(n_shared=shared, shared_ff=FF * max(shared, 1))
    lay = JM.moe_layout(D, FF, E, **kw)
    p = j_materialize(jax.random.PRNGKey(seed), lay,
                      jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _x(B=2, S=40, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _jax_routing(P, x, E, top_k, cf):
    """The reference's routing: sorted top-k experts per token and the
    keep mask of the sorted assignments."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ jnp.asarray(P["router"], jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, top_k)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    start = jnp.searchsorted(se, jnp.arange(E), side="left")
    pos = jnp.arange(flat.shape[0]) - start[se]
    cap = JM._capacity(xf.shape[0], top_k, E, cf)
    return np.sort(np.asarray(idx), -1), np.asarray(pos < cap)


def _port_routing(tp, tx, E, top_k, cf):
    """The port's routing (the router and dispatch plan ``moe_apply``
    runs): sorted top-k experts per token and the sorted assignments'
    keep mask."""
    _, _, _, idx, _, _, keep, _ = TM._route(
        tp, tx.reshape(-1, tx.shape[-1]), E, top_k, cf, True)
    return {"idx": idx.sort(dim=-1).values, "keep": keep}


def _run(P, x, E, top_k, cf=1.25, dtype=torch.float32):
    tp = params_from_numpy(P, "cpu")
    tx = torch.from_numpy(x).to(dtype)
    y, aux = TM.moe_apply(tp, tx, n_experts=E, top_k=top_k,
                          capacity_factor=cf)
    return y, aux, _port_routing(tp, tx, E, top_k, cf)


CASES = [dict(E=8, top_k=2), dict(E=4, top_k=1), dict(E=16, top_k=6),
         dict(E=8, top_k=2, shared=1), dict(E=16, top_k=6, shared=2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_moe_apply_matches_reference(case):
    E, k = case["E"], case["top_k"]
    P = _case(E, k, case.get("shared", 0))
    x = _x()
    y, aux, route = _run(P, x, E, k)
    jy, jaux = JM.moe_apply(jax.tree_util.tree_map(jnp.asarray, P),
                            jnp.asarray(x), n_experts=E, top_k=k)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD)
    assert sorted(aux) == sorted(jaux)
    for name, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[name]), **AUX)
    idx, keep = _jax_routing(P, x, E, k, 1.25)
    np.testing.assert_array_equal(route["idx"].numpy(), idx)
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    assert ("shared" in P) == bool(case.get("shared"))


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_dropped_assignments_match_reference(cf):
    """A capacity factor that drops assignments: the same ones dropped,
    dropped_frac equal and above 0, and y still equal (a dropped slot adds
    nothing)."""
    E, k = 8, 2
    P = _case(E, k)
    x = _x(S=64)
    y, aux, route = _run(P, x, E, k, cf=cf)
    jy, jaux = JM.moe_apply(jax.tree_util.tree_map(jnp.asarray, P),
                            jnp.asarray(x), n_experts=E, top_k=k,
                            capacity_factor=cf)
    _, keep = _jax_routing(P, x, E, k, cf)
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    assert float(aux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(aux["dropped_frac"]),
                               float(jaux["dropped_frac"]), **AUX)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD)


def test_capacity_matches_reference():
    for T in (1, 2, 7, 96, 2048, 4096):
        for k, E in ((1, 4), (2, 8), (6, 160)):
            for cf in (0.25, 1.0, 1.25):
                assert TM._capacity(T, k, E, cf) == JM._capacity(T, k, E, cf)


def test_bf16_input_keeps_the_f32_router():
    """bf16 experts and input: the router stays f32 in both layouts and
    the routing is computed in f32 from the same bf16 input."""
    E, k = 8, 2
    P = _case(E, k, dtype="bfloat16")
    assert P["router"].dtype == np.float32 and P["w1"].dtype != np.float32
    tlay = TM.moe_layout(D, FF, E)
    tp = materialize(torch.Generator().manual_seed(0), tlay,
                     torch.bfloat16, "cpu")
    assert tp["router"].dtype == torch.float32
    assert tp["w1"].dtype == torch.bfloat16
    x = _x().astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    y, aux = TM.moe_apply(params_from_numpy(P, "cpu"), tx, n_experts=E,
                          top_k=k)
    route = _port_routing(params_from_numpy(P, "cpu"), tx, E, k, 1.25)
    jy, jaux = JM.moe_apply(jax.tree_util.tree_map(jnp.asarray, P),
                            jnp.asarray(x), n_experts=E, top_k=k)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    err = float(np.abs(y.float().numpy() - want).max())
    assert err <= BF16 * float(np.abs(want).max()), err
    idx, keep = _jax_routing(P, x.astype(np.float32), E, k, 1.25)
    np.testing.assert_array_equal(route["idx"].numpy(), idx)
    for name, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[name]), **AUX)


def test_rerun_and_gradients_match_reference():
    """A rerun is bit-equal; the gradients of x and of every param (the
    router's through the gates and the z / load-balance losses) match
    jax.grad of the same scalar at the zoo's gradient bound (5e-4 of each
    leaf's scale)."""
    E, k = 8, 2
    P = _case(E, k, shared=1)
    x = _x()
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_apply(p, xx, n_experts=E, top_k=k)
        return (jnp.sum(y * w) + aux["lb_loss"] + 1e-3 * aux["z_loss"])

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, P), jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(), params_from_numpy(P, "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_apply(tp, tx, n_experts=E, top_k=k)
    y2, _ = TM.moe_apply(tp, tx, n_experts=E, top_k=k)
    assert torch.equal(y, y2)
    (( y * torch.from_numpy(w)).sum() + aux["lb_loss"]
     + 1e-3 * aux["z_loss"]).backward()
    want = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict((p, t.grad.numpy()) for p, t in flatten_with_path(tp))
    got["x"], want["x"] = tx.grad.numpy(), np.asarray(jgx)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        assert float(np.abs(g - want[path]).max()) <= 5e-4 * scale, path


# backward nodes that add into a row of their input's gradient (on CUDA
# with atomics): an index or gather, whose backward is an accumulating
# index_put or a scatter_add, or an index_add / scatter_add itself
ADDING = {"IndexBackward0", "GatherBackward0", "TakeAlongDimBackward0",
          "IndexSelectBackward0", "EmbeddingBackward0", "IndexAddBackward0",
          "ScatterAddBackward0"}


def _backward_nodes(*outs):
    seen, todo, names = set(), [o.grad_fn for o in outs], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("shared", [0, 2])
def test_backward_adds_into_no_row(shared):
    """Every row gather of the dispatch and the combine goes through
    ``_take_rows``, whose backward stores and adds nothing; the dispatch's
    own write (``index_put`` without accumulation, its backward a gather)
    is the one indexed write. So the graph of y and the auxiliaries holds
    no backward that adds into a row, and none that CUDA runs with
    atomics."""
    E, k = 16, 6
    P = _case(E, k, shared)
    tp = tree_map(lambda a: a.requires_grad_(), params_from_numpy(P, "cpu"))
    tx = torch.from_numpy(_x()).requires_grad_()
    y, aux = TM.moe_apply(tp, tx, n_experts=E, top_k=k, capacity_factor=0.5)
    assert float(aux["dropped_frac"]) > 0
    names = _backward_nodes(y, *aux.values())
    assert {"_TakeRowsBackward", "IndexPutBackward0"} <= names
    assert not names & ADDING, names & ADDING


def _kill(arr, frac, axis, seed):
    rng = np.random.default_rng(seed)
    arr = np.array(arr)
    dead = rng.choice(arr.shape[axis], int(arr.shape[axis] * frac),
                      replace=False)
    idx = [slice(None)] * arr.ndim
    idx[axis] = dead
    arr[tuple(idx)] = 0.0
    return arr


def test_moe_expert_compact_exact():
    """The reference's ``test_moe_expert_compact_exact`` on the port: MoE
    expert w1/w3/w2 compaction over the stacked expert dim (union support
    across experts) reproduces the dense forward bit-exactly on the CPU."""
    cfg = get_reduced("mixtral_8x7b")
    specs = cfg.projection_specs + (ProjectionSpec(
        pattern="blocks/.*/moe/w2$", norm="l1inf", radius=64.0, axis=0,
        every_k=10),)
    cfg = dataclasses.replace(cfg, projection_specs=specs)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    moe = params["blocks"]["p0_local"]["moe"]
    # w1: (cycles, E, d, ff): kill ff columns; w2: (..., ff, d): kill d cols
    moe["w1"] = torch.from_numpy(_kill(moe["w1"].numpy(), 0.75, 3, 2))
    moe["w2"] = torch.from_numpy(_kill(moe["w2"].numpy(), 0.50, 3, 3))
    cm = TS.compact_model(params, cfg.projection_specs)
    cmoe = cm.params["blocks"]["p0_local"]["moe"]
    assert cmoe["w1"].shape[-1] == 32 and cmoe["w2"].shape[-1] == 32
    assert "w2_sel" in cmoe
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, 16)))
    dense, daux = model.forward(params, {"tokens": tokens})
    compact, caux = model.forward(cm.params, {"tokens": tokens})
    assert torch.equal(dense, compact)
    for k in daux:
        assert torch.equal(daux[k], caux[k])


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's MoE "
                    "dispatch and combine to the CPU's")
    return torch.device("cuda")


def _wide(dev, E=8, k=2, T=512):
    """mixtral's width (d 4096, d_ff 14336 cut to 2048), one layer's
    experts from the layout's init, T tokens."""
    lay = TM.moe_layout(4096, 2048, E)
    p = materialize(torch.Generator(device=dev).manual_seed(0), lay,
                    torch.float32, dev)
    x = torch.randn((1, T, 4096), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    return p, x


@pytest.mark.cuda
def test_cuda_moe_reruns_bit_equal_and_matches_cpu(card):
    p, x = _wide(card)
    g = torch.randn_like(x)

    def run(params, xx, gg):
        q = tree_map(lambda a: a.detach().requires_grad_(), params)
        xs = xx.detach().requires_grad_()
        y, aux = TM.moe_apply(q, xs, n_experts=8, top_k=2)
        grads = torch.autograd.grad(
            (y * gg).sum() + aux["lb_loss"] + aux["z_loss"],
            leaves(q) + [xs])
        return [y.detach()] + list(grads)

    a, b = run(p, x, g), run(p, x, g)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    host = run(tree_map(lambda t: t.cpu(), p), x.cpu(), g.cpu())
    for u, v in zip(a, host):
        scale = float(v.abs().max())
        assert float((u.cpu() - v).abs().max()) <= 2e-4 * scale


@pytest.mark.cuda
def test_cuda_moe_forward_captures_into_a_graph(card):
    p, x = _wide(card, T=8)
    with torch.no_grad():
        want, _ = TM.moe_apply(p, x, n_experts=8, top_k=2)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TM.moe_apply(p, x, n_experts=8, top_k=2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = TM.moe_apply(p, x, n_experts=8, top_k=2)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)
