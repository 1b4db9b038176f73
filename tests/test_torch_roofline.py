"""The dry-run's pieces (``repro_torch.models.param.abstract``,
``Model.abstract_params``, ``models.zoo.input_specs``,
``repro_torch.roofline``, the kernels' meta branches and ``*_cost``
functions, the meta rule of ``repro_torch._device``) against
``repro.models`` / ``repro.roofline`` on the CPU.

* ``abstract_params`` of all ten archs at full size, bf16 and f32: the
  paths, shapes and dtypes of JAX's ``abstract``, every leaf meta.
* ``input_specs`` of every supported (arch, shape) cell, the decode cache
  included, equal to JAX's ``ShapeDtypeStruct``s.
* ``model_flops_for`` / ``active_params`` equal to the reference's.
* The counter against the reference's HLO parser on
  ``tests/test_roofline.py``'s programs (a dot, a 13-trip loop, a 5 x 7
  nested loop): dot FLOPs within 1%; the byte proxy of ``(x @ x).sum()``
  in the reference's [3n, 10n].
* Ring bytes on a fake group of 16 ranks, a (4, 4) mesh: the reference's
  synthetic all-reduce of 1024 f32 over 4 ranks at 2 (3/4) 4096 bytes and
  an all-gather at (3/4) of its result.
* Each kernel wrapper on meta tensors: outputs of its plain version's
  shapes and dtypes (the plain version run on the CPU), no launch count
  moved, one launch recorded at its ``*_cost``; a CPU call records none.
* The cost functions reproduce ``PERF.md`` section 6's bound column
  within 1% (colstats at sae_enc1, the bf16 flash forward at hymba-1.5b's
  prefill, the bf16 flash backward at stablelm-3b's training shape,
  ``ssd_bwd`` at hymba-1.5b's).
* On meta the Newton runs exactly ``max_iter`` evaluations, and
  ``newton_loop`` takes the card's branch on the rows
  (``NEWTON_LOOP_MAX_ROWS``, the CUDA source's ``kRegRows``).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import zoo as JZ
from repro.roofline import analysis as JA
from repro.roofline.hlo_parse import parse_hlo
from repro_torch import configs as TC
from repro_torch._tree import flatten_with_path
from repro_torch.core.l1inf import project_l1inf_newton_stats
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.fused_step import kernel as FK
from repro_torch.kernels.l1inf import kernel as K
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.models import zoo as TZ
from repro_torch.roofline import analysis as TA
from repro_torch.roofline.counter import Counter

_DT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
       torch.int32: jnp.int32}
CELLS = [(a, s) for a in TC.ARCH_IDS for s in TZ.SHAPES
         if TZ.cell_supported(TC.get_config(a), s)[0]]


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", k)) for k in path),
             tuple(leaf.shape), jnp.dtype(leaf.dtype)) for path, leaf in flat]


def _torch_flat(tree):
    out = []
    for path, leaf in flatten_with_path(tree):
        assert leaf.device.type == "meta", path
        out.append((path, tuple(leaf.shape), jnp.dtype(_DT[leaf.dtype])))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_abstract_params_match_reference(arch, dtype):
    """Every leaf of the full-size model as a meta tensor with JAX's
    path, shape and dtype."""
    got = TZ.build(TC.get_config(arch)).abstract_params(dtype)
    want = JZ.build(JC.get_config(arch)).abstract_params(_DT[dtype])
    assert _torch_flat(got) == _jax_flat(want)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every input of the cell (a decode cell's cache tree included) as a
    meta tensor with JAX's path, shape and dtype."""
    got = TZ.input_specs(TC.get_config(arch), shape)
    want = JZ.input_specs(JC.get_config(arch), shape)
    assert _torch_flat(got) == _jax_flat(want)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_model_flops_and_active_params_match_reference(arch):
    model, jmodel = TZ.build(TC.get_config(arch)), JZ.build(
        JC.get_config(arch))
    n = model.n_params()
    assert n == jmodel.n_params()
    act = TA.active_params(model.cfg, n)
    assert act == JA.active_params(jmodel.cfg, n)
    for shape in TZ.SHAPES:
        assert TA.model_flops_for(model.cfg, shape, n, act) == \
            JA.model_flops_for(jmodel.cfg, shape, n, act)


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _counted(fn, *args):
    with Counter() as c:
        fn(*args)
    return c.counts


def test_counter_single_dot_matches_parser():
    a, b = np.zeros((128, 256), np.float32), np.zeros((256, 64), np.float32)
    want = parse_hlo(_hlo(lambda x, y: x @ y, a, b)).dot_flops
    got = _counted(lambda x, y: x @ y, torch.empty(128, 256, device="meta"),
                   torch.empty(256, 64, device="meta")).dot_flops
    assert got == 2 * 128 * 256 * 64
    assert abs(got - want) <= 0.01 * want


def test_counter_loop_matches_parser_trip_count():
    """A Python loop of 13 products counts 13 of them, as the parser
    multiplies the scan's body by its trip count."""
    T = 13

    def jfn(x, w):
        return jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0]

    def tfn(x, w):
        for i in range(T):
            x = torch.tanh(x @ w[i])
        return x

    want = parse_hlo(_hlo(jfn, np.zeros((8, 64), np.float32),
                          np.zeros((T, 64, 64), np.float32))).dot_flops
    got = _counted(tfn, torch.empty(8, 64, device="meta"),
                   torch.empty(T, 64, 64, device="meta")).dot_flops
    assert got == T * 2 * 8 * 64 * 64
    assert abs(got - want) <= 0.01 * want


def test_counter_nested_loop_matches_parser():
    T1, T2 = 5, 7

    def jfn(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                length=T2)[0], None
        return jax.lax.scan(outer, x, None, length=T1)[0]

    def tfn(x, w):
        for _ in range(T1):
            for _ in range(T2):
                x = x @ w
        return x

    want = parse_hlo(_hlo(jfn, np.zeros((4, 32), np.float32),
                          np.zeros((32, 32), np.float32))).dot_flops
    got = _counted(tfn, torch.empty(4, 32, device="meta"),
                   torch.empty(32, 32, device="meta")).dot_flops
    assert got == T1 * T2 * 2 * 4 * 32 * 32
    assert abs(got - want) <= 0.01 * want


def test_counter_bytes_proxy_anchored_on_products():
    """The product counts its operands and result, the sum its operand
    and result; the reference's bound [3n, 10n]."""
    n = 512 * 512 * 4
    got = _counted(lambda x: (x @ x).sum(),
                   torch.empty(512, 512, device="meta")).bytes_proxy
    assert 3 * n <= got <= 10 * n, got


def test_collective_ring_bytes_on_a_fake_group():
    """The reference's synthetic HLO (tests/test_roofline.py): an
    all-reduce of 1024 f32 over a group of 4 moves 2 (3/4) 4096 bytes, an
    all-gather to 4096 f32 (3/4) of its result; the group size comes from
    the process group the collective ran on."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    with fake_group(16):
        mesh = make_local_mesh(4, 4, device="cpu")
        x = torch.empty(1024, device="meta")
        with Counter() as c:
            dist.all_reduce(x, group=mesh.get_group("model"))
            out = torch.empty(4096, device="meta")
            dist.all_gather_into_tensor(out, x, group=mesh.get_group("data"))
    assert c.counts.collectives == [("all-reduce", 4096, 4),
                                    ("all-gather", 16384, 4)]
    st = TA.collective_stats(c.counts.collectives)
    assert st.counts == {"all-reduce": 1, "all-gather": 1}
    assert abs(st.bytes_by_kind["all-reduce"] - 2 * 0.75 * 4096) < 1
    assert abs(st.bytes_by_kind["all-gather"] - 0.75 * 16384) < 1


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _meta(*ts):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            if isinstance(t, torch.Tensor) else
            tuple(_meta(*t)) if isinstance(t, tuple) else t for t in ts]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)] if isinstance(
        out, (tuple, list)) else []


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(
        *s, generator=g).to(dt)
    Y = r(24, 16)
    A = Y.abs()
    mu = A.amax(0) * 0.5
    sids = torch.zeros(16, dtype=torch.int32)
    colsum = A.sum(0)
    one = torch.ones(1)
    nact = torch.full((1,), 16, dtype=torch.int32)
    sc = torch.tensor([1.0, 1e-3, 0.1, 0.001])
    p3 = r(2, 8, 12)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0, transpose=False)
    cases = [
        ("colstats", K.colstats, (Y,), {}, K.colstats_cost(24, 16)),
        ("mu_solve", K.mu_solve, (A, torch.tensor(1.0)), dict(block_m=8),
         K.mu_solve_cost(24, 16, 16)),
        ("clip_apply", K.clip_apply, (Y, mu), {}, K.clip_apply_cost(24, 16)),
        ("clip_apply", K.clip_apply, (Y.bfloat16(), mu), {},
         K.clip_apply_cost(24, 16, 2)),
        ("newton_loop", K.newton_loop,
         (A, sids, colsum, 0.5 * one, one, nact),
         dict(num_segments=1, block_m=8, max_newton=6),
         K.newton_loop_cost(24, 16, 5 * 16)),
        ("adam_colstats", FK.adam_colstats,
         (sc, p3, p3 * 0, p3 * 0, p3), kw,
         FK.adam_colstats_cost(2, 8, 12, False)),
        ("adam_clip_apply", FK.adam_clip_apply,
         (sc, p3, p3.abs(), p3, torch.ones(2, 12)), kw,
         FK.adam_clip_apply_cost(2, 8, 12, False)),
    ]
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = r(4, 40, 16, dt=dt), r(2, 40, 16, dt=dt), r(2, 40, 16,
                                                              dt=dt)
        akw = dict(groups=2, causal=True, window=8)
        size = q.element_size()
        out, lse = FA.flash_attention_fwd_plain(q, k, v, **akw,
                                                return_lse=True)
        cases += [
            ("flash_attention_fwd", FA.flash_attention_fwd, (q, k, v), akw,
             FA.flash_attention_fwd_cost(4, 40, 40, 16, 2, True, 8, size)),
            ("flash_attention_bwd", FA.flash_attention_bwd,
             (q, k, v, out, r(4, 40, 16, dt=dt), lse), akw,
             FA.flash_attention_bwd_cost(4, 40, 40, 16, 2, True, 8, size))]
    x, dt_, a, d = r(4, 32, 8), r(4, 32).abs() * 0.1, -r(4).abs(), r(4)
    B, C = r(2, 32, 8), r(2, 32, 8)
    skw = dict(chunk=8, groups=2)
    y, st, saved = SK.ssd_fwd_plain(x, dt_, a, d, B, C, **skw,
                                    return_saved=True)
    cases += [
        ("ssd_fwd", SK.ssd_fwd, (x, dt_, a, d, B, C), skw,
         SK.ssd_fwd_cost(4, 32, 8, 8, 8, 2)),
        ("ssd_fwd", SK.ssd_fwd, tuple(t.bfloat16() if t.ndim > 1 else t
                                      for t in (x, dt_, a, d, B, C)), skw,
         SK.ssd_fwd_cost(4, 32, 8, 8, 8, 2, 2)),
        ("ssd_bwd", SK.ssd_bwd, (x, dt_, a, d, B, C, r(4, 32, 8), None,
                                 saved), skw,
         SK.ssd_bwd_cost(4, 32, 8, 8, 8, 2))]
    return cases


@pytest.mark.parametrize("case", range(len(_kernel_cases())))
def test_kernel_meta_branch_takes_the_shape_rule(case):
    """On meta inputs a wrapper returns its plain version's shapes and
    dtypes (integer counters as integers), records one launch at its cost and moves no launch count;
    on CPU inputs it records nothing."""
    name, fn, args, kw, cost = _kernel_cases()[case]
    counts = (K.launch_counts(), FK.launch_counts(), FA.launch_counts(),
              SK.launch_counts())
    with Counter() as c:
        want = fn(*args, **kw)
    assert c.counts.kernels == {}
    with Counter() as c:
        got = fn(*_meta(*args), **kw)
    assert c.counts.kernels == {name: {"launches": 1,
                                       "operations": float(cost[0]),
                                       "bytes": float(cost[1])}}
    # integer counters as the card returns them: newton_loop's work count
    # is the kernel's int64 stats entry, the plain loop's an int32
    kind = lambda t: (tuple(t.shape), t.dtype if t.is_floating_point()
                      or t.dtype == torch.bool else "int")
    assert list(map(kind, _flat(got))) == list(map(kind, _flat(want)))
    assert all(t.device.type == "meta" for t in _flat(got))
    assert counts == (K.launch_counts(), FK.launch_counts(),
                      FA.launch_counts(), SK.launch_counts())


@pytest.mark.parametrize("what,cost,dtype,bound", [
    ("colstats, sae_enc1", K.colstats_cost(96, 10112), torch.float32,
     0.00118),
    ("bf16 flash forward, hymba-1.5b prefill",
     FA.flash_attention_fwd_cost(50, 2048, 2048, 64, 5, True, 1024, 2),
     torch.bfloat16, 0.0204),
    ("bf16 flash backward, stablelm-3b",
     FA.flash_attention_bwd_cost(32, 2048, 2048, 80, 1, True, 0, 2),
     torch.bfloat16, 0.0543),
    ("ssd_bwd, hymba-1.5b", SK.ssd_bwd_cost(50, 2048, 64, 16, 64, 50),
     torch.float32, 0.0284)])
def test_cost_reproduces_perf_bound(what, cost, dtype, bound):
    """PERF.md section 6's bound column, from the kernels' cost functions."""
    ms, _ = TA.kernel_bound_ms(cost, dtype)
    assert abs(ms - bound) <= 0.01 * bound, (what, ms)


@pytest.mark.parametrize("max_iter", [5, 32])
def test_meta_newton_runs_its_cap(max_iter):
    """A data-dependent loop takes its cap on meta (the reference's count
    for an early-exit while loop): max_iter Eq.-(19) evaluations."""
    Y = torch.empty(64, 48, device="meta")
    X, stats = project_l1inf_newton_stats(Y, 1.0, max_iter=max_iter)
    assert stats["iters"] == max_iter
    assert X.shape == Y.shape and X.device.type == "meta"


def test_newton_loop_row_limit_is_the_kernels():
    """``NEWTON_LOOP_MAX_ROWS`` is ``kRegRows`` of the CUDA source (what
    ``l1inf_newton_loop_max_rows()`` returns on the card)."""
    path = os.path.join(os.path.dirname(K.__file__), "..", "..", "csrc",
                        "l1inf.cu")
    src = open(path).read()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     src).group(1))
    assert "kRegRows = kMaxCluster * kSlabRows;" in src
    assert K.NEWTON_LOOP_MAX_ROWS == get("kMaxCluster") * get("kSlabRows")


@pytest.mark.parametrize("tall", [False, True])
def test_meta_newton_loop_takes_the_cards_row_branch(tall):
    """On meta ``newton_loop`` branches on the rows as the card does: up
    to ``NEWTON_LOOP_MAX_ROWS`` one loop launch at its cap; past it the
    host loop over ``mu_solve``, max_newton launches at the cap (pass 2,
    max_newton - 2 evaluations, the cap exit's re-evaluation)."""
    n, m, cap = K.NEWTON_LOOP_MAX_ROWS + int(tall), 16, 6
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt,
                                                    device="meta")
    args = (meta(n, m), meta(m, dt=torch.int32), meta(m), meta(1), meta(1),
            meta(1, dt=torch.int32))
    with Counter() as c:
        out = K.newton_loop(*args, num_segments=1, block_m=8,
                            max_newton=cap)
    if tall:
        cost = K.mu_solve_cost(n, m, m)
        want = {"mu_solve": {"launches": cap,
                             "operations": float(cap * cost[0]),
                             "bytes": float(cap * cost[1])}}
    else:
        cost = K.newton_loop_cost(n, m, (cap - 1) * m)
        want = {"newton_loop": {"launches": 1, "operations": float(cost[0]),
                                "bytes": float(cost[1])}}
    assert c.counts.kernels == want
    assert [tuple(t.shape) for t in out[:2]] == [(1,), (m,)]
