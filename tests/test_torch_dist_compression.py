"""The port's gradient compression (``repro_torch.dist.compression``)
against ``repro.dist.compression``.

* The pieces on the same numpy inputs as ``tests/test_dist_units.py``'s
  cases: int8 quantization (q and scale bit-equal to JAX's, the scale / 2
  bound, zero input, a shared scale), top-k (values and indices equal to
  JAX's, the dense scatter), error feedback (the exact split, the
  telescoping residual).
* ``compressed_psum`` over spawned gloo groups of 2 ranks and 4 (2 x 2),
  each rank with its own partial gradients (``tests/_dist_ranks.py``):
  "none" within float32 summation order of the exact sum; "int8" bit-equal
  to the JAX functions' shared-scale quantize, int32 sum and dequantize,
  and within P * scale / 2 of the exact sum; "topk" bit-equal to JAX's
  ``.at[idx].add`` of every rank's pairs in rank order; every rank holds
  the same result. Collectives: "none" one all-reduce a leaf and no
  all-gather; int8 its one-byte payload all-gathered by design, beside a
  MAX all-reduce for the scale; top-k two all-gathers a leaf.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.dist import compression as JD
from repro_torch.dist import compression as TD

import _dist_ranks as R


@pytest.mark.parametrize("shape", [(7,), (64,), (16, 16), (3, 5, 2)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_int8_matches_jax(shape, scale):
    x = (np.random.default_rng(0).normal(size=shape) * scale).astype(
        np.float32)
    qj, sj = JD.int8_quantize(jnp.asarray(x))
    qt, st = TD.int8_quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    xr = TD.int8_dequantize(qt, st)
    np.testing.assert_array_equal(xr.numpy(),
                                  np.asarray(JD.int8_dequantize(qj, sj)))
    np.testing.assert_allclose(xr.numpy(), x, atol=float(st) * 0.5 + 1e-12)
    assert int(qt.abs().max()) == (127 if np.abs(x).max() > 0 else 0)


def test_int8_zero_input_and_shared_scale():
    q, s = TD.int8_quantize(torch.zeros(8))
    assert torch.equal(TD.int8_dequantize(q, s), torch.zeros(8))
    x = np.asarray([-3.0, 0.5, 2.0], np.float32)
    shared = np.float32(np.abs(x).max() / 127.0)
    q1, _ = TD.int8_quantize(torch.from_numpy(x))
    q2, _ = TD.int8_quantize(torch.from_numpy(x), torch.tensor(shared))
    qj, _ = JD.int8_quantize(jnp.asarray(x), jnp.asarray(shared))
    np.testing.assert_array_equal(q1.numpy(), q2.numpy())
    np.testing.assert_array_equal(q2.numpy(), np.asarray(qj))


@pytest.mark.parametrize("n,k_frac", [(64, 0.25), (100, 0.05), (7, 0.5),
                                      (5, 1.0)])
def test_topk_matches_jax(n, k_frac):
    g = np.random.default_rng(1).normal(size=(n,)).astype(np.float32)
    vj, ij = JD.topk_compress(jnp.asarray(g), k_frac)
    vt, it = TD.topk_compress(torch.from_numpy(g), k_frac)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    rec = TD.topk_decompress(vt, it, g.shape, torch.float32)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(JD.topk_decompress(vj, ij, g.shape,
                                                   jnp.float32)))


def test_topk_2d_uses_flat_indices():
    g = torch.tensor([[0.0, 5.0], [-7.0, 1.0]])
    vals, idx = TD.topk_compress(g, 0.5)
    rec = TD.topk_decompress(vals, idx, g.shape, g.dtype)
    assert torch.equal(rec, torch.tensor([[0.0, 5.0], [-7.0, 0.0]]))


def test_ef_step_matches_jax():
    g = np.asarray([4.0, -1.0, 0.5, 3.0], np.float32)
    err0 = np.asarray([0.0, 2.5, 0.0, 0.0], np.float32)
    sj, ej = JD.ef_step(jnp.asarray(g), jnp.asarray(err0), k_frac=0.5)
    st, et = TD.ef_step(torch.from_numpy(g), torch.from_numpy(err0), 0.5)
    np.testing.assert_array_equal(st.numpy(), [4.0, 0.0, 0.0, 3.0])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_ef_residual_telescopes():
    rng = np.random.default_rng(2)
    gs = [rng.normal(size=(64,)).astype(np.float32) for _ in range(10)]
    err, sent = torch.zeros(64), torch.zeros(64)
    err_j = jnp.zeros((64,), jnp.float32)
    for g in gs:
        sparse, err = TD.ef_step(torch.from_numpy(g), err, k_frac=0.125)
        sj, err_j = JD.ef_step(jnp.asarray(g), err_j, k_frac=0.125)
        np.testing.assert_array_equal(sparse.numpy(), np.asarray(sj))
        assert int((sparse != 0).sum()) == 8
        sent = sent + sparse
    np.testing.assert_allclose((sent + err).numpy(), np.sum(gs, axis=0),
                               atol=1e-4)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        TD.compressed_psum({"g": torch.ones(4)}, None, mode="fp4")


MESHES = [(2, 1), (2, 2)]
K_FRAC = 0.05


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp(f"compress{shape[0]}x{shape[1]}")
        out[shape] = R.run_ranks("compression", shape[0] * shape[1], shape,
                                 work, k_frac=K_FRAC)
    return out


def _partials(rs):
    return {k: [r["partial"][k] for r in rs] for k in rs[0]["partial"]}


@pytest.mark.parametrize("shape", MESHES)
def test_psum_none_is_the_sum(groups, shape):
    rs = groups[shape]
    for k, parts in _partials(rs).items():
        want = np.sum(np.asarray(parts, np.float64), axis=0)
        for r in rs:
            got = r["none"][0][k]
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
            assert np.array_equal(got, rs[0]["none"][0][k])
        assert rs[0]["none"][1] == {"all_reduce": 2, "all_to_all": 0,
                                    "all_gather": 0}


@pytest.mark.parametrize("shape", MESHES)
def test_psum_int8_matches_jax_and_bound(groups, shape):
    rs = groups[shape]
    P = len(rs)
    for k, parts in _partials(rs).items():
        absmax = max(float(np.abs(p).max()) for p in parts)
        scale_in = jnp.asarray(np.float32(absmax) / np.float32(127.0))
        qs = [JD.int8_quantize(jnp.asarray(p), scale_in) for p in parts]
        total = sum(np.asarray(q, np.int32) for q, _ in qs)
        want = np.asarray(JD.int8_dequantize(jnp.asarray(total), qs[0][1]))
        exact = np.sum(np.asarray(parts, np.float64), axis=0)
        for r in rs:
            got = r["int8"][0][k]
            np.testing.assert_array_equal(got, want)
            assert np.abs(got - exact).max() <= P * float(qs[0][1]) / 2 + \
                1e-6 * np.abs(exact).max()
    # the scale's MAX all-reduce and the int8 payload's all-gather, a leaf
    assert rs[0]["int8"][1] == {"all_reduce": 2, "all_to_all": 0,
                                "all_gather": 2}


@pytest.mark.parametrize("shape", MESHES)
def test_psum_topk_is_the_rank_ordered_scatter(groups, shape):
    rs = groups[shape]
    for k, parts in _partials(rs).items():
        flat = jnp.zeros((parts[0].size,), jnp.float32)
        for p in parts:                               # rank order
            v, i = JD.topk_compress(jnp.asarray(p), K_FRAC)
            flat = flat.at[i].add(v)
        want = np.asarray(flat).reshape(parts[0].shape)
        for r in rs:
            np.testing.assert_array_equal(r["topk"][0][k], want)
    assert rs[0]["topk"][1] == {"all_reduce": 0, "all_to_all": 0,
                                "all_gather": 4}
