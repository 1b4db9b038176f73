"""The fixed-order scan of ``repro_torch.core.simplex`` and the sort-based
paths that use it.

On a CUDA tensor ``torch.cumsum`` over every element (a 1-D scan) goes
through CUB's decoupled look-back scan, whose float sums depend on which
tiles finish first, so reruns of the sort-based projections differed in the
last bits on the card (``project_l1inf_sorted`` at paper Fig. 2's shapes
and ``project_l1_ball`` of a 10^7-element buffer). ``cumsum_in_order``
runs those scans as rows plus carries, both scans torch runs in a fixed
order, in float64 as torch's CPU scan accumulates. On the CPU it is
``torch.cumsum`` itself, so the CPU parity tests against JAX are
untouched; here its blocked form is held against a float64 cumsum (rtol
1e-5, the f32 scan's own error at these lengths).

Tests marked ``cuda`` rerun each changed path on the card and require
bit-equal results; they skip here, with the reason, when no card is
present.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bilevel import project_bilevel_ref
from repro_torch.core.l1inf import project_l1inf_newton, project_l1inf_sorted
from repro_torch.core.norms import project_l12_ball
from repro_torch.core.simplex import (_blocked_cumsum, cumsum_in_order,
                                      project_l1_ball)


@pytest.mark.parametrize("n", [2, 3, 17, 1000, 10007])
def test_blocked_cumsum_matches_float64(n):
    v = np.random.default_rng(n).uniform(-1, 1, size=n).astype(np.float32)
    got = _blocked_cumsum(torch.from_numpy(v)).numpy()
    want = np.cumsum(v.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(v).sum())


@pytest.mark.parametrize("shape,dim", [((7,), 0), ((5, 4), 0), ((5, 4), 1),
                                       ((1, 9), 1)])
def test_cumsum_in_order_is_torch_cumsum_on_cpu(shape, dim):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=shape).astype(np.float32))
    assert torch.equal(cumsum_in_order(x, dim=dim), torch.cumsum(x, dim=dim))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rerun checks are about CUDA's "
                    "scan")
    return torch.device("cuda")


def _fig2_wide(card):
    g = torch.Generator(device=card).manual_seed(0)
    return torch.rand((1000, 10000), generator=g, device=card)


CHANGED = {
    "sorted": lambda Y: project_l1inf_sorted(Y, 1.0),
    "l1_ball": lambda Y: project_l1_ball(Y, 100.0),
    "l12_ball": lambda Y: project_l12_ball(Y, 10.0),
    "bilevel_ref": lambda Y: project_bilevel_ref(Y, 10.0),
    "newton_one_column": lambda Y: project_l1inf_newton(
        Y.reshape(-1, 1), 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(CHANGED))
def test_cuda_rerun_bit_equal(card, path):
    Y = _fig2_wide(card)
    first = CHANGED[path](Y)
    for _ in range(3):
        assert torch.equal(first, CHANGED[path](Y))


@pytest.mark.cuda
def test_cuda_blocked_scan_agrees_with_cumsum(card):
    v = _fig2_wide(card).reshape(-1) - 0.5
    got = cumsum_in_order(v)
    want = torch.cumsum(v.double(), dim=0).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
