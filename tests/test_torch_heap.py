"""The port's host oracles (``repro_torch.core.heap`` and ``.baselines``:
the paper's Algorithms 2 and 1, the Quattoni and Bejar baselines and the
numpy Newton) against ``repro.core``'s, and the port's sorted projection
against Algorithm 2 (fault C-10).

The oracles are numpy copies, float64 on the host, so on the same input
they must return the same arrays bit for bit. A CPU tensor is read through
``np.asarray``, so it gives the numpy answer too.

Fault C-10: the sorted projection kept Eq. (19)'s running sums A and B in
float32. Near theta* only a few columns live, so B is a few thousandths
while A starts near m; rounded to float32 (ulp ~ 1e-3 at 10^4), the
candidate theta of every segment can miss it, the first-valid search then
fell back to segment 0 (theta ~ 0), and a 4-step polish from there stays
far below theta*. The CPU cases below are U(0, 1) draws on which float32
sums leave no valid segment (outside the tolerance before the float64
sums); the ``cuda`` cases are paper Fig. 2's shapes on the card,
with the numpy draw of ``chip_smoke.py`` phase 3 and with ``torch.rand``.
Tolerance: ``tests/test_kernels_l1inf.py``'s projection tolerance, atol
3e-4 * scale, rtol 3e-3.
"""
import numpy as np
import pytest
import torch

try:
    import repro.core as JC
except ImportError:       # the card's machine has PyTorch but no JAX
    JC = None
import repro_torch.core as TC
from repro_torch.core import baselines as TB
from repro_torch.core import heap as TH

PROJ = dict(atol=3e-4, rtol=3e-3)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "normal_64x30": (rng.normal(size=(64, 30)), 2.0),
        "uniform_40x120": (rng.uniform(0, 1, size=(40, 120)), 1.0),
        "sparse_high_C": (rng.normal(size=(20, 50)) * (rng.uniform(
            size=(20, 50)) < 0.3), 5.0),
        "one_column": (rng.normal(size=(30, 1)), 0.5),
        "one_row": (rng.normal(size=(1, 25)), 3.0),
        "inside": (rng.normal(size=(10, 8)) * 1e-3, 100.0),
        "zero_radius": (rng.normal(size=(10, 8)), 0.0),
        "float32": (rng.normal(size=(50, 40)).astype(np.float32), 4.0),
    }


INPUTS = _inputs()
ORACLES = ["project_l1inf_heap", "project_l1inf_naive", "theta_l1inf_heap",
           "project_l1inf_quattoni", "project_l1inf_bejar",
           "project_l1inf_newton_np"]


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("oracle", ORACLES)
def test_oracle_equals_repro(oracle, name):
    Y, C = INPUTS[name]
    got = getattr(TC, oracle)(Y, C)
    want = getattr(JC, oracle)(Y, C)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("oracle", ["project_l1inf_heap",
                                    "project_l1inf_quattoni"])
def test_oracle_reads_a_cpu_tensor(oracle):
    Y, C = INPUTS["float32"]
    got = getattr(TC, oracle)(torch.from_numpy(Y), C)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, getattr(JC, oracle)(Y, C))


def test_oracles_agree_with_each_other():
    Y, C = INPUTS["normal_64x30"]
    want = TH.project_l1inf_heap(Y, C)
    for fn in (TH.project_l1inf_naive, TB.project_l1inf_quattoni,
               TB.project_l1inf_bejar, TB.project_l1inf_newton_np):
        np.testing.assert_allclose(fn(Y, C), want, atol=1e-10)
    assert np.abs(want).max(axis=0).sum() == pytest.approx(C, rel=1e-12)


def _assert_sorted_exact(Y, C):
    Xh = torch.from_numpy(TH.project_l1inf_heap(
        Y.detach().cpu().double().numpy(), C)).float()
    X = TC.project_l1inf_sorted(Y, C).cpu()
    scale = max(float(Y.abs().max()), 1.0)
    torch.testing.assert_close(X, Xh, atol=PROJ["atol"] * scale,
                               rtol=PROJ["rtol"])


@pytest.mark.parametrize("shape,seed,C", [((2000, 500), 0, 1.0),
                                          ((1000, 1000), 1, 1.0),
                                          ((4000, 500), 0, 0.5)])
def test_sorted_exact_where_float32_sums_find_no_segment(shape, seed, C):
    Y = np.random.default_rng(seed).uniform(0, 1, size=shape)
    _assert_sorted_exact(torch.from_numpy(Y.astype(np.float32)), C)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: holds the sorted projection to the "
                    "heap oracle on the card (fault C-10)")
    return torch.device("cuda")


def _fig2(card, shape, draw):
    if draw == "torch_rand":
        return torch.rand(shape, device=card,
                          generator=torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(0)          # chip_smoke.py phase 3's draw
    wide = rng.uniform(0, 1, size=(1000, 10000))
    Y = wide if shape == (1000, 10000) else rng.uniform(0, 1, size=shape)
    return torch.from_numpy(Y.astype(np.float32)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["numpy", "torch_rand"])
@pytest.mark.parametrize("shape", [(1000, 10000), (10000, 1000)])
def test_cuda_sorted_matches_heap_at_fig2(card, shape, draw):
    _assert_sorted_exact(_fig2(card, shape, draw), 1.0)
