"""The fused_sharded step on the card: 2 ranks spawned on one GPU in a gloo
group (``tests/_dist_ranks.py``; NCCL refuses two ranks on one GPU), the
same cases as ``tests/test_torch_dist_projection.py``'s fused ones, held
to the single-device ``solver="fused"`` step each rank runs on the card.

The ``adam_colstats`` and ``adam_clip_apply`` kernels launch on every
rank's column block (twice each a step: two leaves), every rank's Adam
moments are bit-equal to the single-device step's, params within 1e-5
and theta within 1e-6. This file imports no JAX (the card's machine has
none); it skips without a card.
"""
import numpy as np
import pytest
import torch

import _dist_ranks as R


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels run only there")
    return R.run_ranks("fused_sharded", 2, (2, 1),
                       tmp_path_factory.mktemp("card"), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["bilevel", "l12"])
def test_fused_sharded_on_the_card(card_ranks, norm):
    for x in card_ranks:
        r = x[norm]
        assert r["launches"] == {"adam_colstats": 2, "adam_clip_apply": 2}
        assert r["mu"][1] and r["nu"][1], (r["mu"], r["nu"])
        assert r["params"][0] <= 1e-5, r["params"]
        th_s, th_r = r["theta"]
        for k in th_r:
            np.testing.assert_allclose(th_s[k], th_r[k], rtol=1e-6,
                                       atol=1e-6)
        assert r["comm"]["all_gather"] == 0
        assert x["fallback_bit_equal"]
