"""The GPipe ring (``repro_torch.dist.pipeline.build_pipeline_fn``) on
spawned gloo rank groups on the CPU (``tests/_dist_ranks.py``), as the
reference's ``tests/test_pipeline_compression.py::test_pipeline_matches_
sequential`` and ``tests/test_dist_units.py:255-271``:

* 2 stages (a (2, 1) mesh, axis "data", 3 microbatches) and 4 stages (a
  (4, 1) mesh, 8 microbatches) against applying the stages in order, on
  every rank, within 1e-5;
* one stage (a one-rank mesh) is the stage applied to every microbatch;
* a mesh axis whose size is not n_stages raises ValueError.
"""
import numpy as np
import pytest

import _dist_ranks as R


def _sequential(out):
    ref = out["x"].copy()
    for s in range(out["w"].shape[0]):
        ref = np.tanh(ref @ out["w"][s])
    return ref


@pytest.mark.parametrize("shape,n_micro", [((2, 1), 3), ((4, 1), 8),
                                           ((1, 1), 5)])
def test_pipeline_matches_sequential(tmp_path, shape, n_micro):
    res = R.run_ranks("pipeline_run", shape[0] * shape[1], shape, tmp_path,
                      n_micro=n_micro)
    ref = _sequential(res[0])
    for r in res:
        np.testing.assert_allclose(r["y"], ref, atol=1e-5)


def test_pipeline_rejects_wrong_mesh(tmp_path):
    res = R.run_ranks("pipeline_wrong_axis", 2, (2, 1), tmp_path)
    assert all(r is not None and "n_stages" in r for r in res)
