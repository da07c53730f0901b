"""The NLTV-CSAD slice of the port against faldoi_tpu's fused run: seeds ->
``match_growing`` -> ``global_refine`` for method 6 (warm requeue), on a
20x28 crop of the synthetic pair, cut as the TV-CSAD slice is
(``test_torch_csad_slice.py``, whose helper this file shares).  JAX runs in
the repo's exact configuration.  The flows are held by EPE against JAX's
(rg <= 0.05 px, var <= 0.01 px, 100% fill in both) and the occlusion masks
must be equal."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn
from tests.test_torch_csad_slice import EXACT_ENV, LOC_IT, csad_slice

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def test_nltvcsad_slice_matches_jax():
    """Method 6 (measured: rg 1.3e-4 px, var 5.2e-3 px)."""
    jrg, jvar, jocc, prg, pvar, occ, stats, gf, k8 = csad_slice(
        P.M_NLTVCSAD, 20, 28, 121)
    assert k8 == 0                                   # the twin ran
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()    # 100% fill
    assert syn.epe(prg, jrg) <= 0.05
    assert syn.epe(pvar, jvar) <= 0.01
    assert syn.epe(pvar, gf) < 1.5 and syn.epe(jvar, gf) < 1.5
    assert len(stats["sweeps"]) == 2 * LOC_IT + 1
    assert stats["global_iters"] == [P.MAX_ITERATIONS_GLOBAL] * 5
    np.testing.assert_array_equal(occ, jocc)
