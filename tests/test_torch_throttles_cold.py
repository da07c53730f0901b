"""The growing's throttles of the port against faldoi_tpu's: the m0 growing
of ``test_torch_throttles.py`` with the cold requeue (``warm_band`` 0) and a
late floor scale of 4 (JAX: ``FALDOI_GROW_WARM_BAND=0``,
``FALDOI_GROW_FS_LATE=4``), in a file of its own so that xdist runs its JAX
growing beside the warm one.  JAX runs in the repo's exact configuration."""

import pytest
import torch

from tests.test_torch_throttles import EXACT_ENV, check_growing, growing_case

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def test_growing_throttles_match_jax_cold():
    """Cold requeue, the late floor scale 4 against floor_scale 8."""
    check_growing(*growing_case(0, 4))
