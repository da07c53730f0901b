"""The PD iterations of each global warp of method 1 (weighted TV-L1), the
port against faldoi_tpu, on a SIFT-seeded flow grown by the port.

At 436x1024 every global warp of the port's SIFT-seeded m1 flow stops at the
400-iteration cap.  Here the port grows an m1 flow on the CPU
(``faldoi_sift -vm 1``, its built-in SIFT matcher) from a 64x96 crop of the
same synthetic pair, whose first warp caps too, and the same flow and frames
go through JAX's ``tvl2_global`` and the port's (K5's twin inside), the
frames prepared as the stage CLI prepares them: the count of each warp must
be equal, and equal to the port's own run; the refined flows agree within
an EPE of 1e-5 px and, element by element, within 3e-5 abs (672 PD
iterations carry XLA's FMA contractions on the CPU, which the port never
makes, to 2.1e-5 abs on 6 of the 6144 elements).
JAX's counts are read from its own ``lax.while_loop`` as it runs (a debug
callback on the loop's counter, in a fresh trace).  JAX runs in the repo's
exact configuration."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EPE_TOL = 1e-5
ATOL = 3e-5    # elementwise: just above the worst measured, 2.1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
CROP = (200, 500, 64, 96)    # y0, x0, h, w in the 436x1024 synthetic pair


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def m1_flow(tmp_path_factory):
    """The crop's frames (3, h, w), the port's m1 flow of ``faldoi_sift -vm 1``
    on the CPU, and that run's stats."""
    from faldoi_tpu_torch.cli import faldoi_sift
    from faldoi_tpu_torch.io.flo import read_flo

    d = tmp_path_factory.mktemp("m1")
    y0, x0, h, w = CROP
    i0, i1, _, _ = syn.make_pair(436, 1024, seed=0)
    frames = [np.round(im[:, y0:y0 + h, x0:x0 + w]).astype(np.float32)
              for im in (i0, i1)]
    names = []
    for k, im in enumerate(frames):
        names.append(str(d / f"frame_{k}.npy"))
        np.save(names[-1], im.astype(np.uint8).transpose(1, 2, 0))
    (d / "ims.txt").write_text("\n".join(names) + "\n")
    (d / "no_binaries").mkdir()
    stats = {}
    assert faldoi_sift.main([str(d / "ims.txt"), "-vm", "1", "-device", "cpu",
                             "-bsz", "256", "-res_path", str(d) + os.sep,
                             "-bin_dir", str(d / "no_binaries")],
                            stats=stats) == 0
    return frames, read_flo(str(d / "frame_0_sift_rg.flo")), stats


def test_m1_global_iterations_match_jax(m1_flow):
    from faldoi_tpu.core import global_step as jgs
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.preprocess import prepare_triple
    from faldoi_tpu_torch.models import method_global_params

    frames, rg, run = m1_flow
    assert run["matcher"].startswith("built-in") and min(run["matches"]) > 0
    assert np.isfinite(rg).all()
    prm = P.Parameters()
    lam, theta, tau = method_global_params(P.M_TVL1_W, prm)
    warps = P.PAR_DEFAULT_NWARPS_GLOBAL          # the drivers' -warps default
    # the frames as global_faldoi prepares two of them (I-1 = I1)
    a, b, _ = prepare_triple(*frames, frames[1], device="cpu")
    stats = {}
    u1, u2 = tvl2_global(a, b, torch.as_tensor(rg[..., 0]).contiguous(),
                         torch.as_tensor(rg[..., 1]).contiguous(), lam, theta,
                         tau, prm.tol_OF, warps, stats=stats)

    counts = []
    while_loop = jax.lax.while_loop

    def counted(cond, body, init):
        out = while_loop(cond, body, init)
        jax.debug.callback(lambda n: counts.append(int(n)), out[9], ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", counted)
        # a new function object: JAX caches a trace by the function it wraps,
        # so a test run earlier in this process that traced tvl2_global at
        # these shapes would hand back that trace, without the callback
        fresh = jax.jit(functools.partial(jgs.tvl2_global.__wrapped__),
                        static_argnames=("warps", "max_iters"))
        j1, j2 = fresh(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                       jnp.asarray(rg[..., 0]), jnp.asarray(rg[..., 1]), lam,
                       theta, tau, prm.tol_OF, warps)
        jax.block_until_ready((j1, j2))
        jax.effects_barrier()
    assert counts == stats["global_iters"] == run["global_iters"]
    assert len(counts) == warps and counts[0] == P.MAX_ITERATIONS_GLOBAL
    port = torch.stack([u1, u2], -1).numpy()
    ref = np.stack([np.asarray(j1), np.asarray(j2)], -1)
    assert syn.epe(port, ref) <= EPE_TOL
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)
