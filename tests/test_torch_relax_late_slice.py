"""The port's parity-frontier growing, ``match_growing(warm_band=0,
relax_late=True, polish=1)``, against JAX's chunked loop in its own order
(match_growing.py:857-903): per outer iteration the fwd and bwd drains
(relax from iteration 1 on), a ``polish_all`` pass of each lane from
iteration 1 on, the prune and cold requeue; then the final forward drain in
relax mode and its polish.  JAX's chunked path itself waits on a compile
thread (its rung ladder) and does not reproduce, and its fused path ignores
``FALDOI_GROW_RELAX_LATE`` and ``FALDOI_GROW_POLISH``; so the test composes
JAX's own pieces: ``LocalSolver(mode="fused")`` drains, ``polish_all`` and
``_prune_requeue_pair``.  A synthetic 45x61 pair, 30 seeds a lane, bsz 64,
method 0.  Held by EPE (rg <= 0.05 px, 100% fill); relax_late with polish
must move the flow away from the plain cold growing by more than the
gap."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 45, 61
BSZ = 64


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def jax_chunked_order(i0, i1, go, ba, prm, relax_late, polish):
    """JAX's chunked loop for one pair, from JAX's pieces (cold requeue)."""
    import jax
    import jax.numpy as jnp

    from faldoi_tpu.core.functionals import solve_tvl1
    from faldoi_tpu.core.local_step import LocalSolver, init_state, polish_all
    from faldoi_tpu.core.match_growing import (
        _consts_pair_jit, _prune_requeue_pair, _stack_trees,
    )
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.models import method_local_params

    ja, jb = prepare_pair(i0, i1)
    n = H * W
    sc = _consts_pair_jit(0, ja, jb, *method_local_params(0, 5), prm.tol_OF,
                          5, 11)
    ls = LocalSolver(H, W, wr=5, bsz=BSZ, solver=solve_tvl1, warps=1,
                     max_iters=prm.max_iter_patch, mode="fused", delta=0.05,
                     fill="patch_rb", floor=4096, relax=False, delta_rel=0.5,
                     floor_scale=64, with_chi=False)
    sal = jnp.ones((n + 1,), jnp.float32)
    sts = [ls.insert_seeds(init_state(H, W), s, c, sal)
           for s, c in zip((go, ba), sc)]
    trust2 = jnp.ones((2, n + 1), jnp.int32)

    def polished(st, c):
        for _ in range(polish):
            st = polish_all(st, c, sal, solve_tvl1, H, W, 5, BSZ, 1,
                            prm.max_iter_patch)
        return st

    for it in range(prm.iterations_of):
        ls.floor_scale = 64 if it == 0 else 16
        ls.relax = relax_late and it >= 1
        sts = [ls.grow(st, c, trust2[k], sal, it)
               for k, (st, c) in enumerate(zip(sts, sc))]
        if it >= 1:
            sts = [polished(st, c) for st, c in zip(sts, sc)]
        st2, trust2, _, _ = _prune_requeue_pair(
            _stack_trees(*sts), ja, jb, jnp.float32(prm.epsilon), n=n, h=H,
            w=W, warm_band=0)
        sts = [jax.tree.map(lambda a, k=k: a[k], st2) for k in range(2)]
    ls.floor_scale = 16
    ls.relax = relax_late
    st = polished(ls.grow(sts[0], sc[0], trust2[0], sal, prm.iterations_of),
                  sc[0])
    return np.stack([np.asarray(st.out_u[:n]).reshape(H, W),
                     np.asarray(st.out_v[:n]).reshape(H, W)], -1)


def test_relax_late_polish_matches_jax_order(exact_env):
    from faldoi_tpu import params as JP
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=157)
    rng = np.random.default_rng(158)
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 30, rng), rng)
    jrg = jax_chunked_order(i0, i1, go, ba, JP.Parameters(), True, 1)
    a, b = prepare_pair(i0, i1, device="cpu")
    stats = {}
    rg = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ, stats=stats,
                       warm_band=0, relax_late=True, polish=1)[0].numpy()
    cold = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ,
                         warm_band=0)[0].numpy()
    assert np.isfinite(rg).all() and np.isfinite(jrg).all()
    gap = syn.epe(rg, jrg)
    assert gap <= 0.05
    assert syn.epe(rg, cold) > max(gap, 1e-3)
    assert {"polish_it1", "polish_it2", "polish_final"} <= set(stats["seconds"])
    assert "polish_it0" not in stats["seconds"]
