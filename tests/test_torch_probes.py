"""The probe kernels' plain twins (P1-P3, ``faldoi_tpu_torch.ops.probes``)
against the Pallas probes of ``scripts/`` themselves.

The probe scripts run their work when imported, so the kernel bodies and
the functions that call ``pl.pallas_call`` are read out of the script
sources with ``ast`` and run as written, with their own specs, through
``pl.pallas_call(..., interpret=True)`` on the CPU.  P1 and P2 must equal
their twins exactly; P3 (another summation order) within relative 1e-5."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from faldoi_tpu_torch.ops import probes

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
P3_RTOL = 1e-5


class _InterpretPallas:
    """``pl`` as the scripts see it, with every pallas_call interpreted."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _load(script, names, consts=()):
    """Exec the named top-level functions of ``script`` (decorators
    dropped) and its top-level constant assignments named in ``consts``;
    returns the namespace."""
    tree = ast.parse((SCRIPTS / script).read_text())
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": _InterpretPallas()}
    if "pallas_gather" in script:
        from jax.experimental.pallas import tpu as pltpu

        ns["pltpu"] = pltpu
    body = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            node.decorator_list = []
            body.append(node)
        elif isinstance(node, ast.Assign) and all(
                isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets):
            targets = [t.id for tg in node.targets
                       for t in (tg.elts if isinstance(tg, ast.Tuple) else [tg])]
            if targets and all(t in consts for t in targets):
                body.append(node)
    missing = set(names) - {n.name for n in body if isinstance(n, ast.FunctionDef)}
    assert not missing, f"{script} has no {missing}"
    exec(compile(ast.Module(body=body, type_ignores=[]), str(script), "exec"), ns)
    return ns


def test_p1_twin_equals_the_pallas_probe():
    ns = _load("tpu_pallas_probe.py", ("kernel", "f"))
    rng = np.random.default_rng(40)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    y = rng.standard_normal((256, 256)).astype(np.float32)
    want = np.asarray(ns["f"](jnp.asarray(x), jnp.asarray(y)))
    got = probes.probe_axpy(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(got.numpy(), want)


def test_p2_twin_equals_the_pallas_probe():
    ns = _load("tpu_pallas_probe.py", ("kernel2", "g"))
    rng = np.random.default_rng(41)
    x = rng.standard_normal((11, 11, 1024)).astype(np.float32)
    want = np.asarray(ns["g"](jnp.asarray(x)))
    got = probes.probe_roll4(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)


@pytest.mark.parametrize("b", [16, 32])
def test_p3_twin_matches_the_pallas_probe(b):
    ns = _load("tpu_pallas_gather_probe.py", ("kernel", "run"),
               consts=("H", "W", "ROWS", "COLS", "C", "G"))
    ns["B"] = b                     # the script reads B from its argv
    h, w, c = ns["H"], ns["W"], ns["C"]
    assert (ns["ROWS"], ns["COLS"]) == (probes.WIN_ROWS, probes.WIN_COLS)
    rng = np.random.default_rng(42 + b)
    planes = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    oy8 = (rng.integers(0, (h - 40) // 8, b) * 8).astype(np.int32)
    cb = (rng.integers(0, (w - 128) // 128, b) * 128).astype(np.int32)
    oy8[:2], cb[:2] = [0, h - 40], [0, w - 128]          # the far edges
    want = np.asarray(ns["run"](*map(jnp.asarray, (planes, oy8, cb))))
    got = probes.probe_window_fetch(*map(torch.as_tensor, (planes, oy8, cb)))
    assert got.shape == want.shape == (b, 128)
    err = np.abs(got.numpy() - want).max()
    assert err <= P3_RTOL * np.abs(want).max()


def test_probe_wrappers_raise_on_what_the_kernels_do_not_take():
    planes = torch.zeros((3, 440, 1024))

    def origins(oy, cb):
        return (torch.tensor(oy, dtype=torch.int32),
                torch.tensor(cb, dtype=torch.int32))

    with pytest.raises(ValueError, match="aligned"):
        probes.probe_window_fetch(planes, *origins([8, 3], [0, 128]))
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_window_fetch(planes, *origins([8, 16], [0, 64]))
    with pytest.raises(ValueError, match="leaves"):
        probes.probe_window_fetch(planes, *origins([408], [0]))     # 408+40 > 440
    with pytest.raises(ValueError, match="leaves"):
        probes.probe_window_fetch(planes, *origins([0], [1024]))
    with pytest.raises(ValueError, match="leaves"):
        probes.probe_window_fetch(planes, *origins([-8], [0]))
    with pytest.raises(ValueError, match="one length"):
        probes.probe_window_fetch(planes, *origins([0, 8], [0]))
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.probe_roll4(torch.zeros((11, 11, 100)))
    with pytest.raises(ValueError, match=r"\(11, 11, L\)"):
        probes.probe_roll4(torch.zeros((12, 11, 128)))
    with pytest.raises(ValueError, match="differ"):
        probes.probe_axpy(torch.zeros(4), torch.zeros(5))
    # in range and aligned: the far corner window is fine; no launch on CPU
    before = probes.probe_window_fetch.launches
    out = probes.probe_window_fetch(planes + 1, *origins([400], [896]))
    np.testing.assert_allclose(out.numpy(), 3 * 40 * 128 * 1e-6, rtol=1e-6)
    assert probes.probe_window_fetch.launches == before


def _edge_origins(rng, b, h, w):
    """Random aligned origins with the first and last band and column block
    among them."""
    oy8 = (rng.integers(0, (h - 40) // 8 + 1, b) * 8).astype(np.int32)
    cb = (rng.integers(0, w // 128, b) * 128).astype(np.int32)
    last_oy, last_cb = (h - 40) // 8 * 8, (w // 128 - 1) * 128
    oy8[:4], cb[:4] = [0, last_oy, 0, last_oy], [0, last_cb, last_cb, 0]
    return oy8, cb


@pytest.mark.parametrize("h,c", [(436, 1), (436, 3), (440, 3), (47, 2)])
@pytest.mark.parametrize("b", [7, 64, 1024])
def test_p3_band_decomposition_matches_the_twin(b, h, c):
    """The kernel's decomposition (band table, five adds a lane) in PyTorch
    against the window-sum twin: H a multiple of 8 or not (a last partial
    band that no window reads), C 1 to 3, origins on the first and last band
    and column block."""
    rng = np.random.default_rng(50 + b + h + c)
    w = 512 + 4 * (h % 8)             # a ragged tail of columns no window reads
    planes = torch.as_tensor(rng.uniform(0, 1, (c, h, w)).astype(np.float32))
    oy8, cb = map(torch.as_tensor, _edge_origins(rng, b, h, w))
    table = probes.band_table_plain(planes)
    assert table.shape == (-(-h // 8), w // 128)
    want = probes.probe_window_fetch_plain(planes, oy8, cb)
    got = probes.probe_window_fetch_bands_plain(planes, oy8, cb)
    assert got.shape == want.shape == (b, 128)
    assert (got - want).abs().max() <= P3_RTOL * want.abs().max()
    # a last partial band sums the rows that exist
    last = planes[:, (table.shape[0] - 1) * 8:, :128].double().sum()
    assert abs(float(table[-1, 0]) - float(last)) <= P3_RTOL * float(last)


@pytest.mark.parametrize("b", [7, 64, 1024])
def test_p3_band_decomposition_matches_the_pallas_probe(b):
    """The same decomposition against the Pallas probe itself (interpret
    mode), at the probe's planes; the probe takes 4 lanes a grid step, so
    B = 7 runs as 8 lanes and its first 7 are compared."""
    lanes = -(-b // 4) * 4
    ns = _load("tpu_pallas_gather_probe.py", ("kernel", "run"),
               consts=("H", "W", "ROWS", "COLS", "C", "G"))
    ns["B"] = lanes
    h, w, c = ns["H"], ns["W"], ns["C"]
    rng = np.random.default_rng(60 + b)
    planes = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    oy8, cb = _edge_origins(rng, lanes, h, w)
    want = np.asarray(ns["run"](*map(jnp.asarray, (planes, oy8, cb))))[:b]
    got = probes.probe_window_fetch_bands_plain(
        *map(torch.as_tensor, (planes, oy8[:b], cb[:b])))
    assert got.shape == want.shape == (b, 128)
    assert np.abs(got.numpy() - want).max() <= P3_RTOL * np.abs(want).max()


def test_p3_band_table_of_empty_batch_and_narrow_planes():
    planes = torch.ones((2, 48, 130))
    none = torch.zeros(0, dtype=torch.int32)
    assert probes.probe_window_fetch_bands_plain(planes, none, none).shape == (0, 128)
    assert probes.probe_window_fetch(planes, none, none).shape == (0, 128)
    table = probes.band_table_plain(planes)
    np.testing.assert_array_equal(table.numpy(), np.full((6, 1), 2 * 8 * 128.0))
    assert probes.band_table_plain(torch.ones((1, 48, 100))).shape == (6, 0)
