"""Infinite-boundary-condition windows of the PyTorch port against the JAX
package, on the CPU.

Both packages start from one VUMPS ground state or one thermal
purification, made by the port (both held against the JAX package in
``test_torch_vumps.py`` and ``test_torch_thermal.py``) and crossing as numpy
arrays (``convert.ground_to_numpy`` / ``ground_from_numpy``), and are compared
at 1e-10 through the correlators and expectations they return; window states
are compared through their overlaps and expectations, windows crossing with
``convert.state_from_numpy``.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import (ground_from_numpy, ground_to_numpy,
                                         state_from_numpy)

jb = import_module("contractn_tpu.models.ibc")
tb = import_module("contractn_tpu_torch.models.ibc")
tv = import_module("contractn_tpu_torch.models.vumps")
tv_dmrg = import_module("contractn_tpu_torch.models.dmrg")
jm = import_module("contractn_tpu.models.mpo")
jth = import_module("contractn_tpu.models.thermal")
tth = import_module("contractn_tpu_torch.models.thermal")
expect_local = import_module("contractn_tpu_torch.models.umps").expect_local

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SY = np.array([[0.0, -1j], [1j, 0.0]])
SZ = np.diag([1.0, -1.0])
ZZ = np.kron(SZ, SZ)
N, QJ, DT, STEPS, BOND = 6, 2, 0.05, 2, 8


@pytest.fixture(scope="module")
def ref():
    """One TFIM ground state (h 2, bond 8) and one XX-chain purification, made
    by the port and handed to both packages as numpy arrays, and the JAX
    package's correlators on them (the windows' bonds held at the ground
    bond, so each local step compiles once)."""
    hc = tv_dmrg.tfim_mpo(2, h=2.0, device=CPU)
    g = tv.vumps(hc, BOND, iters=40, a0=np.random.default_rng(0).normal(size=(2, 8, 8)),
                 device=CPU)
    h2 = 0.5 * (np.kron(SX, SX) + np.real(np.kron(SY, SY)))
    hx = np.asarray(jm.mpo_from_bond_term(h2, 2).cores)[0]
    core = tth.thermal_wii(torch.from_numpy(hx), 1.0, BOND, dbeta=0.05)
    gn, hc, core_n = ground_to_numpy(g), hc.cores[0].numpy(), core.numpy()
    win = jb.ibc_window(gn, hc, N)
    quench = jb.window_apply_bond(win, ZZ, 2)
    return {
        "g": gn, "hc": hc, "hx": hx, "core": core_n, "win": win,
        "dyn": jb.ibc_dynamic_correlator(gn, hc, SZ, SZ, N, QJ, DT, STEPS, max_bond=BOND),
        "bond_ov": np.asarray(jb.window_overlaps_bond(win, quench, ZZ)),
        "thermal": jb.ibc_thermal_correlator(core_n, hx, SZ, SZ, 4, 1, DT, 1,
                                             max_bond=BOND),
        "quench_x": np.asarray(jb.window_expectations(
            jb.window_evolve(quench, DT, STEPS, max_bond=BOND), SX)),
    }


@pytest.fixture(scope="module")
def port(ref):
    return ground_from_numpy(ref["g"], device=CPU), torch.from_numpy(ref["hc"])


def test_window_embedding_matches_jax(ref, port):
    g, hc = port
    win = tb.ibc_window(g, hc, N)
    assert abs(win["e_bulk"] - ref["win"]["e_bulk"]) < TOL
    for key in ("env_left", "env_right"):
        np.testing.assert_allclose(win[key].numpy(), np.asarray(ref["win"][key]), atol=TOL)
    np.testing.assert_allclose(tb.window_expectations(win, SX).numpy(),
                               np.asarray(jb.window_expectations(ref["win"], SX)),
                               atol=TOL)
    # the JAX window, carried across, measures the same in the port
    moved = state_from_numpy(ref["win"], device=CPU)
    np.testing.assert_allclose(tb.window_expectations(moved, SX).numpy(),
                               np.asarray(jb.window_expectations(ref["win"], SX)),
                               atol=TOL)
    with pytest.raises(ValueError, match="n_sites >= 2"):
        tb.ibc_window(g, hc, 1)


def test_window_operators_are_consistent(port):
    """The JAX test's exactness contract: a bond ZZ equals two local Zs, and
    the one-pass bond overlaps equal explicit bond applications."""
    win = tb.ibc_window(*port, N)
    k1 = tb.window_apply_bond(win, ZZ, 3)
    k2 = tb.window_apply_local(tb.window_apply_local(win, SZ, 3), SZ, 4)
    ov11 = complex(tb.window_overlaps_local(k1, k1))
    assert abs(complex(tb.window_overlaps_local(k1, k2)) / abs(ov11) - 1.0) < 1e-12
    vb = tb.window_overlaps_bond(win, win, ZZ).numpy()
    for i in (2, 4):
        ki = tb.window_apply_bond(win, ZZ, i)
        assert abs(vb[i] - complex(tb.window_overlaps_local(win, ki))) < 1e-12


def test_window_evolution_matches_jax(ref, port):
    g, hc = port
    win = tb.ibc_window(g, hc, N)
    quench = tb.window_apply_bond(win, ZZ, 2)
    np.testing.assert_allclose(tb.window_overlaps_bond(win, quench, ZZ).numpy(),
                               ref["bond_ov"], atol=TOL)
    got = tb.window_evolve(quench, DT, STEPS, max_bond=BOND)
    np.testing.assert_allclose(tb.window_expectations(got, SX).numpy(), ref["quench_x"],
                               atol=TOL)
    # imaginary time: the embedded ground window is stationary (the JAX
    # test's real-time criterion, 1e-8)
    seen = []
    got = tb.window_evolve(win, DT, 2, max_bond=BOND, imaginary=True,
                           callback=lambda k, w: seen.append(k))
    assert seen == [0, 1]
    x0 = tb.window_expectations(win, SX).numpy()
    assert np.abs(tb.window_expectations(got, SX).numpy() - x0).max() < 1e-8
    assert abs(x0[0] - expect_local(g["al"], SX)) < 1e-9


def test_dynamic_correlators_match_jax(ref, port):
    g, hc = port
    got = tb.ibc_dynamic_correlator(g, hc, SZ, SZ, N, QJ, DT, STEPS, max_bond=BOND)
    assert got.shape == (N, STEPS + 1)
    np.testing.assert_allclose(got, ref["dyn"], atol=TOL)
    got = tb.ibc_dynamic_correlator(g, hc, ZZ, ZZ, N, QJ, DT, 1, max_bond=BOND,
                                    bond_b=True, bond_a=True)
    assert got.shape == (N - 1, 2)
    win = tb.ibc_window(g, hc, N)  # t = 0: the bond overlaps of the quench
    np.testing.assert_allclose(got[:, 0], tb.window_overlaps_bond(
        win, tb.window_apply_bond(win, ZZ, QJ), ZZ).numpy(), atol=1e-12)
    ks, ws = np.array([0.0, np.pi / 3]), np.linspace(-5.0, 10.0, 31)
    np.testing.assert_allclose(tb.ibc_spectral_function(ref["dyn"], QJ, DT, ks, ws),
                               jb.ibc_spectral_function(ref["dyn"], QJ, DT, ks, ws),
                               atol=1e-14)


def test_thermal_correlator_matches_jax(ref):
    core = tth.thermal_wii(torch.from_numpy(ref["hx"]), 1.0, 8, dbeta=0.05)
    got = tb.ibc_thermal_correlator(core, torch.from_numpy(ref["hx"]), SZ, SZ, 4, 1,
                                    DT, 1, max_bond=BOND)
    np.testing.assert_allclose(got, ref["thermal"], atol=TOL)
    # t = 0: the static thermal correlator of the same purification
    stat = tth.thermal_wii_correlate(core, SZ, SZ, [1, 2])
    assert abs(got[1, 0] - 1.0) < 1e-10
    for r in (1, 2):
        assert abs(got[1 + r, 0] - stat[r - 1]) < 1e-10
