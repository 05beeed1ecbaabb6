"""iTEBD and MPS circuits (TEBD, purified thermal states) of the PyTorch port
against the JAX package, on the CPU (``tests/test_torch_dynamics.py`` holds
TDVP).

Initial states are drawn once in numpy and carried into both packages
through ``convert.py``; gates and bond terms are numpy matrices.  Evolved
states differ by SVD/QR gauge and global phase, so they compare as dense
vectors through |overlap|, with energies, norms, log-norms, Schmidt
coefficients and expectation values compared directly; float64/complex128,
tolerance 1e-10 unless a test says otherwise.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPS as JMPS
from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy

ji, jc = (import_module(f"contractn_tpu.models.{m}") for m in ("itebd", "circuits"))
ti, tc = (import_module(f"contractn_tpu_torch.models.{m}") for m in ("itebd", "circuits"))

torch.set_num_threads(1)

TOL = 1e-10
N, BOND = 4, 4


def _arrays(n=N, bond=BOND, seed=0):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((n, 2, bond, bond)) / np.sqrt(2 * bond)
    return cores, rng.standard_normal(bond), rng.standard_normal(bond)


def _both(arrays):
    return (JMPS(*(jnp.asarray(a) for a in arrays)),
            mps_from_numpy(*arrays, device="cpu"))


def _dense(cores, left, right):
    bond = cores.shape[-1]
    amp = np.asarray(left)[None]
    for core in cores:
        amp = np.einsum("cj,djk->cdk", amp, core).reshape(-1, bond)
    return amp @ np.asarray(right)


def _overlap(jmps, tmps):
    """|<a|b>| / (|a| |b|) of the two packages' states."""
    a = _dense(*(np.asarray(x) for x in (jmps.cores, jmps.left, jmps.right)))
    b = _dense(*mps_to_numpy(tmps))
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("h2", ["tfim", "heisenberg"])
def test_itebd_matches_jax(h2):
    term = ji.tfim_h2(h=1.2) if h2 == "tfim" else ji.heisenberg_h2()
    np.testing.assert_array_equal(
        ti.tfim_h2(h=1.2) if h2 == "tfim" else ti.heisenberg_h2(), term)
    schedule = ((0.1, 60), (0.01, 60))
    jstate, ej = ji.itebd_ground_state(term, 6, schedule=schedule)
    tstate, et = ti.itebd_ground_state(term, 6, schedule=schedule, device="cpu")
    assert abs(et - ej) < TOL
    for key in ("lambda_a", "lambda_b"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   atol=1e-9)
    jcore = np.asarray(ji.unit_cell_core(jstate))
    tcore = ti.unit_cell_core(tstate).numpy()
    assert tcore.shape == jcore.shape
    np.testing.assert_allclose(np.sort(np.abs(np.linalg.eigvals(
        np.einsum("sij,skl->ikjl", tcore, tcore).reshape(tcore.shape[1] ** 2, -1)))),
        np.sort(np.abs(np.linalg.eigvals(
            np.einsum("sij,skl->ikjl", jcore, jcore).reshape(jcore.shape[1] ** 2, -1)))),
        atol=1e-8)
    gen = torch.Generator().manual_seed(0)
    _, ep = ti.itebd_ground_state(term, 6, schedule=schedule, generator=gen,
                                  device="cpu")
    assert abs(ep - et) < 1e-3


def test_two_site_gate_matches_jax():
    for dt in (0.1, 0.05j):
        np.testing.assert_allclose(
            ti.two_site_gate(ji.heisenberg_h2(), dt, device="cpu").numpy(),
            np.asarray(ji.two_site_gate(ji.heisenberg_h2(), dt)), atol=1e-12)


def _circuit(mod, n, seed, **kw):
    rng = np.random.default_rng(seed)
    st = mod.CircuitState.product(n, [1.0, 0.0], max_bond=kw.get("max_bond"),
                                  **({"device": "cpu"} if mod is tc else {}))
    for layer in range(3):
        for i in range(n):
            q, _ = np.linalg.qr(rng.standard_normal((2, 2))
                                + 1j * rng.standard_normal((2, 2)))
            st.apply_gate(q, i)
        for i in range(layer % 2, n - 1, 2):
            q, _ = np.linalg.qr(rng.standard_normal((4, 4))
                                + 1j * rng.standard_normal((4, 4)))
            st.apply_gate2(q, i)
    return st


@pytest.mark.parametrize("max_bond", [4, 2])
def test_circuit_matches_jax(max_bond):
    """Random unitary layers at full bond (exact) and truncated to bond 2
    (the discarded weight in ``log_norm``)."""
    js = _circuit(jc, 5, 7, max_bond=max_bond)
    ts = _circuit(tc, 5, 7, max_bond=max_bond)
    assert abs(ts.log_norm - js.log_norm) < TOL
    assert abs(_overlap(js.finalize(), ts.finalize()) - 1.0) < 1e-9
    ghz = [tc.CircuitState.product(3, [1.0, 0.0], device="cpu"),
           jc.CircuitState.product(3, [1.0, 0.0])]
    for st in ghz:
        st.apply_gate(tc.H_GATE, 0).apply_gate2(tc.CNOT, 0).apply_gate2(tc.CNOT, 1)
    vec = _dense(*mps_to_numpy(ghz[0].finalize()))
    np.testing.assert_allclose(np.abs(vec), np.abs([1, 0, 0, 0, 0, 0, 0, 1]) / np.sqrt(2),
                               atol=1e-12)


@pytest.mark.parametrize("imaginary", [False, True])
def test_tebd_matches_jax(imaginary):
    j0, t0 = _both(_arrays(seed=5))
    h2 = ji.tfim_h2(h=0.9)
    jout, jlog = jc.tebd_evolve(j0, h2, 0.3, 3, BOND, imaginary=imaginary)
    tout, tlog = tc.tebd_evolve(t0, h2, 0.3, 3, BOND, imaginary=imaginary)
    assert abs(tlog - float(jlog)) < TOL
    assert abs(_overlap(jout, tout) - 1.0) < 1e-9


def test_thermal_state_and_correlation_match_jax():
    h2 = ji.tfim_h2(h=0.8)
    js = jc.thermal_state(h2, 3, 1.0, max_bond=16, n_steps=6)
    ts = tc.thermal_state(h2, 3, 1.0, max_bond=16, n_steps=6, device="cpu")
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    for site in (0, 1):
        assert abs(tc.thermal_expectation(ts, sx, site)
                   - jc.thermal_expectation(js, sx, site)) < TOL
    sz = np.diag([1.0, -1.0])
    jt_, jv = jc.thermal_correlation(h2, 3, 0.5, sz, 0, 0.2, 2, max_bond=16, site2=1)
    tt_, tv = tc.thermal_correlation(h2, 3, 0.5, sz, 0, 0.2, 2, max_bond=16, site2=1,
                                     device="cpu")
    np.testing.assert_allclose(tt_, jt_, atol=1e-14)
    np.testing.assert_allclose(tv, jv, atol=TOL)


def test_chip_smoke_finite_chains_rehearsal_on_cpu():
    # phase 8 at a tiny size: every check of the phase runs, and on the CPU
    # nothing is launched (the 6-site spin-1 energy, -7.3702750 by exact
    # diagonalization, stands in for the published 100-site value)
    import chip_smoke

    sizes = {
        "spin1": {"n_sites": 6, "bond": 27, "sweeps": 2, "serve_batch": 32,
                  "published": -7.370274969, "published_tol": 1e-8, "seed": 3},
        "tfim": {"n_sites": 8, "h": 1.0, "bond": 16, "sweeps": 2, "rtol": 1e-8, "seed": 4},
        "ensemble": {"n_members": 3, "h": (0.5, 1.5), "n_sites": 6, "bond": 8,
                     "sweeps": 2, "rtol": 1e-7, "seed": 5},
        "quench": {"h": 0.5, "dt": 0.05, "steps": 2, "drift_tol": 1e-7, "norm_tol": 1e-10},
        "itebd": {"bond": 4, "tol": 5e-3},
        "opsum": {"n_sites": 8, "bond": 4, "rtol": 1e-10, "seed": 6},
        "svd": {"rows": 8, "reps": 1},
    }
    runs = chip_smoke.finite_chains(torch.device("cpu"), "cpu", sizes)
    assert set(runs) == {"dmrg_spin1", "serve_spin1", "dmrg_tfim", "dmrg_ensemble",
                         "tdvp1_quench", "itebd", "opsum_heisenberg"}
    for counts, _ in runs.values():
        assert set(counts.values()) == {0}
