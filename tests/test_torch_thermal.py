"""Finite temperature and open systems in the thermodynamic limit: the
port's ``thermal`` and ``lindblad_infinite`` against the JAX package, on the
CPU.

Thermal states (purification iTEBD and the W^II route) and the uniform
Lindblad evolution are compared through gauge-free observables at 1e-10,
states crossing with ``convert.state_from_numpy``.  One case cannot be:
uniform evolution under a bond (two-site) dissipator from a product state
fuses a rank-deficient core, whose left-isometric gauge (iterated QR) fills
the null directions differently on each LAPACK build, and the two states
part at 1e-3; there the port is held to the JAX package at the tolerance
the JAX test holds it to its dense RK4 oracle (1e-3).
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import state_from_numpy, state_to_numpy

jth = import_module("contractn_tpu.models.thermal")
tth = import_module("contractn_tpu_torch.models.thermal")
jl = import_module("contractn_tpu.models.lindblad_infinite")
tl = import_module("contractn_tpu_torch.models.lindblad_infinite")
ji = import_module("contractn_tpu.models.itebd")
jd = import_module("contractn_tpu.models.dmrg")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
SM = np.array([[0.0, 0.0], [1.0, 0.0]])
H2 = ji.tfim_h2()
HC = np.asarray(jd.tfim_mpo(2, h=1.2).cores)[0]
PLUS = 0.5 * (np.eye(2) + SX)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's states and values, computed once for the file."""
    st = jth.thermal_itebd(H2, 1.0, 8, dbeta=0.05)
    core = jth.thermal_wii(HC, 0.6, 8, dbeta=0.05)
    rho = jl.lindblad_evolve_infinite(jl.product_density(PLUS), HC, jumps=[SM],
                                      rates=[0.5], t=0.3, n_steps=4, bond_dim=8)
    return {
        "state": st,
        "energy": jth.thermal_energy_density(st, H2),
        "sx": jth.thermal_site_expectation(st, SX),
        "ti": jth.thermal_log_z_ti(H2, 0.5, 8, dbeta=0.05, intervals=2, iters=100)[0],
        "core": np.asarray(core),
        "wii_x": complex(jth.thermal_wii_expectation(core, SX)),
        "wii_zz": np.asarray(jth.thermal_wii_correlate(core, SZ, SZ, [1, 2])),
        "rho": np.asarray(rho),
        "rho_x": jl.trace_expect(rho, SX),
        "rho_zz": jl.trace_correlate(rho, SZ, SZ, [1, 2]),
        "rho1": jl.one_site_density(rho),
        "ness": jl.ness_infinite(None, jumps=[SM], rates=[0.8], bond_dim=4,
                                 t_chunk=1.0, max_chunks=3, steps_per_unit=8),
    }


def test_thermal_itebd_matches_jax(ref):
    st = tth.thermal_itebd(torch.from_numpy(H2), 1.0, 8, dbeta=0.05)
    assert abs(st["log_z"] - ref["state"]["log_z"]) < TOL
    assert abs(tth.thermal_energy_density(st, H2) - ref["energy"]) < TOL
    assert abs(tth.thermal_site_expectation(st, SX) - ref["sx"]) < TOL
    assert abs(tth.thermal_free_energy(st) + st["log_z"]) < 1e-15
    # the JAX state measured by the port: same observables
    moved = state_from_numpy(ref["state"], device=CPU)
    assert abs(tth.thermal_energy_density(moved, H2) - ref["energy"]) < TOL
    back = state_to_numpy(st)
    assert abs(jth.thermal_energy_density({**back, "d": 2}, H2) - ref["energy"]) < TOL


def test_thermal_log_z_ti_matches_jax(ref):
    got, state = tth.thermal_log_z_ti(torch.from_numpy(H2), 0.5, 8, dbeta=0.05,
                                      intervals=2, iters=100)
    assert abs(got - ref["ti"]) < TOL and state["beta"] == 0.5
    with pytest.raises(ValueError, match="even interval"):
        tth.thermal_log_z_ti(torch.from_numpy(H2), 0.5, 8, intervals=3)


def test_commuting_hamiltonian_is_trotter_exact():
    """The JAX test's closed form: the classical Ising chain."""
    h2 = torch.from_numpy(ji.tfim_h2(j=1.0, h=0.0))
    st = tth.thermal_itebd(h2, 1.0, 8, dbeta=0.02)
    assert abs(st["log_z"] - np.log(2 * np.cosh(1.0))) < 1e-12
    assert abs(tth.thermal_energy_density(st, h2) + np.tanh(1.0)) < 1e-10


def test_thermal_wii_matches_jax(ref):
    core = tth.thermal_wii(torch.from_numpy(HC), 0.6, 8, dbeta=0.05)
    assert abs(tth.thermal_wii_expectation(core, SX) - ref["wii_x"]) < TOL
    np.testing.assert_allclose(tth.thermal_wii_correlate(core, SZ, SZ, [1, 2]),
                               ref["wii_zz"], atol=TOL)
    for fn in ("fold_umpo", "fold_umpo_anc"):
        np.testing.assert_array_equal(getattr(tth, fn)(torch.from_numpy(HC)),
                                      np.asarray(getattr(jth, fn)(HC)))
    np.testing.assert_array_equal(tth.balanced_umpo(torch.from_numpy(HC)).numpy(),
                                  np.asarray(jth.balanced_umpo(HC)))
    assert tth.tfim_exact_thermal(0.7, h=1.3) == jth.tfim_exact_thermal(0.7, h=1.3)


def test_lindblad_evolution_matches_jax(ref):
    rho = tl.lindblad_evolve_infinite(tl.product_density(PLUS, device=CPU),
                                      torch.from_numpy(HC), jumps=[SM], rates=[0.5],
                                      t=0.3, n_steps=4, bond_dim=8)
    assert abs(tl.trace_expect(rho, SX) - ref["rho_x"]) < TOL
    np.testing.assert_allclose(tl.trace_correlate(rho, SZ, SZ, [1, 2]), ref["rho_zz"],
                               atol=TOL)
    np.testing.assert_allclose(tl.one_site_density(rho), ref["rho1"], atol=TOL)
    # the JAX core measured by the port's trace gauge
    assert abs(tl.trace_expect(torch.from_numpy(ref["rho"]), SX) - ref["rho_x"]) < 1e-12
    lv = tl.liouvillian_umpo(torch.from_numpy(HC), jumps=[SM], rates=[0.5],
                             bond_jumps=[np.kron(SM.T, SM)])
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl.liouvillian_umpo(
        HC, jumps=[SM], rates=[0.5], bond_jumps=[np.kron(SM.T, SM)])))
    with pytest.raises(ValueError, match="needs a Hamiltonian core"):
        tl.liouvillian_umpo(None)


def test_pure_dephasing_is_exact():
    """The JAX test's closed form: <X>(t) = exp(-2 gamma t)."""
    gam, t = 0.35, 0.5
    out = tl.lindblad_evolve_infinite(tl.product_density(PLUS, device=CPU), None,
                                      jumps=[SZ], rates=[gam], t=t, n_steps=10,
                                      bond_dim=4)
    assert abs(tl.trace_expect(out, SX) - np.exp(-2 * gam * t)) < 1e-12
    assert abs(tl.trace_expect(out, SZ)) < 1e-12


def test_trace_gauge_of_a_vectorized_pure_state():
    a = np.random.default_rng(3).normal(size=(2, 3, 3))
    got = tl.vectorize_umps(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.vectorize_umps(a)), atol=1e-15)
    assert abs(tl.trace_expect(got, SX) - jl.trace_expect(jl.vectorize_umps(a), SX)) < 1e-12
    np.testing.assert_array_equal(tl.maximally_mixed(3, device=CPU).numpy(),
                                  np.asarray(jl.maximally_mixed(3)))


def test_ness_matches_jax(ref):
    """Three chunks of the steady-state search (the JAX test runs it to a
    1e-8 drift, 12 chunks): the loop's bookkeeping and state agree."""
    out = tl.ness_infinite(None, jumps=[SM], rates=[0.8], bond_dim=4, t_chunk=1.0,
                           max_chunks=3, steps_per_unit=8,
                           rho0=tl.maximally_mixed(2, device=CPU))
    want = ref["ness"]
    assert (out["converged"], out["t_total"]) == (want["converged"], want["t_total"])
    np.testing.assert_allclose(out["rho1"], want["rho1"], atol=TOL)
    assert abs(out["drift"] - want["drift"]) < TOL
    drift = tl.steady_state_check(out["core"], None, jumps=[SM], rates=[0.8], ops=[SZ])
    assert abs(drift - jl.steady_state_check(want["core"], None, jumps=[SM], rates=[0.8],
                                             ops=[SZ])) < TOL


def test_bond_dissipator_within_the_jax_tolerance():
    """See the module docstring: the two packages part at the rank-deficient
    first step, and agree within the JAX test's tolerance against its dense
    oracle (1e-3)."""
    bj = np.kron(SM.T, SM)
    kw = dict(t=0.3, n_steps=6, bond_dim=8, bond_jumps=[bj], bond_rates=[0.5])
    got = tl.lindblad_evolve_infinite(tl.product_density(PLUS, device=CPU),
                                      torch.from_numpy(HC), **kw)
    want = jl.lindblad_evolve_infinite(jl.product_density(PLUS), jnp.asarray(HC), **kw)
    for op in (SX, SZ):
        assert abs((tl.trace_expect(got, op) - jl.trace_expect(want, op)).real) < 1e-3
