"""Quantum chemistry (``gaussians.py``, ``chemistry.py``) of the PyTorch
port against the JAX package, on the CPU.

The integral engines, the SCF solvers, the term lists and the FCI oracle are
host numpy in both packages and must agree exactly.  The compiled MPOs are
compared as dense operators at 1e-10; the DMRG routes reach the
independent determinant FCI at 1e-10 (1e-7 for frozen-core water at bond
24, the JAX test's bound); the thermal purification is compared with the
JAX package's at 1e-10.  JAX references are computed once per file.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy, mps_to_numpy

jc = import_module("contractn_tpu.models.chemistry")
tc = import_module("contractn_tpu_torch.models.chemistry")
jg = import_module("contractn_tpu.models.gaussians")
tg = import_module("contractn_tpu_torch.models.gaussians")
tu1 = import_module("contractn_tpu_torch.models.u1")

torch.set_num_threads(1)

TOL = 1e-10


def _dense(cores, left, right):
    """Dense operator of an MPO ``(cores, left, right)``."""
    cur = np.einsum("w,abwv->abv", left, cores[0])
    for w in cores[1:]:
        d = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(
            d * w.shape[0], d * w.shape[1], -1)
    return np.einsum("ABv,v->AB", cur, right)


def _mol(pkg, n, r):
    syms, xyz = pkg.h_chain_geometry(n, r)
    basis, charges = pkg.sto3g_basis(syms, xyz)
    s, hcore, eri, e_nuc = pkg.molecular_integrals(basis, charges, xyz)
    return basis, s, hcore, eri, e_nuc


@pytest.fixture(scope="module")
def h2():
    basis, s, hcore, eri, e_nuc = _mol(tc, 2, 1.4011)
    e_hf, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 2)
    h1, g2 = tc.mo_transform(hcore, eri, c)
    return basis, c, h1, g2, e_hf + e_nuc


@pytest.fixture(scope="module")
def h3():
    """H3+ (the cation: two electrons on three centers), MO basis."""
    _, s, hcore, eri, _ = _mol(tc, 3, 1.65)
    _, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 2)
    return tc.mo_transform(hcore, eri, c)


def test_host_chemistry_equals_jax():
    """Integrals, RHF/UHF, MO transform, ordering and the FCI oracle are
    the same host numpy code in both packages."""
    for pkg_out in zip(_mol(tc, 3, 1.65)[1:], _mol(jc, 3, 1.65)[1:]):
        np.testing.assert_array_equal(*pkg_out)
    _, s, hcore, eri, _ = _mol(tc, 3, 1.65)
    for a, b in zip(tc.restricted_hartree_fock(s, hcore, eri, 2),
                    jc.restricted_hartree_fock(s, hcore, eri, 2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tc.unrestricted_hartree_fock(s, hcore, eri, 2, 1),
                    jc.unrestricted_hartree_fock(s, hcore, eri, 2, 1)):
        np.testing.assert_array_equal(a, b)
    _, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 2)
    h1, g2 = tc.mo_transform(hcore, eri, c)
    np.testing.assert_array_equal(tc.orbital_ordering(h1, g2),
                                  jc.orbital_ordering(h1, g2))
    assert tc.chemistry_terms(h1, g2) == jc.chemistry_terms(h1, g2)
    assert tc.fci_ground(h1, g2, 2, k=3).tolist() == \
        np.atleast_1d(jc.fci_ground(h1, g2, 2, k=3)).tolist()
    for a, b in zip(tc.fci_rdms(h1, g2, 2), jc.fci_rdms(h1, g2, 2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gaussians_equal_jax():
    """The general-angular-momentum engine on LiH (s and p shells) and the
    frozen-core transform: identical to the JAX package's copy."""
    xyz = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.015]])
    tb, tch = tg.sto3g_shell_basis(["Li", "H"], xyz)
    jb, jch = jg.sto3g_shell_basis(["Li", "H"], xyz)
    np.testing.assert_array_equal(tch, jch)
    for a, b in zip(tg.molecular_integrals_general(tb, tch, xyz),
                    jg.molecular_integrals_general(jb, jch, xyz)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.dipole_integrals(tb), jg.dipole_integrals(jb))
    for t in (0.0, 0.5, 40.0):
        np.testing.assert_array_equal(tg.boys(3, t), jg.boys(3, t))
    s, hcore, eri, _ = tg.molecular_integrals_general(tb, tch, xyz)
    _, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 4)
    h1, g2 = tc.mo_transform(hcore, eri, c)
    for a, b in zip(tg.freeze_core(h1, g2, 1), jg.freeze_core(h1, g2, 1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("symmetric", [False, True])
def test_chunked_mpo_matches_jax_densely(h2, symmetric):
    """H2's 28 terms compiled 12 a chunk (folded by mpo_sum + compression on
    the device): the same dense operator as the JAX package's."""
    h1, g2 = h2[2], h2[3]
    got = tc.chemistry_mpo(h1, g2, chunk=12, symmetric=symmetric, device="cpu")
    want = jc.chemistry_mpo(h1, g2, chunk=12, symmetric=symmetric)
    dense = _dense(*mpo_to_numpy(got))
    np.testing.assert_allclose(
        dense, _dense(*(np.asarray(a) for a in (want.cores, want.left,
                                                 want.right))), atol=TOL)
    if symmetric:
        tu1.mpo_channel_charges(got, (0, 1))  # raises if not definite


def test_dmrg_routes_reach_fci(h2, h3):
    h1, g2 = h2[2], h2[3]
    e, mps, mpo = tc.chemistry_dmrg(h1, g2, 2, max_bond=8, sweeps=4, device="cpu")
    assert abs(e - tc.fci_ground(h1, g2, n_elec=2)) < TOL
    gamma, gam2 = tc.one_rdm(mps), tc.two_rdm(mps)
    f1, f2 = tc.fci_rdms(h1, g2, 2)
    np.testing.assert_allclose(gamma, f1, atol=1e-8)
    np.testing.assert_allclose(gam2, f2, atol=1e-8)
    assert abs(tc.rdm_energy(h1, g2, gamma, gam2) - e) < 1e-8
    assert abs(tc.natural_occupations(mps).sum() - 2.0) < 1e-8
    # the cation sector held structurally (charge masks, no penalty)
    h1c, g2c = h3
    e, mps, _, masks = tc.chemistry_dmrg_u1(
        h1c, g2c, 2, bond_dim=16, sweeps=4,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert abs(e - tc.fci_ground(h1c, g2c, 2)) < 1e-9
    assert not (mps.cores * (1 - masks)).any()


def test_penalty_route_reaches_fci_where_mkl_eigh_fails():
    """H4 at bond 16 through the penalty route: the dense two-site solves
    meet zero-padded effective Hamiltonians whose degenerate spectra make
    MKL's CPU ``eigh`` raise (the local solve then uses numpy's LAPACK);
    both routes reach the determinant FCI."""
    _, s, hcore, eri, _ = _mol(tc, 4, 1.8)
    _, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 4)
    h1, g2 = tc.mo_transform(hcore, eri, c)
    e_fci = tc.fci_ground(h1, g2, n_elec=4)
    mpo = tc.chemistry_mpo(h1, g2, symmetric=True, device="cpu")
    e_pen, _, _ = tc.chemistry_dmrg(h1, g2, 4, max_bond=16, sweeps=4, mpo=mpo)
    assert abs(e_pen - e_fci) < 1e-10
    e_u1, _, _, _ = tc.chemistry_dmrg_u1(h1, g2, 4, bond_dim=32, sweeps=4, mpo=mpo,
                                         generator=torch.Generator().manual_seed(0))
    assert abs(e_u1 - e_fci) < 1e-10


def test_masked_route_matches_jax_from_the_determinant(h3):
    """The charge-masked route from the bare Hartree-Fock determinant (noise
    off, so both packages start from the same state): the same energy as
    the JAX package's at 1e-10, wherever its slot allocation leaves it."""
    h1, g2 = h3
    want, _, _, _ = jc.chemistry_dmrg_u1(h1, g2, 2, bond_dim=8, sweeps=2, noise=0.0)
    got, _, _, _ = tc.chemistry_dmrg_u1(h1, g2, 2, bond_dim=8, sweeps=2, noise=0.0,
                                        device="cpu")
    assert abs(got - want) < TOL


@pytest.fixture(scope="module")
def h4():
    """H4 at 1.8 bohr (8 spin-orbitals, four electrons), MO basis, with its
    FCI energy and each package's charge-blocked operator."""
    _, s, hcore, eri, _ = _mol(tc, 4, 1.8)
    _, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 4)
    h1, g2 = tc.mo_transform(hcore, eri, c)
    return (h1, g2, tc.fci_ground(h1, g2, n_elec=4),
            jc.chemistry_mpo(h1, g2, symmetric=True),
            tc.chemistry_mpo(h1, g2, symmetric=True, device="cpu"))


@pytest.mark.parametrize("bond,tol", [(8, TOL), (12, 1e-4)])
def test_masked_route_matches_jax_below_full_bond(h4, bond, tol, monkeypatch):
    """H4 below the bond that holds every Schmidt rank (16), from the same
    determinant and the same masked noise in both packages (each package's
    normal draw patched to one numpy array): the masked route stops above
    FCI, where ``u1_bond_charges``' slot split leaves it, at the JAX
    package's energy.  At bond 8 that level is determined (the JAX package
    reaches it from five keys within 1e-13), so the two agree at 1e-10; at
    bond 12 it depends on the start and on the SVD's choice of null
    directions in rank-deficient classes (the JAX package's own energies
    over five keys span 1.0e-4), so they agree to that spread."""
    import jax
    import jax.numpy as jnp

    h1, g2, e_fci, jmpo, tmpo = h4
    draw = np.random.default_rng(bond).normal(size=(8, 2, bond, bond))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(draw, dtype))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(draw.copy()))
    want, _, _, _ = jc.chemistry_dmrg_u1(h1, g2, 4, bond_dim=bond, sweeps=4, mpo=jmpo)
    got, mps, _, masks = tc.chemistry_dmrg_u1(h1, g2, 4, bond_dim=bond, sweeps=4,
                                              mpo=tmpo)
    assert abs(got - want) < tol
    assert got - e_fci > 1e-3 and want - e_fci > 1e-3
    assert not (mps.cores * (1 - masks)).any()


def test_excited_states_and_oscillator_strengths(h2):
    """H2's N = 2 sector: all six DMRG states against FCI, the bright
    sigma_g -> sigma_u singlet (state 4) and the dark triplets."""
    basis, c, h1, g2, _ = h2
    want = tc.fci_ground(h1, g2, 2, k=6)
    es, states = tc.chemistry_excited(h1, g2, 2, 6, max_bond=8, sweeps=5,
                                      generator=torch.Generator().manual_seed(1),
                                      device="cpu")
    np.testing.assert_allclose(es, want, atol=1e-8)
    d_mo = np.einsum("cpq,pi,qj->cij", tg.dipole_integrals(basis), c, c)
    f, tdip = tc.oscillator_strengths(es, states, d_mo)
    assert np.all(f[1:4] < 1e-12) and f[4] > 0.5
    assert np.abs(tdip[:, :2]).max() < 1e-12
    z_mpo = tc.one_body_mpo(d_mo[2], device="cpu")
    perm = tc.transition_element(z_mpo, states[0], states[0])
    gamma, _ = tc.fci_rdms(h1, g2, 2)
    assert abs(perm - np.einsum("pq,pq->", d_mo[2], gamma)) < 1e-8


def test_thermal_purification_matches_jax(h2):
    _, _, h1, g2, _ = h2
    e, n, _, _ = tc.chemistry_thermal(h1, g2, 0.5, max_bond=16, n_steps=2,
                                      device="cpu")
    je, jn, _, _ = jc.chemistry_thermal(h1, g2, 0.5, max_bond=16, n_steps=2)
    assert abs(e - je) < TOL and abs(n - jn) < TOL
    # the product-state helpers, entry by entry
    for got, want in (
            (tc.infinite_temperature_purification(3, device="cpu"),
             jc.infinite_temperature_purification(3)),
            (tc.determinant_mps([1, 0, 1, 1], 3, device="cpu"),
             jc.determinant_mps([1, 0, 1, 1], 3))):
        for a, b in zip(mps_to_numpy(got), (want.cores, want.left, want.right)):
            np.testing.assert_array_equal(a, np.asarray(b))
    mpo = tc.one_body_mpo(h1, device="cpu")
    jl = jc.ancilla_lift_mpo(jc.one_body_mpo(h1))
    np.testing.assert_allclose(
        _dense(*mpo_to_numpy(tc.ancilla_lift_mpo(mpo))),
        _dense(*(np.asarray(a) for a in (jl.cores, jl.left, jl.right))),
        atol=TOL)


def test_frozen_core_water_anchor():
    """STO-3G water at the experimental geometry: RHF within 2e-3 of the
    published -74.9630, frozen-core DMRG at bond 24 within 1e-7 of FCI."""
    half = np.deg2rad(104.52) / 2.0
    r = 0.9572 / 0.52917721067
    xyz = np.array([[0.0, 0.0, 0.0], [r * np.sin(half), 0.0, r * np.cos(half)],
                    [-r * np.sin(half), 0.0, r * np.cos(half)]])
    basis, ch = tg.sto3g_shell_basis(["O", "H", "H"], xyz)
    s, hcore, eri, e_nuc = tg.molecular_integrals_general(basis, ch, xyz)
    e_hf, c, _ = tc.restricted_hartree_fock(s, hcore, eri, 10)
    assert abs(e_hf + e_nuc - (-74.9630)) < 2e-3
    h1, g2 = tc.mo_transform(hcore, eri, c)
    h1a, ga, _ = tg.freeze_core(h1, g2, 1)
    e_fci = tc.fci_ground(h1a, ga, n_elec=8)
    e_dmrg, _, _ = tc.chemistry_dmrg(h1a, ga, 8, max_bond=24, sweeps=4,
                                     device="cpu")
    assert abs(e_dmrg - e_fci) < 1e-7
