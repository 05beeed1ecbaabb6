"""Fermion, 2D spin and Hubbard builders of the PyTorch port against the JAX
package, on the CPU.

The builders are host numpy in both packages: uncompressed MPOs compare
entry by entry, compressed ones as dense operators (and by width), the
oracles (BdG energies, Fock Hamiltonians, Lieb-Wu integrals) exactly or at
1e-10.  Ground energies of the port's DMRG (plain and charge-masked) are
held against the exact free-fermion and sector-ED values at the JAX tests'
small sizes; the Hubbard sector state pins ``cores * (1 - masks) == 0`` and
its spin densities sum to the sector's particle numbers.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy

jf = import_module("contractn_tpu.models.fermions")
tf = import_module("contractn_tpu_torch.models.fermions")
jf2 = import_module("contractn_tpu.models.fermions2d")
tf2 = import_module("contractn_tpu_torch.models.fermions2d")
js = import_module("contractn_tpu.models.spin2d")
ts = import_module("contractn_tpu_torch.models.spin2d")
jh = import_module("contractn_tpu.models.hubbard")
th = import_module("contractn_tpu_torch.models.hubbard")
tdmrg = import_module("contractn_tpu_torch.models.dmrg")

torch.set_num_threads(1)

TOL = 1e-10


def _same(jmpo, tmpo):
    for a, b in zip((jmpo.cores, jmpo.left, jmpo.right), mpo_to_numpy(tmpo)):
        a = np.asarray(a)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=0, rtol=0)


def _dense(cores, left, right):
    cores, left, right = (np.asarray(a) for a in (cores, left, right))
    d = cores.shape[1]
    cur = np.einsum("w,abwv->abv", left, cores[0])
    for w in cores[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(d * dd, d * dd, -1)
    return np.einsum("ABv,v->AB", cur, right)


def _ground(mpo, n, bond, sweeps=6, seed=0):
    mps0 = tdmrg.MPS.random(n, mpo.cores.shape[1], bond, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")
    return tdmrg.dmrg(mpo, mps0, max_bond=bond, sweeps=sweeps)


@pytest.mark.parametrize("kw", [dict(), dict(t=1.0, delta=0.6, mu=0.4),
                                dict(t=0.7, delta=-0.3, mu=2.5)])
def test_kitaev_chain_matches_jax_and_bdg(kw):
    _same(jf.kitaev_chain_mpo(8, **kw), tf.kitaev_chain_mpo(8, device="cpu", **kw))
    e = tf.free_fermion_energy(8, **kw)
    assert e == jf.free_fermion_energy(8, **kw)
    _, energy, _ = _ground(tf.kitaev_chain_mpo(8, device="cpu", **kw), 8, 16)
    assert abs(energy - e) < 1e-9


@pytest.mark.parametrize("lx, ly, kw", [
    (2, 2, dict(t=1.0, mu=0.3)), (3, 2, dict(t=1.0, mu=0.2, delta=0.5)),
    (3, 2, dict(t=0.8, periodic_x=True)),
])
def test_fermion2d_matches_jax(lx, ly, kw):
    _same(jf2.fermion2d_mpo(lx, ly, **kw),
          tf2.fermion2d_mpo(lx, ly, device="cpu", **kw))
    e = tf2.free_fermion_energy_2d(lx, ly, **kw)
    assert abs(e - jf2.free_fermion_energy_2d(lx, ly, **kw)) < TOL
    assert tf2.snake_index(1, 0, lx) == jf2.snake_index(1, 0, lx)
    _, energy, _ = _ground(tf2.fermion2d_mpo(lx, ly, device="cpu", **kw),
                           lx * ly, 16)
    assert abs(energy - e) < 1e-8


def test_string_mpo_matches_jax():
    z = np.diag([1.0, -1.0])
    terms = [(0.5, [(0, tf2._SP), (3, tf2._SM)], z),
             (-1.5, [(1, tf2._SM), (2, z), (4, tf2._SP)], np.eye(2))]
    onsite = [(2, 0.3 * z)]
    _same(jf2.string_mpo(5, terms, onsite=onsite),
          tf2.string_mpo(5, terms, onsite=onsite, device="cpu"))
    with pytest.raises(ValueError, match="increase"):
        tf2.string_mpo(4, [(1.0, [(2, z), (1, z)], z)], device="cpu")


@pytest.mark.parametrize("build, kw", [("tfim2d_mpo", dict(j=1.0, h=0.8)),
                                       ("heisenberg2d_mpo", dict(jz=1.3))])
def test_spin2d_matches_jax(build, kw):
    jm = getattr(js, build)(3, 2, **kw)
    tm = getattr(ts, build)(3, 2, device="cpu", **kw)
    assert tm.cores.shape[3] == jm.cores.shape[3]
    want = _dense(jm.cores, jm.left, jm.right)
    got = _dense(*mpo_to_numpy(tm))
    assert np.max(np.abs(got - want)) < TOL * np.max(np.abs(want))
    raw = ts.spin2d_mpo(3, 2, [(1.0, ts._SZ, ts._SZ)], compress=False, device="cpu")
    _same(js.spin2d_mpo(3, 2, [(1.0, js._SZ, js._SZ)], compress=False), raw)
    e_ed = float(np.linalg.eigvalsh(want)[0])
    _, energy, _ = _ground(tm, 6, 8)
    assert abs(energy - e_ed) < 1e-9


def test_hubbard_builders_and_oracles_match_jax():
    _same(jh.hubbard2d_mpo(2, 2, t=1.0, u=3.0, mu=0.5),
          th.hubbard2d_mpo(2, 2, t=1.0, u=3.0, mu=0.5, device="cpu"))
    _same(jh.hubbard_chain_cell(u=4.0, mu=0.3),
          th.hubbard_chain_cell(u=4.0, mu=0.3, device="cpu"))
    hj = jh.hubbard_fock_hamiltonian(2, 1, u=4.0, mu=0.7)
    assert np.array_equal(hj, th.hubbard_fock_hamiltonian(2, 1, u=4.0, mu=0.7))
    tm = th.hubbard2d_mpo(2, 1, u=4.0, mu=0.7, device="cpu")
    np.testing.assert_allclose(_dense(*mpo_to_numpy(tm)), hj, atol=1e-12)
    assert th.hubbard_phys_charges(3, 2) == jh.hubbard_phys_charges(3, 2)
    assert th.hubbard_relative_charges() == jh.hubbard_relative_charges()
    assert th.so_index(1, 2, 1, 3) == jh.so_index(1, 2, 1, 3)
    assert th.hubbard_sector_ed(2, 2, 2, 1) == jh.hubbard_sector_ed(2, 2, 2, 1)
    assert th.hubbard_ed_energy(2, 1) == jh.hubbard_ed_energy(2, 1)
    for u in (2.0, 4.0):
        assert abs(th.lieb_wu_energy(u) - jh.lieb_wu_energy(u)) < TOL
        assert abs(th.hubbard_charge_gap(u) - jh.hubbard_charge_gap(u)) < TOL


def test_hubbard_vumps_matches_jax():
    """The infinite half-filled Hubbard chain at the JAX test's U = 8 (the
    d = 16 folded cell, charge-masked VUMPS) at bond 16: both packages
    start from the same draws and gauge (the JAX module's draw is patched
    and its aligned orthogonalization is the port's, whose singular
    vectors carry this build's LAPACK signs), and their energy traces
    agree."""
    import jax
    import jax.numpy as jnp

    ju = import_module("contractn_tpu.models.u1_vumps")
    tu = import_module("contractn_tpu_torch.models.u1_vumps")
    tu1 = import_module("contractn_tpu_torch.models.u1")
    a0 = np.random.default_rng(0).normal(size=(16, 16, 16))

    def port_ortho(mat, row_sel, slot_sel):
        sel = torch.from_numpy(np.array(slot_sel))
        q, c = tu1._aligned_ortho(torch.from_numpy(np.array(mat)),
                                  torch.from_numpy(np.array(row_sel)), sel,
                                  tu._rank(sel))
        return jnp.asarray(q.numpy()), jnp.asarray(c.numpy())

    real_normal, real_ortho = jax.random.normal, ju._aligned_ortho
    jax.random.normal = lambda key, shape, dtype=None: jnp.asarray(a0, dtype)
    ju._aligned_ortho = port_ortho
    try:
        want = jh.hubbard_vumps(8.0, bond_dims=(16,), iters=8)
    finally:
        jax.random.normal, ju._aligned_ortho = real_normal, real_ortho
    real_randn = torch.randn
    torch.randn = lambda *a, **k: torch.from_numpy(a0.copy())
    try:
        got = th.hubbard_vumps(8.0, bond_dims=(16,), iters=8, device="cpu")
    finally:
        torch.randn = real_randn
    np.testing.assert_allclose(got["energies"], want["energies"], atol=TOL)
    assert abs(got["energy_per_site"] - want["energy_per_site"]) < TOL
    mask = got["sector"]["site_mask"]
    assert not any((got[k] * (1 - mask)).any() for k in ("al", "ar", "ac"))


@pytest.mark.parametrize("n_up, n_dn", [(2, 2), (2, 1)])
def test_hubbard_sector_dmrg_matches_sector_ed(n_up, n_dn):
    mps, energy, energies, masks = th.hubbard_dmrg_sector(
        2, 2, n_up, n_dn, 16, sweeps=6,
        generator=torch.Generator().manual_seed(1), device="cpu")
    assert abs(float(energy) - th.hubbard_sector_ed(2, 2, n_up, n_dn)) < 1e-9
    assert torch.count_nonzero(mps.cores * (1 - masks)) == 0
    trace = energies.numpy()
    assert np.all(np.diff(trace) <= 1e-10 * np.abs(trace[:-1]))
    up, dn = th.spin_densities(mps, 2, 2)
    assert abs(up.sum() - n_up) < 1e-10 and abs(dn.sum() - n_dn) < 1e-10
