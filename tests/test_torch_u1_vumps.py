"""Charge-masked VUMPS (one-site and native cells) of the PyTorch port
against the JAX package, on the CPU.

The ladders, masks and selectors are host bookkeeping and compare exactly.
Both packages' VUMPS start from the same numpy cores (each package's
normal draws are patched: ``jax.random.normal`` and ``torch.randn``).  The masked start
is an aligned orthogonalization whose singular vectors carry the LAPACK
build's sign convention, so the JAX run is handed the port's start gauge
(its module's ``_aligned_ortho`` patched to the port's); the energy traces
then agree at 1e-10, with the sector leak exactly zero.
Sector excitation minima (projected Lanczos from each package's own draw)
are compared with the JAX package's on the same ground state.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import ground_from_numpy, ground_to_numpy

ju = import_module("contractn_tpu.models.u1_vumps")
tu = import_module("contractn_tpu_torch.models.u1_vumps")
juc = import_module("contractn_tpu.models.u1_vumps_cell")
tuc = import_module("contractn_tpu_torch.models.u1_vumps_cell")
jmodels = import_module("contractn_tpu.models")
jx = import_module("contractn_tpu.models.excitations")
jh = import_module("contractn_tpu.models.hubbard")
tu1 = import_module("contractn_tpu_torch.models.u1")

torch.set_num_threads(1)

TOL = 1e-10
FOLDED = (2, 0, 0, -2)
Q4 = (33, 31, -31, -33)  # (2 n_up - 1) * 32 + (2 n_dn - 1), d = 4


def _tmpo(jm):
    from contractn_tpu_torch.convert import mpo_from_numpy

    return mpo_from_numpy(*(np.array(a) for a in (jm.cores, jm.left, jm.right)),
                          device="cpu")


def _with_draws(draws, fn, *args, **kwargs):
    it = iter(draws)
    real = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=None: jnp.asarray(next(it), dtype)
    try:
        return fn(*args, **kwargs)
    finally:
        jax.random.normal = real


def _port_draws(draws, fn, *args, **kwargs):
    it = iter(draws)
    real = torch.randn
    torch.randn = lambda *a, **k: torch.from_numpy(np.array(next(it)))
    try:
        return fn(*args, **kwargs)
    finally:
        torch.randn = real


def _port_ortho(mat, row_sel, slot_sel):
    """The port's aligned orthogonalization on JAX arrays."""
    q, c = tu1._aligned_ortho(*(torch.from_numpy(np.array(a)) for a in
                                (mat, row_sel, slot_sel)),
                              tu._rank(torch.from_numpy(np.array(slot_sel))))
    return jnp.asarray(q.numpy()), jnp.asarray(c.numpy())


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("phys", [FOLDED, jh.hubbard_relative_charges()])
def test_uniform_ladders_and_sectors_match_jax(phys):
    for bond in (8, 16, 24, 48):
        assert np.array_equal(tu.u1_uniform_charges(phys, bond),
                              ju.u1_uniform_charges(phys, bond))
    got = tu.u1_uniform_sector(phys, 16, device="cpu")
    want = ju.u1_uniform_sector(phys, 16)
    for key in ("site_mask", "bond_mask", "row_sel", "row_t_sel", "slot_sel"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
    for dq in (0, 2, -2):
        np.testing.assert_array_equal(_np(tu.excitation_charge_masks(got, dq)),
                                      _np(ju.excitation_charge_masks(want, dq)))


@pytest.mark.parametrize("phys_list", [[(1, -1)] * 2, [(1, -1), (2, 0, 0, -2)],
                                       [Q4, Q4]])
def test_cell_ladders_and_sectors_match_jax(phys_list):
    for bond in (8, 16, 32):
        for a, b in zip(tuc.u1_cell_charges(phys_list, bond),
                        juc.u1_cell_charges(phys_list, bond)):
            assert np.array_equal(a, b)
    got = tuc.u1_cell_sector(phys_list, 16, device="cpu")
    want = juc.u1_cell_sector(phys_list, 16)
    for key in ("site_masks", "bond_masks", "row_sels", "row_t_sels", "slot_sels"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(tuc.excitation_charge_masks_cell(got, 2),
                    juc.excitation_charge_masks_cell(want, 2)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_string_parities_match_jax():
    sec = [(1, -1)] * 2
    got = tuc.string_parities_cell(tuc.u1_cell_sector(sec, 16, device="cpu"),
                                   (-1, 1))
    want = juc.string_parities_cell(juc.u1_cell_sector(sec, 16), (-1, 1))
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(_np(a), _np(b))
    with pytest.raises(ValueError, match="parity"):
        tuc.string_parities_cell(tuc.u1_cell_sector([(1, -1, 3)] * 2, 8,
                                                    device="cpu"), (1, -1, 1))


@pytest.fixture(scope="module")
def xxz():
    """Folded gapped XXZ (Delta = 2), bond 8: both packages from one start
    core and gauge."""
    jcell = jmodels.block_mpo(jmodels.xxz_mpo_u1(2, jz=2.0), 2)
    a0 = np.random.default_rng(0).normal(size=(4, 8, 8))
    real = ju._aligned_ortho
    ju._aligned_ortho = _port_ortho
    try:
        want = _with_draws([a0], ju.vumps_u1, jcell, 8, FOLDED, iters=6)
    finally:
        ju._aligned_ortho = real
    got = _port_draws([a0], tu.vumps_u1, _tmpo(jcell), 8, FOLDED, iters=6,
                      device="cpu")
    return jcell, want, got


def test_vumps_u1_matches_jax(xxz):
    _, want, got = xxz
    np.testing.assert_allclose(got["energies"], want["energies"], atol=TOL)
    mask = got["sector"]["site_mask"]
    for key in ("al", "ar", "ac"):
        assert not (got[key] * (1 - mask)).any()
    assert not (got["c"] * (1 - got["sector"]["bond_mask"])).any()


def test_expand_sector_state_matches_jax(xxz):
    """Embedding the same converged state into a wider ladder, noise off:
    the same tensors in the same slots."""
    _, want, _ = xxz
    jgrown = ju.expand_sector_state(want, 16, noise=0.0)
    tgrown = tu.expand_sector_state(ground_from_numpy(want, device="cpu"), 16,
                                    noise=0.0)
    for key in ("al", "ar", "ac", "c"):
        np.testing.assert_array_equal(tgrown[key].numpy(), np.asarray(jgrown[key]))
    for key in ("charges", "site_mask", "bond_mask"):
        np.testing.assert_array_equal(_np(tgrown["sector"][key]),
                                      _np(jgrown["sector"][key]))
    with pytest.raises(ValueError, match="room"):
        tu.expand_sector_state(ground_from_numpy(want, device="cpu"), 3,
                               charges=np.asarray([0, 0, 0]))


def test_sector_excitation_minimum_matches_jax():
    """Charged bands of the folded dimerized XX chain above one masked
    ground (the port's, carried across): each package's projected Lanczos
    lands on the same sector minimum."""
    j, delta = 1.5, 1.0 / 3.0
    jcell = jmodels.block_mpo(jmodels.xx_dimerized_mpo(2, j, delta), 2)
    g = _port_draws([np.random.default_rng(1).normal(size=(4, 8, 8))], tu.vumps_u1,
                    _tmpo(jcell), 8, FOLDED, iters=60, device="cpu")
    jg = {**ground_to_numpy(g), "sector": ju.u1_uniform_sector(FOLDED, 8)}
    prep = jx.prepare_excitations(jg, jcell)
    want, _ = ju.sector_excitation_minimum(jg, jcell, 2, 0.0, prep=prep)
    got, b = tu.sector_excitation_minimum(g, _tmpo(jcell), 2, 0.0,
                                          generator=torch.Generator().manual_seed(0))
    assert abs(got - float(want)) < 1e-8
    assert not (b * (1 - tu.excitation_charge_masks(g["sector"], 2))).any()
    with pytest.raises(ValueError, match="live tangent"):
        tu.sector_excitation_minimum(g, _tmpo(jcell), 99, 0.0)


@pytest.fixture(scope="module")
def native_xxz():
    """Native d=2 XXZ cell on alternating ladders, bond 8."""
    w = np.array(jmodels.xxz_mpo_u1(4, jz=2.0).cores[1])
    rng = np.random.default_rng(2)
    cell0 = [rng.normal(size=(2, 8, 8)) for _ in range(2)]
    real = juc._aligned_ortho
    juc._aligned_ortho = _port_ortho
    try:
        want = _with_draws(cell0, juc.vumps_u1_cell, [jnp.asarray(w)] * 2, 8,
                           (1, -1), iters=4)
    finally:
        juc._aligned_ortho = real
    got = _port_draws(cell0, tuc.vumps_u1_cell, [torch.from_numpy(w)] * 2, 8,
                      (1, -1), iters=30, device="cpu")
    return w, want, got


def test_vumps_u1_cell_matches_jax(native_xxz):
    _, want, got = native_xxz
    np.testing.assert_allclose(got["energies"][:4], want["energies"], atol=TOL)
    for i in range(2):
        mask = got["sector"]["site_masks"][i]
        for key in ("als", "ars", "acs"):
            assert not (got[key][i] * (1 - mask)).any()


def test_sector_excitation_minimum_cell_matches_the_dense_spectrum(native_xxz):
    """On the converged native cell ground, the charge-2 minimum
    (projected Lanczos, reproducible from a fixed generator) is an
    eigenvalue of the full dense cell ``H_eff`` at the same momentum (the
    masks commute with it), and its tensors stay in the sector."""
    w, _, got = native_xxz
    assert got["gradient_norm"] < 1e-9
    cores = [torch.from_numpy(w)] * 2
    txc = import_module("contractn_tpu_torch.models.excitations_cell")
    prep = txc.prepare_excitations_cell(got, cores)
    e1, bs = tuc.sector_excitation_minimum_cell(
        got, cores, 2, 0.0, prep=prep, generator=torch.Generator().manual_seed(0))
    e2, _ = tuc.sector_excitation_minimum_cell(
        got, cores, 2, 0.0, prep=prep, generator=torch.Generator().manual_seed(0))
    assert e1 == e2
    spec = txc.excitation_spectrum_cell(got, cores, 0.0, prep=prep).numpy()
    assert np.abs(spec - e1).min() < 1e-8
    masks = tuc.excitation_charge_masks_cell(got["sector"], 2)
    assert all(not (b * (1 - m)).any() for b, m in zip(bs, masks))
    with pytest.raises(ValueError, match="live tangent"):
        tuc.sector_excitation_minimum_cell(got, cores, 99, 0.0, prep=prep)


def test_fermionic_spectral_weights_match_jax(native_xxz):
    """The string-dressed removal operator on the converged masked cell
    ground (the port's, carried across): the telescoped Jordan-Wigner
    parities, the wrap sign, the poles and each level's weight equal the
    JAX package's."""
    w, _, got = native_xxz
    sm = np.array([[0.0, 0.0], [1.0, 0.0]])
    t_par, t_sign = tuc.string_parities_cell(got["sector"], (-1, 1))
    jg = ground_to_numpy(got)
    jg["sector"] = juc.u1_cell_sector([(1, -1)] * 2, 8,
                                      charges=list(got["sector"]["charges"]))
    j_par, j_sign = juc.string_parities_cell(jg["sector"], (-1, 1))
    assert t_sign == j_sign
    for a, b in zip(t_par, j_par):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jxc = import_module("contractn_tpu.models.excitations_cell")
    txc = import_module("contractn_tpu_torch.models.excitations_cell")
    want = jxc.spectral_weights_cell(jg, [jnp.asarray(w)] * 2, sm, 1.2,
                                     string_parities=j_par, cell_sign=j_sign)
    om, wt = txc.spectral_weights_cell(got, [torch.from_numpy(w)] * 2, sm, 1.2,
                                       string_parities=t_par, cell_sign=t_sign)
    np.testing.assert_allclose(om.numpy(), np.asarray(want[0]), atol=TOL)
    # within a degenerate level the weights depend on the eigenvector basis
    # eigh returns; each level's total does not
    levels = np.cumsum(np.r_[0, np.diff(om.numpy()) > 1e-8])
    for got_w, want_w in zip(np.bincount(levels, wt.numpy()),
                             np.bincount(levels, np.asarray(want[1]))):
        assert abs(got_w - want_w) < TOL
