"""Quasiparticle excitations (single-site and native cells) and cell VUMPS
of the PyTorch port against the JAX package, on the CPU.

The excitation machinery is deterministic given a ground state, so one
VUMPS ground (the port's, carried across with ``ground_to_numpy``) feeds
both packages, and band energies, spectral weights, environments and cell
observables are compared at 1e-10 on the same state.  Cell VUMPS itself
starts both packages from the same numpy cores (each package's normal draws
are patched: ``jax.random.normal`` and ``torch.randn``).  The JAX references are computed once
per file.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import ground_from_numpy, ground_to_numpy

jx = import_module("contractn_tpu.models.excitations")
tx = import_module("contractn_tpu_torch.models.excitations")
jxc = import_module("contractn_tpu.models.excitations_cell")
txc = import_module("contractn_tpu_torch.models.excitations_cell")
jvc = import_module("contractn_tpu.models.vumps_cell")
tvc = import_module("contractn_tpu_torch.models.vumps_cell")
jd = import_module("contractn_tpu.models.dmrg")
tv = import_module("contractn_tpu_torch.models.vumps")
tkr = import_module("contractn_tpu_torch.ops.krylov")

torch.set_num_threads(1)

TOL = 1e-10
H = 1.5
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])


class _Mpo:
    """A one-core MPO stand-in (only ``cores[0]`` is read)."""

    def __init__(self, w):
        self.cores = w[None]


def _patched_normal(draws):
    it = iter(draws)
    return lambda key, shape, dtype=None: jnp.asarray(next(it), dtype)


def _port_draws(draws, fn, *args, **kwargs):
    it = iter(draws)
    real = torch.randn
    torch.randn = lambda *a, **k: torch.from_numpy(np.array(next(it)))
    try:
        return fn(*args, **kwargs)
    finally:
        torch.randn = real


@pytest.fixture(scope="module")
def single():
    """TFIM h=1.5, bond 4: the port's ground and the JAX package's
    excitation references on it."""
    jm = jd.tfim_mpo(2, h=H)
    w = np.array(jm.cores[0])
    g = ground_to_numpy(tv.vumps(_Mpo(torch.from_numpy(w)), 4, iters=40,
                                 a0=np.random.default_rng(1).normal(size=(2, 4, 4)),
                                 device="cpu"))
    prep = jx.prepare_excitations(g, jm)
    ref = {k: np.asarray(jx.excitation_spectrum(g, jm, k, prep=prep))
           for k in (0.0, 1.0)}
    om, wt = jx.spectral_weights(g, jm, SZ, 0.7, prep=prep)
    return g, w, ref, (np.asarray(om), np.asarray(wt))


@pytest.mark.parametrize("k", [0.0, 1.0])
def test_excitation_spectrum_matches_jax(single, k):
    g, w, ref, _ = single
    got = tx.excitation_spectrum(ground_from_numpy(g, device="cpu"),
                                 _Mpo(torch.from_numpy(w)), k).numpy()
    np.testing.assert_allclose(got, ref[k], atol=TOL)
    pfeuty = 2.0 * np.sqrt(H * H - 2.0 * H * np.cos(k) + 1.0)
    assert abs(got[0] - pfeuty) < 1e-5


def test_spectral_weights_match_jax(single):
    g, w, _, (om, wt) = single
    got_om, got_wt = tx.spectral_weights(ground_from_numpy(g, device="cpu"),
                                         _Mpo(torch.from_numpy(w)), SZ, 0.7)
    np.testing.assert_allclose(got_om.numpy(), om, atol=TOL)
    np.testing.assert_allclose(got_wt.numpy(), wt, atol=TOL)


def test_dense_heff_is_one_batched_solve_per_channel(single, monkeypatch):
    """The JAX package vmaps whole GMRES solves over the (d-1) D^2 basis
    columns; here every solve carries the whole basis as its batch."""
    g, w, _, _ = single
    batches = []
    real = tkr.gmres

    def spy(matvec, b, *args, batch_ndim=0, **kw):
        batches.append(tuple(b.shape[:batch_ndim]))
        return real(matvec, b, *args, batch_ndim=batch_ndim, **kw)

    ground = ground_from_numpy(g, device="cpu")
    prep = tx.prepare_excitations(ground, _Mpo(torch.from_numpy(w)))
    monkeypatch.setattr(tx, "gmres", spy)
    tx.excitation_spectrum(ground, None, 0.3, prep=prep)
    n = (w.shape[0] - 1) * 4 * 4
    assert batches and set(batches) == {(n,)}


def test_dispersion_and_structure_factor_map(single):
    g, w, ref, (om, wt) = single
    ground = ground_from_numpy(g, device="cpu")
    mpo = _Mpo(torch.from_numpy(w))
    _, bands = tx.quasiparticle_dispersion(mpo, [0.0, 1.0], ground=ground,
                                           n_bands=2)
    np.testing.assert_allclose(bands, np.stack([ref[0.0][:2], ref[1.0][:2]]),
                               atol=TOL)
    grid = np.linspace(0.0, 8.0, 50)
    smap = tx.dynamic_structure_factor(ground, mpo, SZ, [0.7], grid, eta=0.1)
    lor = (0.1 / np.pi) / ((grid[None, :] - om[:, None]) ** 2 + 0.01)
    np.testing.assert_allclose(smap[0], wt @ lor, atol=1e-9)


@pytest.fixture(scope="module")
def cell():
    """A uniform TFIM on a 2-site cell, bond 4: the port's cell ground and
    the JAX package's excitation references on it."""
    w = np.array(jd.tfim_mpo(2, h=H).cores[0])
    rng = np.random.default_rng(2)
    cell0 = [rng.normal(size=(2, 4, 4)) for _ in range(2)]
    jg = ground_to_numpy(_port_draws(cell0, tvc.vumps_cell, [torch.from_numpy(w)] * 2,
                                     4, iters=30, device="cpu"))
    cores = [jnp.asarray(w)] * 2
    prep = jxc.prepare_excitations_cell(jg, cores)
    spec = np.asarray(jxc.excitation_spectrum_cell(jg, cores, 0.6, prep=prep))
    om, wt = jxc.spectral_weights_cell(jg, cores, SX, 0.4, prep=prep)
    return w, jg, spec, (np.asarray(om), np.asarray(wt))


def test_vumps_cell_matches_jax():
    """Four iterations of both packages' cell VUMPS from the same start
    cores: the uniform TFIM on a 2-site cell (the JAX test's case)."""
    w = np.array(jd.tfim_mpo(2, h=H).cores[0])
    rng = np.random.default_rng(3)
    cell0 = [rng.normal(size=(2, 4, 4)) for _ in range(2)]
    real = jax.random.normal
    jax.random.normal = _patched_normal(cell0)
    try:
        jg = jvc.vumps_cell([jnp.asarray(w)] * 2, 4, iters=4)
    finally:
        jax.random.normal = real
    tg = _port_draws(cell0, tvc.vumps_cell, [torch.from_numpy(w)] * 2, 4, iters=4,
                     device="cpu")
    np.testing.assert_allclose(tg["energies"], jg["energies"], atol=TOL)
    assert abs(tg["gradient_norm"] - jg["gradient_norm"]) < 1e-9
    for c_t, c_j in zip(tg["cs"], jg["cs"]):
        np.testing.assert_allclose(np.diag(c_t.numpy()), np.diag(np.asarray(c_j)),
                                   atol=1e-9)


def test_cell_environments_and_observables_match_jax(cell):
    w, jg, _, _ = cell
    g = ground_from_numpy(jg, device="cpu")
    jfl, jfr, je = jvc.mpo_environments_cell(jg["als"], jg["ars"], jg["cs"],
                                             [jnp.asarray(w)] * 2)
    fl, fr, e = tvc.mpo_environments_cell(g["als"], g["ars"], g["cs"],
                                          [torch.from_numpy(w)] * 2)
    assert abs(e - float(je)) < TOL
    for a, b in zip(fl + fr, tuple(jfl) + tuple(jfr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
    for site in (0, 1):
        assert abs(tvc.expect_local_cell(g, SX, site)
                   - jvc.expect_local_cell(jg, SX, site)) < TOL
    np.testing.assert_allclose(tvc.correlate_cell(g, SZ, SZ, 1, [1, 2, 5]),
                               jvc.correlate_cell(jg, SZ, SZ, 1, [1, 2, 5]),
                               atol=TOL)
    np.testing.assert_allclose(
        tvc.correlate_cell(g, SX, SX, 0, [2, 3], string=SZ),
        jvc.correlate_cell(jg, SX, SX, 0, [2, 3], string=SZ), atol=TOL)
    np.testing.assert_allclose(
        tvc.static_structure_factor_cell(g, SX, [0.0, 1.0], max_distance=20),
        jvc.static_structure_factor_cell(jg, SX, [0.0, 1.0], max_distance=20),
        atol=TOL)


def test_mixed_gauge_cell_matches_jax():
    rng = np.random.default_rng(4)
    cell0 = [rng.normal(size=(2, 5, 5)), rng.normal(size=(3, 5, 5))]
    jal, jar, jcs = jvc.mixed_gauge_cell(tuple(jnp.asarray(a) for a in cell0))
    als, ars, cs = tvc.mixed_gauge_cell(tuple(torch.from_numpy(a) for a in cell0))
    for i in range(2):
        np.testing.assert_allclose(np.diag(cs[i].numpy()),
                                   np.diag(np.asarray(jcs[i])), atol=TOL)
        j = (i + 1) % 2
        np.testing.assert_allclose(
            np.einsum("dij,jk->dik", als[i].numpy(), cs[j].numpy()),
            np.einsum("ij,djk->dik", cs[i].numpy(), ars[i].numpy()), atol=1e-9)


def test_cell_spectrum_and_weights_match_jax(cell):
    w, jg, spec, (om, wt) = cell
    g = ground_from_numpy(jg, device="cpu")
    cores = [torch.from_numpy(w)] * 2
    prep = txc.prepare_excitations_cell(g, cores)
    got = txc.excitation_spectrum_cell(g, cores, 0.6, prep=prep).numpy()
    np.testing.assert_allclose(got, spec, atol=TOL)
    got_om, got_wt = txc.spectral_weights_cell(g, cores, SX, 0.4, prep=prep)
    np.testing.assert_allclose(got_om.numpy(), om, atol=TOL)
    np.testing.assert_allclose(got_wt.numpy(), wt, atol=TOL)
    _, bands = txc.quasiparticle_dispersion_cell(cores, [0.6], ground=g)
    assert abs(bands[0, 0] - spec[0]) < TOL
    smap = txc.dynamic_structure_factor_cell(g, cores, SX, [0.4], [1.0, 2.0],
                                             eta=0.1)
    lor = (0.1 / np.pi) / ((np.array([1.0, 2.0])[None] - om[:, None]) ** 2 + 0.01)
    np.testing.assert_allclose(smap[0], wt @ lor, atol=1e-9)


def test_excitation_minimum_cell_matches_the_dense_band(cell):
    """Projected Lanczos (its own generator start) lands on the lowest
    dense band of the JAX package at the same momentum."""
    w, jg, spec, _ = cell
    g = ground_from_numpy(jg, device="cpu")
    e, bs = txc.excitation_minimum_cell(g, [torch.from_numpy(w)] * 2, 0.6,
                                        generator=torch.Generator().manual_seed(0))
    assert abs(e - spec[0]) < 1e-8
    assert len(bs) == 2 and bs[0].shape == (2, 4, 4)


def test_unfolded_bands_match_jax():
    """ARPES-style unfolding of the dimerized XX chain folded into d = 4
    sites, on one blocked ground (the port's, bond 4): the dominant pole
    and its weight share at each per-site momentum equal the JAX
    package's."""
    j_mpo = jd.xx_dimerized_mpo(2, 1.0, 0.5)
    jblocked = import_module("contractn_tpu.models.mpo").block_mpo(j_mpo, 2)
    w = np.array(jblocked.cores[0])
    g = ground_to_numpy(tv.vumps(_Mpo(torch.from_numpy(w)), 4, iters=30,
                                 a0=np.random.default_rng(5).normal(size=(4, 4, 4)),
                                 device="cpu"))
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    kappas = [0.3, 0.3 + np.pi]
    _, j_om, j_share = jx.unfolded_bands(j_mpo, kappas, sp, ground=g)
    t_mpo = import_module("contractn_tpu_torch.convert").mpo_from_numpy(
        *(np.array(a) for a in (j_mpo.cores, j_mpo.left, j_mpo.right)), device="cpu")
    _, om, share = tx.unfolded_bands(t_mpo, kappas, sp,
                                     ground=ground_from_numpy(g, device="cpu"))
    np.testing.assert_allclose(om, j_om, atol=TOL)
    np.testing.assert_allclose(share, j_share, atol=TOL)
