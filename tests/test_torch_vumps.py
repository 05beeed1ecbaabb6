"""VUMPS and the uniform-MPS tooling of the PyTorch port against the JAX
package, on the CPU.

Both packages start VUMPS from the same numpy core (the JAX module's draw
is patched, the port takes ``a0=``) and are compared at 1e-10 through
invariants: the energy trace, C's singular values, transfer spectra.
Deterministic functions of the same inputs (mixed gauge, environments,
correlators, the exact window distribution) are compared directly; the
sampler (its own generator draws) against the exact distribution with a
fixed seed and a 5-sigma bound.  The file also rehearses ``chip_smoke.py``'s
phase 10 on the CPU.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from contractn_tpu_torch.convert import ground_from_numpy, mpo_from_numpy

jv = import_module("contractn_tpu.models.vumps")
tv = import_module("contractn_tpu_torch.models.vumps")
ju = import_module("contractn_tpu.models.umps")
tu = import_module("contractn_tpu_torch.models.umps")
jd = import_module("contractn_tpu.models.dmrg")

torch.set_num_threads(1)

TOL = 1e-10
D = 8
SZ = np.diag([1.0, -1.0])


def _tmpo(jm):
    return mpo_from_numpy(*(np.asarray(a) for a in (jm.cores, jm.left, jm.right)),
                          device="cpu")


def jax_vumps_from(a0, *args, **kwargs):
    """The JAX package's ``vumps`` started from the numpy core ``a0``."""
    real = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=None: jnp.asarray(a0, dtype)
    try:
        return jv.vumps(*args, **kwargs)
    finally:
        jax.random.normal = real


@pytest.fixture(scope="module")
def tfim():
    """TFIM h=1.5 at bond 8 (the JAX test's size), both packages from one
    start core."""
    jm = jd.tfim_mpo(2, h=1.5)
    a0 = np.random.default_rng(0).normal(size=(2, D, D))
    want = jax_vumps_from(a0, jm, D, iters=12)
    got = tv.vumps(_tmpo(jm), D, iters=12, a0=a0, device="cpu")
    return jm, want, got


def test_vumps_matches_jax(tfim):
    _, want, got = tfim
    np.testing.assert_allclose(got["energies"], want["energies"], atol=TOL)
    np.testing.assert_allclose(np.diag(got["c"].numpy()),
                               np.diag(np.asarray(want["c"])), atol=1e-8)
    assert abs(got["gradient_norm"] - want["gradient_norm"]) < 1e-8
    k = np.linspace(0, np.pi, 200001)
    exact = -np.trapezoid(np.sqrt(1 + 1.5 ** 2 - 3.0 * np.cos(k)), k) / np.pi
    assert abs(got["energy"] - exact) < 1e-9


def test_vumps_generator_start_and_dtype_promotion():
    """The port's own draw: a fixed generator reproduces itself, and a
    complex MPO promotes the state (as the JAX package's guard does)."""
    jm = jd.tfim_mpo(2, h=1.5)
    mpo = _tmpo(jm)
    g1 = tv.vumps(mpo, 4, iters=2, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    g2 = tv.vumps(mpo, 4, iters=2, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    assert g1["energies"] == g2["energies"]
    mpo.cores = mpo.cores.to(torch.complex128)
    g3 = tv.vumps(mpo, 4, iters=2, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    assert g3["al"].dtype == torch.complex128


def test_mixed_gauge_matches_jax():
    a = 0.6 * np.random.default_rng(1).normal(size=(2, 6, 6))
    jal, jar, jc = (np.asarray(x) for x in jv.mixed_gauge(jnp.asarray(a)))
    al, ar, c = (x.numpy() for x in tv.mixed_gauge(torch.from_numpy(a)))
    eye = np.eye(6)
    np.testing.assert_allclose(np.einsum("dji,djk->ik", al, al), eye, atol=TOL)
    np.testing.assert_allclose(np.einsum("dij,dkj->ik", ar, ar), eye, atol=TOL)
    np.testing.assert_allclose(np.diag(c), np.diag(jc), atol=TOL)
    # same state: AL C = C AR, and the transfer spectra agree with JAX's
    np.testing.assert_allclose(np.einsum("dij,jk->dik", al, c),
                               np.einsum("ij,djk->dik", c, ar), atol=1e-9)

    def spectrum(core):
        t = sum(np.kron(core[s], core[s]) for s in range(2))
        return np.sort(np.abs(np.linalg.eigvals(t)))[::-1]

    np.testing.assert_allclose(spectrum(al), spectrum(jal), atol=TOL)
    np.testing.assert_allclose(spectrum(ar), spectrum(jar), atol=TOL)


def test_environments_match_jax_on_the_same_state(tfim):
    """Deterministic given (AL, AR, C, W): the channel solves (GMRES on the
    corners) give JAX's environments entry by entry."""
    jm, want, _ = tfim
    w = np.array(jm.cores[0])
    jfl, jfr, je = jv.mpo_environments(want["al"], want["ar"], want["c"],
                                       jnp.asarray(w))
    g = ground_from_numpy(want, device="cpu")
    fl, fr, e = tv.mpo_environments(g["al"], g["ar"], g["c"], torch.from_numpy(w))
    assert abs(e - float(je)) < TOL
    np.testing.assert_allclose(fl.numpy(), np.asarray(jfl), atol=1e-9)
    np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), atol=1e-9)


def test_interior_channel_environments_match_jax():
    """An exponentially decaying interaction (the long-range Ising chain's
    interior diagonal channel, solved by GMRES as a strict contraction)
    on a generic mixed-gauge state: the same environments and energy as
    the JAX package's."""
    je = import_module("contractn_tpu.models.mpo_evolution")
    w = np.array(je.exp_decay_ising_mpo(3, lam=0.6).cores[1])
    a = np.random.default_rng(7).normal(size=(2, 6, 6))
    jal, jar, jc = (np.array(x) for x in jv.mixed_gauge(jnp.asarray(a)))
    want = jv.mpo_environments(*(jnp.asarray(x) for x in (jal, jar, jc, w)))
    got = tv.mpo_environments(*(torch.from_numpy(x).to(torch.complex128)
                                for x in (jal, jar, jc, w)))
    assert abs(got[2] - float(want[2])) < TOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-9)


def _aklt():
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    return np.stack([np.sqrt(2.0 / 3.0) * sp, -np.sqrt(1.0 / 3.0) * SZ,
                     -np.sqrt(2.0 / 3.0) * sp.T])


def test_transfer_spectrum_and_local_values_match_jax():
    core = _aklt()
    spec = tu.transfer_spectrum(core, iters=400, device="cpu")
    jspec = ju.transfer_spectrum(jnp.asarray(core), iters=400)
    assert abs(spec["lam1"] - jspec["lam1"]) < TOL
    assert abs(abs(spec["lam2"]) / spec["lam1"] - 1.0 / 3.0) < 1e-8
    assert abs(spec["xi"] - jspec["xi"]) < 1e-8
    sz1 = np.diag([1.0, 0.0, -1.0])
    assert abs(tu.expect_local(core, sz1, iters=400, device="cpu")
               - ju.expect_local(jnp.asarray(core), sz1, iters=400)) < TOL
    assert abs(tu.correlation_length(core, device="cpu")
               - 1.0 / np.log(3.0)) < 1e-8
    rng = np.random.default_rng(5)
    raw = 0.5 * rng.normal(size=(2, 4, 4))
    assert abs(tu.log_norm_per_site(raw, iters=500, device="cpu")
               - ju.log_norm_per_site(jnp.asarray(raw), iters=500)) < TOL


def test_correlators_and_structure_factor_match_jax(tfim):
    _, want, _ = tfim
    al = np.asarray(want["al"])
    op = np.array([[1.0, 0.3], [0.3, -1.0]])
    dists = [1, 2, 5, 9]
    np.testing.assert_allclose(
        tu.correlate(al, op, SZ, dists, device="cpu"),
        ju.correlate(jnp.asarray(al), op, SZ, dists), atol=TOL)
    ks = np.array([0.0, 1.0, np.pi])
    np.testing.assert_allclose(
        tu.static_structure_factor(al, SZ, ks, max_distance=30, device="cpu"),
        ju.static_structure_factor(jnp.asarray(al), SZ, ks, max_distance=30),
        atol=TOL)


@pytest.fixture(scope="module")
def window_core(tfim):
    return np.asarray(tfim[1]["al"])


def test_window_distribution_matches_jax(window_core):
    got = tu.umps_window_distribution(window_core, 5, device="cpu")
    want = ju.umps_window_distribution(jnp.asarray(window_core), 5)
    assert abs(got.sum() - 1.0) < 1e-12
    np.testing.assert_allclose(got, want, atol=TOL)


def test_sampler_reproduces_the_exact_distribution(window_core):
    """8192 draws from a fixed generator: every outcome frequency within 5
    sigma of the exact window distribution."""
    n, ns = 4, 8192
    p = tu.umps_window_distribution(window_core, n, device="cpu")
    s = tu.umps_sample(window_core, n, ns,
                       generator=torch.Generator().manual_seed(7), device="cpu")
    assert s.shape == (ns, n)
    freq = np.zeros((2,) * n)
    np.add.at(freq, tuple(s.T), 1.0)
    freq /= ns
    sig = np.sqrt(np.maximum(p * (1 - p), 1e-12) / ns)
    assert np.max(np.abs(freq - p) / (sig + 1e-12)) < 5.0


def test_phase10_rehearsal_on_cpu():
    """``chip_smoke.py``'s phase 10 at a tiny size on the CPU: every path
    runs its checks, and none launches a hand kernel (the CPU runs the
    plain versions)."""
    runs = chip_smoke.infinite_chains(torch.device("cpu"), "cpu",
                                      sizes=chip_smoke.INFINITE_TINY)
    assert set(runs) == {"haldane_vumps", "haldane_gap", "haldane_dense",
                         "hubbard_vumps", "h_chain_dmrg", "serve_h_chain",
                         "water_anchor", "umps_evolve"}
    for counts, seconds in runs.values():
        assert not any(counts.values()) and seconds > 0
