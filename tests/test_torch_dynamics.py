"""TDVP of the PyTorch port against the JAX package, on the CPU
(``tests/test_torch_circuits.py`` holds iTEBD and the MPS circuits).

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
from contractn_tpu_torch.models.mpo import rayleigh

jd, jt = (import_module(f"contractn_tpu.models.{m}") for m in ("dmrg", "tdvp"))
td, tt = (import_module(f"contractn_tpu_torch.models.{m}") for m in ("dmrg", "tdvp"))

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


@pytest.mark.parametrize("imaginary", [False, True])
def test_tdvp_two_site_matches_jax(imaginary):
    j0, t0 = _both(_arrays(seed=1))
    jmps, jes = jt.tdvp_evolve(jd.tfim_mpo(N), j0, 0.05, 2, max_bond=BOND,
                               imaginary=imaginary)
    tmps, tes = tt.tdvp_evolve(td.tfim_mpo(N, device="cpu"), t0, 0.05, 2,
                               max_bond=BOND, imaginary=imaginary)
    np.testing.assert_allclose(tes, jes, atol=TOL)
    assert abs(_overlap(jmps, tmps) - 1.0) < 1e-9
    assert tmps.cores.dtype == (torch.float64 if imaginary else torch.complex128)


@pytest.mark.parametrize("imaginary", [False, True])
def test_tdvp_one_site_matches_jax(imaginary):
    j0, t0 = _both(_arrays(seed=2))
    jmps, jes = jt.tdvp1_evolve(jd.tfim_mpo(N), j0, 0.05, 2, imaginary=imaginary)
    tmps, tes = tt.tdvp1_evolve(td.tfim_mpo(N, device="cpu"), t0, 0.05, 2,
                                imaginary=imaginary)
    np.testing.assert_allclose(tes, jes, atol=TOL)
    assert abs(_overlap(jmps, tmps) - 1.0) < 1e-9
    if not imaginary:  # the exact manifold projection conserves the energy
        assert abs(tes[-1] - tes[0]) < 1e-9


def test_tdvp_complex64_from_float32():
    """Real time from a float32 state runs in complex64 (as the JAX package's
    does) and keeps the norm and the energy to float32 precision."""
    t0 = mps_from_numpy(*(a.astype(np.float32) for a in _arrays(seed=3)),
                        device="cpu")
    mpo = td.tfim_mpo(N, dtype=torch.float32, device="cpu")
    for step in (tt.tdvp_step, tt.tdvp1_step):
        out, energy = step(mpo, t0, 0.05)
        assert out.cores.dtype == torch.complex64
        assert abs(float(out.norm_squared(split_format=False).real) - 1) < 1e-5
        assert abs(energy - rayleigh(mpo, t0)) < 1e-3


def test_tdvp_driven_matches_jax():
    j0, t0 = _both(_arrays(seed=4))
    jmps, jes = jt.tdvp_evolve_driven(
        lambda t: jd.tfim_mpo(N, h=1.0 + 0.5 * np.sin(t)), j0, 0.1, 2, max_bond=BOND)
    tmps, tes = tt.tdvp_evolve_driven(
        lambda t: td.tfim_mpo(N, h=1.0 + 0.5 * np.sin(t), device="cpu"), t0, 0.1, 2,
        max_bond=BOND)
    np.testing.assert_allclose(tes, jes, atol=TOL)
    assert abs(_overlap(jmps, tmps) - 1.0) < 1e-9


def test_tdvp_rejects_single_site_and_bare_masks():
    t1 = mps_from_numpy(*_arrays(n=1, bond=1), device="cpu")
    with pytest.raises(ValueError):
        tt.tdvp_step(td.tfim_mpo(1, device="cpu"), t1, 0.1)
    with pytest.raises(ValueError):
        tt.tdvp1_step(td.tfim_mpo(1, device="cpu"), t1, 0.1)
    t0 = mps_from_numpy(*_arrays(), device="cpu")
    with pytest.raises(ValueError, match="theta_masks"):
        tt.tdvp_step(td.tfim_mpo(N, device="cpu"), t0, 0.1,
                     masks=torch.ones((N, 2, BOND, BOND)))
