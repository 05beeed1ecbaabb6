"""Correction-vector dynamical DMRG of the PyTorch port against the JAX
package, on the CPU.

Both packages solve from the same ground state (the port's DMRG result,
carried across): the Green's function values agree at 1e-10, the batched
frequency grid (one leading frequency axis through every op in the port,
``jit(vmap)`` in the JAX package) agrees with the JAX grid, and both land
on the dense Lehmann sum.  The file also rehearses ``chip_smoke.py``'s
phase 9 (``physics_chains``) on the CPU at a tiny size.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from contractn_tpu_torch.convert import mpo_to_numpy, mps_from_numpy, mps_to_numpy

jd = import_module("contractn_tpu.models.dynamical")
td = import_module("contractn_tpu_torch.models.dynamical")
jmpo = import_module("contractn_tpu.models.mpo")
jmps = import_module("contractn_tpu.models.mps")
tdmrg = import_module("contractn_tpu_torch.models.dmrg")

torch.set_num_threads(1)

TOL = 1e-10
N = 6
SZ = np.diag([0.5, -0.5])
OMEGAS = np.array([0.4, 1.1, 2.0])
ETA = 0.3


@pytest.fixture(scope="module")
def setup():
    h = tdmrg.heisenberg_mpo(N, device="cpu")
    mps0 = tdmrg.MPS.random(N, 2, 8, dtype=torch.float64, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    ground, e0, _ = tdmrg.dmrg(h, mps0, max_bond=8, sweeps=6)
    jh = jmpo.MPO(*(jnp.asarray(a) for a in mpo_to_numpy(h)))
    jg = jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(ground)))
    return h, ground, e0, jh, jg


def _lehmann(h, e0, site):
    cores, left, right = mpo_to_numpy(h)
    d = cores.shape[1]
    cur = np.einsum("w,abwv->abv", left, cores[0])
    for w in cores[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(d * dd, d * dd, -1)
    hd = np.einsum("ABv,v->AB", cur, right)
    vals, vecs = np.linalg.eigh(hd)
    b = np.kron(np.kron(np.eye(2 ** site), SZ), np.eye(2 ** (N - site - 1)))
    w = np.abs(vecs.conj().T @ (b @ vecs[:, 0])) ** 2
    return np.array([np.sum(w / (om + e0 - vals + 1j * ETA)) for om in OMEGAS])


def jmps_to_port(m):
    return mps_from_numpy(m.cores, m.left, m.right, device="cpu")


def _norm(m):
    return float(torch.real(m.norm_squared(split_format=False))) ** 0.5


def test_apply_site_operator_matches_jax(setup):
    _, ground, _, _, jg = setup
    got = td.apply_site_operator(ground, SZ, 2)
    want = jd.apply_site_operator(jg, SZ, 2)
    for a, b in zip((want.cores, want.left, want.right), mps_to_numpy(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-15)


def test_greens_function_matches_jax_and_lehmann(setup):
    h, ground, e0, jh, jg = setup
    kw = dict(max_bond=16, sweeps=4, cg_iters=32)
    # one correction vector in both packages, on a 4-site chain (the JAX
    # package compiles its CG once per local block shape)
    b_t = tdmrg.MPS.random(4, 2, 2, dtype=torch.float64, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    b_j = jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(b_t)))
    h4 = tdmrg.heisenberg_mpo(4, device="cpu")
    j4 = jmpo.MPO(*(jnp.asarray(a) for a in mpo_to_numpy(h4)))
    y, g = td.correction_vector(h4, -1.6, b_t, OMEGAS[1], ETA, **kw)
    jy, jg1 = jd.correction_vector(j4, -1.6, b_j, OMEGAS[1], ETA, **kw)
    assert abs(g - jg1) < TOL
    ov = abs(complex(y.inner(jmps_to_port(jy), split_format=False)))
    assert abs(ov / (_norm(y) * _norm(jmps_to_port(jy))) - 1.0) < TOL
    got = td.cv_greens_function(h, ground, e0, SZ, 2, OMEGAS, ETA, **kw)
    np.testing.assert_allclose(got, _lehmann(h, e0, 2), atol=1e-8)
    spec = td.cv_spectral_function(h, ground, e0, SZ, 2, OMEGAS, ETA, **kw)
    np.testing.assert_allclose(spec, -got.imag / np.pi, atol=1e-14)


def test_batched_grid_matches_jax(setup):
    h, ground, e0, jh, jg = setup
    kw = dict(max_bond=16, sweeps=4, cg_iters=32)
    got = td.cv_greens_function_batched(h, ground, e0, SZ, 2, OMEGAS, ETA, **kw)
    want = jd.cv_greens_function_batched(jh, jg, e0, SZ, 2, OMEGAS, ETA, **kw)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, _lehmann(h, e0, 2), atol=1e-8)
    spec = td.cv_spectral_function_batched(h, ground, e0, SZ, 2, OMEGAS, ETA, **kw)
    np.testing.assert_allclose(spec, -got.imag / np.pi, atol=1e-14)


def test_batched_grid_is_one_batched_sweep(setup, monkeypatch):
    """The frequency grid is a leading axis: each two-site split is ONE
    batched SVD over all frequencies (no loop over frequencies)."""
    h, ground, e0, _, _ = setup
    calls = []
    real_split = td._split_theta

    def spy(theta, max_bond, to_left):
        calls.append(theta.shape[0])
        return real_split(theta, max_bond, to_left)

    monkeypatch.setattr(td, "_split_theta", spy)
    td.cv_greens_function_batched(h, ground, e0, SZ, 2, OMEGAS, ETA, sweeps=1,
                                  cg_iters=4)
    assert calls == [len(OMEGAS)] * (2 * (N - 1))


def test_phase9_rehearsal_on_cpu():
    """``chip_smoke.py``'s phase 9 at a tiny size on the CPU: every path
    runs its checks, and none launches a hand kernel (the CPU runs the
    plain versions)."""
    runs = chip_smoke.physics_chains(torch.device("cpu"), "cpu",
                                     sizes=chip_smoke.PHYSICS_TINY)
    assert set(runs) == {"hubbard_sector", "serve_hubbard", "quantics_tci",
                         "quantics_dense", "lindblad_wii", "cv_spectral", "mcwf"}
    for counts, seconds in runs.values():
        assert not any(counts.values()) and seconds > 0
