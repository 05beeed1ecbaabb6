"""MPS linear solves and Chebyshev moments of the PyTorch port against the JAX
package, on the CPU.

Operators and states are drawn once in numpy and carried into both packages
through ``convert.py``; float64.  Solutions compare as dense vectors (and
against ``np.linalg.solve``); KPM moments, residuals and reconstructed
spectra compare directly.  Tolerance 1e-10.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPO as JMPO
from contractn_tpu.models import MPS as JMPS
from contractn_tpu_torch.convert import mpo_from_numpy, mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import MPO as TMPO

jl, jch, jm = (import_module(f"contractn_tpu.models.{m}")
               for m in ("linsolve", "chebyshev", "mpo"))
tl, tch, tm = (import_module(f"contractn_tpu_torch.models.{m}")
               for m in ("linsolve", "chebyshev", "mpo"))

torch.set_num_threads(1)

TOL = 1e-10
N = 4


def _mpo_arrays(wdim, seed):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((N, 2, 2, wdim, wdim)) / np.sqrt(2 * wdim)
    return cores, rng.standard_normal(wdim), rng.standard_normal(wdim)


def _mps_arrays(bond, seed):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((N, 2, bond, bond)) / np.sqrt(2 * bond)
    return cores, rng.standard_normal(bond), rng.standard_normal(bond)


def _dense_mps(cores, left, right):
    bond = cores.shape[-1]
    amp = np.asarray(left)[None]
    for core in cores:
        amp = np.einsum("cj,djk->cdk", amp, core).reshape(-1, bond)
    return amp @ np.asarray(right)


def _dense_mpo(cores, left, right):
    cur = np.einsum("w,abwv->abv", np.asarray(left), np.asarray(cores[0]))
    for w in np.asarray(cores)[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(2 * dd, 2 * dd, -1)
    return np.einsum("ABv,v->AB", cur, np.asarray(right))


def _operators(general):
    """``A^+ A + 0.5`` (Hermitian positive definite) or a nonsymmetric
    ``G + 0.8``, in both packages, and the dense matrix."""
    arrays = _mpo_arrays(3 if not general else 2, seed=0)
    jraw = JMPO(*(jnp.asarray(a) for a in arrays))
    traw = mpo_from_numpy(*arrays, device="cpu")
    jid, tid = JMPO.identity(N, 2), TMPO.identity(N, 2, device="cpu")
    shift = 0.8 if general else 0.5
    jid = JMPO(jid.cores, shift * jid.left, jid.right)
    tid = TMPO(tid.cores, shift * tid.left, tid.right)
    if general:
        ja, ta = jm.mpo_sum(jraw, jid), tm.mpo_sum(traw, tid)
    else:
        ja = jm.mpo_sum(jm.mpo_multiply(jm.mpo_dagger(jraw), jraw), jid)
        ta = tm.mpo_sum(tm.mpo_multiply(tm.mpo_dagger(traw), traw), tid)
    return ja, ta, _dense_mpo(*(np.asarray(x) for x in (ja.cores, ja.left, ja.right)))


@pytest.mark.parametrize("general", [False, True])
def test_linear_solve_matches_jax_and_dense(general):
    ja, ta, dense = _operators(general)
    b = _mps_arrays(4, seed=1)
    jb, tb = JMPS(*(jnp.asarray(x) for x in b)), mps_from_numpy(*b, device="cpu")
    if general:
        ja_op, jb_rhs = jl.normal_equations(ja, jb)
        ta_op, tb_rhs = tl.normal_equations(ta, tb)
    else:
        ja_op, jb_rhs, ta_op, tb_rhs = ja, jb, ta, tb
    jx, jres = jl.mps_linear_solve(ja_op, jb_rhs, sweeps=3, max_bond=16)
    tx, tres = tl.mps_linear_solve(ta_op, tb_rhs, sweeps=3, max_bond=16)
    exact = np.linalg.solve(dense, _dense_mps(*b))
    got = _dense_mps(*mps_to_numpy(tx))
    want = _dense_mps(*(np.asarray(x) for x in (jx.cores, jx.left, jx.right)))
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, exact, atol=TOL)
    np.testing.assert_allclose(tres, jres, atol=TOL)
    assert abs(tl.linear_residual(ta, tx, tb) - jl.linear_residual(ja, jx, jb)) < 1e-7
    assert tl.linear_residual(ta, tx, tb) < 1e-6


def test_normal_equations_compressed_match_jax():
    ja, ta, _ = _operators(True)
    b = _mps_arrays(2, seed=2)
    jb, tb = JMPS(*(jnp.asarray(x) for x in b)), mps_from_numpy(*b, device="cpu")
    jop, _ = jl.normal_equations(ja, jb, compress_bond=3)
    top, _ = tl.normal_equations(ta, tb, compress_bond=3)
    np.testing.assert_allclose(
        _dense_mpo(*(x.numpy() for x in (top.cores, top.left, top.right))),
        _dense_mpo(*(np.asarray(x) for x in (jop.cores, jop.left, jop.right))),
        atol=TOL)


def test_chebyshev_moments_match_jax_and_dense():
    jmpo = import_module("contractn_tpu.models.dmrg").tfim_mpo(N, h=1.2)
    tmpo = import_module("contractn_tpu_torch.models.dmrg").tfim_mpo(
        N, h=1.2, device="cpu")
    psi = _mps_arrays(4, seed=3)
    nrm = np.linalg.norm(_dense_mps(*psi))
    psi = (psi[0], psi[1] / nrm, psi[2])
    jpsi, tpsi = JMPS(*(jnp.asarray(x) for x in psi)), mps_from_numpy(*psi, device="cpu")
    z = np.diag([1.0, -1.0])
    dense_h = _dense_mpo(*(np.asarray(x) for x in (jmpo.cores, jmpo.left, jmpo.right)))
    evals = np.linalg.eigvalsh(dense_h)
    bounds = (evals[0] - 0.1, evals[-1] + 0.1)
    n_mom = 24
    jmom, a, b = jch.chebyshev_moments(jmpo, jpsi, [(1, z)], n_mom, bounds, max_bond=16)
    tmom, ta, tb = tch.chebyshev_moments(tmpo, tpsi, [(1, z)], n_mom, bounds, max_bond=16)
    smom, _, _ = tch.chebyshev_moments_scanned(tmpo, tpsi, [(1, z)], n_mom, bounds,
                                               max_bond=16)
    jsmom, _, _ = jch.chebyshev_moments_scanned(jmpo, jpsi, [(1, z)], n_mom, bounds,
                                                max_bond=16)
    assert (ta, tb) == (a, b)
    np.testing.assert_allclose(tmom, jmom, atol=TOL)
    np.testing.assert_allclose(smom, jsmom, atol=TOL)
    # dense Chebyshev recursion oracle (bond 16 holds every vector exactly)
    v = np.kron(np.kron(np.eye(2), z), np.eye(4)) @ _dense_mps(*psi)
    hp = (dense_h - b * np.eye(16)) / a
    t_prev, t_cur = v, hp @ v
    dense = [v @ t_prev, v @ t_cur]
    for _ in range(2, n_mom):
        t_prev, t_cur = t_cur, 2 * hp @ t_cur - t_prev
        dense.append(v @ t_cur)
    np.testing.assert_allclose(np.real(tmom), dense, atol=TOL)
    np.testing.assert_allclose(np.real(smom), dense, atol=TOL)
    w = np.linspace(-1.0, 8.0, 101)
    np.testing.assert_allclose(tch.spectral_function(tmom, a, b, w, e0=evals[0]),
                               jch.spectral_function(jmom, a, b, w, e0=evals[0]),
                               atol=TOL)
    np.testing.assert_array_equal(tch.jackson_kernel(n_mom), jch.jackson_kernel(n_mom))
    with pytest.raises(ValueError):
        tch.rescaled_mpo(tmpo, (1.0, 0.0))
