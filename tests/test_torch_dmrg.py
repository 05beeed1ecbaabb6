"""DMRG family of the PyTorch port against the JAX package, on the CPU.

``dmrg``, ``dmrg_excited``, ``idmrg``, ``dmrg_sector`` and the local solvers
(``tests/test_torch_dmrg_variants.py`` holds ``dmrgx``, ``dmrg3s``, the
ensemble and the MPO algebra).  Initial states are drawn once in numpy and carried into both packages
through ``convert.py``; float64.  Site tensors differ by SVD/eigh gauge, so
states compare through energies, traces, |overlaps| of dense vectors and
Schmidt spectra; tolerance 1e-10 unless a test says otherwise.  Where an
algorithm draws random numbers (``idmrg``), both packages' draws are
replaced by the same numpy stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from importlib import import_module

from contractn_tpu.models import MPS as JMPS
from contractn_tpu_torch.convert import mpo_from_numpy, mpo_to_numpy, mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models.canonical import schmidt_spectra

# the packages export functions named like these modules
_MODULES = ("dmrg", "dmrg3s", "dmrgx", "ensemble", "mpo", "autompo")
jd, jd3, jdx, je, jmpo, ja = (import_module(f"contractn_tpu.models.{m}")
                              for m in _MODULES)
td, td3, tdx, te, tmpo, ta = (import_module(f"contractn_tpu_torch.models.{m}")
                              for m in _MODULES)

torch.set_num_threads(1)

TOL = 1e-10
N, BOND = 4, 4  # bond 4 is exact at 4 sites: converged states are eigenstates


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
    vec = amp @ np.asarray(right)
    return vec / np.linalg.norm(vec)


def _same_state(jmps, tmps):
    a = _dense(*(np.asarray(x) for x in (jmps.cores, jmps.left, jmps.right)))
    b = _dense(*mps_to_numpy(tmps))
    assert abs(abs(np.vdot(a, b)) - 1.0) < 1e-9


def _port(jmpo_obj):
    return mpo_from_numpy(*(np.asarray(x) for x in (jmpo_obj.cores, jmpo_obj.left,
                                                    jmpo_obj.right)), device="cpu")


@pytest.mark.parametrize("model", ["tfim", "heisenberg"])
def test_dmrg_matches_jax(model):
    jm = jd.tfim_mpo(N, h=0.8) if model == "tfim" else jd.heisenberg_mpo(N)
    tm = (td.tfim_mpo(N, h=0.8, device="cpu") if model == "tfim"
          else td.heisenberg_mpo(N, device="cpu"))
    np.testing.assert_array_equal(mpo_to_numpy(tm)[0], np.asarray(jm.cores))
    j0, t0 = _both(_arrays(seed=1))
    jg, ej, trj = jd.dmrg(jm, j0, max_bond=BOND, sweeps=2)
    tg, et, trt = td.dmrg(tm, t0, max_bond=BOND, sweeps=2)
    assert abs(et - ej) < TOL
    np.testing.assert_allclose(trt, trj, atol=TOL)
    _same_state(jg, tg)
    for sj, st in zip(jax_spectra(jg), schmidt_spectra(tg)):
        np.testing.assert_allclose(np.asarray(st), np.asarray(sj), atol=1e-9)


def jax_spectra(mps):
    from contractn_tpu.models.canonical import schmidt_spectra as j_spectra

    return j_spectra(mps)


def test_truncated_dmrg_matches_jax():
    """A binding bond cap (2 < 4): the truncated optimum is gauge-free too."""
    j0, t0 = _both(_arrays(seed=2))
    _, ej, _ = jd.dmrg(jd.tfim_mpo(N), j0, max_bond=2, sweeps=2)
    _, et, _ = td.dmrg(td.tfim_mpo(N, device="cpu"), t0, max_bond=2, sweeps=2)
    assert abs(et - ej) < 1e-9


def _random_heff(seed, d=2, w=3, dl=17, dr=17):
    """Random Hermitian effective-Hamiltonian pieces (dim 1156 > the dense
    limit, so the Lanczos path runs)."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((dl, w, dl))
    L = 0.5 * (L + L.transpose(2, 1, 0))
    R = rng.standard_normal((dr, w, dr))
    R = 0.5 * (R + R.transpose(2, 1, 0))
    w1 = rng.standard_normal((d, d, w, w))
    w1 = 0.5 * (w1 + w1.transpose(1, 0, 2, 3))
    w2 = rng.standard_normal((d, d, w, w))
    w2 = 0.5 * (w2 + w2.transpose(1, 0, 2, 3))
    theta0 = rng.standard_normal((d, d, dl, dr))
    return L, w1, w2, R, theta0


def test_local_lanczos_solves_match_jax():
    arrs = _random_heff(0)
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.from_numpy(a) for a in arrs]
    ej, vj = jd._local_ground_state(*jargs)
    et, vt = td._local_ground_state(*targs)
    assert abs(et - ej) < TOL
    assert abs(abs(np.vdot(np.asarray(vj), vt.numpy())) - 1.0) < 1e-9
    # the penalized Lanczos: one rank-1 penalty on a random vector
    pg = np.random.default_rng(9).standard_normal(arrs[-1].shape)
    pg /= np.linalg.norm(pg)
    ej, _ = jd._local_ground_penalized(*jargs, [(3.0, jnp.asarray(pg))])
    et, _ = td._local_ground_penalized(*targs, [(3.0, torch.from_numpy(pg))])
    assert abs(et - ej) < TOL
    # and the dense solve below the limit
    small = [a[..., :3, :, :3] if a.ndim == 3 else a for a in arrs[:4]]
    ej, _ = jd._local_ground_state(*(jnp.asarray(a) for a in small))
    et, _ = td._local_ground_state(*(torch.from_numpy(a) for a in small))
    assert abs(et - ej) < TOL


def test_dmrg_excited_match_jax_and_dense_spectrum():
    j0, t0 = _both(_arrays(seed=3))
    _, ej = jd.dmrg_excited(jd.tfim_mpo(N), j0, 3, max_bond=BOND, sweeps=2)
    gen = torch.Generator().manual_seed(0)
    states, et = td.dmrg_excited(td.tfim_mpo(N, device="cpu"), t0, 3,
                                 max_bond=BOND, sweeps=2, generator=gen)
    np.testing.assert_allclose(et, ej, atol=TOL)
    dense = np.linalg.eigvalsh(_dense_tfim(N))[:3]
    np.testing.assert_allclose(et, dense, atol=1e-9)
    assert abs(float(states[0].inner(states[1], split_format=False))) < 1e-8


def _dense_tfim(n, j=1.0, h=1.0):
    sx, sz = np.array([[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0])

    def at(op, i):
        out = np.eye(1)
        for s in range(n):
            out = np.kron(out, op if s == i else np.eye(2))
        return out

    return (-j * sum(at(sz, i) @ at(sz, i + 1) for i in range(n - 1))
            - h * sum(at(sx, i) for i in range(n)))


def test_idmrg_matches_jax(monkeypatch):
    """Both packages' random draws replaced by one numpy stream; the dense
    solve runs while the block is small, the 80-step Lanczos at bond 20."""
    def stream():
        rng = np.random.default_rng(7)
        return lambda shape: rng.standard_normal(shape)

    draw_j, draw_t = stream(), stream()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(draw_j(shape), dtype))
    monkeypatch.setattr(td, "_normal", lambda shape, dtype, device, gen:
                        torch.from_numpy(draw_t(shape)).to(device, dtype))
    ej, trj = jd.idmrg(jd.tfim_mpo(2, h=1.5), max_bond=20, steps=8)
    et, trt = td.idmrg(td.tfim_mpo(2, h=1.5, device="cpu"), max_bond=20, steps=8)
    assert abs(et - ej) < TOL
    np.testing.assert_allclose(trt, trj, atol=TOL)


def test_dmrg_sector_matches_jax():
    n = N
    j0, t0 = _both(_arrays(seed=4))
    for q in (0.0, 1.0):
        _, ej, rj = jd.dmrg_sector(jd.heisenberg_mpo(n), j0, q, sweeps=2)
        _, et, rt = td.dmrg_sector(td.heisenberg_mpo(n, device="cpu"), t0, q,
                                   sweeps=2)
        assert abs(et - ej) < TOL and abs(rt - rj) < TOL
        assert rt < 1e-10  # the sector is resolved


def test_validation():
    t1 = mps_from_numpy(*_arrays(n=1, bond=2), device="cpu")
    for fn in (td.dmrg, td3.dmrg3s, tdx.dmrgx, te.dmrg_uniform):
        with pytest.raises(ValueError):
            fn(td.tfim_mpo(1, device="cpu"), t1)
    with pytest.raises(ValueError):
        td.idmrg(td.tfim_mpo(2, device="cpu"), 4, steps=1)
    with pytest.raises(ValueError):
        te.stack_pytrees([])
