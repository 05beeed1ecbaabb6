"""DMRG variants of the PyTorch port against the JAX package, on the CPU.

``dmrgx``, ``dmrg3s``, the uniform and ensemble sweeps and the MPO algebra
(``tests/test_torch_dmrg.py`` holds ``dmrg``, ``dmrg_excited``, ``idmrg`` and
``dmrg_sector``; the two files split the JAX package's first-call compiles).  Initial states are drawn once in numpy and carried into both packages
through ``convert.py``; float64.  Site tensors differ by SVD/eigh gauge, so
states compare through energies, traces, |overlaps| of dense vectors and
Schmidt spectra; tolerance 1e-10 unless a test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from importlib import import_module

from contractn_tpu.models import MPS as JMPS
from contractn_tpu_torch.convert import mpo_from_numpy, mpo_to_numpy, mps_from_numpy

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


def _port(jmpo_obj):
    return mpo_from_numpy(*(np.asarray(x) for x in (jmpo_obj.cores, jmpo_obj.left,
                                                    jmpo_obj.right)), device="cpu")


def test_mpo_algebra_matches_jax():
    n = N
    jm1, jm2 = jd.tfim_mpo(n, h=0.7), jd.heisenberg_mpo(n, jz=0.5)
    tm1, tm2 = _port(jm1), _port(jm2)
    w1 = np.asarray(jm1.cores[0])
    j0, t0 = _both(_arrays(n=n, bond=3, seed=5))
    for jop, top in (
        (jmpo.mpo_sum(jm1, jm2), tmpo.mpo_sum(tm1, tm2)),
        (jmpo.mpo_multiply(jm1, jm2), tmpo.mpo_multiply(tm1, tm2)),
        (jmpo.mpo_dagger(jm2), tmpo.mpo_dagger(tm2)),
        (jmpo.block_mpo(jm2), tmpo.block_mpo(tm2)),
        (jmpo.deparallelize_mpo(ja.umpo_finite(jmpo.umpo_sum(w1, w1), n)),
         tmpo.deparallelize_mpo(ta.umpo_finite(tmpo.umpo_sum(w1, w1, device="cpu"), n))),
    ):
        for got, want in zip(mpo_to_numpy(top), (jop.cores, jop.left, jop.right)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)
    assert abs(tmpo.rayleigh(tmpo.mpo_sum(tm1, tm2), t0)
               - jmpo.rayleigh(jmpo.mpo_sum(jm1, jm2), j0)) < TOL
    w = np.asarray(jm2.cores[0])
    for jout, tout in (
        (jmpo.umpo_scale(w, 0.3), tmpo.umpo_scale(w, 0.3, device="cpu")),
        (jmpo.umpo_sum(w, np.asarray(jm1.cores[0])),
         tmpo.umpo_sum(w, np.asarray(jm1.cores[0]), device="cpu")),
        (jmpo.umpo_onsite(np.diag([0.5, -0.5])),
         tmpo.umpo_onsite(np.diag([0.5, -0.5]), device="cpu")),
    ):
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-12)
    jx = jd.xx_dimerized_mpo(n)
    tx = td.xx_dimerized_mpo(n, device="cpu")
    np.testing.assert_array_equal(mpo_to_numpy(tx)[0], np.asarray(jx.cores))
    np.testing.assert_array_equal(mpo_to_numpy(td.total_sz_penalty_mpo(n, 1.0, 2.0, device="cpu"))[1],
                                  np.asarray(jd.total_sz_penalty_mpo(n, 1.0, 2.0).left))


def _disordered_heisenberg(n, seed):
    from contractn_tpu.models.autompo import OpSum as JOpSum
    from contractn_tpu_torch.models.autompo import OpSum as TOpSum

    fields = np.random.default_rng(seed).uniform(-4.0, 4.0, n)
    out = []
    for cls in (JOpSum, TOpSum):
        h = cls()
        for i in range(n - 1):
            h += (1.0, "Sz", i, "Sz", i + 1)
            h += (0.5, "S+", i, "S-", i + 1)
            h += (0.5, "S-", i, "S+", i + 1)
        for i in range(n):
            h += (float(fields[i]), "Sz", i)
        out.append(h)
    return out[0].to_mpo(n), out[1].to_mpo(n, device="cpu")


def test_dmrgx_matches_jax():
    n = N
    jm, tm = _disordered_heisenberg(n, seed=3)
    cores = np.zeros((n, 2, BOND, BOND))
    for i in range(n):  # a Neel product seed
        cores[i, i % 2, 0, 0] = 1.0
    e0 = np.eye(BOND)[0]
    j0, t0 = _both((cores, e0, e0))
    _, ej, vj = jdx.dmrgx(jm, j0, sweeps=3, max_bond=BOND)
    _, et, vt = tdx.dmrgx(tm, t0, sweeps=3, max_bond=BOND)
    assert abs(et - ej) < TOL and abs(vt - vj) < 1e-9
    assert vt < 1e-9  # converged onto an eigenstate


@pytest.mark.parametrize("solver", ["dense", "lanczos"])
def test_dmrg3s_matches_jax(monkeypatch, solver):
    if solver == "lanczos":  # force the Lanczos one-site solve everywhere
        monkeypatch.setattr(jd3, "_DENSE_EIGH_LIMIT", 0)
        monkeypatch.setattr(td3, "_DENSE_EIGH_LIMIT", 0)
    j0, t0 = _both(_arrays(bond=2, seed=6))  # the expansion grows 2 -> 4
    jg, ej, trj = jd3.dmrg3s(jd.tfim_mpo(N), j0, max_bond=BOND, sweeps=3,
                              mixing=1e-2, decay=0.3)
    tg, et, trt = td3.dmrg3s(td.tfim_mpo(N, device="cpu"), t0, max_bond=BOND,
                              sweeps=3, mixing=1e-2, decay=0.3)
    assert tg.bond_dim == jg.bond_dim
    assert abs(et - ej) < 1e-9
    np.testing.assert_allclose(trt, trj, atol=1e-9)


def test_dmrg_uniform_matches_jax():
    j0, t0 = _both(_arrays(seed=8))
    _, ej, trj = je.dmrg_uniform(jd.tfim_mpo(N), j0, sweeps=2)
    _, et, trt = te.dmrg_uniform(td.tfim_mpo(N, device="cpu"), t0, sweeps=2)
    assert abs(float(et) - float(ej)) < TOL
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), atol=TOL)


def test_dmrg_ensemble_matches_jax_members():
    """One batched sweep over a field scan equals the JAX package's vmapped
    search member by member, and each member's own uniform search."""
    hs = (0.5, 1.0, 1.5)
    arrays = [_arrays(seed=10 + k) for k in range(len(hs))]
    jg, ej, trj = je.dmrg_ensemble(
        je.stack_pytrees([jd.tfim_mpo(N, h=h) for h in hs]),
        je.stack_pytrees([_both(a)[0] for a in arrays]), sweeps=2)
    tg, et, trt = te.dmrg_ensemble(
        te.stack_pytrees([td.tfim_mpo(N, h=h, device="cpu") for h in hs]),
        te.stack_pytrees([_both(a)[1] for a in arrays]), sweeps=2)
    assert tuple(tg.cores.shape) == tuple(jg.cores.shape) == (3, N, 2, BOND, BOND)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=TOL)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), atol=TOL)
    _, e1, _ = te.dmrg_uniform(td.tfim_mpo(N, h=hs[1], device="cpu"),
                               _both(arrays[1])[1], sweeps=2)
    assert abs(float(e1) - float(et[1])) < TOL


def test_ensemble_masks_are_per_member():
    """Per-member masks under the batch axis: all-ones masks leave every
    member's search unchanged, and masking one member's sites changes that
    member's search and no other's."""
    hs = (0.5, 1.5)
    mpos = te.stack_pytrees([td.tfim_mpo(N, h=h, device="cpu") for h in hs])
    mps0s = te.stack_pytrees([_both(_arrays(seed=20 + k))[1] for k in range(2)])
    _, free, _ = te.dmrg_ensemble(mpos, mps0s, sweeps=2)
    masks = torch.ones((2, N, 2, BOND, BOND), dtype=torch.float64)
    _, ones, _ = te._dmrg_uniform_core(mpos, mps0s, 2, 40, masks=masks, batch_ndim=1)
    np.testing.assert_allclose(ones.numpy(), free.numpy(), atol=TOL)
    masks[1] = 0
    masks[1, :, :, 0, 0] = 1  # member 1 confined to bond 1
    _, pinned, _ = te._dmrg_uniform_core(mpos, mps0s, 2, 40, masks=masks, batch_ndim=1)
    assert abs(float(pinned[0]) - float(free[0])) < TOL
    assert abs(float(pinned[1]) - float(free[1])) > 1e-3
