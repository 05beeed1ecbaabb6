"""The exact-U(1) layer of the PyTorch port against the JAX package, on the
CPU.

Charge ladders, masks and MPO channel bookkeeping are host numpy in both
packages and compare exactly.  The masked solvers start from the same numpy
state in both packages and compare through gauge invariants (energies, the
per-sweep trace, |overlap| of the dense states) at 1e-10; the mask identity
``cores * (1 - masks) == 0`` is pinned exactly, and sector energies against
exact diagonalization.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy, mps_from_numpy, mps_to_numpy

ju = import_module("contractn_tpu.models.u1")
tu = import_module("contractn_tpu_torch.models.u1")
jmps = import_module("contractn_tpu.models.mps")
ja = import_module("contractn_tpu.models.autompo")
ta = import_module("contractn_tpu_torch.models.autompo")
tdmrg = import_module("contractn_tpu_torch.models.dmrg")
tens = import_module("contractn_tpu_torch.models.ensemble")

torch.set_num_threads(1)

TOL = 1e-10
N, BOND = 8, 20
HUB_PHYS = [(3, 0) if k % 2 == 0 else (1, 0) for k in range(4)]  # 1 x 2 lattice


def _dense_op(cores, left, right):
    cores, left, right = (np.asarray(a) for a in (cores, left, right))
    d = cores.shape[1]
    cur = np.einsum("w,abwv->abv", left, cores[0])
    for w in cores[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(d * dd, d * dd, -1)
    return np.einsum("ABv,v->AB", cur, right)


def _dense_state(cores, left, right):
    cores, left, right = (np.asarray(a) for a in (cores, left, right))
    v = np.einsum("i,dij->dj", left, cores[0])
    for a in cores[1:]:
        v = np.einsum("xj,djk->xdk", v, a).reshape(-1, a.shape[-1])
    return v @ right


def _overlap(a, b):
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return abs(np.vdot(a, b))


def _xxz_sector_ed(n, jz, q):
    mpo = tu.xxz_mpo_u1(n, jz=jz, device="cpu")
    h = _dense_op(*mpo_to_numpy(mpo))
    szs = np.array([sum(1 if (k >> (n - 1 - i)) & 1 == 0 else -1
                        for i in range(n)) for k in range(2 ** n)])
    idx = np.nonzero(szs == q)[0]
    return float(np.linalg.eigvalsh(h[np.ix_(idx, idx)])[0])


def _random_masked(masks, seed):
    rng = np.random.default_rng(seed)
    e0 = np.zeros(masks.shape[-1])
    e0[0] = 1.0
    return rng.standard_normal(masks.shape) * masks, e0


@pytest.mark.parametrize("n, phys, q, bond", [
    (N, (1, -1), 0, BOND), (7, (1, -1), 1, 5), (4, HUB_PHYS, 4, 6),
    (5, (2, 0, -2), 2, 9),
])
def test_charges_and_masks_equal(n, phys, q, bond):
    bj = ju.u1_bond_charges(n, phys, q, bond)
    bt = tu.u1_bond_charges(n, phys, q, bond)
    assert all(np.array_equal(a, b) for a, b in zip(bj, bt))
    sj = ju.u1_sector(n, q, bond, phys_charges=phys)
    st = tu.u1_sector(n, q, bond, phys_charges=phys, device="cpu")
    assert np.array_equal(np.asarray(sj["masks"]), st["masks"].numpy())
    assert np.array_equal(np.asarray(sj["theta_masks"]), st["theta_masks"].numpy())
    assert np.array_equal(np.asarray(sj["bond_masks"]), st["bond_masks"].numpy())
    for a, b in zip(sj["split_masks"], st["split_masks"][:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    slot = st["split_masks"][2].numpy()
    want = np.clip(np.cumsum(slot, axis=-1) - 1, 0, st["phys_dim"] * bond - 1)
    assert np.array_equal(st["split_masks"][3].numpy(), want)
    assert sj["phys_charges"] == st["phys_charges"]


def test_xxz_mpo_and_channel_charges():
    jm = ju.xxz_mpo_u1(6, jx=0.8, jz=1.3)
    tm = tu.xxz_mpo_u1(6, jx=0.8, jz=1.3, device="cpu")
    for a, b in zip((jm.cores, jm.left, jm.right), mpo_to_numpy(tm)):
        assert np.array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(ju.mpo_channel_charges(jm, (1, -1)),
                                  tu.mpo_channel_charges(tm, (1, -1)))
    with pytest.raises(ValueError, match="charge-definite"):
        tu.mpo_channel_charges(tdmrg.heisenberg_mpo(4, device="cpu"), (1, -1))


def test_compress_mpo_u1_and_op_sum_phys_charges():
    def build(h):
        for i in range(5):
            h += (0.5, "S+", i, "S-", i + 1)
            h += (0.5, "S-", i, "S+", i + 1)
            h += (0.7, "Sz", i, "Sz", i + 1)
        h += (0.3, "S+", 0, "S-", 3)
        return h

    jm = ja.op_sum_mpo(build(ja.OpSum()), 6, phys_charges=(1, -1))
    tm = ta.op_sum_mpo(build(ta.OpSum()), 6, phys_charges=(1, -1), device="cpu")
    want = _dense_op(jm.cores, jm.left, jm.right)
    got = _dense_op(*mpo_to_numpy(tm))
    assert np.max(np.abs(got - want)) < TOL * np.max(np.abs(want))
    assert tm.cores.shape[3] == jm.cores.shape[3]
    tu.mpo_channel_charges(tm, (1, -1))  # stays channel-charge-definite
    # and the compression directly: charges per bond equal
    naive = tu.xxz_mpo_u1(6, jz=0.4, device="cpu")
    cj, qj = ju.compress_mpo_u1(ju.xxz_mpo_u1(6, jz=0.4), (1, -1))
    ct, qt = tu.compress_mpo_u1(naive, (1, -1))
    assert all(np.array_equal(a, b) for a, b in zip(qj, qt))
    np.testing.assert_allclose(_dense_op(*mpo_to_numpy(ct)),
                               _dense_op(cj.cores, cj.left, cj.right), atol=TOL)


@pytest.fixture(scope="module")
def xxz_ground():
    """One masked DMRG run in both packages from the same numpy start."""
    jz = 0.7
    bc = tu.u1_bond_charges(N, (1, -1), 0, BOND)
    masks = tu.u1_masks(bc, (1, -1), device="cpu").numpy()
    cores, e0 = _random_masked(masks, 0)
    jstart = jmps.MPS(*(jnp.asarray(a) for a in (cores, e0, e0)))
    jout = ju.dmrg_u1(ju.xxz_mpo_u1(N, jz=jz), 0, BOND, sweeps=6, mps0=jstart)
    tmpo = tu.xxz_mpo_u1(N, jz=jz, device="cpu")
    tout = tu.dmrg_u1(tmpo, 0, BOND, sweeps=6,
                      mps0=mps_from_numpy(cores, e0, e0, device="cpu"))
    return jz, jout, tout, tmpo


def test_dmrg_u1_matches_jax_and_sector_ed(xxz_ground):
    jz, (jm, je, jtr, _), (tm, te, ttr, tmask), _ = xxz_ground
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=TOL * N)
    assert abs(float(te) - float(je)) < TOL * N
    assert torch.count_nonzero(tm.cores * (1 - tmask)) == 0
    assert abs(float(te) - _xxz_sector_ed(N, jz, 0)) < 1e-8
    ov = _overlap(_dense_state(*mps_to_numpy(tm)),
                  _dense_state(jm.cores, jm.left, jm.right))
    assert abs(ov - 1.0) < 1e-8


def test_dmrg_u1_rejects_unmasked_start():
    mpo = tu.xxz_mpo_u1(4, device="cpu")
    bad = tdmrg.MPS.random(4, 2, 4, dtype=torch.float64, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="outside the sector masks"):
        tu.dmrg_u1(mpo, 0, 4, mps0=bad)


@pytest.mark.parametrize("which", ["tdvp_u1", "tdvp1_u1"])
def test_masked_tdvp_matches_jax(xxz_ground, which):
    jz, _, (tm, _, _, _), tmpo = xxz_ground
    quench = tu.xxz_mpo_u1(N, jz=0.2, device="cpu")
    sector = tu.u1_sector(N, 0, BOND, device="cpu")
    tout, tes = getattr(tu, which)(quench, tm, sector, 0.05, 2)
    jstart = jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(tm)))
    jout, jes = getattr(ju, which)(ju.xxz_mpo_u1(N, jz=0.2),
                                   jstart, ju.u1_sector(N, 0, BOND), 0.05, 2)
    np.testing.assert_allclose(tes, [float(e) for e in jes], atol=TOL * N)
    assert torch.count_nonzero(tout.cores * (1 - sector["masks"])) == 0
    ov = _overlap(_dense_state(*mps_to_numpy(tout)),
                  _dense_state(jout.cores, jout.left, jout.right))
    assert abs(ov - 1.0) < TOL


def test_dmrg_u1_ensemble_is_batched_members():
    """The ensemble's members equal single runs from the same masked draws
    (one batched draw from a seeded generator) and sector ED."""
    jzs = (0.5, 2.0)
    n, q, bond = 6, 2, 8
    mpos = tens.stack_pytrees([tu.xxz_mpo_u1(n, jz=j, device="cpu") for j in jzs])
    mpss, energies, traces, tmask = tu.dmrg_u1_ensemble(
        mpos, q, bond, sweeps=6, generator=torch.Generator().manual_seed(3))
    assert traces.shape == (2, 6)
    assert torch.count_nonzero(mpss.cores * (1 - tmask)) == 0
    starts = tu.random_masked_mps(tmask, generator=torch.Generator().manual_seed(3),
                                  batch=(2,))
    for k, jz in enumerate(jzs):
        start = tdmrg.MPS(starts.cores[k], starts.left[k], starts.right[k])
        one = tu.dmrg_u1(tu.xxz_mpo_u1(n, jz=jz, device="cpu"), q, bond, sweeps=6,
                         mps0=start)
        np.testing.assert_allclose(traces[k].numpy(), one[2].numpy(), atol=TOL * n)
        assert abs(float(energies[k]) - _xxz_sector_ed(n, jz, q)) < 1e-9


def test_determinant_and_random_masked_states():
    n, bond = 6, 6
    bc = tu.u1_bond_charges(n, (1, -1), 0, bond)
    occ = [0, 1, 0, 1, 1, 0]
    jd = ju.determinant_mps_u1(occ, bc, (1, -1), noise=0.0)
    td = tu.determinant_mps_u1(occ, bc, (1, -1), noise=0.0, device="cpu")
    assert np.array_equal(np.asarray(jd.cores), td.cores.numpy())
    masks = tu.u1_masks(bc, (1, -1), device="cpu")
    noisy = tu.determinant_mps_u1(occ, bc, (1, -1), noise=1e-2, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    assert torch.count_nonzero(noisy.cores * (1 - masks)) == 0
    # statistics of the masked draws at a fixed seed
    big = tu.u1_masks(tu.u1_bond_charges(12, (1, -1), 0, 16), (1, -1), device="cpu")
    r = tu.random_masked_mps(big, generator=torch.Generator().manual_seed(0))
    live = r.cores[big > 0]
    assert torch.count_nonzero(r.cores * (1 - big)) == 0
    assert torch.count_nonzero(live) == live.numel()
    k = live.numel()
    assert abs(float(live.mean())) < 5.0 / k ** 0.5
    assert abs(float(live.std()) - 1.0) < 5.0 / (2 * k) ** 0.5
