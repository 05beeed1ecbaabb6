"""Canonical forms, compression, boundary-MPS PEPS contraction and the
degeneracy-safe decompositions of the PyTorch port against the JAX package,
on the CPU.

QR and SVD factors differ in sign (and phase) between the two libraries, so
gauge-dependent outputs compare through gauge-invariant quantities: dense
state vectors for small N, log-norms, Schmidt spectra, entanglement
entropies, truncation errors, contracted values and expectation values, and
gradients of gauge-invariant losses.  Same numpy-seeded float64 (or
complex128) inputs in both packages; tolerance 1e-10 unless a test says
otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPO as JMPO
from contractn_tpu.models import MPS as JMPS
from contractn_tpu.models import boundary as jb
from contractn_tpu.models import canonical as jc
from contractn_tpu.models.dmrg import tfim_mpo as j_tfim_mpo
from contractn_tpu.models.peps import peps_tn as j_peps_tn
from contractn_tpu.ops.linalg_ad import eigh_safe as j_eigh_safe
from contractn_tpu.ops.linalg_ad import svd_safe as j_svd_safe
from contractn_tpu_torch.convert import mpo_from_numpy, mpo_to_numpy, mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import boundary as tb
from contractn_tpu_torch.models import canonical as tc
from contractn_tpu_torch.models import peps_tn, tfim_mpo
from contractn_tpu_torch.ops.linalg_ad import eigh_safe, svd_safe

torch.set_num_threads(1)

RTOL = 1e-10


def _arrays(n=6, d=2, bond=4, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((n, d, bond, bond)) / np.sqrt(d * bond)
    left, right = rng.standard_normal(bond), rng.standard_normal(bond)
    if complex_:
        cores = cores + 1j * rng.standard_normal(cores.shape) / np.sqrt(d * bond)
        left, right = left + 0.3j, right - 0.2j
    return cores, left, right


def _both(arrays):
    return (JMPS(*(jnp.asarray(a) for a in arrays)),
            mps_from_numpy(*arrays, device="cpu"))


def _dense(cores, left, right):
    bond = cores.shape[-1]
    amp = np.asarray(left)[None]
    for core in cores:
        amp = np.einsum("cj,djk->cdk", amp, core).reshape(-1, bond)
    return amp @ np.asarray(right)


def _dense_j(m):
    return _dense(*(np.asarray(a) for a in (m.cores, m.left, m.right)))


def _dense_t(m):
    return _dense(*mps_to_numpy(m))


@pytest.mark.parametrize("complex_", [False, True])
def test_canonical_forms_match_jax(complex_):
    arrays = _arrays(seed=1, complex_=complex_)
    mj, mt = _both(arrays)
    psi = _dense(*arrays)
    for name in ("left_canonicalize", "right_canonicalize"):
        cj, lj = getattr(jc, name)(mj)
        ct, lt = getattr(tc, name)(mt)
        np.testing.assert_allclose(lt, lj, rtol=RTOL)
        np.testing.assert_allclose(_dense_t(ct) * np.exp(lt), psi, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(_dense_t(ct)), 1.0, rtol=RTOL)
    # the isometries: sum_d A_d^H A_d = I (left), sum_d A_d A_d^H = I (right)
    lc, _ = tc.left_canonicalize(mt)
    rc, _ = tc.right_canonicalize(mt)
    a = lc.cores[2]
    eye = torch.eye(4, dtype=a.dtype)
    torch.testing.assert_close(torch.einsum("dji,djk->ik", a.conj(), a), eye)
    a = rc.cores[2]
    torch.testing.assert_close(torch.einsum("dij,dkj->ik", a, a.conj()), eye)


def test_compress_matches_jax():
    mj, mt = _both(_arrays(n=5, bond=4, seed=2))
    for max_bond, cutoff in ((8, 0.0), (2, 0.0), (None, 0.3)):
        cj, lj, ej = jc.compress(mj, max_bond=max_bond, cutoff=cutoff)
        ct, lt, et = tc.compress(mt, max_bond=max_bond, cutoff=cutoff)
        assert ct.cores.shape == cj.cores.shape
        np.testing.assert_allclose([lt, et], [lj, ej], rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(_dense_t(ct), _dense_j(cj), rtol=RTOL, atol=1e-12)
    # the fixed-bond sweep
    cj, lj, ej = jc.compress_fixed(mj, 3)
    ct, lt, et = tc.compress_fixed(mt, 3)
    np.testing.assert_allclose([float(lt), float(et)], [float(lj), float(ej)], rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(_dense_t(ct), _dense_j(cj), rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):
        tc.compress(mt, max_bond=0)


def test_mps_add_matches_jax():
    aj, at = _both(_arrays(n=5, bond=3, seed=3))
    bj, bt = _both(_arrays(n=5, bond=2, seed=4))
    s = tc.mps_add(at, bt)
    assert s.bond_dim == 5
    np.testing.assert_allclose(_dense_t(s), _dense_t(at) + _dense_t(bt), rtol=RTOL)
    cj, lj, ej = jc.mps_add(aj, bj, max_bond=4)
    ct, lt, et = tc.mps_add(at, bt, max_bond=4)
    # the truncation error is rounding noise here (rank 4 fits): atol
    np.testing.assert_allclose([lt, et], [lj, ej], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(_dense_t(ct), _dense_j(cj), rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):
        tc.mps_add(at, mps_from_numpy(*_arrays(n=6, seed=5), device="cpu"))


def test_compress_mpo_matches_jax():
    rng = np.random.default_rng(6)
    arrays = (rng.standard_normal((4, 2, 2, 3, 3)) / 3, rng.standard_normal(3),
              rng.standard_normal(3))
    oj, lj, ej = jc.compress_mpo(JMPO(*(jnp.asarray(a) for a in arrays)), max_bond=2)
    ot, lt, et = tc.compress_mpo(mpo_from_numpy(*arrays, device="cpu"), max_bond=2)
    np.testing.assert_allclose([lt, et], [lj, ej], rtol=RTOL, atol=1e-12)
    assert mpo_to_numpy(ot)[0].shape == np.asarray(oj.cores).shape
    # expectation values on a state are gauge-invariant
    mj, mt = _both(_arrays(n=4, bond=3, seed=7))
    vj, gj = oj.expectation(mj)
    vt, gt = ot.expectation(mt)
    np.testing.assert_allclose(float(vt) * np.exp(float(gt)), float(vj) * np.exp(float(gj)),
                               rtol=RTOL)


def test_spectra_entropy_and_imaginary_time_match_jax():
    mj, mt = _both(_arrays(n=5, bond=4, seed=8))
    np.testing.assert_allclose(tc.schmidt_spectra(mt).numpy(),
                               np.asarray(jc.schmidt_spectra(mj)), rtol=RTOL, atol=1e-12)
    for alpha in (1, 2):
        np.testing.assert_allclose(tc.entanglement_entropy(mt, alpha).numpy(),
                                   np.asarray(jc.entanglement_entropy(mj, alpha)), rtol=RTOL)
    with pytest.raises(ValueError):
        tc.entanglement_entropy(mt, alpha=0)
    mj, ej = jc.imaginary_time_step(mj, j_tfim_mpo(5), tau=0.1, max_bond=4)
    mt, et = tc.imaginary_time_step(mt, tfim_mpo(5, device="cpu"), tau=0.1, max_bond=4)
    np.testing.assert_allclose(et, ej, rtol=RTOL)
    np.testing.assert_allclose(_dense_t(mt), _dense_j(mj), rtol=RTOL, atol=1e-12)


def test_truncate_safe_and_its_gradient_match_jax():
    rng = np.random.default_rng(9)
    shapes = [(2, 3, 4), (2, 4, 5), (2, 5, 3)]
    cores = [rng.standard_normal(s) for s in shapes]
    left, right = rng.standard_normal(3), rng.standard_normal(3)
    probe = rng.standard_normal(2 ** 3)

    def contract(out, log, lib, probe):
        # <probe|state> of the truncated chain, times its norm: gauge-invariant
        v = out[0][:, 0, :]
        for c in out[1:]:
            v = lib.einsum("pj,djk->pdk", v, c).reshape(-1, c.shape[-1])
        return (v[:, 0] * probe).sum() * lib.exp(log)

    @jax.jit
    def j_obj(cs):
        out, log = jc.truncate_safe(cs, jnp.asarray(left), jnp.asarray(right), 2)
        return contract(out, log, jnp, jnp.asarray(probe))

    j_cores = [jnp.asarray(c) for c in cores]
    t_cores = [torch.from_numpy(c).requires_grad_(True) for c in cores]
    out, log = tc.truncate_safe(t_cores, torch.from_numpy(left), torch.from_numpy(right), 2)
    val = contract(out, log, torch, torch.from_numpy(probe))
    np.testing.assert_allclose(float(val.detach()), float(j_obj(j_cores)), rtol=RTOL)
    for got, want in zip(torch.autograd.grad(val, t_cores), jax.grad(j_obj)(j_cores)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("complex_", [False, True])
def test_eigh_and_svd_safe_gradients_match_jax(complex_):
    # gauge-invariant losses: a function of the spectrum plus a projector on
    # the top eigen/singular space.  JAX's gradient of a real loss in a
    # complex input is the conjugate of torch's.
    rng = np.random.default_rng(10)
    a = rng.standard_normal((5, 5))
    b = rng.standard_normal((6, 4))
    if complex_:
        a = a + 1j * rng.standard_normal((5, 5))
        b = b + 1j * rng.standard_normal((6, 4))
    h = 0.5 * (a + a.conj().T)
    p = rng.standard_normal((5, 5))
    p = p + p.T

    def eig_loss(vals, vecs, lib):
        top = vecs[:, -2:]
        proj = top @ top.conj().T
        return (vals ** 3).sum() + lib.real((proj * lib.asarray(p)).sum())

    def svd_loss(u, s, vh, lib):
        top = u[:, :2]
        return (s ** 2 * lib.arange(1, 5)).sum() + lib.real((top @ top.conj().T)[0, 1] *
                                                             (top @ top.conj().T)[1, 0])

    gj_e = jax.jit(jax.grad(lambda m: eig_loss(*j_eigh_safe(m), jnp)))(jnp.asarray(h))
    gj_s = jax.jit(jax.grad(lambda m: svd_loss(*j_svd_safe(m), jnp)))(jnp.asarray(b))
    ht = torch.from_numpy(h).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (gt_e,) = torch.autograd.grad(eig_loss(*eigh_safe(ht), torch), ht)
    (gt_s,) = torch.autograd.grad(svd_loss(*svd_safe(bt), torch), bt)
    np.testing.assert_allclose(gt_e.numpy(), np.conj(np.asarray(gj_e)), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(gt_s.numpy(), np.conj(np.asarray(gj_s)), rtol=1e-8, atol=1e-10)
    # forward values are the decompositions themselves
    vals, _ = eigh_safe(torch.from_numpy(h))
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(h), rtol=RTOL, atol=1e-12)


def test_eigh_safe_is_finite_on_a_degenerate_spectrum():
    h = torch.diag(torch.tensor([1.0, 1.0, 2.0], dtype=torch.float64)).requires_grad_(True)
    vals, vecs = eigh_safe(h)
    (g,) = torch.autograd.grad((vecs[:, 0] ** 2).sum() + vals.sum(), h)
    assert bool(torch.isfinite(g).all())


def _grid_pair(rows, cols, phys_dim, seed, complex_=False):
    tj, gj = j_peps_tn(rows, cols, bond_dim=2, phys_dim=phys_dim, rng=np.random.default_rng(seed))
    tt, gt = peps_tn(rows, cols, bond_dim=2, phys_dim=phys_dim, rng=np.random.default_rng(seed))
    if complex_:
        rng = np.random.default_rng(seed + 100)
        for row_j, row_t in zip(gj, gt):
            for nj, nt in zip(row_j, row_t):
                t = nj.tensor + 1j * rng.standard_normal(nj.tensor.shape) / np.sqrt(2)
                nj.tensor, nt.tensor = t, t.copy()
    return (tj, gj), (tt, gt)


def _value(pair):
    return complex(np.asarray(pair[0])) * np.exp(complex(np.asarray(pair[1])))


@pytest.mark.parametrize("rows,cols,chi,complex_", [
    (2, 2, None, False), (3, 3, None, True), (3, 3, 2, False), (3, 3, 2, True),
])
def test_boundary_contract_matches_jax(rows, cols, chi, complex_):
    (tj, gj), (tt, gt) = _grid_pair(rows, cols, None, seed=rows * 10 + cols,
                                    complex_=complex_)
    want = _value(jb.boundary_contract(tj, gj, chi=chi))
    got = _value(tb.boundary_contract(tt, gt, chi=chi, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if chi is None:  # exact: the dense contraction of the same graph
        np.testing.assert_allclose(got, complex(tt.contract(device="cpu")), rtol=RTOL)
    dense = tb.boundary_contract(tt, gt, chi=chi, split_format=False, device="cpu")
    np.testing.assert_allclose(complex(dense), want, rtol=RTOL)


@pytest.mark.parametrize("rows,cols,chi,complex_", [
    (2, 2, None, True), (3, 3, 8, False), (1, 3, None, False),
])
def test_peps_norm_and_expectation_match_jax(rows, cols, chi, complex_):
    (tj, gj), (tt, gt) = _grid_pair(rows, cols, 2, seed=rows + 7 * cols, complex_=complex_)
    np.testing.assert_allclose(_value(tb.peps_norm(tt, gt, chi=chi, device="cpu")),
                               _value(jb.peps_norm(tj, gj, chi=chi)), rtol=RTOL)
    sz = np.diag([1.0, -1.0])
    for site in ((0, 0), (rows - 1, cols - 1)):
        got = complex(tb.peps_expectation(tt, gt, sz, site, chi=chi, device="cpu"))
        want = complex(np.asarray(jb.peps_expectation(tj, gj, jnp.asarray(sz), site, chi=chi)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):
        tb.peps_expectation(tt, gt, sz, (rows, 0), device="cpu")
    with pytest.raises(ValueError):
        tb.peps_norm(*peps_tn(rows, cols, 2), device="cpu")
