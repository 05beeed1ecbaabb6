"""iPEPS expectation values via CTMRG environments.

Counterpart of ``contractn_tpu/models/ipeps.py``.  Extends :mod:`.ctmrg`
from classical partition functions to infinite 2D *quantum* states: an iPEPS
is a translation-invariant PEPS tensor ``A (d, D, D, D, D)`` (phys, up,
left, down, right), its norm network is the **double-layer** tensor ``a =
sum_s A[s] (x) conj(A[s])`` with fused bra+ket bonds ``q = D**2``, and local
/ nearest-neighbor observables come from inserting operator impurities
between the layers inside the converged ``(C, T)`` environment.

Scope: the single-site C4v-symmetric variant matching the symmetric CTMRG
(:func:`symmetrize_c4v` projects any tensor onto it) — the standard ansatz
for rotation-invariant phases such as the 2D transverse-field Ising model.

Environments converge on the tensor's device (``ctmrg._converge``),
expectation patches are single einsums, and the simple-update stage is a
plain loop of SVD-per-gate updates on the device (no host read until the
energy).  Cross-validation: the square-root-Boltzmann PEPS maps
``<psi|psi>`` exactly onto the classical Ising partition function, so iPEPS
magnetization/free energy equal the classical CTMRG values and Onsager's.

Departure: the host-array builders (:func:`tfim_bond_term_2d`,
:func:`heisenberg_bond_term_2d`, :func:`product_peps`) take ``device=``
(default ``cuda``) and return torch tensors.
"""

import numpy as np
import torch

from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from .ctmrg import _site_weight, ctmrg_environment


def _site(a_site):
    return as_tensor(a_site, resolve_device(None, (a_site,)))


def symmetrize_c4v(a_site):
    """Project a PEPS tensor onto the C4v-symmetric subspace: the average
    over the 8 dihedral-group images (4 rotations x optional reflection) of
    the virtual legs ``(u, l, d, r)``."""
    a_site = _site(a_site)
    # Leg order (phys, u, l, d, r); rotation by 90deg: u<-l<-d<-r<-u
    rot = (0, 2, 3, 4, 1)
    refl = (0, 1, 4, 3, 2)  # mirror: swap left/right
    images = []
    cur = a_site
    for _ in range(4):
        images.append(cur)
        images.append(cur.permute(refl))
        cur = cur.permute(rot)
    return sum(images) / len(images)


def peps_double_layer(a_site, op=None):
    """Closed double-layer tensor ``(q, q, q, q)`` with ``q = D**2``:
    ``a[(u u'), (l l'), (d d'), (r r')] = sum_{s s'} conj(A[s']) O[s', s]
    A[s]`` (``op=None`` means ``O = id``)."""
    a_site = _site(a_site)
    bond = a_site.shape[1]
    bra = a_site.conj()
    if op is None:
        ket = a_site
    else:
        # promote, never narrow: a complex observable on a real state must
        # not be silently cast to real (e.g. <S_y>)
        op = as_tensor(op, a_site.device)
        ket = peinsum("ts,suldr->tuldr", op, a_site)
    q = bond * bond
    return peinsum("suldr,sULDR->uUlLdDrR", ket, bra).reshape(q, q, q, q)


def peps_double_layer_open(a_site):
    """Open double-layer tensor ``(d, d, q, q, q, q)``: (ket, bra) physical
    indices left uncontracted, for multi-site operator insertions."""
    a_site = _site(a_site)
    d, bond = a_site.shape[0], a_site.shape[1]
    q = bond * bond
    return peinsum("suldr,SULDR->sSuUlLdDrR", a_site, a_site.conj()).reshape(
        d, d, q, q, q, q)


def _pair_weight(c, t, a1, a2):
    """Weight of a horizontal 1x2 patch inside the environment ring:
    ``[C T T C; T a1 a2 T; C T T C]``."""
    return path_einsum("ab,buc,cvd,de,erf,fg,gyh,hxi,ij,jla,ulxm,vmyr->",
                   c, t, t, c, t, c, t, t, c, t, a1, a2)


def _pair_weight_op(c, t, ao1, ao2, op4):
    """Same patch with OPEN pair tensors ``(d, d, q, q, q, q)`` contracted
    against a two-site operator ``op4[s1', s2', s1, s2]`` (bra first)."""
    return path_einsum("ab,buc,cvd,de,erf,fg,gyh,hxi,ij,jla,pPulxm,qQvmyr,PQpq->",
                   c, t, t, c, t, c, t, t, c, t, ao1, ao2, op4)


def ipeps_expect_local(a_site, op, chi, iters=200, boundary=None):
    """``<psi| O_i |psi> / <psi|psi>`` for a one-site observable (a 0-d
    tensor on the device).

    Args:
        a_site: iPEPS tensor ``(d, D, D, D, D)``; its double layer must be
            C4v-symmetric (use :func:`symmetrize_c4v`).
        op: ``(d, d)`` observable.
        chi: environment bond dimension (``>= D**2``).
        boundary: optional ``(C0, T0)`` seed in double-layer bonds.
    """
    a_norm = peps_double_layer(a_site)
    a_imp = peps_double_layer(a_site, op)
    c, t = ctmrg_environment(a_norm, chi, iters=iters, boundary=boundary)
    return _site_weight(c, t, a_imp) / _site_weight(c, t, a_norm)


def ipeps_expect_bond(a_site, h2, chi, iters=200, boundary=None):
    """``<psi| h_{i,i+x} |psi> / <psi|psi>`` for a nearest-neighbor term
    ``h2`` (dense ``(d^2, d^2)`` or ``(d, d, d, d)`` as ``[s1', s2', s1,
    s2]``); a 0-d tensor on the device."""
    a_site = _site(a_site)
    d = a_site.shape[0]
    op4 = as_tensor(h2, a_site.device, a_site.dtype).reshape(d, d, d, d)
    a_norm = peps_double_layer(a_site)
    ao = peps_double_layer_open(a_site)
    c, t = ctmrg_environment(a_norm, chi, iters=iters, boundary=boundary)
    return _pair_weight_op(c, t, ao, ao, op4) / _pair_weight(c, t, a_norm, a_norm)


def ipeps_energy(a_site, h2, chi, iters=200, boundary=None):
    """Energy per site of ``H = sum_<ij> h2`` on the square lattice: for a
    C4v-symmetric state each site owns two equal bonds, ``E = 2
    <h2>_bond``."""
    return 2.0 * ipeps_expect_bond(a_site, h2, chi, iters=iters,
                                   boundary=boundary)


_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])


def tfim_bond_term_2d(j=1.0, h=1.0, device=None):
    """Square-lattice TFIM bond term ``-J Z(x)Z - (h/4)(X(x)1 + 1(x)X)``:
    the field is split ``h/4`` per bond side because every site belongs to
    four bonds (coordination 4).  Critical field ``h_c ~ 3.044 J``.  On
    ``device`` (default ``cuda``)."""
    eye = np.eye(2)
    h2 = -j * np.kron(_SZ, _SZ) - 0.25 * h * (np.kron(_SX, eye) + np.kron(eye, _SX))
    return torch.from_numpy(h2).to(resolve_device(device))


def heisenberg_bond_term_2d(j=1.0, rotated=True, device=None):
    """Square-lattice spin-1/2 Heisenberg bond term ``J S_i . S_j``.

    ``rotated=True`` (default) applies the sublattice rotation (spins on
    one checkerboard sublattice turned by pi about y), mapping the Neel
    order onto a translation-invariant state: ``S . S -> -Sx Sx + Sy Sy -
    Sz Sz`` (a real matrix).  ``rotated=False`` returns the bare ``J S .
    S``.  The symmetrized single-site :func:`simple_update` stalls for this
    model (see its docstring).  On ``device`` (default ``cuda``).
    """
    sx = _SX / 2.0
    sy = np.array([[0.0, -1.0j], [1.0j, 0.0]]) / 2.0
    sz = _SZ / 2.0
    syy = np.real(np.kron(sy, sy))  # purely real: (+-i/2)(+-i/2) entries
    if rotated:
        h2 = j * (-np.kron(sx, sx) + syy - np.kron(sz, sz))
    else:
        h2 = j * (np.kron(sx, sx) + syy + np.kron(sz, sz))
    return torch.from_numpy(h2).to(resolve_device(device))


# --------------------------------------------------------------------- #
# Simple-update ground states
# --------------------------------------------------------------------- #

_LAM_TOL = 1e-9  # relative to max(lambda); matches itebd's guarded inverse


def _su_bond_update(gamma, lam, gate):
    """One simple-update gate application on a horizontal bond.

    ``gamma (d, D, D, D, D)`` in (phys, u, l, d, r) order, ``lam (D,)`` the
    shared C4v bond weight.  Weights are absorbed on every external bond and
    the shared bond, the gate acts on the two-site block, an SVD truncates
    back to ``D``, external weights are divided back out, and the two
    updated tensors are averaged into one C4v-symmetric gamma.
    """
    d, bond = gamma.shape[0], gamma.shape[1]
    cut = _LAM_TOL * lam.max()
    linv = torch.where(lam > cut, 1.0 / torch.clamp(lam, min=1e-300),
                       torch.zeros_like(lam)).to(gamma.dtype)
    lamc = lam.to(gamma.dtype)

    wl = gamma * lamc[None, :, None, None, None]  # up
    wl = wl * lamc[None, None, :, None, None]     # left
    wl = wl * lamc[None, None, None, :, None]     # down
    wl = wl * lamc[None, None, None, None, :]     # right (the shared bond)
    wr = gamma * lamc[None, :, None, None, None]  # up
    wr = wr * lamc[None, None, None, :, None]     # down
    wr = wr * lamc[None, None, None, None, :]     # right

    # theta[s1, u1, l1, d1, s2, u2, d2, r2]
    theta = peinsum("sulxm,tvmyr->sulxtvyr", wl, wr)
    theta = peinsum("STst,sulxtvyr->SulxTvyr", gate.reshape(d, d, d, d), theta)
    mat = theta.reshape(d * bond ** 3, d * bond ** 3)
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    lam_new = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    # The C4v projection below is not covariant under a sign change on one
    # leg, and cuSOLVER and LAPACK sign their singular vectors differently:
    # each pair is signed so that its new bond slice overlaps the old
    # tensor's slice on the same (right) leg positively, which keeps the
    # bond basis continuous from update to update (LAPACK's output already
    # is, so the JAX package's trajectory is unchanged).
    overlap = torch.real((u.reshape(d, bond, bond, bond, bond).conj() * gamma).sum(
        dim=(0, 1, 2, 3)))
    sign = torch.where(overlap < 0, -1.0, 1.0).to(u.dtype)
    u, vh = u * sign[None, :], vh * sign[:, None]

    g1 = u.reshape(d, bond, bond, bond, bond)  # (s, u, l, d, m)
    g1 = g1 * linv[None, :, None, None, None]
    g1 = g1 * linv[None, None, :, None, None]
    g1 = g1 * linv[None, None, None, :, None]
    g2 = vh.reshape(bond, d, bond, bond, bond).permute(1, 2, 0, 3, 4)  # (s, u, m, d, r)
    g2 = g2 * linv[None, :, None, None, None]
    g2 = g2 * linv[None, None, None, :, None]
    g2 = g2 * linv[None, None, None, None, :]

    # g1's new bond sits at 'right', g2's at 'left': mirror g2 and average,
    # then project the pair onto the full C4v orbit.
    gamma_new = symmetrize_c4v(0.5 * (g1 + g2.permute(0, 1, 4, 3, 2)))
    nrm = torch.sqrt((gamma_new.abs() ** 2).sum())
    return gamma_new / torch.clamp(nrm, min=1e-300), lam_new


def _su_stage(gamma, lam, gate, n_iter):
    for _ in range(int(n_iter)):
        gamma, lam = _su_bond_update(gamma, lam, gate)
    return gamma, lam


def su_absorb_weights(gamma, lam):
    """The measurable iPEPS tensor: ``sqrt(lam)`` absorbed on every bond."""
    root = torch.sqrt(lam).to(gamma.dtype)
    a_site = gamma * root[None, :, None, None, None]
    a_site = a_site * root[None, None, :, None, None]
    a_site = a_site * root[None, None, None, :, None]
    return a_site * root[None, None, None, None, :]


def simple_update(h2, bond_dim, d=2,
                  schedule=((0.1, 200), (0.02, 200), (0.005, 100)),
                  dtype=torch.float64, init=None):
    """Symmetric simple-update imaginary-time evolution on the square
    lattice (Jiang-Weng-Xiang), restricted to the C4v single-site cell this
    module's CTMRG measures.  Each stage (fixed Trotter step) is a plain
    loop on the device; the host only walks the ``(dt, n_iter)`` schedule.

    Suitable for rotation-invariant, weakly-entangled phases (e.g. the 2D
    transverse-field Ising model).  For the Heisenberg antiferromagnet this
    symmetrized update stalls at the product fixed point (the C4v rotation
    averaging cancels the entanglement-growth direction); the two-site-cell
    update has no such pathology.

    ``h2`` (and ``init``) set the device: a torch tensor keeps its own, a
    numpy array goes to ``cuda``.

    Returns:
        ``(gamma, lam)`` — pass through :func:`su_absorb_weights` and the
        expectation functions to measure.
    """
    from .itebd import two_site_gate

    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,) + ((init,) if init is not None else ()))
    if init is None:
        v = np.cos(0.3 + 0.4 * np.arange(d))
        v = v / np.linalg.norm(v)
        gamma = product_peps(v, bond_dim, dtype=dtype, device=device)
        # tiny symmetric noise so gates can grow entanglement out of the
        # rank-1 start (drawn on the host, as the JAX package draws it)
        rng = np.random.default_rng(0)
        noise = rng.normal(size=tuple(gamma.shape)).astype(
            torch.empty((), dtype=dtype).numpy().dtype)
        gamma = gamma + symmetrize_c4v(0.01 * torch.from_numpy(noise).to(device))
    else:
        gamma = as_tensor(init, device, dtype)
    # bond weights are singular values: REAL even for complex dtypes
    lam = torch.ones((bond_dim,), dtype=real_dtype(dtype), device=device) / np.sqrt(bond_dim)

    h2 = as_tensor(h2, device, dtype)
    for dt, n_iter in schedule:
        gamma, lam = _su_stage(gamma, lam, two_site_gate(h2, dt), n_iter)
    return gamma, lam


def ipeps_ground_state(h2, bond_dim, chi, d=2,
                       schedule=((0.1, 200), (0.02, 200), (0.005, 100)),
                       iters=200, dtype=torch.float64):
    """Ground state of ``H = sum_<ij> h2`` by simple update + CTMRG.

    Returns ``(a_site, energy)``: the optimized iPEPS tensor (weights
    absorbed) and its true variational energy per site measured with
    :func:`ipeps_energy` (a 0-d tensor on the device).
    """
    gamma, lam = simple_update(h2, bond_dim, d=d, schedule=schedule,
                               dtype=dtype)
    a_site = su_absorb_weights(gamma, lam)
    h2 = as_tensor(h2, a_site.device, a_site.dtype)
    return a_site, ipeps_energy(a_site, h2, chi, iters=iters)


def product_peps(vec, bond_dim=1, dtype=None, device=None):
    """The product state ``|v>^(x) N`` as a (trivially C4v) iPEPS; ``bond_dim
    > 1`` zero-pads the virtual bonds.  On ``device`` (default ``cuda``)."""
    vec = np.asarray(vec)
    dtype = torch_dtype(dtype)
    np_dtype = vec.dtype if dtype is None else torch.empty((), dtype=dtype).numpy().dtype
    a_site = np.zeros((vec.shape[0],) + (bond_dim,) * 4, np_dtype)
    a_site[(slice(None),) + (0,) * 4] = vec
    return torch.from_numpy(a_site).to(resolve_device(device))
