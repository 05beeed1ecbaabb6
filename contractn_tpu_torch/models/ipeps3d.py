"""iPEPS on the cubic lattice: infinite 3D quantum ground states.

Counterpart of ``contractn_tpu/models/ipeps3d.py``.  A translation-invariant
PEPS tensor ``A (d, D, D, D, D, D, D)`` (phys + six virtual legs ``u, l, d,
r, f, k`` in :mod:`.hotrg3d`'s axis convention) optimized by the symmetric
single-site simple update (Jiang-Weng-Xiang generalized to coordination 6),
and measured by contracting the double-layer norm network (bond ``q = D^2``)
with the 3D HOTRG impurity flows of :mod:`.hotrg3d`.

Scope mirrors the 2D module: the cubic-symmetric single-tensor variant (one
gamma, one shared bond weight, full octahedral averaging of the virtual
legs), for rotation-invariant phases such as the 3D transverse-field Ising
model.  Each Trotter stage is a plain loop of SVD-per-gate updates on the
device (:func:`~..ops.linalg_ad.small_svd`).

Sign rule (as in :mod:`.ipeps`): the cubic projection is not covariant under
a sign change of one bond slice, and cuSOLVER and LAPACK sign their singular
vectors differently, so each pair is signed so that its new bond slice
overlaps the old tensor's slice on the same leg positively.  LAPACK's output
already is, so the JAX package's trajectory is unchanged.

Departures: the functions that build host arrays
(:func:`tfim_bond_term_3d`, :func:`product_peps3d`) take ``device=``
(default ``cuda``) and return torch tensors; :func:`ipeps3d_expect_bond`
raises :class:`TNError` on an ``h2`` with a nonzero imaginary part, where
the JAX package silently drops it.
"""

import numpy as np
import torch

from ..ops.linalg_ad import small_svd
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from ..utils.errors import TNError
from .hotrg3d import hotrg3d_bond_expectation, hotrg3d_expectation

_LAM_TOL = 1e-12


def _cubic_group():
    """The 48 virtual-leg permutations of the cube's symmetry group, acting
    on legs ``(u, l, d, r, f, k)`` = axis pairs z/x/y."""
    rot = (1, 4, 3, 5, 0, 2)   # axes cycle z -> x -> y (hotrg3d._rot3)
    swap_ud = (2, 1, 0, 3, 4, 5)
    swap_lr = (0, 3, 2, 1, 4, 5)
    swap_zx = (1, 0, 3, 2, 4, 5)  # exchange the z and x axes
    perms = {(0, 1, 2, 3, 4, 5)}
    frontier = [(0, 1, 2, 3, 4, 5)]
    while frontier:
        p = frontier.pop()
        for g in (rot, swap_ud, swap_lr, swap_zx):
            q = tuple(p[i] for i in g)
            if q not in perms:
                perms.add(q)
                frontier.append(q)
    return sorted(perms)


_CUBIC_PERMS = _cubic_group()


def _site(a_site):
    return as_tensor(a_site, resolve_device(None, (a_site,)))


def symmetrize_cubic(a):
    """Average a ``(d, D, D, D, D, D, D)`` tensor over the full cubic point
    group on its virtual legs (48 images)."""
    a = _site(a)
    acc = 0.0
    for p in _CUBIC_PERMS:
        acc = acc + a.permute((0,) + tuple(i + 1 for i in p))
    return acc / len(_CUBIC_PERMS)


def tfim_bond_term_3d(j=1.0, h=1.0, device=None):
    """Bond term of the cubic-lattice TFIM with the field split across the
    SIX bonds each site touches: ``-j Z(x)Z - (h/6)(X(x)I + I(x)X)``.  On
    ``device`` (default ``cuda``)."""
    z = np.diag([1.0, -1.0])
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    eye = np.eye(2)
    h2 = -j * np.kron(z, z) - (h / 6.0) * (np.kron(x, eye) + np.kron(eye, x))
    return torch.from_numpy(h2).to(resolve_device(device))


def _dress(g, lam, axes):
    for ax in axes:
        shape = [1] * 7
        shape[ax] = lam.shape[0]
        g = g * lam.reshape(shape)
    return g


def _su_bond_update3(gamma, lam, gate):
    """One simple-update gate on an x-axis (r) bond, then cubic
    re-symmetrization (gates on the five other leg orientations are
    redundant by symmetry)."""
    d, bond = gamma.shape[0], gamma.shape[1]
    cut = _LAM_TOL * lam.max()
    linv = torch.where(lam > cut, 1.0 / torch.clamp(lam, min=1e-300),
                       torch.zeros_like(lam)).to(gamma.dtype)
    lamc = lam.to(gamma.dtype)

    # left site: weights on u, l, d, f, k and the shared r bond
    wl = _dress(gamma, lamc, (1, 2, 3, 4, 5, 6))
    # right site: weights on u, d, r, f, k (l is the shared bond)
    wr = _dress(gamma, lamc, (1, 3, 4, 5, 6))
    # theta[s, u1, l1, d1, f1, k1, t, u2, d2, r2, f2, k2]
    theta = peinsum("suldmfk,tvmwxyz->suldfktvwxyz", wl, wr)
    theta = peinsum("STst,suldfktvwxyz->SuldfkTvwxyz", gate.reshape(d, d, d, d), theta)
    mat = theta.reshape(d * bond ** 5, d * bond ** 5)
    u, s, vh = small_svd(mat)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    lam_new = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    # sign each pair so its new slice overlaps the old tensor's r slice
    # positively (module docstring)
    old = gamma.permute(0, 1, 2, 3, 5, 6, 4).reshape(-1, bond)
    overlap = torch.real((u.conj() * old).sum(dim=0))
    sign = torch.where(overlap < 0, -1.0, 1.0).to(u.dtype)
    u, vh = u * sign[None, :], vh * sign[:, None]

    g1 = u.reshape(d, bond, bond, bond, bond, bond, bond)
    g1 = g1.permute(0, 1, 2, 3, 6, 4, 5)  # (s, u, l, d, f, k, m) -> (s, u, l, d, m, f, k)
    g1 = _dress(g1, linv, (1, 2, 3, 5, 6))
    g2 = vh.reshape(bond, d, bond, bond, bond, bond, bond)
    g2 = g2.permute(1, 2, 0, 3, 4, 5, 6)  # (m, s, u, d, r, f, k) -> (s, u, m, d, r, f, k)
    g2 = _dress(g2, linv, (1, 3, 4, 5, 6))
    # g1's fresh bond sits at 'r', g2's at 'l': mirror g2 onto g1's
    # orientation, average, project onto the cubic orbit
    gamma_new = symmetrize_cubic(0.5 * (g1 + g2.permute(0, 1, 4, 3, 2, 5, 6)))
    nrm = torch.sqrt((gamma_new.abs() ** 2).sum())
    return gamma_new / torch.clamp(nrm, min=1e-300), lam_new


def _su_stage3(gamma, lam, gate, n_iter):
    for _ in range(int(n_iter)):
        gamma, lam = _su_bond_update3(gamma, lam, gate)
    return gamma, lam


def product_peps3d(vec, bond_dim=1, dtype=None, device=None):
    """Rank-1 cubic PEPS encoding the product state ``|vec>^(x)N``; on
    ``device`` (default ``cuda``)."""
    vec = np.asarray(vec)
    dtype = torch_dtype(dtype)
    np_dtype = vec.dtype if dtype is None else torch.empty((), dtype=dtype).numpy().dtype
    a = np.zeros((vec.shape[0],) + (bond_dim,) * 6, np_dtype)
    a[(slice(None),) + (0,) * 6] = vec
    return torch.from_numpy(a).to(resolve_device(device))


def simple_update_3d(h2, bond_dim, d=2,
                     schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                     dtype=torch.float64, init=None):
    """Cubic-symmetric simple-update imaginary-time evolution.

    Returns ``(gamma, lam)``; measure via :func:`su3d_absorb_weights` and
    the expectation functions.  ``h2`` (and ``init``) set the device: a
    torch tensor keeps its own, a numpy array goes to ``cuda``.
    """
    from .itebd import two_site_gate

    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,) + ((init,) if init is not None else ()))
    if init is None:
        v = np.cos(0.3 + 0.4 * np.arange(d))
        v = v / np.linalg.norm(v)
        gamma = product_peps3d(v, bond_dim, dtype=dtype, device=device)
        # the start's noise drawn on the host, as the JAX package draws it
        rng = np.random.default_rng(0)
        noise = rng.normal(size=tuple(gamma.shape))
        gamma = gamma + symmetrize_cubic(
            torch.from_numpy(0.01 * noise).to(device, dtype))
    else:
        gamma = as_tensor(init, device, dtype)
    lam = torch.ones((bond_dim,), dtype=real_dtype(dtype), device=device) / np.sqrt(bond_dim)
    h2 = as_tensor(h2, device, dtype)
    for dt, n_iter in schedule:
        gamma, lam = _su_stage3(gamma, lam, two_site_gate(h2, dt), n_iter)
    return gamma, lam


def su3d_absorb_weights(gamma, lam):
    """The measurable tensor: ``sqrt(lam)`` absorbed on all six legs."""
    gamma = _site(gamma)
    return _dress(gamma, torch.sqrt(as_tensor(lam, gamma.device)).to(gamma.dtype),
                  range(1, 7))


def peps3d_double_layer(a_site, op=None):
    """Norm-network tensor ``sum_s A[s] (x) conj(A[s])`` with fused ``(ket,
    bra)`` bonds ``q = D^2``, or the ``op`` impurity when given.  Legs ``(u,
    l, d, r, f, k)``, ready for :mod:`.hotrg3d`."""
    a_site = _site(a_site)
    if op is None:
        pair = peinsum("suldrfk,sULDRFK->uUlLdDrRfFkK", a_site, a_site.conj())
    else:
        op = as_tensor(op, a_site.device, a_site.dtype)
        pair = peinsum("st,tuldrfk,sULDRFK->uUlLdDrRfFkK", op, a_site, a_site.conj())
    q = a_site.shape[1] ** 2
    return pair.reshape((q,) * 6)


def ipeps3d_expect_local(a_site, op, chi, steps=25):
    """``<op>`` per site from the 3D HOTRG impurity flow over the double
    layer (``chi`` is the flow bond, needs ``chi >= D^2``); a host float."""
    return hotrg3d_expectation(peps3d_double_layer(a_site),
                               peps3d_double_layer(a_site, op), chi, steps=steps)


def _real_bond_term(h2, d):
    """``h2`` as a real ``(d, d, d, d)`` host array; a nonzero imaginary part
    raises :class:`TNError` (the operator-Schmidt channels are real)."""
    if isinstance(h2, torch.Tensor):
        h2 = h2.detach().cpu().numpy()
    h2 = np.asarray(h2)
    if np.iscomplexobj(h2):
        if np.any(h2.imag != 0):
            raise TNError("h2 has a nonzero imaginary part; this measurement takes "
                          "a real bond term")
        h2 = h2.real
    return np.asarray(h2, float).reshape(d, d, d, d)


def ipeps3d_expect_bond(a_site, h2, chi, steps=25):
    """Nearest-neighbor ``<h2>`` on a bond via the pinned-pair seed merge
    (operator Schmidt split of ``h2`` over the two sites); a host float."""
    a_site = _site(a_site)
    d = a_site.shape[0]
    h2 = _real_bond_term(h2, d)
    # operator-Schmidt: h2[s1 t1, s2 t2] = sum_c oa_c (x) ob_c
    mat = np.transpose(h2, (0, 2, 1, 3)).reshape(d * d, d * d)
    uu, ss, vv = np.linalg.svd(mat)
    total = 0.0
    a2 = peps3d_double_layer(a_site)
    for c in range(len(ss)):
        if ss[c] < 1e-14:
            continue
        oa = (uu[:, c] * ss[c]).reshape(d, d)
        ob = vv[c, :].reshape(d, d)
        total += hotrg3d_bond_expectation(a2, peps3d_double_layer(a_site, oa),
                                          peps3d_double_layer(a_site, ob), chi, steps=steps)
    return float(total)


def ipeps3d_energy(a_site, h2, chi, steps=25):
    """Energy per site: three bonds per site on the cubic lattice."""
    return 3.0 * ipeps3d_expect_bond(a_site, h2, chi, steps=steps)


def ipeps3d_ground_state(h2, bond_dim, chi, d=2,
                         schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                         steps=25, dtype=torch.float64):
    """Ground state of ``H = sum_<ij> h2`` on the cubic lattice by simple
    update, measured with the 3D HOTRG environment.  Returns ``(a_site,
    energy_per_site)``, the energy a host float."""
    gamma, lam = simple_update_3d(h2, bond_dim, d=d, schedule=schedule, dtype=dtype)
    a_site = su3d_absorb_weights(gamma, lam)
    return a_site, ipeps3d_energy(a_site, h2, chi, steps=steps)
