"""CTMRG: corner-transfer-matrix environments for infinite 2D networks.

Counterpart of ``contractn_tpu/models/ctmrg.py``.  The corner transfer
matrix renormalization group (Nishino-Okunishi, symmetric C4v variant)
computes the environment of a translation-invariant 2D tensor network
directly in the thermodynamic limit: a corner matrix ``C (chi, chi)`` and an
edge tensor ``T (chi, q, chi)`` absorb one row/column of the lattice per
iteration, truncated back to ``chi`` by the corner's own eigenbasis.
Converged environments give

* the partition function per site via Baxter's corner ratio
  ``kappa = w_site * w_corner / w_edge^2`` (free energy per site);
* local observables by inserting an impurity tensor into the site patch.

The growth phase (``chi`` expanding from ``q`` to ``chi_max``) and the
fixed-count convergence loop run on the site tensor's device with static
shapes after growth (enlarged-corner eigh + projected renormalization per
step) and read nothing on the host until the caller asks for a number.
Scale normalization per step keeps everything O(1); the free energy needs
only converged RATIOS.

The corner eigh goes through :func:`~..ops.linalg_ad.dense_eigh` by
default: the seed environments are zero-padded and exactly degenerate,
where the CPU build's MKL driver can raise.  ``eigh_fn`` lets the
variational layer substitute :func:`~..ops.linalg_ad.eigh_safe`.

Validated against Onsager's exact 2D Ising results (free energy and the
spontaneous magnetization ``(1 - sinh(2 beta)^-4)^(1/8)``).

Departure: the host-array builders (:func:`ising_tensor`,
:func:`potts_tensor`, :func:`ising_boundary`) take ``device=`` (default
``cuda``) and return torch tensors.
"""

import numpy as np
import torch

from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, resolve_device


def _step(c, t, a, chi, eigh_fn=dense_eigh):
    """One symmetric CTMRG absorption; returns renormalized ``(c, t)``.

    ``c (chi0, chi0)``, ``t (chi0, q, chi0)``, ``a (q, q, q, q)``
    C4v-symmetric.  Output bond is ``min(chi0 * q, chi)``.
    """
    chi0, q = t.shape[0], t.shape[1]
    # Enlarged corner: C2[(c_out, r), (d_out, d2)]
    tmp = peinsum("cua,ab->cub", t, c)
    tmp = peinsum("cub,bld->culd", tmp, t)
    c2 = peinsum("culd,ulxr->crdx", tmp, a)
    m = c2.reshape(chi0 * q, chi0 * q)
    m = 0.5 * (m + m.T)
    vals, vecs = eigh_fn(m)
    k = min(chi0 * q, chi)
    order = torch.argsort(-vals.abs(), stable=True)[:k]
    lam = vals[order]
    p = vecs[:, order]  # (chi0*q, k) isometry
    scale = torch.clamp(lam.abs().max(), min=1e-300)
    c_new = torch.diag(lam / scale)

    # Edge absorption: T2[(a_, l), d, (b, r)]
    t2 = peinsum("aub,uldr->aldbr", t, a).reshape(chi0 * q, q, chi0 * q)
    t_new = path_einsum("xi,xdy,yj->idj", p, t2, p)
    t_new = 0.5 * (t_new + t_new.permute(2, 1, 0))
    t_new = t_new / torch.clamp(t_new.abs().max(), min=1e-300)
    return c_new, t_new


def _converge(c, t, a, chi, iters, eigh_fn=dense_eigh):
    for _ in range(int(iters)):
        c, t = _step(c, t, a, chi, eigh_fn)
    return c, t


def _site_tensor(a):
    return as_tensor(a, resolve_device(None, (a,)))


def ctmrg_environment(a, chi, iters=200, boundary=None):
    """Converged ``(C, T)`` environment of the infinite lattice of ``a``.

    Args:
        a: C4v-symmetric site tensor ``(q, q, q, q)`` in (up, left, down,
            right) order; a numpy array goes to ``cuda``.
        chi: environment bond dimension.
        iters: fixed-point iterations at full ``chi``.
        boundary: optional ``(C0, T0)`` seed, e.g. a symmetry-breaking
            fixed-spin boundary (:func:`ising_boundary`); default is the
            tensor's own partial traces (free boundary).
    """
    a = _site_tensor(a)
    q = a.shape[0]
    if chi < q:
        raise ValueError(
            f"chi ({chi}) must be >= the site tensor's bond dimension "
            f"({q}) — the seed environment already has that width"
        )
    if a.is_complex():
        raise TypeError(
            "the C4v CTMRG renormalizes with a SYMMETRIC-corner eigh "
            "(m + m.T), which is structurally real-only — a complex "
            "double layer's enlarged corner is Hermitian only up to a "
            "layer swap, so the projectors silently degrade.  Use the "
            "checkerboard cell machinery (models.ipeps_cell / "
            "models.ctmrg_cell / variational_ipeps_cell), whose "
            "biorthogonal SVD projectors are complex-safe."
        )
    if boundary is None:
        c = peinsum("uldr->dr", a)
        t = peinsum("uldr->ldr", a)
    else:
        c, t = (as_tensor(x, a.device, a.dtype) for x in boundary)
    c = c / torch.clamp(c.abs().max(), min=1e-300)
    t = t / torch.clamp(t.abs().max(), min=1e-300)

    # Growth phase: chi expands by a factor q per step; then the
    # fixed-count loop at full chi.
    while c.shape[0] < chi:
        c, t = _step(c, t, a, chi)
        if c.shape[0] == chi:
            break
    return _converge(c, t, a, chi, iters)


def _site_weight(c, t, a):
    """Ring of 4 corners + 4 edges around the center tensor:
    ``[C T C; T a T; C T C]``."""
    return path_einsum("ab,buc,cd,dre,ef,fxg,gh,hla,ulxr->",
                   c, t, c, t, c, t, c, t, a)


def _corner_weight(c):
    """``tr(C^4)``: the corners-only patch."""
    c2 = c @ c
    return torch.trace(c2 @ c2)


def _edge_weight(c, t):
    """Patch ``[C T C; C T C]``: two edges, q-legs contracted."""
    return path_einsum("ab,buc,cd,de,euf,fa->", c, t, c, c, t, c)


def free_energy_per_site(a, chi, iters=200, boundary=None):
    """``log(partition function per site)`` via Baxter's corner ratio (a
    host float)."""
    a = _site_tensor(a)
    c, t = ctmrg_environment(a, chi, iters=iters, boundary=boundary)
    kappa = _site_weight(c, t, a) * _corner_weight(c) / _edge_weight(c, t) ** 2
    return float(torch.log(kappa.abs()))


def expectation(a, impurity, chi, iters=200, boundary=None):
    """``<impurity> = w[impurity] / w[a]`` at the center of the lattice."""
    a = _site_tensor(a)
    impurity = as_tensor(impurity, a.device, a.dtype)
    c, t = ctmrg_environment(a, chi, iters=iters, boundary=boundary)
    return float(_site_weight(c, t, impurity) / _site_weight(c, t, a))


# ---------------------------------------------------------------------- #
# Classical 2D Ising model tensors (built on the host with numpy)
# ---------------------------------------------------------------------- #


def _bond_factor(b):
    """``W`` with ``W W^T = B`` from the eigendecomposition of ``B``."""
    vals, vecs = np.linalg.eigh(b)
    return vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]


def _ising_bond(beta):
    return np.array([[np.exp(beta), np.exp(-beta)],
                     [np.exp(-beta), np.exp(beta)]])


def _to(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def ising_tensor(beta, field_op=None, device=None):
    """Partition-function site tensor of the square-lattice Ising model.

    ``a[u,l,d,r] = sum_s W[s,u] W[s,l] W[s,d] W[s,r]`` with
    ``W = V sqrt(E)`` from the bond Boltzmann matrix
    ``B = [[e^b, e^-b], [e^-b, e^b]] = W W^T``.  ``field_op`` (a length-2
    vector over spin values +1/-1, e.g. ``[1, -1]`` for the magnetization)
    turns the tensor into the matching impurity.  Built on the host, placed
    on ``device`` (default ``cuda``).
    """
    w = _bond_factor(_ising_bond(beta))
    weight = np.ones(2) if field_op is None else np.asarray(field_op)
    return _to(np.einsum("s,su,sl,sd,sr->uldr", weight, w, w, w, w), device)


def potts_tensor(beta, q=3, field_op=None, device=None):
    """Partition-function site tensor of the q-state Potts model
    ``H = -sum_<ij> delta(s_i, s_j)`` (same W-decomposition as
    :func:`ising_tensor`).  Self-dual critical point:
    ``beta_c = ln(1+sqrt(q))``; for the continuous transitions (``q <= 4``)
    the internal energy there is exactly ``d ln z / d beta = 1 +
    1/sqrt(q)``."""
    w = _bond_factor((np.exp(beta) - 1.0) * np.eye(q) + np.ones((q, q)))
    weight = np.ones(q) if field_op is None else np.asarray(field_op)
    return _to(np.einsum("s,su,sl,sd,sr->uldr", weight, w, w, w, w), device)


def ising_boundary(beta, device=None):
    """Fixed-spin (+1) boundary seed ``(C0, T0)`` — breaks the Z2 symmetry
    so the ordered phase converges to one pure state."""
    w = _bond_factor(_ising_bond(beta))
    c0 = np.einsum("u,l->ul", w[0], w[0])
    t0 = np.einsum("l,d,r->ldr", w[0], w[0], w[0])
    return _to(c0, device), _to(t0, device)


def ising_magnetization(beta, chi=16, iters=200):
    """``<sigma>`` of the square-lattice Ising model at inverse temperature
    ``beta`` (symmetry-broken branch; exact Onsager-Yang value
    ``(1 - sinh(2 beta)^-4)^(1/8)`` below the critical point), on
    ``cuda``."""
    a = ising_tensor(beta)
    m = ising_tensor(beta, field_op=[1.0, -1.0])
    return expectation(a, m, chi, iters=iters, boundary=ising_boundary(beta))
