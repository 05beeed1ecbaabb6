"""HOTRG: higher-order TRG coarse-graining of infinite 2D networks.

Counterpart of ``contractn_tpu/models/hotrg.py``.  The higher-order tensor
renormalization group (Xie et al., PRB 86, 045139) contracts an infinite 2D
tensor network by repeatedly merging pairs of site tensors along alternating
lattice axes and truncating the squared transverse bonds with an isometry
from the merged tensor's own one-sided density matrix.  After ``k`` steps
one tensor represents a ``2^k``-site block.  CTMRG (:mod:`.ctmrg`) converges
a fixed *environment*, HOTRG renormalizes the *bulk tensor itself*; the two
give independent routes to the same partition function.

* **Zero-padded static bonds.**  The site tensor is padded to ``(chi, chi,
  chi, chi)`` up front, so the whole flow (growth phase included) is one
  loop of static shapes.  The values depend on the padding: the density
  matrix's null-space eigenvectors project the merged tensor onto
  exactly-zero slices, and kept columns with numerically zero eigenvalue are
  zeroed outright (the live mask), so no junk enters an impurity flow.
* **Never materialize the chi^6 pair tensor.**  The density matrix is
  assembled from two chi^4 half-contractions, and the truncated update
  applies the isometries in an O(chi^7) three-step order with chi^5 peak
  intermediates.
* **Split format rides the flow.**  Each merged tensor is rescaled to mean
  ``|mantissa| = 1`` and the log factor is carried on the device with the
  ``g -> 2 g + log c`` block-doubling recursion.
* The axis choice (the isometry with the smaller discarded weight) is a
  device-side ``torch.where``: nothing is read on the host inside the flow.

Observables use impurity flows: a one-site impurity is averaged over block
positions (``(i (x) a + a (x) i) / 2`` per merge), a nearest-neighbor pair
impurity is seeded by one un-truncated vertical merge of two impure tensors
and then flows as a one-site impurity.  The differentiable flow
(:func:`hotrg_log_z_diff`) holds the isometries fixed (``.detach()``) and
differentiates the rest with ``torch.autograd``; the density-matrix
``eigh`` is :func:`~..ops.linalg_ad.eigh_safe`.

Departure: the host-array builders (:func:`ising_tensor_smooth`,
:func:`potts_tensor_smooth`) take ``device=`` (default: ``beta``'s device if
it is a tensor, else ``cuda``).
"""

import numpy as np
import torch

from ..ops.linalg_ad import eigh_safe
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device


def _pad_to_chi(a, chi):
    """Zero-pad every bond of ``a (q,q,q,q)`` up to ``chi``."""
    pad = []
    for s in reversed(a.shape):
        pad += [0, chi - s]
    return torch.nn.functional.pad(a, pad)


def _density_pair(top, bot):
    """Left-bond density matrix of the (never-built) vertical pair,
    ``rho[(l1 l2), (l1' l2')]``, from two chi^4 halves (HOTRG paper's
    factorization, App. A)."""
    chi = top.shape[0]
    h1 = peinsum("ulmr,uLMr->lLmM", top, top)
    h2 = peinsum("mldr,MLdr->lLmM", bot, bot)
    rho = peinsum("aAmM,bBmM->abAB", h1, h2)
    return rho.reshape(chi * chi, chi * chi)


def _isometry(rho, chi):
    """Top-``chi`` eigenbasis of a PSD ``rho``; returns ``(u3, err)`` with
    ``u3 (chi, chi, chi)`` and ``err`` the discarded weight.

    Kept columns whose eigenvalue is numerically ZERO (padding null space)
    are zeroed outright: eigh fills them with arbitrary orthonormal junk
    that annihilates the pure tensor but leaks impurity components.
    """
    rho = 0.5 * (rho + rho.T)
    vals, vecs = eigh_safe(rho)
    keep = torch.argsort(-vals, stable=True)[:chi]
    kept_vals = vals[keep]
    err = vals.abs().sum() - kept_vals.abs().sum()
    live = kept_vals > 1e-13 * torch.clamp(vals.abs().max(), min=1e-300)
    u = vecs[:, keep] * live[None, :].to(vecs.dtype)
    return u.reshape(chi, chi, chi), err


def _apply_pair(top, bot, u3l, u3r):
    """Truncated vertical merge: ``U_L^T (top*bot) U_R`` without the chi^6
    intermediate (O(chi^7) flops, chi^5 peak memory)."""
    q = peinsum("abl,mbdr->almdr", u3l, bot)
    r = peinsum("uamt,almdr->utldr", top, q)
    return peinsum("utldr,trx->uldx", r, u3r)


def _rot(a):
    """Rotate the lattice 90 degrees: ``(u,l,d,r) <- (l,d,r,u)``."""
    return a.permute(1, 2, 3, 0)


def _choose_isometry(a, chi):
    """The isometry of the side (left or right of the vertical pair) with
    the smaller discarded weight, chosen on the device."""
    u3l, err_l = _isometry(_density_pair(a, a), chi)
    # Right-side density: mirror l<->r (transpose both bond pairs).
    am = a.permute(0, 3, 2, 1)
    u3r, err_r = _isometry(_density_pair(am, am), chi)
    return torch.where(err_l <= err_r, u3l, u3r), torch.minimum(err_l, err_r)


def _merge_step(a, imp, chi, frozen_proj=False):
    """One HOTRG merge along the current vertical axis + rotation.

    Returns the renormalized ``(a, imp, log_c, err)``; ``imp`` flows as a
    position-averaged one-site impurity sharing ``a``'s isometries and
    normalization, so ``Tr(imp)/Tr(a)`` stays the observable.

    ``frozen_proj=True`` detaches the isometries (autodiff mode): the
    truncation boundary almost always cuts through a symmetry multiplet of
    the block density matrix, where a straight-through ``eigh`` gradient
    diverges; with the projectors held fixed the gradient is exactly the
    position-averaged impurity insertion, accurate to the truncation error.
    """
    u3, err = _choose_isometry(a, chi)
    if frozen_proj:
        u3 = u3.detach()
    a_new = _apply_pair(a, a, u3, u3)
    imp_new = 0.5 * (_apply_pair(imp, a, u3, u3) + _apply_pair(a, imp, u3, u3))
    c = torch.clamp(a_new.abs().mean(), min=1e-300)
    return _rot(a_new / c), _rot(imp_new / c), torch.log(c), err


def _closure(a):
    """Periodic one-tensor closure ``sum_{u,l} a[u,l,u,l]``."""
    return peinsum("ulul->", a)


def _hotrg_flow(a0, imp0, chi, steps, frozen_proj=False):
    c0 = torch.clamp(a0.abs().mean(), min=1e-300)
    a, imp, g = a0 / c0, imp0 / c0, torch.log(c0)
    errs = []
    for _ in range(int(steps)):
        a, imp, log_c, err = _merge_step(a, imp, chi, frozen_proj)
        # Block doubles: g_{k+1} = 2 g_k + log c_{k+1}.
        g = 2.0 * g + log_c
        errs.append(err)
    tr_a = _closure(a)
    log_z = (g + torch.log(tr_a.abs())) / (2.0 ** steps)
    return log_z, _closure(imp) / tr_a, errs


def _site(a):
    return as_tensor(a, resolve_device(None, (a,)))


def hotrg_log_z(a, chi, steps=30):
    """``log(partition function per site)`` of the infinite square lattice
    built from site tensor ``a (q,q,q,q)`` (axes ``u,l,d,r``, matching
    :func:`~.ctmrg.ising_tensor`); a host float."""
    a0 = _pad_to_chi(_site(a), chi)
    with torch.no_grad():
        log_z, _, _ = _hotrg_flow(a0, a0, chi, int(steps))
    return float(log_z)


def hotrg_expectation(a, impurity, chi, steps=30):
    """``<impurity>``: one-site impurity average over the infinite lattice
    (e.g. the magnetization tensor from ``ising_tensor(beta, field_op=[1,
    -1])``)."""
    a = _site(a)
    impurity = as_tensor(impurity, a.device, a.dtype)
    with torch.no_grad():
        _, ratio, _ = _hotrg_flow(_pad_to_chi(a, chi),
                                  _pad_to_chi(impurity, chi), chi, int(steps))
    return float(ratio)


def hotrg_bond_expectation(a, imp_top, imp_bot, chi, steps=30):
    """Nearest-neighbor pair expectation ``<O_i O_j>`` on a vertical bond:
    the first merge contracts the two impure tensors into ONE coarse
    impurity (no position averaging — the pair is pinned), which then flows
    as a one-site impurity."""
    a = _site(a)
    chi = int(chi)
    a0 = _pad_to_chi(a, chi)
    t0 = _pad_to_chi(as_tensor(imp_top, a.device, a.dtype), chi)
    b0 = _pad_to_chi(as_tensor(imp_bot, a.device, a.dtype), chi)
    with torch.no_grad():
        c0 = torch.clamp(a0.abs().mean(), min=1e-300)
        a0, t0, b0 = a0 / c0, t0 / c0, b0 / c0
        # Seed merge: pure tensor and pinned pair share the pure tensor's
        # isometries and normalization.
        u3, _ = _choose_isometry(a0, chi)
        a1 = _apply_pair(a0, a0, u3, u3)
        i1 = _apply_pair(t0, b0, u3, u3)
        c = torch.clamp(a1.abs().mean(), min=1e-300)
        _, ratio, _ = _hotrg_flow(_rot(a1 / c), _rot(i1 / c), chi,
                                  int(steps) - 1)
    return float(ratio)


# -- differentiable RG (autodiff through the whole flow) --------------- #

def _beta_tensor(beta, device):
    device = resolve_device(device, (beta,))
    if isinstance(beta, torch.Tensor):
        return beta.to(device)
    return torch.tensor(float(beta), dtype=torch.float64, device=device)


def ising_tensor_smooth(beta, h_field=0.0, device=None):
    """Square-lattice Ising site tensor as a SMOOTH torch function of
    ``beta`` (and an optional longitudinal field), for autodiff.

    Identical values to :func:`~.ctmrg.ising_tensor` up to an orthogonal
    gauge on each bond: the bond Boltzmann factorization is written in
    closed form, ``W = [[sqrt(cosh b), sqrt(sinh b)], [sqrt(cosh b),
    -sqrt(sinh b)]]``, so every operation is differentiable.
    """
    beta = _beta_tensor(beta, device)
    ch = torch.sqrt(torch.cosh(beta))
    sh = torch.sqrt(torch.sinh(beta))
    w = torch.stack([torch.stack([ch, sh]), torch.stack([ch, -sh])])
    spins = torch.tensor([1.0, -1.0], dtype=beta.dtype, device=beta.device)
    weight = torch.exp(h_field * spins)
    return peinsum("s,su,sl,sd,sr->uldr", weight, w, w, w, w)


def potts_tensor_smooth(beta, q=3, device=None):
    """q-state Potts site tensor, smooth in ``beta``: the bond matrix ``B =
    (e^b - 1) I + J`` has the CONSTANT eigenbasis (uniform vector + its
    orthogonal complement) with eigenvalues ``e^b - 1 + q`` and ``e^b -
    1``, so only the eigenvalues trace through ``beta``."""
    beta = _beta_tensor(beta, device)
    seed = np.ones((q, q))
    seed[:, 1:] = np.eye(q)[:, 1:]
    vecs, _ = np.linalg.qr(seed)  # first column = -+ 1/sqrt(q)
    eb = torch.exp(beta)
    vals = torch.cat([(eb - 1.0 + q)[None], (eb - 1.0).expand(q - 1)])
    w = torch.from_numpy(vecs).to(beta.device, beta.dtype) * torch.sqrt(vals)[None, :]
    return peinsum("su,sl,sd,sr->uldr", w, w, w, w)


def hotrg_log_z_diff(a, chi, steps=24):
    """``log Z`` per site as a 0-d tensor, differentiable through the
    entire RG flow with ``torch.autograd``.

    The isometries are held FIXED under differentiation (see
    :func:`_merge_step`); the resulting gradient equals the impurity-flow
    value and converges with ``chi`` like every other HOTRG observable.
    ``torch.autograd.grad(hotrg_log_z_diff(ising_tensor_smooth(b), chi),
    b)`` is ``-u(beta)``, the internal energy from one reverse pass.
    """
    a0 = _pad_to_chi(_site(a), chi)
    log_z, _, _ = _hotrg_flow(a0, a0, chi, int(steps), frozen_proj=True)
    return log_z


def ising_internal_energy_ad(beta, chi, steps=24, h_field=0.0, device=None):
    """Onsager-testable internal energy per site ``u = -d log Z / d beta``
    by autodiff through the HOTRG flow (on ``device``, default ``cuda``; a
    host float)."""
    b = torch.tensor(float(beta), dtype=torch.float64,
                     device=resolve_device(device), requires_grad=True)
    log_z = hotrg_log_z_diff(ising_tensor_smooth(b, h_field), chi, steps)
    (grad,) = torch.autograd.grad(log_z, b)
    return float(-grad)


def ising_specific_heat_ad(beta, chi, steps=24, delta=1e-4):
    """Specific heat ``C = beta^2 d^2 log Z / d beta^2`` as a central
    difference over the autodiff energy (differencing two machine-accurate
    first derivatives costs only ~``delta^2``)."""
    beta = float(beta)
    up = ising_internal_energy_ad(beta + delta, chi, steps)
    dn = ising_internal_energy_ad(beta - delta, chi, steps)
    return float(-beta * beta * (up - dn) / (2.0 * delta))
