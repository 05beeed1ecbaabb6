"""Thermal 3D quantum states: purification iPEPS on the cubic lattice.

Counterpart of ``contractn_tpu/models/thermal3d.py``.  The identity
purification ``|Psi(beta)> = e^{-beta H / 2} |Phi>`` on fused ``(phys x
ancilla)`` cubic-lattice sites, evolved in imaginary time by Trotter sweeps
with iTEBD-exact bookkeeping, and measured through the CHECKERBOARD 3D HOTRG
flows (:func:`~.hotrg3d.hotrg3d_ab_expectation`); the ancilla trace is free
in the double layer, as in :mod:`.thermal2d`.

* **Evolution is bipartite.**  A one-tensor scheme averaging the two SVD
  halves puts the fresh Schmidt basis on the r-legs only and stalls, so the
  module keeps TWO sublattice tensors and SIX direction-resolved bond
  classes (+-x, +-y, +-z), one gate per class per sweep: after ``n`` sweeps
  every bond has received ``exp(-d_beta h2)`` exactly ``n`` times.  The
  fresh basis lands on both bond ends, so the update is blind to the signs
  of the singular vectors.
* **Measurement is checkerboard-aware.**  The evolved A and B tensors differ
  by per-bond gauges; the checkerboard flow contracts the genuine A/B
  network.

For commuting Hamiltonians (pure Ising) the thermal PEPS is exact at bond
dimension 2, so ``<Z Z>`` equals the classical 3D Ising bond correlation of
:func:`~.hotrg3d.hotrg3d_bond_expectation` at the same beta and flow chi.
``ln Z`` is not tracked.

Departures: :func:`infinite_temperature_site3d` takes ``device=`` (default
``cuda``); :func:`thermal_ipeps3d` takes ``device=`` (default: ``h2``'s if a
tensor, else ``cuda``); :func:`thermal3d_bond_expectation` raises
:class:`TNError` on an ``h2`` with a nonzero imaginary part, where the JAX
package silently drops it.
"""

import numpy as np
import torch

from ..ops.linalg_ad import small_svd
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from .hotrg3d import hotrg3d_ab_expectation
from .ipeps3d import _real_bond_term
from .thermal2d import lift_bond, lift_onsite

_LAM_TOL = 1e-12

# Bipartite bookkeeping: legs (p, u, l, d, r, f, k); u/d = +z/-z, l/r =
# -x/+x, f/k = +y/-y.  "x1" = even-to-odd along +x (A.r -- B.l), "x2" =
# odd-to-even along +x (B.r -- A.l), likewise y/z.  For each class: the frame
# permutation putting the shared pair on the update core's (l, r) slots and
# its inverse, the (left, right) tensor roles, and the slot -> class maps of
# both tensors in that frame.
_Y_PERM = (0, 1, 6, 3, 5, 2, 4)    # new (l, r) = old (k, f)
_Y_INV = (0, 1, 5, 3, 6, 4, 2)     # not self-inverse
_Z_PERM = (0, 2, 3, 4, 1, 5, 6)    # new (l, r) = old (d, u)
_Z_INV = (0, 4, 1, 2, 3, 5, 6)
_ID7 = (0, 1, 2, 3, 4, 5, 6)
_BOND_CLASSES = (
    ("x1", "A", "B", _ID7, _ID7,
     ("z1", "x2", "z2", "x1", "y1", "y2"),
     ("z2", "x1", "z1", "x2", "y2", "y1")),
    ("x2", "B", "A", _ID7, _ID7,
     ("z2", "x1", "z1", "x2", "y2", "y1"),
     ("z1", "x2", "z2", "x1", "y1", "y2")),
    ("y1", "A", "B", _Y_PERM, _Y_INV,
     ("z1", "y2", "z2", "y1", "x2", "x1"),
     ("z2", "y1", "z1", "y2", "x1", "x2")),
    ("y2", "B", "A", _Y_PERM, _Y_INV,
     ("z2", "y1", "z1", "y2", "x1", "x2"),
     ("z1", "y2", "z2", "y1", "x2", "x1")),
    ("z1", "A", "B", _Z_PERM, _Z_INV,
     ("x2", "z2", "x1", "z1", "y1", "y2"),
     ("x1", "z1", "x2", "z2", "y2", "y1")),
    ("z2", "B", "A", _Z_PERM, _Z_INV,
     ("x1", "z1", "x2", "z2", "y2", "y1"),
     ("x2", "z2", "x1", "z1", "y1", "y2")),
)
_CLASS_NAMES = ("x1", "x2", "y1", "y2", "z1", "z2")
# slot -> bond class on each sublattice tensor (u, l, d, r, f, k)
_A_SLOTS = ("z1", "x2", "z2", "x1", "y1", "y2")
_B_SLOTS = ("z2", "x1", "z1", "x2", "y2", "y1")


def _dress(g, lam_by_slot, slots, inv=False):
    for ax in slots:
        lam = lam_by_slot[ax]
        if inv:
            cut = _LAM_TOL * lam.max()
            lam = torch.where(lam > cut, 1.0 / torch.clamp(lam, min=1e-300),
                              torch.zeros_like(lam))
        shape = [1] * 7
        shape[ax] = lam.shape[0]
        g = g * lam.reshape(shape).to(g.dtype)
    return g


def _bond_update_pair(gl, gr, lams_l, lams_r, gate):
    """Gate on the shared bond (left's slot r = 4, right's slot l = 2) of the
    current frame; two tensors, iTEBD-exact bookkeeping."""
    d, bond = gl.shape[0], gl.shape[1]
    wl = _dress(gl, lams_l, (1, 2, 3, 4, 5, 6))
    wr = _dress(gr, lams_r, (1, 3, 4, 5, 6))
    theta = peinsum("suldmfk,tvmwxyz->suldfktvwxyz", wl, wr)
    theta = peinsum("STst,suldfktvwxyz->SuldfkTvwxyz", gate.reshape(d, d, d, d), theta)
    mat = theta.reshape(d * bond ** 5, d * bond ** 5)
    u, s, vh = small_svd(mat)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    lam_new = s / torch.clamp(torch.linalg.norm(s), min=1e-300)

    g1 = u.reshape(d, bond, bond, bond, bond, bond, bond).permute(0, 1, 2, 3, 6, 4, 5)
    g1 = _dress(g1, lams_l, (1, 2, 3, 5, 6), inv=True)
    g2 = vh.reshape(bond, d, bond, bond, bond, bond, bond).permute(1, 2, 0, 3, 4, 5, 6)
    g2 = _dress(g2, lams_r, (1, 3, 4, 5, 6), inv=True)
    n1 = torch.sqrt((g1.abs() ** 2).sum())
    n2 = torch.sqrt((g2.abs() ** 2).sum())
    return g1 / torch.clamp(n1, min=1e-300), g2 / torch.clamp(n2, min=1e-300), lam_new


def _sweep(ga, gb, lams, gate):
    """One Trotter sweep: every bond class gated exactly once."""
    lams = dict(lams)
    for cls, left, right, perm, inv, lcls, rcls in _BOND_CLASSES:
        gl = (ga if left == "A" else gb).permute(perm)
        gr = (gb if right == "B" else ga).permute(perm)
        lams_l = {i + 1: lams[lcls[i]] for i in range(6)}
        lams_r = {i + 1: lams[rcls[i]] for i in range(6)}
        gl, gr, lams[cls] = _bond_update_pair(gl, gr, lams_l, lams_r, gate)
        gl, gr = gl.permute(inv), gr.permute(inv)
        if left == "A":
            ga, gb = gl, gr
        else:
            gb, ga = gl, gr
    return ga, gb, lams


def infinite_temperature_site3d(bond_dim, d=2, dtype=torch.float64, device=None):
    """The exact ``beta = 0`` purification: ``vec(1)/sqrt(d)`` on every fused
    site, all bonds trivial (zero-padded to ``bond_dim``); on ``device``
    (default ``cuda``)."""
    a = np.zeros((d * d,) + (bond_dim,) * 6)
    a[(slice(None),) + (0,) * 6] = np.eye(d).reshape(d * d) / np.sqrt(d)
    return torch.from_numpy(a).to(resolve_device(device), torch_dtype(dtype))


def thermal_ipeps3d(h2, beta, bond_dim, n_steps, d=2, dtype=torch.float64, device=None):
    """Purification of ``e^{-beta H}`` for ``H = sum_<ij> h2`` on the cubic
    lattice.  Returns ``(ga, gb, lams)``: the two sublattice tensors and the
    six direction-resolved bond weights (a dict by class name)."""
    from .itebd import two_site_gate

    device = resolve_device(device, (h2,))
    dtype = torch_dtype(dtype)
    d_beta = beta / (2.0 * n_steps)
    if not dtype.is_complex:
        h2 = _real_bond_term(h2, d).reshape(d * d, d * d)
    gate = two_site_gate(as_tensor(lift_bond(h2, d), device, dtype), d_beta)
    ga = gb = infinite_temperature_site3d(bond_dim, d, dtype, device)
    lam0 = torch.zeros((bond_dim,), dtype=real_dtype(dtype), device=device)
    lam0[0] = 1.0
    lams = {c: lam0 for c in _CLASS_NAMES}
    for _ in range(int(n_steps)):
        ga, gb, lams = _sweep(ga, gb, lams, gate)
    return ga, gb, lams


def _absorb(g, slots, lams):
    roots = {slot: torch.sqrt(as_tensor(lams[cls], g.device))
             for slot, cls in enumerate(slots, start=1)}
    return _dress(g, roots, range(1, 7))


def _double_layer(site, op=None):
    if op is None:
        pair = peinsum("suldrfk,sULDRFK->uUlLdDrRfFkK", site, site.conj())
    else:
        op = as_tensor(op, site.device, site.dtype)
        pair = peinsum("st,tuldrfk,sULDRFK->uUlLdDrRfFkK", op, site, site.conj())
    q = site.shape[1] ** 2
    return pair.reshape((q,) * 6)


def thermal3d_double_layers(ga, gb, lams, op_a=None, op_b=None):
    """Norm-network tensors ``(E_A, E_B)`` with ``sqrt(lam)`` absorbed per leg
    by bond class (each bond's weight split across its two ends), with
    optional one-site operator insertions."""
    ga = as_tensor(ga, resolve_device(None, (ga,)))
    gb = as_tensor(gb, ga.device)
    a = _absorb(ga, _A_SLOTS, lams)
    b = _absorb(gb, _B_SLOTS, lams)
    return _double_layer(a, op_a), _double_layer(b, op_b)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def thermal3d_site_expectation(ga, gb, lams, op, chi, d=2, steps=22, sublattice="A"):
    """One-site physical observable ``tr(op rho)`` (ancilla traced) on the
    chosen sublattice, via the checkerboard 3D HOTRG flow; a host float."""
    ea, eb = thermal3d_double_layers(ga, gb, lams)
    lop = lift_onsite(_host(op), d)
    if sublattice == "A":
        imp, _ = thermal3d_double_layers(ga, gb, lams, op_a=lop)
        return hotrg3d_ab_expectation(ea, eb, imp_a=imp, chi=chi, steps=steps)
    _, imp = thermal3d_double_layers(ga, gb, lams, op_b=lop)
    return hotrg3d_ab_expectation(ea, eb, imp_b=imp, chi=chi, steps=steps)


def thermal3d_bond_expectation(ga, gb, lams, h2, chi, d=2, steps=22):
    """Two-site ``<h2>`` on a +z bond (A below, B above) by operator-Schmidt
    channels through the checkerboard flow; a host float."""
    dd = d * d
    h4 = lift_bond(_real_bond_term(h2, d).reshape(dd, dd), d)
    mat = np.transpose(h4.reshape(dd, dd, dd, dd), (0, 2, 1, 3)).reshape(dd * dd, dd * dd)
    uu, ss, vv = np.linalg.svd(mat)
    ea, eb = thermal3d_double_layers(ga, gb, lams)
    total = 0.0
    for c in range(len(ss)):
        if ss[c] < 1e-14:
            continue
        oa = (uu[:, c] * ss[c]).reshape(dd, dd)
        ob = vv[c, :].reshape(dd, dd)
        ia, _ = thermal3d_double_layers(ga, gb, lams, op_a=oa)
        _, ib = thermal3d_double_layers(ga, gb, lams, op_b=ob)
        total += hotrg3d_ab_expectation(ea, eb, imp_a=ia, imp_b=ib, chi=chi, steps=steps)
    return float(total)


def thermal3d_energy(ga, gb, lams, h2, chi, d=2, steps=22):
    """``<H>/N = 3 <h2>_bond`` (three bonds per site)."""
    return 3.0 * thermal3d_bond_expectation(ga, gb, lams, h2, chi, d=d, steps=steps)
