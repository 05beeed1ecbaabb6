"""Thermal 2D quantum states: purification iPEPS on the checkerboard.

Counterpart of ``contractn_tpu/models/thermal2d.py``.  ``rho(beta) =
e^{-beta H}`` is purified as ``|Psi(beta)> = e^{-beta H / 2} |Phi>`` with
``|Phi>`` the site-local identity purification; the fused ``(phys x
ancilla)`` site (dimension ``d^2``) rides the checkerboard simple update of
:mod:`.ipeps_cell` unchanged, with gates and observables lifted onto the
physical factor, and expectation values come from the directional cell
CTMRG (the double layer's physical contraction is the ancilla trace).

The ``beta = 0`` start is exact (a product PEPS), and for commuting
Hamiltonians (pure Ising) every gate has operator-Schmidt rank 2, so the
thermal PEPS is exact at D = 2 and ``<Z Z>`` reproduces Onsager's
nearest-neighbor correlation.  ``ln Z`` is not tracked.

Departure: the builders :func:`lift_onsite`, :func:`lift_bond` return host
numpy arrays as in the JAX package; :func:`infinite_temperature_site` takes
``device=`` (default ``cuda``) and returns a torch tensor.
"""

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .ipeps_cell import cell_energy, cell_site_expectations, simple_update_cell, su_cell_absorb


def lift_onsite(op, d=2):
    """``op (d, d)`` on the physical factor of the fused ``(phys, anc)``
    site: ``op (x) 1_anc`` as a ``(d^2, d^2)`` matrix."""
    return np.kron(np.asarray(op), np.eye(d))


def lift_bond(h2, d=2):
    """Two-site bond term ``h2 (d^2, d^2)`` lifted to a pair of fused sites
    (acts on ``(p1, p2)``, identity on ``(a1, a2)``), as ``(d^4, d^4)`` with
    the fused ordering ``(p, a)`` per site."""
    if isinstance(h2, torch.Tensor):
        h2 = h2.detach().cpu().numpy()
    h4 = np.asarray(h2).reshape(d, d, d, d)
    eye = np.eye(d)
    lift = np.einsum("PQpq,xy,uv->PxQupyqv", h4, eye, eye)
    return lift.reshape(d * d * d * d, d * d * d * d)


def infinite_temperature_site(bond_dim, d=2, dtype=torch.float64, device=None):
    """The exact ``beta = 0`` fused-site tensor: ``vec(1)/sqrt(d)`` on the
    physical-ancilla pair, trivial (zero-padded) virtual bonds."""
    g = np.zeros((d * d,) + (bond_dim,) * 4)
    g[:, 0, 0, 0, 0] = np.eye(d).reshape(-1) / np.sqrt(d)
    return torch.from_numpy(g).to(resolve_device(device), torch_dtype(dtype))


def thermal_ipeps_cell(h2, beta, bond_dim, n_steps, d=2, dtype=torch.float64,
                       device=None):
    """Purification iPEPS at inverse temperature ``beta``: from the exact
    identity purification, ``n_steps`` first-order checkerboard sweeps of
    step ``beta / (2 n_steps)`` with the lifted gates ``exp(-dt h2) (x)
    1_anc``.  On ``device`` (default: ``h2``'s if a tensor, else ``cuda``).

    Returns ``(a_site, b_site)``, fused-site tensors ``(d^2, D, D, D, D)``.
    """
    device = resolve_device(device, (h2,))
    g0 = infinite_temperature_site(bond_dim, d=d, dtype=dtype, device=device)
    dt = float(beta) / 2.0 / int(n_steps)
    lifted = torch.from_numpy(lift_bond(h2, d)).to(device)
    ga, gb, lams = simple_update_cell(lifted, bond_dim, d=d * d,
                                      schedule=((dt, int(n_steps)),), dtype=dtype,
                                      init=(g0, g0))
    return su_cell_absorb(ga, gb, lams)


def thermal2d_energy(a_site, b_site, h2, chi, d=2, iters=100):
    """``<H>/N = Tr(H rho)/Tr(rho)`` per site of the purified pair
    (:func:`~.ipeps_cell.cell_energy` on the lifted bond term)."""
    return cell_energy(a_site, b_site, lift_bond(h2, d), chi, iters=iters)


def thermal2d_site_expectation(a_site, b_site, op, chi, d=2, iters=100):
    """One-site thermal ``<op>`` at every cell position (2x2 tuple)."""
    return cell_site_expectations(a_site, b_site, lift_onsite(op, d), chi, iters=iters)
