"""Two-dimensional spinless fermions by snake Jordan-Wigner + string MPOs.

Counterpart of ``contractn_tpu/models/fermions2d.py`` (the string-MPO route;
the parity swap-gate route, ``fswap``, belongs to the 2D slice).  An
``lx x ly`` open lattice is ordered along a boustrophedon ("snake") path;
under JW in that ordering in-row hopping is string-free while vertical bonds
carry a ``Z`` string across the intervening snake segment.
:func:`string_mpo` compiles any sum of such string operators into per-site
MPO cores exactly (one virtual channel per term, active over its span), on
the host, and the MPO goes to ``device``.

Sign conventions (as in the JAX package): with ``c_i = (prod_{j<i} Z_j)
S^-_i`` and ``m < n``,

    ``c^d_m c_n   = - S^+_m (prod_{m<j<n} Z_j) S^-_n``
    ``c^d_m c^d_n = - S^+_m (prod_{m<j<n} Z_j) S^+_n``

and ``n_i = (1 + Z_i) / 2`` (the first basis state is the occupied one).
"""

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .mpo import MPO

_SP = np.array([[0.0, 1.0], [0.0, 0.0]])   # S^+ (|0> = empty = spin up)
_SM = _SP.T
_Z = np.diag([1.0, -1.0])
_I2 = np.eye(2)


def _np_dtype(dtype):
    return torch.empty((), dtype=torch_dtype(dtype)).numpy().dtype


def string_mpo(n_sites, terms, onsite=None, d=2, dtype=torch.float64,
               device=None):
    """Exact MPO for ``H = sum_t coeff_t O_{i1} F ... F O_{i2} + onsite``.

    Args:
        n_sites: chain length (snake-flattened lattice size).
        terms: list of ``(coeff, [(site, op), ...], fill)`` — operators at
            strictly increasing sites, ``fill`` (e.g. the JW ``Z``) inserted
            on every site strictly between the first and last.  Single-site
            terms go in ``onsite`` instead.
        onsite: optional list of ``(site, matrix)`` one-site terms.
        device: where the MPO goes (default ``cuda``).

    One virtual channel per term (bond ``W = n_terms + 2``), the standard
    first-order finite-state MPO; exact for any term set.
    """
    n_terms = len(terms)
    wdim = n_terms + 2
    last = wdim - 1
    cores = np.zeros((n_sites, d, d, wdim, wdim), dtype=_np_dtype(dtype))
    for i in range(n_sites):
        cores[i, :, :, 0, 0] = np.eye(d)
        cores[i, :, :, last, last] = np.eye(d)
    if onsite:
        for site, mat in onsite:
            cores[site, :, :, 0, last] += np.asarray(mat)
    for t_idx, (coeff, ops, fill) in enumerate(terms):
        ch = 1 + t_idx
        sites = [s for s, _ in ops]
        if sorted(sites) != sites or len(set(sites)) != len(sites):
            raise ValueError(f"term {t_idx}: sites must strictly increase")
        if len(ops) < 2:
            raise ValueError(f"term {t_idx}: single-site terms go in `onsite`")
        first_s, last_s = sites[0], sites[-1]
        opd = dict(ops)
        for i in range(first_s, last_s + 1):
            if i == first_s:
                cores[i, :, :, 0, ch] = coeff * np.asarray(opd[i])
            elif i == last_s:
                cores[i, :, :, ch, last] = np.asarray(opd[i])
            elif i in opd:
                cores[i, :, :, ch, ch] = np.asarray(opd[i])
            else:
                cores[i, :, :, ch, ch] = np.asarray(fill)
    left = np.zeros((wdim,))
    left[0] = 1.0
    right = np.zeros((wdim,))
    right[last] = 1.0
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    return MPO(*(torch.from_numpy(a).to(device, dtype)
                 for a in (cores, left, right)))


def snake_index(r, c, lx):
    """Boustrophedon flattening: even rows left-to-right, odd reversed."""
    return r * lx + (c if r % 2 == 0 else lx - 1 - c)


def _neighbors_2d(r, c, lx, ly, periodic_x):
    """Forward neighbour pairs of ``(r, c)``, with the x-wrap bond on a
    cylinder (``lx >= 3``)."""
    out = [(r, c + 1), (r + 1, c)]
    if periodic_x and c == lx - 1:
        out[0] = (r, 0)
    elif not periodic_x and c + 1 >= lx:
        out = out[1:]
    return [(r2, c2) for (r2, c2) in out if r2 < ly and c2 < lx]


def fermion2d_mpo(lx, ly, t=1.0, mu=0.0, delta=0.0, dtype=torch.float64,
                  periodic_x=False, device=None):
    """Snake-JW MPO of 2D spinless fermions on the ``lx x ly`` lattice (open,
    or a cylinder with ``periodic_x=True``):

        ``H = -t sum_<ij> (c^d_i c_j + h.c.)
              + delta sum_<ij> (c^d_i c^d_j + h.c.)  - mu sum_i n_i``
    """
    if periodic_x and lx < 3:
        raise ValueError("periodic_x needs lx >= 3")
    terms = []
    onsite = []
    for r in range(ly):
        for c in range(lx):
            i = snake_index(r, c, lx)
            onsite.append((i, -mu * 0.5 * (_I2 + _Z)))
            for (r2, c2) in _neighbors_2d(r, c, lx, ly, periodic_x):
                j = snake_index(r2, c2, lx)
                m, n = (i, j) if i < j else (j, i)
                # c^d_m c_n + c^d_n c_m = -(S+ Z.. S- + S- Z.. S+)
                terms.append((t, [(m, _SP), (n, _SM)], _Z))
                terms.append((t, [(m, _SM), (n, _SP)], _Z))
                if delta != 0.0:
                    # c^d_i c^d_j in LATTICE order; reversing the pair flips
                    # the sign, and the JW string gives the global minus
                    sgn = 1.0 if m == i else -1.0
                    terms.append((-sgn * delta, [(m, _SP), (n, _SP)], _Z))
                    terms.append((-sgn * delta, [(m, _SM), (n, _SM)], _Z))
    return string_mpo(lx * ly, terms, onsite=onsite, dtype=dtype, device=device)


def free_fermion_energy_2d(lx, ly, t=1.0, mu=0.0, delta=0.0, periodic_x=False):
    """Exact ground energy of :func:`fermion2d_mpo`'s Hamiltonian (host
    float): filled negative modes when ``delta == 0``, else
    ``E0 = (1/2) sum_{lower half} eps + (1/2) tr h`` of the BdG spectrum."""
    n = lx * ly
    h = np.zeros((n, n))
    dmat = np.zeros((n, n))
    for r in range(ly):
        for c in range(lx):
            i = snake_index(r, c, lx)
            h[i, i] += -mu
            for (r2, c2) in _neighbors_2d(r, c, lx, ly, periodic_x):
                j = snake_index(r2, c2, lx)
                h[i, j] += -t
                h[j, i] += -t
                dmat[i, j] += delta
                dmat[j, i] -= delta
    if delta == 0.0:
        ev = np.linalg.eigvalsh(h)
        return float(ev[ev < 0].sum())
    big = np.block([[h, dmat], [-dmat, -h]])
    ev = np.linalg.eigvals(big).real
    ev.sort()
    return float(0.5 * ev[: n].sum() + 0.5 * np.trace(h))
