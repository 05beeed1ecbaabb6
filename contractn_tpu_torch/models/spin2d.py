"""2D spin systems on open rectangles: snake MPOs at minimal bond.

Counterpart of ``contractn_tpu/models/spin2d.py``.  Boustrophedon flattening
keeps in-row neighbours adjacent; vertical bonds span at most ``2 lx - 1``
chain sites with identity fill (spins commute, no strings).
:func:`~.fermions2d.string_mpo` gives one virtual channel per term, and the
exact-rank SVD compression (:func:`~.canonical.compress_mpo`, on the MPO's
device) collapses the parallel channels to the minimal automaton.
"""

import math

import numpy as np
import torch

from .canonical import compress_mpo
from .fermions2d import snake_index, string_mpo
from .mpo import MPO

_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
_SY_IM = np.array([[0.0, -1.0], [1.0, 0.0]])  # i * sigma_y (real)


def spin2d_mpo(lx, ly, bond_terms, field=None, d=2, compress=True,
               cutoff=1e-12, dtype=torch.float64, device=None):
    """MPO of ``H = sum_<ij> sum_k c_k O1_k(i) O2_k(j) + sum_i field`` on the
    open ``ly x lx`` rectangle (snake-flattened).

    Args:
        bond_terms: list of ``(coeff, op1, op2)`` — ``op1`` acts on the
            snake-earlier site of each nearest-neighbour pair.
        field: optional one-site term applied at every site.
        compress: SVD-compress to the minimal exact rank (the scale is
            folded back into the left boundary, so the result IS the
            Hamiltonian).
        device: where the MPO goes (default ``cuda``).
    """
    n = lx * ly
    eye = np.eye(d)
    pairs = []
    for r in range(ly):
        for c in range(lx):
            i = snake_index(r, c, lx)
            if c + 1 < lx:
                pairs.append((i, snake_index(r, c + 1, lx)))
            if r + 1 < ly:
                pairs.append((i, snake_index(r + 1, c, lx)))
    terms = []
    for (i, j) in pairs:
        a, b = (i, j) if i < j else (j, i)
        for coeff, op1, op2 in bond_terms:
            oa, ob = (op1, op2) if i < j else (op2, op1)
            terms.append((coeff, [(a, np.asarray(oa)), (b, np.asarray(ob))], eye))
    onsite = ([(i, np.asarray(field)) for i in range(n)]
              if field is not None else None)
    mpo = string_mpo(n, terms, onsite=onsite, d=d, dtype=dtype, device=device)
    if not compress:
        return mpo
    comp, log_norm, err = compress_mpo(mpo, cutoff=cutoff)
    if float(err) > 1e-10:
        raise ValueError(f"exact-rank compression lost weight ({err})")
    # compress_mpo Frobenius-normalizes; restore the physical scale
    return MPO(comp.cores, comp.left * math.exp(log_norm), comp.right)


def tfim2d_mpo(lx, ly, j=1.0, h=1.0, **kwargs):
    """2D transverse-field Ising ``-j sum ZZ - h sum X`` (open)."""
    return spin2d_mpo(lx, ly, [(-j, _SZ, _SZ)], field=-h * _SX, **kwargs)


def heisenberg2d_mpo(lx, ly, jx=1.0, jz=1.0, **kwargs):
    """2D XXZ ``sum (jx/4)(XX + YY) + (jz/4) ZZ`` (open; real form)."""
    terms = [(0.25 * jx, _SX, _SX),
             (-0.25 * jx, _SY_IM, _SY_IM),
             (0.25 * jz, _SZ, _SZ)]
    return spin2d_mpo(lx, ly, terms, **kwargs)
