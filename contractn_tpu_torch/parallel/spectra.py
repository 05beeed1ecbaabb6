"""Mesh-sharded dynamical spectra: frequency grids over the ranks.

Counterpart of ``contractn_tpu/parallel/spectra.py``.  The correction-vector
frequency grid is embarrassingly parallel and tiny in its batch data: the
operator's cores are frequency-independent and only a ``(n_w, W)``
boundary-vector array varies (see ``models/dynamical.py``).  So the grid
shards over a ``dp`` mesh axis: each rank solves ``n_w / n_dev`` resolvent
systems with the port's batched solve, overlap and sandwich, with no
collective until the final gather of the two scalars a frequency.  The
per-frequency body is that of ``cv_greens_function_batched``, so results
match it at machine precision.
"""

import numpy as np

from ..models.dynamical import _cv_batched_terms
from ._collectives import all_gather
from .mesh import axis_group, axis_index, mesh_shape

__all__ = ["cv_greens_function_sharded", "cv_spectral_function_sharded"]


def cv_greens_function_sharded(mesh, h_mpo, ground, e0, op, site, omegas, eta,
                               axis="dp", max_bond=None, sweeps=6, cg_iters=64):
    """``cv_greens_function_batched`` with the frequency axis sharded over
    ``mesh[axis]``; every rank returns the whole complex numpy grid.
    ``len(omegas)`` must divide by the axis size."""
    omegas = np.atleast_1d(np.asarray(omegas, float))
    n_dev = mesh_shape(mesh)[axis]
    if omegas.shape[0] % n_dev:
        raise ValueError(
            f"n_omegas={omegas.shape[0]} must divide by the "
            f"'{axis}' mesh axis (size {n_dev})"
        )
    group = axis_group(mesh, axis)
    chunk = omegas.shape[0] // n_dev
    members = slice(axis_index(group) * chunk, (axis_index(group) + 1) * chunk)
    bky, by, norm = _cv_batched_terms(h_mpo, ground, e0, op, site, omegas, eta,
                                      max_bond, sweeps, cg_iters, members)
    bky, by = (all_gather(t, group, tiled=True).cpu().numpy() for t in (bky, by))
    return (bky - 1j * eta * by) / norm


def cv_spectral_function_sharded(mesh, h_mpo, ground, e0, op, site, omegas, eta,
                                 **kwargs):
    """``-(1/pi) Im G`` with the grid sharded over the mesh."""
    g = cv_greens_function_sharded(mesh, h_mpo, ground, e0, op, site, omegas, eta,
                                   **kwargs)
    return -g.imag / np.pi
