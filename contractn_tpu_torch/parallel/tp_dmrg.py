"""Tensor-parallel DMRG: Lanczos solves AND environments sharded over the
bond.

Counterpart of ``contractn_tpu/parallel/tp_dmrg.py``: ONE ground-state
search spread over a mesh axis, for bond dimensions whose working set
outgrows one device.  Per two-site solve at bond ``D`` on ``n_tp`` ranks:

* the two-site block ``theta (d, d, Dl, Dr)`` shards over its right bond
  (each rank holds ``(d, d, D, D/n_tp)``), and with it the whole Krylov
  basis (``iters + 1`` copies, what a solve stores most of);
* both environment stacks ``(n+1, D, W, D)`` are stored sharded over their
  ket bond (the ``env_ops`` seam of ``_dmrg_uniform_core``).  Each
  absorption contracts the local ket slice, completes the partial sum with
  one psum, and re-slices;
* the effective-Hamiltonian matvec contracts this rank's ``q`` slice, then
  one psum-scatter over the output bond ``k`` re-shards the result; the left
  environment is all-gathered once per solve, not per matvec;
* every Lanczos inner product is a local partial dot and a psum
  (:func:`~contractn_tpu_torch.ops.krylov.lanczos_basis` with ``axis_name``).

The sweep itself is the port's ``_dmrg_uniform_core``, through its
``solver`` and ``env_ops`` seams; the SVD splits run replicated on every
rank.  Results match :func:`~contractn_tpu_torch.models.ensemble.dmrg_uniform`
up to the reduction order of the collectives.
"""

import torch

from ..models.ensemble import _dmrg_uniform_core
from ..ops.krylov import lanczos_ground
from ..ops.stabilize import peinsum
from ._collectives import all_gather, psum, psum_scatter
from .mesh import axis_group, mesh_shape, shard


def heff_matvec_tp(L, w1, w2, r_local, theta_local, tp_axis):
    """Bond-sharded two-site Heff matvec: local slice -> local slice.

    ``theta_local (d, d, Dl, Dr_local)``, ``r_local (k, u, q_local)``; the
    contraction over the sharded ``q`` gives a partial sum with a full output
    bond ``k``, which one psum-scatter over ``tp_axis`` (a ``ProcessGroup``)
    both completes and re-shards.
    """
    t = peinsum("iwp,ABpq->iwABq", L, theta_local)
    t = peinsum("XAwv,iwABq->iXvBq", w1, t)
    t = peinsum("YBvu,iXvBq->iXYuq", w2, t)
    part = peinsum("kuq,iXYuq->XYik", r_local, t)
    return psum_scatter(part, tp_axis, dim=3)


def _tp_env_ops(tp_axis):
    """Environment seam: stacks stored sharded over their ket bond.

    One absorption = contract the local ket slice (a partial sum over the
    sharded index), complete it with one psum, slice the new ket bond
    locally.  The full ``(D, W, D)`` tensor exists only inside the update.
    """

    def boundary(vec, bond_dim, dtype):
        full = torch.zeros((bond_dim, vec.shape[0], bond_dim), dtype=dtype,
                           device=vec.device)
        full[0, :, 0] = vec.to(dtype)
        return shard(full, tp_axis, 2)

    def update_left(l_local, site, w):
        # L (i, w_ch, p_local) x site (b, p_local, q) -> partial over p
        t = peinsum("iwp,bpq->iwbq", l_local, shard(site, tp_axis, 1))
        t = peinsum("abwv,iwbq->iavq", w, t)
        part = peinsum("aij,iavq->jvq", site.conj(), t)
        return shard(psum(part, tp_axis), tp_axis, 2)

    def update_right(r_local, site, w):
        t = peinsum("juq,bpq->jubp", r_local, shard(site, tp_axis, 2))
        t = peinsum("abwv,jvbp->jwap", w, t)
        part = peinsum("aij,jwap->iwp", site.conj(), t)
        return shard(psum(part, tp_axis), tp_axis, 2)

    return boundary, update_left, update_right


def _tp_solver(tp_axis, iters):
    """The ``solver`` of ``_dmrg_uniform_core``'s seam.

    Receives the stored (ket-sharded) environments: ``R`` is already this
    rank's slice (used directly by the matvec); ``L`` is gathered once per
    solve (every matvec needs its full ket bond)."""

    def solver(l_local, w1, w2, r_local, theta0):
        L = all_gather(l_local, tp_axis, dim=2, tiled=True)
        energy, vec_l = lanczos_ground(
            lambda t: heff_matvec_tp(L, w1, w2, r_local, t, tp_axis),
            shard(theta0, tp_axis, 3), iters, axis_name=tp_axis)
        return energy, all_gather(vec_l, tp_axis, dim=3, tiled=True)

    return solver


def dmrg_uniform_tp(mesh, mpo, mps0, sweeps=4, lanczos_iters=40, tp_axis="tp"):
    """Uniform-shape two-site DMRG with tensor-parallel local solves.

    Same optimization as :func:`~contractn_tpu_torch.models.ensemble.
    dmrg_uniform`; the bond dimension must divide by the ``tp_axis`` size.
    Every rank passes the full MPO and MPS and returns the same
    ``(ground_mps, energy, energies)``.
    """
    if mps0.n_sites < 2:
        raise ValueError("dmrg_uniform_tp needs at least 2 sites")
    n_tp = mesh_shape(mesh)[tp_axis]
    bond = mps0.cores.shape[-1]
    if bond % n_tp:
        raise ValueError(
            f"bond_dim={bond} must divide by the '{tp_axis}' mesh axis "
            f"(size {n_tp})"
        )
    tp = axis_group(mesh, tp_axis)
    return _dmrg_uniform_core(mpo, mps0, int(sweeps), int(lanczos_iters),
                              solver=_tp_solver(tp, int(lanczos_iters)),
                              env_ops=_tp_env_ops(tp))
