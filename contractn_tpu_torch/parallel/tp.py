"""Tensor-parallel (bond-dimension) sharding for chain contraction.

Counterpart of ``contractn_tpu/parallel/tp.py``.  When the bond dimension is
too large for one device, site matrices shard column-wise over a ``tp`` mesh
axis and the product follows the column-parallel pattern: each step computes
the local column block ``Z_local = P @ M_local`` and an all-gather over
``tp`` reassembles the replicated running product.  Combined with ``dp``
(batch) and ``sp`` (chain segments, :mod:`.sharded`) this gives a 3-axis
``dp x sp x tp`` training step.
"""

import torch

from ..ops.stabilize import peinsum, pmatmul, stabilize_batched
from ..utils.device import real_dtype
from ._collectives import all_gather, psum
from .mesh import axis_group, shard
from .sharded import check_divisible, fold_segments
from .training import _sgd_step


def tp_segment_product(mats_local, tp_axis):
    """Stabilized product of column-sharded site matrices.

    Args:
        mats_local: ``(B, N_local, D, D/tp)`` this rank's column blocks of
            the per-sample site matrices.
        tp_axis: the ``ProcessGroup`` sharding the last (column) dimension.

    Returns:
        ``(product, log)`` with ``product`` the replicated ``(B, D, D)``
        running product and per-sample ``log`` scales ``(B,)``.
    """
    batch, _, bond, _ = mats_local.shape
    p = torch.eye(bond, dtype=mats_local.dtype, device=mats_local.device).expand(
        batch, bond, bond)
    log = torch.zeros((batch,), dtype=real_dtype(mats_local.dtype),
                      device=mats_local.device)
    # one unbind, not a select a site: a select's backward writes a zero
    # gradient of the whole stack for every site
    for m_local in mats_local.unbind(1):
        z_local = pmatmul(p, m_local)
        p = all_gather(z_local, tp_axis, dim=-1, tiled=True)
        p, log = stabilize_batched(p, log, 1)
    return p, log


def segment_mps_forward_3d(cores_local, left, right, x_local, sp_axis=None,
                           tp_axis=None):
    """Per-shard forward over a ``(dp, sp, tp)`` mesh.

    ``cores_local``: ``(N_local, d, D, D/tp)`` -- sites sharded over ``sp``,
    bond columns over ``tp``.  ``x_local``: ``(B_local, N_local, d)`` --
    batch over ``dp``, sites over ``sp``.  ``sp_axis`` and ``tp_axis`` are
    the axes' ``ProcessGroup``s.  Returns split-format ``(amp, log)`` of
    shape ``(B_local,)``, replicated over ``sp`` and ``tp``.
    """
    mats_local = peinsum("bnd,ndij->bnij", x_local, cores_local)
    seg, seg_log = tp_segment_product(mats_local, tp_axis)
    return fold_segments(seg, seg_log, left, right, sp_axis)


def make_tp_train_step(mesh, lr=1e-2, dp_axis="dp", sp_axis="sp", tp_axis="tp"):
    """SGD step ``train_step(mps, x, y) -> (new_mps, loss)`` over a 3-axis
    ``(dp, sp, tp)`` mesh.

    Layouts: cores ``(sp, -, -, tp)`` (sites x bond columns), inputs
    ``(dp, sp, -)``, targets ``(dp,)``.  Gradients flow through the tp
    all-gathers (adjoint: reduce-scatter) and the dp loss psum; every rank
    returns the same updated MPS.
    """
    dp, sp, tp = (axis_group(mesh, a) for a in (dp_axis, sp_axis, tp_axis))

    def loss(mps, x, y):
        amp, log = segment_mps_forward_3d(
            shard(shard(mps.cores, sp, 0), tp, 3), mps.left, mps.right,
            shard(shard(x, dp, 0), sp, 1), sp, tp)
        pred = torch.log(amp.abs() + 1e-30) + log
        total = psum(torch.sum((pred - shard(y, dp, 0)) ** 2), dp)
        return total / x.shape[0]

    step = _sgd_step(loss, lr, mesh)

    def train_step(mps, x, y):
        check_divisible(mesh, mps.cores, x, dp_axis, sp_axis, tp_axis)
        return step(mps, x, y)

    return train_step
