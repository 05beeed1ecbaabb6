"""Mesh-sharded MPS contraction.

Counterpart of ``contractn_tpu/parallel/sharded.py``.  Two named axes:

* ``dp`` -- data parallel over the input batch; the only collective is the
  final gather of the amplitudes (and, in training, the loss reduction);
* ``sp`` -- sequence parallel over chain *sites*.  Each rank contracts its
  contiguous segment of the chain into a per-sample ``(D, D)`` segment
  product (a log-depth batched tree), the ``n_sp`` segment results are
  all-gathered (``n_sp * B_local * D^2`` values) and folded with the
  boundary vectors.  Per-sample log-scale registers ride along and add
  across segments, so split-format semantics survive sharding unchanged.

Entry points take full tensors on every rank and return full results on
every rank, as the JAX entry points take and return global arrays; the
per-shard body :func:`segment_mps_forward` takes and returns local shards.
"""

import torch

from ..ops.chain import tree_chain_product
from ..ops.stabilize import peinsum, stabilize_batched
from ._collectives import all_gather
from .mesh import axis_group, axis_size, mesh_shape, shard


def check_divisible(mesh, cores, x, dp_axis, sp_axis, tp_axis=None):
    """Fail early with actionable messages instead of deep collective errors."""
    shape = mesh_shape(mesh)
    sp = shape.get(sp_axis, 1)
    dp = shape.get(dp_axis, 1)
    if cores.shape[0] % sp:
        raise ValueError(
            f"n_sites={cores.shape[0]} must divide by the '{sp_axis}' mesh "
            f"axis (size {sp})"
        )
    if x.shape[0] % dp:
        raise ValueError(
            f"batch={x.shape[0]} must divide by the '{dp_axis}' mesh axis "
            f"(size {dp})"
        )
    if tp_axis is not None:
        tp = shape.get(tp_axis, 1)
        if cores.shape[-1] % tp:
            raise ValueError(
                f"bond_dim={cores.shape[-1]} must divide by the "
                f"'{tp_axis}' mesh axis (size {tp})"
            )


def fold_segments(seg, seg_log, left, right, sp_group):
    """Gather every rank's segment product over ``sp_group`` and fold the
    chain: ``left . seg_0 . seg_1 ... . right``, stabilized after each
    segment.  Returns split-format ``(amp, log)`` of shape ``(B,)``."""
    all_seg = all_gather(seg, sp_group)  # (n_sp, B, D, D)
    all_log = all_gather(seg_log, sp_group)  # (n_sp, B)
    batch = seg.shape[0]
    v = left.to(seg.dtype).expand(batch, left.shape[0])
    log = torch.sum(all_log, dim=0)
    for k in range(axis_size(sp_group)):  # n_sp is small: unrolled fold
        v = peinsum("bi,bij->bj", v, all_seg[k])
        v, log = stabilize_batched(v, log, 1)
    amp = peinsum("bi,i->b", v, right.to(seg.dtype))
    return stabilize_batched(amp, log, 1)


def segment_mps_forward(cores_seg, left, right, x_seg, axis_name=None):
    """Per-shard body: contract a site segment, combine across ``axis_name``.

    Args:
        cores_seg: ``(N_local, d, D, D)`` this rank's sites.
        left, right: ``(D,)`` boundary vectors (replicated).
        x_seg: ``(B_local, N_local, d)`` this rank's inputs.
        axis_name: the ``ProcessGroup`` of the mesh axis spanning the chain
            segments (``mesh.get_group("sp")``; ``None`` for one segment).

    Returns:
        ``(amp, log)`` of shape ``(B_local,)``: split-format amplitudes,
        replicated across ``axis_name``.
    """
    # site matrices for this segment: one einsum, (B, N_local, D, D)
    mats = peinsum("bnd,ndij->bnij", x_seg, cores_seg)
    seg, seg_log = tree_chain_product(mats)  # (B, D, D), (B,)
    return fold_segments(seg, seg_log, left, right, axis_name)


def sharded_mps_forward(mesh, cores, left, right, x, dp_axis="dp", sp_axis="sp"):
    """Batched MPS evaluation over a ``(dp, sp)`` mesh.

    ``cores`` shards over sites on ``sp``; ``x`` over batch on ``dp`` and
    sites on ``sp``.  Every rank passes the full tensors and receives the
    full split-format ``(amp, log)`` of shape ``(B,)``.
    """
    check_divisible(mesh, cores, x, dp_axis, sp_axis)
    dp, sp = axis_group(mesh, dp_axis), axis_group(mesh, sp_axis)
    x_local = shard(shard(x, dp, 0), sp, 1)
    amp, log = segment_mps_forward(shard(cores, sp, 0), left, right, x_local, sp)
    return all_gather(amp, dp, tiled=True), all_gather(log, dp, tiled=True)
