"""Mesh-sharded Born-machine training (data parallelism).

Counterpart of ``contractn_tpu/parallel/generative.py``.  The exact-NLL loss
of :mod:`~contractn_tpu_torch.models.born` is a mean over independent
per-sample amplitude scans plus one replicated ``log Z`` term, so data
parallelism is the natural mesh axis: each rank scans its own shard of the
batch, one psum folds the global mean into the loss, and the gradients
follow the convention of :mod:`._collectives`.  Parameters stay replicated
on every rank; the optimizer is :class:`~contractn_tpu_torch.ops.optim.Adam`
(optax's Adam, as the JAX package runs).
"""

import torch

from ..models.born import mps_log_amp2
from ..models.mps import MPS
from ..ops.optim import Adam
from ..ops.scan import mps_norm
from ..utils.device import as_tensor
from ._collectives import psum
from .mesh import axis_group, mesh_shape, shard
from .training import optimizer_step


def make_sharded_born_loss(mesh, dp_axis="dp"):
    """Exact NLL ``loss(mps, data)`` with the data sharded over ``dp`` and
    the parameters replicated; every rank passes the full data and gets the
    replicated loss."""
    dp = axis_group(mesh, dp_axis)

    def loss(mps, data):
        la = mps_log_amp2(mps, shard(data, dp, 0))
        total = psum(torch.sum(la), dp)
        m, ls = mps_norm(mps.cores, mps.left, mps.right)
        return -(total / data.shape[0] - (torch.log(torch.real(m)) + ls))

    return loss


def fit_born_machine_sharded(mps, data, mesh, steps=1000, lr=0.01, dp_axis="dp"):
    """Data-parallel exact-ML Born-machine training over a mesh.

    Full-batch per step (the exact gradient; minibatching stays on the
    single-device :func:`~contractn_tpu_torch.models.born.fit_born_machine`).
    Every rank passes the full ``(n_data, N)`` integer data, which must divide
    by the ``dp`` axis.  Returns ``(mps, losses)``: the trained MPS and the
    ``(steps,)`` per-step NLLs, each taken before its update, the same on
    every rank.
    """
    n_dp = mesh_shape(mesh)[dp_axis]
    device = mps.cores.device
    data = as_tensor(data, device, torch.int64)
    if data.shape[0] % n_dp:
        raise ValueError(f"data size {data.shape[0]} not divisible by dp={n_dp}")
    loss = make_sharded_born_loss(mesh, dp_axis)
    params = [t.detach().clone().requires_grad_(True)
              for t in (mps.cores, mps.left, mps.right)]
    opt = Adam(params, lr=float(lr))
    losses = [optimizer_step(opt, params, lambda p: loss(MPS(*p), data), mesh)
              for _ in range(int(steps))]
    return MPS(*(p.detach() for p in params)), torch.stack(losses)
