"""Pipeline parallelism over MPS chain stages.

Counterpart of ``contractn_tpu/parallel/pipeline.py``.  The chain's ``N``
sites are split into ``S`` contiguous *stages*, one a rank along a ``pp``
mesh axis, and the batch streams through them in microbatches: the GPipe
schedule mapped onto tensor-network contraction.  At pipeline step ``t``,
stage ``s`` contracts its sites for microbatch ``t - s`` and hands the
``(B_micro, D)`` boundary carry and its split-format log register to stage
``s + 1`` by :func:`._collectives.ppermute`.  After ``n_micro + S - 1``
steps every microbatch has crossed the whole chain; the final stage's
results are replicated by a psum.

Each stage runs the per-site ``(D, d*D)`` GEMM and rescale of
:func:`~contractn_tpu_torch.ops.scan.mps_evaluate` in its order, so the
split components match the single-device evaluation, not only their
product.

The rank and the step are Python ints, but the schedule keeps the JAX
package's masks as tensors: every stage computes at every step and the
inactive results are masked out.  That keeps the autograd graph, and with
it the sequence of point-to-point exchanges in backward, the same on every
rank (:mod:`._collectives`); with Python branches a stage that skipped a
step would also skip its half of that step's exchange in backward.
"""

import torch

from ..ops.scan import _stab_step
from ..ops.stabilize import peinsum, pmatmul
from ..utils.device import real_dtype
from ._collectives import ppermute, psum
from .mesh import axis_group, axis_index, axis_size, mesh_shape, shard
from .training import _sgd_step


def _check_pipeline_shapes(mesh, cores, x, n_micro, pp_axis):
    stages = mesh_shape(mesh).get(pp_axis, 1)
    if cores.shape[0] % stages:
        raise ValueError(
            f"n_sites={cores.shape[0]} must divide by the '{pp_axis}' mesh "
            f"axis (size {stages})"
        )
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch={x.shape[0]} must divide by n_micro={n_micro}"
        )


def _stage_body(cores_loc, left, right, x_loc, n_micro, axis):
    """Per-stage program: stream ``n_micro`` microbatches through the pipe.

    ``cores_loc (N_local, d, D, D)`` is this stage's site segment,
    ``x_loc (B, N_local, d)`` its site slice of the full batch and ``axis``
    the ``pp`` group.  Returns split-format ``(amp, log)`` of shape
    ``(B,)``, replicated across the group.
    """
    stages, sid = axis_size(axis), axis_index(axis)
    n_loc, phys_dim, bond, _ = cores_loc.shape
    batch = x_loc.shape[0]
    b_micro = batch // n_micro
    dtype, device = cores_loc.dtype, cores_loc.device
    rdt = real_dtype(dtype)

    xm = x_loc.reshape(n_micro, b_micro, n_loc, phys_dim)
    # per-site GEMM layout (D, d*D), as mps_evaluate
    # unbound once: a select's backward writes a zero gradient of the whole
    # stack for every site it is taken at
    mats = cores_loc.permute(0, 2, 1, 3).reshape(n_loc, bond, phys_dim * bond).unbind(0)
    left_b = left.to(dtype).expand(b_micro, bond)
    right_c = right.to(dtype)

    def segment(v, log, x_seg):
        for mat, xn in zip(mats, x_seg.unbind(1)):
            u = pmatmul(v, mat).reshape(b_micro, phys_dim, bond)
            v = peinsum("bd,bdk->bk", xn, u)
            v, log = _stab_step(v, log, 1)
        return v, log

    def flag(b):
        return torch.tensor(bool(b), device=device)

    def pack(vec, log):  # one buffer a hand-off: a single exchange a step
        return torch.cat([vec, log.to(dtype)[:, None]], dim=1)

    pairs = [(i, i + 1) for i in range(stages - 1)]
    is_first, is_last = flag(sid == 0), flag(sid == stages - 1)
    recv = torch.zeros((b_micro, bond + 1), dtype=dtype, device=device)
    out = [torch.zeros((2, b_micro), dtype=dtype, device=device)] * n_micro
    steps = n_micro + stages - 1
    for t in range(steps):
        mb = t - sid
        active = flag(0 <= mb < n_micro)
        mb_c = min(max(mb, 0), n_micro - 1)
        v_recv, log_recv = recv[:, :bond], recv[:, bond].real
        v_in = torch.where(is_first, left_b, v_recv)
        log_in = torch.where(is_first, torch.zeros_like(log_recv), log_recv)
        v_out, log_out = segment(v_in, log_in, xm[mb_c])
        v_out = torch.where(active, v_out, torch.zeros_like(v_out))
        log_out = torch.where(active, log_out, torch.zeros_like(log_out))

        # the final stage closes the chain and records the microbatch
        amp = peinsum("bi,i->b", v_out, right_c)
        amp, amp_log = _stab_step(amp, log_out, 1)
        out[mb_c] = torch.where(active & is_last, torch.stack([amp, amp_log.to(dtype)]),
                                out[mb_c])
        if t < steps - 1:  # the last hand-off would feed no step
            recv = ppermute(pack(v_out, log_out), axis, pairs)
    # only the final stage holds nonzero results; the psum replicates them
    res = psum(torch.stack(out, dim=1), axis)  # (2, n_micro, b_micro)
    return res[0].reshape(batch), res[1].real.reshape(batch)


def pipeline_mps_forward(mesh, cores, left, right, x, n_micro=None, pp_axis="pp"):
    """Batched MPS evaluation pipelined over chain stages.

    Args:
        mesh: mesh with a ``pp_axis`` of size ``S`` (other axes may exist;
            cores and x are replicated over them).
        cores: ``(N, d, D, D)`` site tensors; ``N % S == 0``.
        left, right: ``(D,)`` boundary vectors.
        x: ``(B, N, d)`` batch of inputs; ``B % n_micro == 0``.
        n_micro: microbatch count (default ``S``).

    Returns:
        Split-format ``(amp, log)`` of shape ``(B,)`` each, the same on every
        rank.  Differentiable: cotangents stream back through the hand-offs
        in reverse schedule order; gradients of a replicated loss follow
        :func:`._collectives.mesh_grads`.
    """
    stages = mesh_shape(mesh)[pp_axis]
    if n_micro is None:
        n_micro = stages
    _check_pipeline_shapes(mesh, cores, x, n_micro, pp_axis)
    pp = axis_group(mesh, pp_axis)
    return _stage_body(shard(cores, pp, 0), left, right, shard(x, pp, 1), n_micro, pp)


def make_pipeline_train_step(mesh, lr=1e-2, pp_axis="pp", n_micro=None):
    """SGD step ``train_step(mps, x, y) -> (new_mps, loss)`` with the forward
    pipelined over chain stages.

    Same log-MSE loss as :func:`~.training.make_train_step`; the backward
    streams cotangents through the hand-offs in reverse schedule order, so
    gradients -- and the updates -- match the single-device step.
    """

    def full_loss(mps, x, y):
        amp, log = pipeline_mps_forward(mesh, mps.cores, mps.left, mps.right, x,
                                        n_micro=n_micro, pp_axis=pp_axis)
        pred = torch.log(amp.abs() + 1e-30) + log
        return torch.mean((pred - y) ** 2)

    return _sgd_step(full_loss, lr, mesh)
