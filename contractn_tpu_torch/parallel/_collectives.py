"""The collectives of ``jax.lax`` on ``torch.distributed``, with autograd.

The JAX package's per-shard bodies call ``all_gather``, ``psum``,
``psum_scatter``, ``ppermute`` and ``pmax`` over a mesh axis, and
``jax.grad`` differentiates through them by their transposes.  These are
the port's copies: each takes the ``ProcessGroup`` of one mesh axis (or
``None``, where every one is the identity) and is a
``torch.autograd.Function`` whose backward is the exact adjoint of its
forward:

* :func:`all_gather` (tiled or stacked) -- backward: reduce-scatter;
* :func:`psum` (all-reduce, sum) -- backward: all-reduce of the cotangents;
* :func:`psum_scatter` (reduce-scatter) -- backward: all-gather;
* :func:`ppermute` (point-to-point pairs) -- backward: the inverse pairs;
* :func:`pmax` (all-reduce, max) -- no gradient.

All of them go through ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``batch_isend_irecv``, so gloo on the CPU and NCCL on the
GPU run the same code; complex tensors travel as ``torch.view_as_real``.

**The gradient convention.**  Every rank runs the same program, so a value
every rank computes (a replicated loss) exists ``R`` times, ``R`` the number
of ranks of the mesh.  With exact adjoints, each rank's backward of its own
copy counts that copy once: summing every rank's parameter gradients then
counts the loss ``R`` times.  So, as JAX's ``shard_map`` transpose divides
the cotangent of a replicated output by the number of its replicas, each
rank differentiates ``loss / R``, and the gradient of a parameter that
enters every rank whole (the entry points take full tensors on every rank
and slice their shards from them) is the sum of the ranks' gradients over
the mesh: :func:`mesh_grads`.  The result equals the gradient of the
single-device loss.

Every rank must run the same sequence of collectives in backward too, so a
differentiated body must build the same autograd graph on every rank: the
rank decides *values* (which block, which mask), never whether a collective
or a differentiable path exists.
"""

import warnings

import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size


def _wire(t):
    """A contiguous real view of ``t`` for the backend."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _call(fn, *args, **kwargs):
    # newer torch warns that the *_tensor collectives have new names; the old
    # ones exist in every version the port runs on
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _gather(x, group, dim):
    n = axis_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call(dist.all_gather_into_tensor, _wire(out), _wire(xm), group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, group, dim):
    n = axis_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"axis of size {xm.shape[0]} does not split over {n} ranks")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call(dist.reduce_scatter_tensor, _wire(out), _wire(xm), op=dist.ReduceOp.SUM,
          group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_wire(out), op=op, group=group)
    return out


def _exchange(x, group, pairs):
    """Send ``x`` along every pair ``(src, dst)`` of group ranks that starts
    here, receive along the one that ends here (zeros where none does)."""
    me = axis_index(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, _wire(x), dist.get_global_rank(group, dst),
                                  group=group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, _wire(out), dist.get_global_rank(group, src),
                                  group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _exchange(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, [(d, s) for s, d in ctx.pairs]), None, None


def all_gather(x, group, dim=0, tiled=False):
    """``jax.lax.all_gather``: every rank's ``x``, in rank order, stacked on a
    new axis ``dim`` or (``tiled``) concatenated along ``dim``."""
    if group is None:
        return x if tiled else x.unsqueeze(dim)
    if not tiled:
        dim = dim % (x.ndim + 1)
        return _AllGather.apply(x.unsqueeze(dim), group, dim)
    return _AllGather.apply(x, group, dim % x.ndim)


def psum(x, group):
    """``jax.lax.psum``: the sum of every rank's ``x``, on every rank."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def psum_scatter(x, group, dim=0):
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over ranks, split
    along ``dim``; this rank keeps its block."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim % x.ndim)


def ppermute(x, group, pairs):
    """``jax.lax.ppermute``: ``pairs`` of group ranks ``(src, dst)``; a rank
    that is no pair's destination receives zeros."""
    if group is None:
        return torch.zeros_like(x)
    return _PPermute.apply(x, group, tuple(pairs))


def pmax(x, group):
    """``jax.lax.pmax`` over real values (no gradient)."""
    if group is None:
        return x.detach()
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def mesh_sum(tensors, mesh):
    """Sum ``tensors`` over every rank of ``mesh`` (one all-reduce a mesh
    axis, the tensors of one dtype sent as one buffer)."""
    tensors = list(tensors)
    if mesh is None or not tensors:
        return tensors
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for name in mesh.mesh_dim_names:
            flat = _all_reduce(flat, mesh.get_group(name))
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].reshape(tensors[i].shape)
            start += n
    return out


def mesh_grads(value, params, mesh):
    """Gradients of a replicated ``value`` with respect to replicated
    ``params``, as the single-device program would give them (see the module
    docstring): each rank differentiates ``value / R`` and the results are
    summed over the mesh."""
    grads = torch.autograd.grad(value / mesh.size(), params)
    return mesh_sum(grads, mesh)
