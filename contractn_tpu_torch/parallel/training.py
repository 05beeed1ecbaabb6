"""Training steps for MPS models, on one device and over a mesh.

Counterpart of ``contractn_tpu/parallel/training.py``.  Training is ordinary
autograd over the split-format forward: the log-scale register keeps
``log |psi|`` finite for chains of any length.  On one device the forward is
:meth:`MPS.evaluate` with ``kernel="auto"``, which takes the differentiable
loops whenever autograd records (the hand chain kernel has no backward), so
a step launches no hand kernel.  Over a ``(dp, sp)`` mesh the forward is
:func:`~.sharded.segment_mps_forward` on every rank's shard, and the
gradients follow the convention of :mod:`._collectives` (each rank
differentiates ``loss / R``; the ranks' gradients are summed), so every rank
takes the single-device step.

Where the JAX package takes an optax ``GradientTransformation``, these take
an optimizer factory ``params -> torch.optim.Optimizer`` (for example
``lambda p: ops.optim.Adam(p, lr=1e-3)`` for ``optax.adam(1e-3)``).
"""

import torch

from ..models.mps import MPS
from ._collectives import mesh_grads, psum
from .mesh import axis_group, shard
from .sharded import check_divisible, segment_mps_forward


def loss_fn(mps, x, y):
    """Mean squared error on ``log |psi(x)|`` against targets ``y``.

    Fuses two sites per step when the chain length allows, as the JAX
    package does (its choice, measured on a TPU; it carries no speed claim
    here).
    """
    k = 2 if mps.n_sites % 2 == 0 else 1
    amp, log = mps.evaluate(x, split_format=True, sites_per_step=k)
    pred = torch.log(amp.abs() + 1e-30) + log
    return torch.mean((pred - y) ** 2)


def sgd_init(lr=1e-2):
    """Minimal SGD state, as in the JAX package."""
    return {"lr": lr}


def _leaves(mps):
    """The MPS's tensors as fresh leaves that record gradients."""
    return [t.detach().requires_grad_(True) for t in (mps.cores, mps.left, mps.right)]


def _sgd_step(loss, lr, mesh=None):
    """``train_step(mps, x, y)``: ``p - lr * g`` on cores, left and right of
    a new :class:`MPS` (the argument is left as it was), with the gradients
    of ``loss(mps, x, y)`` reduced over ``mesh`` where one is given."""

    def train_step(mps, x, y):
        params = _leaves(mps)
        value = loss(MPS(*params), x, y)
        grads = (torch.autograd.grad(value, params) if mesh is None
                 else mesh_grads(value, params, mesh))
        with torch.no_grad():
            new = MPS(*(p - lr * g for p, g in zip(params, grads)))
        return new, value.detach()

    return train_step


def make_train_step(lr=1e-2):
    """Single-device SGD step ``train_step(mps, x, y) -> (new_mps, loss)``.

    Returns a new :class:`MPS` with ``p - lr * g`` on cores, left and right
    (the argument is left as it was) and the loss as a 0-d tensor.
    """
    return _sgd_step(loss_fn, lr)


def optimizer_step(opt, params, objective, mesh=None):
    """One step of ``opt`` on ``objective()``: zero the gradients, backward,
    update in place.  Returns the objective's value, detached.  With a
    ``mesh`` the objective is a replicated value and its gradients are
    reduced over the mesh (:func:`._collectives.mesh_grads`)."""
    opt.zero_grad(set_to_none=True)
    value = objective(params)
    if mesh is None:
        value.backward()
    else:
        for p, g in zip(params, mesh_grads(value, params, mesh)):
            p.grad = g
    opt.step()
    return value.detach()


def load_params(opt, tensors):
    """Copy ``tensors`` into the optimizer's parameters (skipping those that
    are already them) and return the parameters."""
    params = opt.param_groups[0]["params"]
    with torch.no_grad():
        for p, t in zip(params, tensors):
            if p is not t:
                p.copy_(t)
    return params


def make_optax_train_step(optimizer, mesh=None, dp_axis="dp", sp_axis="sp",
                          loss=None):
    """Train step driven by a torch optimizer.

    Args:
        optimizer: a factory ``params -> torch.optim.Optimizer``, the
            counterpart of the JAX package's optax ``GradientTransformation``
            (e.g. ``lambda p: ops.optim.Adam(p, lr=1e-3)``).
        mesh: optional ``(dp, sp)`` mesh -- with one, the loss runs through
            the same sharded forward as :func:`make_sharded_train_step`.
        loss: optional ``loss(mps, x, y)`` override (default
            :func:`loss_fn`, MSE on ``log |psi|``).

    Returns:
        ``(train_step, opt_state0_fn)``: ``opt_state0_fn(mps)`` builds the
        optimizer over copies of the MPS's tensors, and
        ``train_step(mps, opt_state, x, y) -> (mps, opt_state, loss)``
        loads ``mps`` into it, takes one step and returns the updated MPS
        (new tensors; the argument is left as it was).
    """
    if mesh is not None:
        if loss is not None:
            raise ValueError(
                "custom loss is not supported with mesh= (the sharded "
                "forward hardcodes the log-MSE loss); build your own "
                "sharded loss with the collectives of parallel._collectives "
                "instead"
            )
        base = _sharded_loss_fn(mesh, dp_axis, sp_axis)
    else:
        base = loss if loss is not None else loss_fn

    def init(mps):
        return optimizer([t.detach().clone().requires_grad_(True)
                          for t in (mps.cores, mps.left, mps.right)])

    def train_step(mps, opt_state, x, y):
        if mesh is not None:
            check_divisible(mesh, mps.cores, x, dp_axis, sp_axis)
        params = load_params(opt_state, (mps.cores, mps.left, mps.right))
        value = optimizer_step(opt_state, params,
                               lambda p: base(MPS(*p), x, y), mesh)
        new = MPS(*(p.detach().clone() for p in params))
        return new, opt_state, value

    return train_step, init


def _sharded_loss_fn(mesh, dp_axis, sp_axis):
    """The log-MSE loss over a ``(dp, sp)`` mesh: full tensors in, this
    rank's shards through :func:`segment_mps_forward`, the global mean out
    (replicated on every rank)."""
    dp, sp = axis_group(mesh, dp_axis), axis_group(mesh, sp_axis)

    def full_loss(mps, x, y):
        amp, log = segment_mps_forward(shard(mps.cores, sp, 0), mps.left,
                                       mps.right, shard(shard(x, dp, 0), sp, 1), sp)
        pred = torch.log(amp.abs() + 1e-30) + log
        total = psum(torch.sum((pred - shard(y, dp, 0)) ** 2), dp)
        return total / x.shape[0]

    return full_loss


def make_sharded_train_step(mesh, lr=1e-2, dp_axis="dp", sp_axis="sp"):
    """SGD step ``train_step(mps, x, y) -> (new_mps, loss)`` over a
    ``(dp, sp)`` mesh.

    Every rank passes the full MPS and data and gets the same updated MPS.
    The loss -- sharded forward, MSE, global mean -- differentiates through
    the collectives (the all-gather's adjoint is a reduce-scatter, the
    psum's an all-reduce), and the ranks' gradients are summed over the mesh
    (:mod:`._collectives`), so the step equals the single-device one: cores
    gradients assembled from their ``sp`` segments, the ``dp`` reduction
    folded in by the loss psum.
    """
    step = _sgd_step(_sharded_loss_fn(mesh, dp_axis, sp_axis), lr, mesh)

    def train_step(mps, x, y):
        check_divisible(mesh, mps.cores, x, dp_axis, sp_axis)
        return step(mps, x, y)

    return train_step
