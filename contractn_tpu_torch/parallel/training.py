"""Training steps for MPS models on one device.

Counterpart of the single-device half of ``contractn_tpu/parallel/
training.py``.  Training is ordinary autograd over the split-format forward:
the log-scale register keeps ``log |psi|`` finite for chains of any length.
The forward is :meth:`MPS.evaluate` with ``kernel="auto"``, which takes the
differentiable loops whenever autograd records (the hand chain kernel has no
backward), so a step launches no hand kernel.

Where the JAX package takes an optax ``GradientTransformation``, these take
an optimizer factory ``params -> torch.optim.Optimizer`` (for example
``lambda p: torch.optim.Adam(p, lr=1e-3)`` for ``optax.adam(1e-3)``).  The
mesh-sharded steps come with the port of the mesh layer; ``mesh=`` raises
until then.
"""

import torch

from ..models.mps import MPS
from ..utils.errors import TNError


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


def make_train_step(lr=1e-2):
    """Single-device SGD step ``train_step(mps, x, y) -> (new_mps, loss)``.

    Returns a new :class:`MPS` with ``p - lr * g`` on cores, left and right
    (the argument is left as it was) and the loss as a 0-d tensor.
    """

    def train_step(mps, x, y):
        params = _leaves(mps)
        loss = loss_fn(MPS(*params), x, y)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            new = MPS(*(p - lr * g for p, g in zip(params, grads)))
        return new, loss.detach()

    return train_step


def optimizer_step(opt, params, objective):
    """One step of ``opt`` on ``objective()``: zero the gradients, backward,
    update in place.  Returns the objective's value, detached."""
    opt.zero_grad(set_to_none=True)
    value = objective(params)
    value.backward()
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


def make_optax_train_step(optimizer, mesh=None, loss=None):
    """Train step driven by a torch optimizer.

    Args:
        optimizer: a factory ``params -> torch.optim.Optimizer``, the
            counterpart of the JAX package's optax ``GradientTransformation``
            (e.g. ``lambda p: torch.optim.Adam(p, lr=1e-3)``).
        mesh: not supported yet (raises :class:`TNError`): the sharded
            forward comes with the port of the mesh layer.
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
        raise TNError(
            "make_optax_train_step(mesh=...) needs the mesh layer, which is "
            "not ported yet; call it without mesh= on one device"
        )
    base = loss if loss is not None else loss_fn

    def init(mps):
        return optimizer([t.detach().clone().requires_grad_(True)
                          for t in (mps.cores, mps.left, mps.right)])

    def train_step(mps, opt_state, x, y):
        params = load_params(opt_state, (mps.cores, mps.left, mps.right))
        value = optimizer_step(opt_state, params,
                               lambda p: base(MPS(*p), x, y))
        new = MPS(*(p.detach().clone() for p in params))
        return new, opt_state, value

    return train_step, init
