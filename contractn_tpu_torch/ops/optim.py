"""optax's Adam written out as a ``torch.optim.Optimizer``.

The JAX package optimizes with ``optax.adam(lr)``: bias-corrected first and
second moments, ``eps = 1e-8`` added outside the square root, and for a
complex parameter the second moment taken from ``|g|^2`` per complex
element.  ``torch.optim.Adam`` agrees on real tensors but forms the second
moment per real component of a complex one, whose trajectory differs.  This
is the one copy of the optax update in the port; every variational and
fermionic optimizer, the PEPS Born machine, VMC and the BP descent use it.

The gradient it consumes is torch's: for a real loss of complex parameters
``p.grad`` already is ``dE/dRe + i dE/dIm``, the descent direction the JAX
package gets by conjugating JAX's gradient, so nothing here conjugates.
"""

import torch


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps)`` on the parameters' ``.grad``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, {"lr": float(lr), "b1": b1, "b2": b2, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(g)
                    state["nu"] = torch.zeros_like(g.real if g.is_complex() else g)
                state["count"] += 1
                mu, nu = state["mu"], state["nu"]
                norm2 = (g * g.conj()).real if g.is_complex() else g * g
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * norm2)
                c1 = 1 - b1 ** state["count"]
                c2 = 1 - b2 ** state["count"]
                p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + eps))
        return loss


def descend(opt, params, grads):
    """One update of ``opt`` with the given gradients (set as ``.grad``)."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
