"""Variational iPEPS: gradient optimization through the CTMRG fixed point.

Counterpart of ``contractn_tpu/models/variational.py``.  The true
variational energy (the CTMRG-contracted expectation value) is a
differentiable function of the iPEPS tensor, descended with Adam
(Liao-Liu-Wang-Xiang, PRX 9, 031041).  Each step warm-starts from the
previous environment, refreshes it with ``refresh_iters`` absorptions
without a tape (``torch.no_grad()``), then differentiates ``grad_iters``
further absorptions through the degeneracy-broadened decompositions of
:mod:`~..ops.linalg_ad` (``eigh_safe`` in the C4v CTMRG, ``svd_safe`` in the
cell CTMRG's projectors).

The JAX package runs the whole optimization as one jitted ``lax.scan``;
here it is a plain loop of device work whose energy trace is read to the
host once, at the end.

Departures, in form not in result:

* torch's gradient of a real loss of complex parameters already is
  ``dE/dRe + i dE/dIm``, the descent direction the JAX package gets by
  conjugating JAX's gradient; it is used as it is.
* ``optimizer=`` is a factory ``lambda params: optimizer`` returning a
  ``torch.optim.Optimizer`` (as in :mod:`..parallel.training`), not an
  optax transformation; the default is optax's Adam written out
  (:class:`~..ops.optim.Adam`), which for complex tensors takes the second
  moment from ``|g|^2`` as optax does.
"""

import torch

from ..ops.linalg_ad import eigh_safe, svd_safe
from ..ops.optim import Adam, descend
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .ctmrg import _converge, _step, ctmrg_environment
from .ipeps import (
    _pair_weight,
    _pair_weight_op,
    ipeps_energy,
    peps_double_layer,
    peps_double_layer_open,
    simple_update,
    su_absorb_weights,
    symmetrize_c4v,
)


def make_ipeps_loss(h2, chi, refresh_iters=10, grad_iters=10):
    """Differentiable energy ``(params, c, t) -> (E, (c', t'))``.

    ``params`` is an unconstrained ``(d, D, D, D, D)`` tensor (the C4v
    projection happens inside); ``(c, t)`` is the warm-start environment at
    width ``chi``, returned refreshed for the next call.
    """
    def loss(params, c, t):
        a_sym = symmetrize_c4v(params)
        d = a_sym.shape[0]
        op4 = as_tensor(h2, a_sym.device, a_sym.dtype).reshape(d, d, d, d)
        dl = peps_double_layer(a_sym)
        # converge without tape, then differentiate the last few steps
        with torch.no_grad():
            cc, tt = _converge(c, t, dl.detach(), chi, refresh_iters)
        for _ in range(grad_iters):
            cc, tt = _step(cc, tt, dl, chi, eigh_fn=eigh_safe)
        ao = peps_double_layer_open(a_sym)
        num = _pair_weight_op(cc, tt, ao, ao, op4)
        den = _pair_weight(cc, tt, dl, dl)
        return 2.0 * torch.real(num / den), (cc, tt)

    return loss


def _optimize(loss_of, params, carry, steps, opt):
    """``steps`` descent steps of ``loss_of(params, carry) -> (E, carry')``;
    returns the final parameters and carry and the device-side trace."""
    energies = []
    for _ in range(int(steps)):
        leaves = [p.requires_grad_(True) for p in params]
        e, carry = loss_of(leaves, carry)
        descend(opt, params, torch.autograd.grad(e, leaves))
        carry = tuple(_detach(x) for x in carry)
        energies.append(e.detach())
    params = [p.detach() for p in params]
    return params, carry, energies


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return type(tree)(_detach(x) for x in tree)


def _trace(energies):
    return [float(x) for x in torch.stack(energies).cpu()] if energies else []


def variational_ipeps(h2, bond_dim, chi, d=2, steps=200, lr=2e-3,
                      optimizer=None, refresh_iters=10, grad_iters=10,
                      init=None,
                      su_schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                      env_iters=150, dtype=torch.float64):
    """Gradient-optimized C4v iPEPS ground state of ``H = sum h2``.

    Args:
        h2: nearest-neighbor bond term ``(d^2, d^2)`` (swap-symmetric,
            rotation-invariant; a torch tensor keeps its device, numpy goes
            to ``cuda``).
        bond_dim: iPEPS virtual dimension D.
        chi: environment bond dimension (``>= D**2``).
        steps: optimization steps.
        lr / optimizer: Adam's learning rate, or a factory ``lambda params:
            torch.optim.Optimizer``.
        refresh_iters / grad_iters: untaped and differentiated absorptions
            per step.
        init: optional ``(d, D, D, D, D)`` start; default is the
            simple-update state.

    Returns:
        ``(a_site, energy, energies)``: the optimized C4v tensor, its fresh
        fully-converged CTMRG energy (a float) and the per-step energy trace.
    """
    dtype = torch_dtype(dtype)
    if dtype.is_complex:
        raise TypeError(
            "variational_ipeps measures through the C4v symmetric-corner "
            "CTMRG, which is real-only (see ctmrg_environment); for complex "
            "Hamiltonians use variational_ipeps_cell, whose biorthogonal "
            "projectors are complex-safe"
        )
    device = resolve_device(None, (h2,) + ((init,) if init is not None else ()))
    h2 = as_tensor(h2, device, dtype)
    if init is None:
        gamma, lam = simple_update(h2, bond_dim, d=d, schedule=su_schedule, dtype=dtype)
        init = su_absorb_weights(gamma, lam)
    params = symmetrize_c4v(as_tensor(init, device, dtype))
    params = params / params.abs().max()

    env = ctmrg_environment(peps_double_layer(params), chi, iters=env_iters)
    opt = (optimizer or (lambda ps: Adam(ps, lr=lr)))([params])
    loss = make_ipeps_loss(h2, chi, refresh_iters=refresh_iters, grad_iters=grad_iters)
    (params,), _, es = _optimize(lambda ps, ct: loss(ps[0], *ct), [params], env, steps, opt)
    a_site = symmetrize_c4v(params)
    e_final = float(torch.real(ipeps_energy(a_site, h2, chi, iters=env_iters)))
    return a_site, e_final, _trace(es)


# --------------------------------------------------------------------- #
# Checkerboard-cell variational optimization (staggered phases)
# --------------------------------------------------------------------- #


def make_cell_loss(h2, chi, refresh_iters=8, grad_iters=6):
    """Differentiable checkerboard energy ``(pa, pb, env) -> (E, env')``
    through the directional cell CTMRG (untaped refresh + ``svd_safe``
    differentiated tail absorptions)."""
    from .ctmrg_cell import _converge as _cc_converge
    from .ctmrg_cell import _iteration as _cc_iteration
    from .ipeps_cell import cell_energy_from_env, checkerboard_cell

    def loss(pa, pb, env):
        cell = checkerboard_cell(pa, pb)
        with torch.no_grad():
            cur = _cc_converge(_detach(cell), env, chi, refresh_iters)
        for _ in range(grad_iters):
            cur = _cc_iteration(cell, cur, chi, svd_fn=svd_safe)
        return torch.real(cell_energy_from_env(pa, pb, h2, cell, cur)), cur

    return loss


def variational_ipeps_cell(h2, bond_dim, chi, d=2, steps=150, lr=2e-3,
                           optimizer=None, refresh_iters=8, grad_iters=6,
                           init=None,
                           su_schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                           env_iters=120, dtype=torch.float64):
    """Gradient-optimized checkerboard iPEPS (two-sublattice cell).

    Two unconstrained tensors ``(A, B)``, energies and gradients through the
    directional (Corboz) cell CTMRG with the degeneracy-broadened SVD
    adjoint in the projectors; the default start is the two-site-cell
    simple update.  Returns ``(a_site, b_site, energy, energies)`` with
    ``energy`` the fresh fully-converged measurement (a float).
    """
    from .ctmrg_cell import ctmrg_cell
    from .ipeps_cell import (cell_energy, checkerboard_cell, simple_update_cell,
                             su_cell_absorb)

    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,) + (tuple(init) if init is not None else ()))
    h2 = as_tensor(h2, device)
    if init is None:
        ga, gb, lams = simple_update_cell(h2, bond_dim, d=d, schedule=su_schedule,
                                          dtype=dtype)
        init = su_cell_absorb(ga, gb, lams)
    pa = as_tensor(init[0], device, dtype)
    pb = as_tensor(init[1], device, dtype)
    scale = torch.maximum(pa.abs().max(), pb.abs().max())
    pa, pb = pa / scale, pb / scale

    env = ctmrg_cell(checkerboard_cell(pa, pb), chi, iters=env_iters)
    opt = (optimizer or (lambda ps: Adam(ps, lr=lr)))([pa, pb])
    loss = make_cell_loss(h2, chi, refresh_iters=refresh_iters, grad_iters=grad_iters)
    (pa, pb), _, es = _optimize(lambda ps, e: loss(ps[0], ps[1], e), [pa, pb], env,
                                steps, opt)
    e_final = float(torch.real(cell_energy(pa, pb, h2, chi, iters=env_iters)))
    return pa, pb, e_final, _trace(es)
