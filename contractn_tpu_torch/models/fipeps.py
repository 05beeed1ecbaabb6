"""Fermionic infinite PEPS: the fswap sign rule fermionized into the double
layer, contracted by the directional cell CTMRG.

Counterpart of ``contractn_tpu/models/fipeps.py``.  For the norm network of
a fermionic PEPS, parity-even site tensors tie ket and bra by a Gauss law,
and the non-local string of :mod:`.fswap` collapses to a site-local rule in
the eight leg parities ``(u, l, d, r, U, L, D, R)`` (capitals = bra):

    norm exponent per site:  ``u + uU + ld + lU + dU + dL + UL + UD``

With that factor baked into the double tensor ``E`` the fermionic norm
network is a plain bosonic one, so the thermodynamic limit rides
:func:`~.ctmrg_cell.ctmrg_cell` unchanged.  Nearest-neighbor two-fermion
terms (parity-odd endpoint operators) take one extra local factor each:
horizontal pair ``d + U`` at the right site; vertical pair ``d + R`` at the
top site and ``l + d`` at the bottom one.  Vertical bonds are measured by
rotating the (bosonic) E-network a quarter turn.

The signs are constant ``(+-1)`` arrays built on the host and moved to the
tensors' device; everything downstream is torch.  The gradient loop is a
plain loop of device work (the JAX package's jitted ``lax.scan``) with the
parity-masked update of optax's Adam written out (:mod:`..ops.optim`) on
torch's gradient, which is not conjugated (see :mod:`.variational`).

Departures: :func:`parity_mask_site` takes ``device=`` (default ``cuda``);
:func:`fipeps_ground_state` draws its start on the host from ``seed`` as the
JAX package does and takes ``device=``.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .ctmrg_cell import ctmrg_cell, pair_weight_h, rotate, site_expectation
from .fswap import absorb_site_signs

_LEGS = ("u", "l", "d", "r", "U", "L", "D", "R")

# the fitted sign rules; each entry is one leg name or a two-leg product
NORM_RULE = ("u", "uU", "ld", "lU", "dU", "dL", "UL", "UD")
H_RIGHT_EXTRA = ("d", "U")
V_TOP_EXTRA = ("d", "R")
V_BOT_EXTRA = ("l", "d")


def _sign_array(pars, terms):
    """Constant ``(-1)**exponent`` (host numpy) over merged double legs
    ``(u2, l2, d2, r2)`` for the given rule terms; ``pars = (pu, pl, pd,
    pr)`` parity vectors shared by ket and bra."""
    vecs = [np.asarray(p, np.int64) for p in pars]
    legs = {n: v for n, v in zip(_LEGS[:4], vecs)}
    legs.update({n: v for n, v in zip(_LEGS[4:], vecs)})
    order = ("u", "U", "l", "L", "d", "D", "r", "R")
    grids = np.meshgrid(*[legs[n] for n in order], indexing="ij")
    at = {n: g for n, g in zip(order, grids)}
    e = np.zeros_like(grids[0])
    for t in terms:
        e = e + (at[t] if len(t) == 1 else at[t[0]] * at[t[1]])
    sgn = (-1.0) ** (e % 2)
    du, dl, dd, dr = (len(v) for v in vecs)
    return sgn.reshape(du * du, dl * dl, dd * dd, dr * dr)


def _signs(pars, extra, like):
    return torch.from_numpy(_sign_array(pars, tuple(NORM_RULE) + tuple(extra))).to(
        like.device, like.real.dtype)


def fdouble(a, pars, op=None, extra=()):
    """Fermionized double tensor ``E[(uU), (lL), (dD), (rR)]``.

    Args:
        a: site tensor ``(d, Du, Dl, Dd, Dr)``, parity-even w.r.t. ``pars``
            and the physical parity (a torch tensor keeps its device; numpy
            goes to ``cuda``).
        pars: ``(pu, pl, pd, pr)`` leg parity vectors.
        op: optional one-site operator between the layers.
        extra: additional sign-rule terms (``H_RIGHT_EXTRA`` etc.).

    Differentiable in ``a`` (the signs are constants).
    """
    a = as_tensor(a, resolve_device(None, (a,)))
    aa = absorb_site_signs(a, pars)
    if op is None:
        e = peinsum("nuldr,nULDR->uUlLdDrR", aa, aa.conj())
    else:
        e = peinsum("nuldr,nm,mULDR->uUlLdDrR", aa, as_tensor(op, a.device, a.dtype),
                    aa.conj())
    s = a.shape
    e = e.reshape(s[1] ** 2, s[2] ** 2, s[3] ** 2, s[4] ** 2)
    return e * _signs(pars, extra, e)


def fdouble_open(a, pars, extra=()):
    """Fermionized double tensor with OPEN physical legs, ``E[p_ket, p_bra,
    (uU), (lL), (dD), (rR)]``: contracting the physical pair against an
    operator reproduces :func:`fdouble` exactly, so a two-site patch takes a
    summed two-site operator ``op4`` in one contraction."""
    a = as_tensor(a, resolve_device(None, (a,)))
    aa = absorb_site_signs(a, pars)
    e = peinsum("nuldr,mULDR->nmuUlLdDrR", aa, aa.conj())
    s = a.shape
    e = e.reshape(s[0], s[0], s[1] ** 2, s[2] ** 2, s[3] ** 2, s[4] ** 2)
    return e * _signs(pars, extra, e)[None, None]


def parity_mask_site(pars, d=2, phys_par=None, device=None):
    """0/1 mask of the parity-even block of a ``(d, Du, Dl, Dd, Dr)`` site
    tensor (the fermionic manifold projector), float64 on ``device``
    (default ``cuda``).  ``phys_par`` overrides the physical parity vector
    (default ``arange(d) % 2``; spinful d = 4 passes ``(0, 1, 1, 0)``)."""
    pu, pl, pd, pr = [np.asarray(p, np.int64) for p in pars]
    pphys = np.arange(d) % 2 if phys_par is None else np.asarray(phys_par, np.int64)
    tot = (pphys[:, None, None, None, None]
           + pu[None, :, None, None, None]
           + pl[None, None, :, None, None]
           + pd[None, None, None, :, None]
           + pr[None, None, None, None, :]) % 2
    return torch.from_numpy((tot == 0).astype(np.float64)).to(resolve_device(device))


# --------------------------------------------------------------------- #
# Expectation values in the thermodynamic limit (uniform 1x1 cell)
# --------------------------------------------------------------------- #


def fipeps_env(a, pars, chi, iters=60):
    """Converged CTMRG environment of the fermionized double layer."""
    return ctmrg_cell(((fdouble(a, pars),),), chi, iters=iters)


_SP = np.array([[0.0, 0.0], [1.0, 0.0]])  # creation: |0> -> |1>
_SM = _SP.T
_NOP = np.diag([0.0, 1.0])

# (coefficient name, op at the first site, op at the second site): the
# Fock-pinned kinds of fswap.fpeps_energy (pdm / mdp / pdp / mdm)
_KINDS = (("t", _SP, _SM), ("t", _SM, _SP), ("delta", _SP, _SP), ("delta", _SM, _SM))


def _cellify(e):
    return ((e,),)


def _rot(tsr):
    return tsr.permute(3, 0, 1, 2)


def _bond_energies(a, pars, kinds, coeff, cell, env):
    """Horizontal plus vertical two-fermion bond energy of a uniform cell
    (the vertical bond through one quarter turn of the E-network)."""
    e = cell[0][0]
    e_h = torch.zeros((), dtype=e.dtype, device=e.device)
    den_h = pair_weight_h(cell, env, e, e)
    for name, o1, o2 in kinds:
        if coeff[name] == 0.0:
            continue
        ia = fdouble(a, pars, op=o1)
        ib = fdouble(a, pars, op=o2, extra=H_RIGHT_EXTRA)
        e_h = e_h + coeff[name] * pair_weight_h(cell, env, ia, ib) / den_h
    cell_r, env_r = rotate(cell, env)
    e_v = torch.zeros((), dtype=e.dtype, device=e.device)
    den_v = pair_weight_h(cell_r, env_r, _rot(e), _rot(e))
    for name, o1, o2 in kinds:
        if coeff[name] == 0.0:
            continue
        ia = fdouble(a, pars, op=o1, extra=V_TOP_EXTRA)
        ib = fdouble(a, pars, op=o2, extra=V_BOT_EXTRA)
        e_v = e_v + coeff[name] * pair_weight_h(cell_r, env_r, _rot(ia), _rot(ib)) / den_v
    return e_h + e_v


def fipeps_measure(a, pars, env, t=1.0, mu=0.0, delta=0.0):
    """Energy per site of the 2D spinless-fermion Hamiltonian

        ``H = sum_<ij> [-t (c^d_i c_j + h.c.) + delta (c^d_i c^d_j + h.c.)]
        - mu sum_i n_i``

    in the given environment; differentiable in ``a``.  Returns ``(energy,
    density)`` as real 0-d tensors.
    """
    a = as_tensor(a, resolve_device(None, (a,)))
    cell = _cellify(fdouble(a, pars))
    dens = site_expectation(cell, env, fdouble(a, pars, op=_NOP))
    bonds = _bond_energies(a, pars, _KINDS, {"t": -t, "delta": delta}, cell, env)
    return torch.real(-mu * dens + bonds), torch.real(dens)


def fipeps_energy(a, pars, chi, t=1.0, mu=0.0, delta=0.0, iters=60):
    """Converge the environment, then measure.  Returns ``(energy_per_site,
    density)`` as floats."""
    a = as_tensor(a, resolve_device(None, (a,)))
    env = fipeps_env(a, pars, chi, iters=iters)
    e, n = fipeps_measure(a, pars, env, t=t, mu=mu, delta=delta)
    return float(e), float(n)


# --------------------------------------------------------------------- #
# Gradient ground states (differentiable CTMRG, as in variational.py)
# --------------------------------------------------------------------- #


def _cell_loss(cell_of, measure, chi, refresh_iters, grad_iters):
    """``(params, env) -> (E, env')``: the cell of ``params`` converged
    without a tape, ``grad_iters`` absorptions differentiated through
    ``svd_safe``, then ``measure(params, env)``."""
    from ..ops.linalg_ad import svd_safe
    from .ctmrg_cell import _converge as _cc_converge
    from .ctmrg_cell import _iteration as _cc_iteration

    def loss(params, env):
        cell = cell_of(params)
        with torch.no_grad():
            cur = _cc_converge(tuple(tuple(t.detach() for t in col) for col in cell),
                               env, chi, refresh_iters)
        for _ in range(grad_iters):
            cur = _cc_iteration(cell, cur, chi, svd_fn=svd_safe)
        return measure(params, cur), cur

    return loss


def make_fipeps_loss(pars, chi, t=1.0, mu=0.0, delta=0.0, refresh_iters=8,
                     grad_iters=4):
    """Differentiable energy ``(a, env) -> (E, env')`` through the cell
    CTMRG: untaped refresh + ``svd_safe``-differentiated absorptions."""
    return _cell_loss(lambda a: _cellify(fdouble(a, pars)),
                      lambda a, env: fipeps_measure(a, pars, env, t=t, mu=mu,
                                                    delta=delta)[0],
                      chi, refresh_iters, grad_iters)


def _masked_descent(loss, params, mask, env, steps, lr):
    """``steps`` parity-masked Adam steps, each followed by the mask and a
    max-abs normalization of every tensor; returns the parameters, the
    environment and the energy trace (floats, read once)."""
    from ..ops.optim import Adam, descend

    opt = Adam(params, lr=lr)
    trace = []
    for _ in range(int(steps)):
        leaves = [p.requires_grad_(True) for p in params]
        e, env = loss(leaves if len(leaves) > 1 else leaves[0], env)
        grads = torch.autograd.grad(e, leaves)
        descend(opt, params, [g * mask for g in grads])
        with torch.no_grad():
            for p in params:
                p.mul_(mask)
                p.div_(p.abs().max())
        env = tuple(tuple(tuple(t.detach() for t in col) for col in part) for part in env)
        trace.append(e.detach())
    params = [p.detach() for p in params]
    return params, env, ([float(x) for x in torch.stack(trace).cpu()] if trace else [])


def fipeps_ground_state(bond_parities=(0, 1), chi=12, t=1.0, mu=0.0, delta=0.0,
                        d=2, steps=300, lr=2e-2, refresh_iters=8, grad_iters=4,
                        seed=0, init=None, env_iters=60, dtype=torch.float64,
                        device=None):
    """Gradient ground state of the 2D spinless-fermion model in the
    thermodynamic limit: Adam on the CTMRG-contracted energy with
    parity-projected gradients (:func:`parity_mask_site`).  The default
    start is the vacuum product state plus small parity-even noise.

    Returns ``(a, energy, density, energies)``: the optimized tensor, its
    fresh fully-converged energy and density, and the per-step trace.
    """
    dtype = torch_dtype(dtype)
    device = resolve_device(device, (init,) if init is not None else ())
    bp = np.asarray(bond_parities)
    pars = (bp, bp, bp, bp)
    mask = parity_mask_site(pars, d=d, device=device).to(dtype)
    if init is None:
        rng = np.random.default_rng(seed)
        init = 0.08 * rng.standard_normal((d,) + (len(bp),) * 4)
        init[0, 0, 0, 0, 0] = 1.0  # vacuum amplitude
    a = as_tensor(init, device, dtype) * mask

    env = fipeps_env(a, pars, chi, iters=env_iters)
    loss = make_fipeps_loss(pars, chi, t=t, mu=mu, delta=delta,
                            refresh_iters=refresh_iters, grad_iters=grad_iters)
    (a,), env, es = _masked_descent(loss, [a], mask, env, steps, lr)
    e_final, dens = fipeps_energy(a, pars, chi, t=t, mu=mu, delta=delta, iters=env_iters)
    return a, e_final, dens, es


# The row string rule: every site strictly between the two parity-odd
# endpoints of a same-row two-point function carries a sign-dressed plain
# tensor (the Jordan-Wigner interval parities collapse onto the legs by the
# Gauss law).  Column strings need string-dressed environments in this
# gauge and are not provided.
H_MID_EXTRA = ("u", "l", "r", "U")


def fipeps_correlator(a, pars, env, o1, o2, distances):
    """Two-point functions ``<o1_0 (string) o2_r>`` of parity-ODD one-site
    operators along a row in the thermodynamic limit (``<c^d_0 c_r>``,
    pairing correlators, ...): the plain bosonic
    :func:`~.ctmrg_cell.row_correlator` with sign-dressed intervening
    tensors (:data:`H_MID_EXTRA`).  Returns a list of floats."""
    from .ctmrg_cell import row_correlator

    a = as_tensor(a, resolve_device(None, (a,)))
    e = fdouble(a, pars)
    i1 = fdouble(a, pars, op=o1)
    i2 = fdouble(a, pars, op=o2, extra=H_RIGHT_EXTRA)
    em = fdouble(a, pars, extra=H_MID_EXTRA)
    vals = row_correlator(_cellify(e), env, i1, i2, list(distances), connected=False,
                          mid=_cellify(em))
    return [float(torch.real(v)) for v in vals]


def bdg_energy_2d(t=1.0, mu=0.0, delta=0.0, nk=400):
    """Exact ground energy per site of the 2D spinless p-wave BdG model on
    the infinite square lattice (host k-space integral):

        ``E/N = (1 / N_k) sum_k (eps_k - E_k) / 2``,
        ``eps_k = -2 t (cos kx + cos ky) - mu``,
        ``Delta_k = 2 delta (sin kx + sin ky)``,
        ``E_k = sqrt(eps_k^2 + |Delta_k|^2)``.
    """
    k = (np.arange(nk) + 0.5) * (2 * np.pi / nk) - np.pi
    kx, ky = np.meshgrid(k, k, indexing="ij")
    eps = -2.0 * t * (np.cos(kx) + np.cos(ky)) - mu
    dk = 2.0 * delta * (np.sin(kx) + np.sin(ky))
    ek = np.sqrt(eps ** 2 + dk ** 2)
    return float(np.mean(eps - ek) / 2.0)
