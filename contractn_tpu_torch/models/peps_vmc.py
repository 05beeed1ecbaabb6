"""Variational Monte Carlo for finite PEPS: sampled energies and gradients.

Counterpart of ``contractn_tpu/models/peps_vmc.py``.  With perfect
Born-rule samples (:func:`~.peps_sample.sample_peps`), the energy and its
gradient are the standard VMC estimators

    E        = E_s[ E_loc(s) ],
    E_loc(s) = sum_{s'} H[s, s'] psi(s') / psi(s),
    grad E   = 2 Re E_s[ O(s) (E_loc(s) - E) ],   O = d log psi / dθ,

over ``p(s) = |psi(s)|^2 / <psi|psi>``.  Passing every configuration with
its Born weight reproduces the Rayleigh quotient and its gradient exactly,
which is how the tests pin them.

One sample's amplitude is a fixed einsum chain (exact single-layer row
absorption, split-format log carried per row).  As in the JAX package the
batch is a ``vmap`` of it (``torch.func.vmap``): ``E_loc`` evaluates every
sample's ``n_bonds * d^2`` flipped configurations in one batched call, and
``O`` is ``torch.func.vmap(torch.func.grad(...))`` of the log-amplitude;
only the optimization steps loop on the host.

Real tensors only (the estimator is the real-parameter form).  Departure:
:func:`fit_peps_vmc` takes ``generator=`` (a ``torch.Generator``) for the
sampler in place of the JAX ``key``.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device


def _check_real(grid):
    for row in grid:
        for t in row:
            if t.is_complex() if torch.is_tensor(t) else np.iscomplexobj(t):
                raise ValueError("peps_vmc is real-only (the gradient estimator uses the "
                                 "real-parameter form)")


def _grid(grid):
    device = resolve_device(None, [t for row in grid for t in row])
    return [[as_tensor(t, device) for t in row] for row in grid]


def peps_log_amp(grid, sample):
    """``(sign, log|amp|)`` of ``<sample|P>``: exact single-layer contraction
    (row-by-row absorption, no truncation), differentiable and
    ``torch.func.vmap``-able over ``sample``."""
    rows, cols = len(grid), len(grid[0])
    like = grid[0][0]
    one = torch.ones((), dtype=like.dtype, device=like.device)
    log = torch.zeros((), dtype=like.dtype, device=like.device)
    env = [one.reshape(1, 1, 1) for _ in range(cols)]  # (dn, l, r)
    for r in range(rows):
        new = []
        for c in range(cols):
            t = torch.index_select(grid[r][c], 0, sample[r, c].reshape(1))[0]
            g = peinsum("uij,uldr->dlirj", env[c], t)
            d_, l_, i_, r_, j_ = g.shape
            new.append(g.reshape(d_, l_ * i_, r_ * j_))
        scale = torch.clamp(new[cols // 2].abs().max(), min=1e-300)
        env = [e / scale if c == cols // 2 else e for c, e in enumerate(new)]
        log = log + torch.log(scale)
    vec = one.reshape(1)
    for c in range(cols):
        vec = peinsum("l,dlr->r", vec, env[c])
        s = torch.clamp(vec.abs().max(), min=1e-300)
        vec = vec / s
        log = log + torch.log(s)
    amp = vec[0]
    return torch.sign(amp), log + torch.log(amp.abs() + 1e-300)


def _bonds(rows, cols):
    hb = [(r, c, r, c + 1) for r in range(rows) for c in range(cols - 1)]
    vb = [(r, c, r + 1, c) for r in range(rows - 1) for c in range(cols)]
    return hb, vb


def _log_amps(grid, samples):
    """Batched ``(sign, log|amp|)`` of ``(B, rows, cols)`` samples."""
    return torch.func.vmap(peps_log_amp, in_dims=(None, 0))(grid, samples)


def _local_energies(grid, samples, h2h, h2v):
    """``E_loc`` of every sample of the batch: all flipped configurations of
    all bonds in one batched amplitude evaluation."""
    rows, cols = len(grid), len(grid[0])
    d = grid[0][0].shape[0]
    b = samples.shape[0]
    hb, vb = _bonds(rows, cols)
    bonds = [(bd, h2h) for bd in hb] + [(bd, h2v) for bd in vb]
    phys = torch.arange(d, device=samples.device)
    flipped, weights = [], []
    for (r1, c1, r2, c2), h2 in bonds:
        h4 = h2.reshape(d, d, d, d)
        weights.append(h4[samples[:, r1, c1], samples[:, r2, c2]])  # (B, d, d)
        s2 = samples[:, None, None].repeat(1, d, d, 1, 1)
        s2[:, :, :, r1, c1] = phys[None, :, None]
        s2[:, :, :, r2, c2] = phys[None, None, :]
        flipped.append(s2)
    sgn0, log0 = _log_amps(grid, samples)
    sgns, logs = _log_amps(grid, torch.stack(flipped, 1).reshape(-1, rows, cols))
    sgns = sgns.reshape(b, len(bonds), d, d)
    logs = logs.reshape(b, len(bonds), d, d)
    ratio = sgns * sgn0[:, None, None, None] * torch.exp(logs - log0[:, None, None, None])
    return (torch.stack(weights, 1) * ratio).sum(dim=(1, 2, 3))


def local_energy(grid, sample, h2h, h2v):
    """``E_loc(s)`` for nearest-neighbor Hamiltonians given as dense two-site
    terms ``h2h`` (horizontal) / ``h2v`` (vertical), each ``(d^2, d^2)``
    ordered ``(s_first, s_second)``; a 0-d tensor."""
    grid = _grid(grid)
    device = grid[0][0].device
    sample = as_tensor(sample, device, torch.int64)
    return _local_energies(grid, sample[None], as_tensor(h2h, device, torch.float64),
                           as_tensor(h2v, device, torch.float64))[0]


def vmc_energy_and_grad(grid, samples, h2h, h2v, weights=None):
    """VMC estimators over a batch of integer configurations.

    Args:
        grid: ``grid[r][c]`` real ``(d, u, l, dn, r)`` tensors.
        samples: ``(B, rows, cols)`` configurations: Born-rule draws, or ALL
            ``d^(rows cols)`` configurations with ``weights = p(s)`` for the
            exact identity.
        h2h / h2v: dense two-site bond terms ``(d^2, d^2)``.
        weights: optional per-sample weights (default uniform, right for
            Born-rule samples).

    Returns:
        ``(energy, grads, variance)``: ``grads`` a grid like ``grid``;
        ``variance`` the weighted local-energy variance (zero at an
        eigenstate).
    """
    _check_real(grid)
    grid = _grid(grid)
    device = grid[0][0].device
    samples = as_tensor(samples, device, torch.int64)
    h2h = as_tensor(h2h, device, torch.float64)
    h2v = as_tensor(h2v, device, torch.float64)
    weights = (torch.ones((samples.shape[0],), dtype=torch.float64, device=device)
               if weights is None else as_tensor(weights, device, torch.float64))
    with torch.no_grad():
        els = _local_energies(grid, samples, h2h, h2v)
    os_ = torch.func.vmap(torch.func.grad(lambda g, s: peps_log_amp(g, s)[1]),
                          in_dims=(None, 0))(grid, samples)
    w = weights / weights.sum()
    energy = (w * els).sum()
    centered = els - energy
    grads = [[2.0 * torch.tensordot(w * centered, o, dims=([0], [0])) for o in row]
             for row in os_]
    return energy, grads, (w * centered ** 2).sum()


def fit_peps_vmc(grid, h2h, h2v, steps=200, num_samples=128, chi=8, lr=0.02,
                 generator=None):
    """Gradient-descent VMC ground-state search: per step ``num_samples``
    perfect Born samples (:func:`~.peps_sample.sample_peps` from
    ``generator``), the estimators above and one Adam update (optax's,
    :mod:`..ops.optim`).  Returns ``(grid, energies)`` with the per-step
    sampled energy trace (floats, read once)."""
    from ..ops.optim import Adam, descend
    from .peps_sample import sample_peps

    _check_real(grid)
    grid = _grid(grid)
    rows, cols = len(grid), len(grid[0])
    device = grid[0][0].device
    h2h = as_tensor(h2h, device, torch.float64)
    h2v = as_tensor(h2v, device, torch.float64)
    params = [t.detach().clone() for row in grid for t in row]
    opt = Adam(params, lr=lr)
    energies = []
    for _ in range(int(steps)):
        g = [params[r * cols:(r + 1) * cols] for r in range(rows)]
        samples, _ = sample_peps(g, num_samples, chi, generator=generator)
        e, grads, _ = vmc_energy_and_grad(g, samples, h2h, h2v)
        descend(opt, params, [t for row in grads for t in row])
        energies.append(e.detach())
    out = [[params[r * cols + c] for c in range(cols)] for r in range(rows)]
    return out, ([float(x) for x in torch.stack(energies).cpu()] if energies else [])
