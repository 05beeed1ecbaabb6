"""PEPS Born machines: exact-likelihood 2D generative modeling.

Counterpart of ``contractn_tpu/models/peps_born.py``.  A finite open PEPS
over discrete variables defines ``p(x) = |<x|P>|^2 / <P|P>``; both terms
are boundary-MPS contractions through the differentiable ragged compressor
:func:`~.canonical.truncate_safe` (``svd_safe`` sweeps: the rank-deficient
bonds of these contractions give stock SVD gradients NaNs):

* **amplitude** ``<x|P>``: single layer, each site tensor gathered at its
  sample value, rows absorbed top-down; the samples ride a leading batch
  axis of one sweep (the JAX package ``vmap``s one sample's sweep);
* **partition function** ``<P|P>``: the traced double layer through the
  same compressor.

With ``chi`` at the exact boundary ranks the likelihood is exact.
:func:`fit_peps_born` trains by Adam (optax's, written out in
:mod:`..ops.optim`) on the exact NLL, a plain loop whose loss trace is read
once at the end (the JAX package's jitted ``lax.scan``).

Departures: ``generator=`` (a ``torch.Generator``) takes the place of the
JAX ``key`` for the minibatches and for :func:`peps_born_machine`'s draw,
which also takes ``device=`` (default ``cuda``).
"""

import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from .canonical import truncate_safe


def _unit(n, dtype, device):
    v = torch.zeros((n,), dtype=dtype, device=device)
    v[0] = 1.0
    return v


def _close_rows(boundary, closing):
    """Contract a compressed boundary (list of ``(..., d, Dl, Dr)``) against
    the closing row (list of ``(..., d, l, r)``) -> ``(...)``."""
    like = boundary[0]
    carry = torch.zeros((closing[0].shape[-2], boundary[0].shape[-2]), dtype=like.dtype,
                        device=like.device)
    carry[0, 0] = 1.0
    for c in range(len(boundary)):
        carry = peinsum("...ab,...dai,...dbj->...ij", carry, closing[c], boundary[c])
    return carry[..., 0, 0]


def _sweep(rows, chi):
    """Top-down boundary sweep over ``rows`` (lists of ``(..., phys_out,
    phys_in, l, r)`` MPO-like cores; row 0 has ``phys_in = 1``, the last row
    ``phys_out = 1``).  Returns ``(value, log_scale)`` in split form, per
    batch member."""
    ly, lx = len(rows), len(rows[0])
    if ly < 2:
        raise ValueError("boundary sweep needs >= 2 rows; single-row grids are "
                         "MPS (use models.born)")
    boundary = [w[..., :, 0, :, :] for w in rows[0]]  # (..., d, l, r)
    dt, device = boundary[0].dtype, boundary[0].device
    boundary, log = truncate_safe(boundary, _unit(boundary[0].shape[-2], dt, device),
                                  _unit(boundary[-1].shape[-1], dt, device), chi)
    for r in range(1, ly - 1):
        grown = []
        for c in range(lx):
            g = peinsum("...DUlr,...Uij->...Dlirj", rows[r][c], boundary[c])
            *batch, d2, l_, i_, r_, j_ = g.shape
            grown.append(g.reshape(*batch, d2, l_ * i_, r_ * j_))
        boundary, lg = truncate_safe(grown, _unit(grown[0].shape[-2], dt, device),
                                     _unit(grown[-1].shape[-1], dt, device), chi)
        log = log + lg
    closing = [w[..., 0, :, :, :] for w in rows[ly - 1]]  # (..., d_in, l, r)
    return _close_rows(boundary, closing), log


def _grid(grid):
    device = resolve_device(None, [t for row in grid for t in row])
    return [[as_tensor(t, device) for t in row] for row in grid]


def peps_log_amp2(grid, samples, chi):
    """``log |<x|P>|^2`` (unnormalized) for ``(B, rows, cols)`` integer
    configurations: single-layer boundary sweeps with the batch on a leading
    axis.  ``grid[r][c]`` are ``(d, u, l, dn, r)`` site tensors with size-1
    boundary bonds (the :func:`~.peps_sample.sample_peps` convention)."""
    grid = _grid(grid)
    samples = as_tensor(samples, grid[0][0].device, torch.int64)
    rows = []
    for r, grow in enumerate(grid):
        # each sample's tensor (B, u, l, dn, r) -> MPO core (B, dn, u, l, r)
        rows.append([t[samples[:, r, c]].permute(0, 3, 1, 2, 4)
                     for c, t in enumerate(grow)])
    val, log = _sweep(rows, chi)
    tiny = torch.finfo(real_dtype(val.dtype)).tiny
    return 2.0 * (log + torch.log(val.abs() + tiny))


def peps_log_norm(grid, chi):
    """``log <P|P>`` via the traced double layer (a 0-d tensor)."""
    rows = []
    for grow in _grid(grid):
        row = []
        for t in grow:
            dbl = peinsum("suldr,sULDR->dDuUlLrR", t, t.conj())
            d, u, l, rr = t.shape[3], t.shape[1], t.shape[2], t.shape[4]
            row.append(dbl.reshape(d * d, u * u, l * l, rr * rr))
        rows.append(row)
    val, log = _sweep(rows, chi)
    return log + torch.log(torch.real(val))


def peps_born_nll(grid, samples, chi):
    """Mean exact negative log-likelihood (nats) of the batch."""
    return peps_log_norm(grid, chi) - torch.mean(peps_log_amp2(grid, samples, chi))


def peps_log_prob(grid, samples, chi):
    """Exact ``(B,)`` Born log-probabilities of integer configurations."""
    return peps_log_amp2(grid, samples, chi) - peps_log_norm(grid, chi)


def fit_peps_born(grid, data, steps=300, batch=None, chi=8, lr=0.02, generator=None):
    """Train a PEPS Born machine on ``(n_data, rows, cols)`` integer samples
    by exact maximum likelihood.  ``batch=None`` uses the full dataset each
    step; an integer draws a minibatch per step from ``generator``.  Returns
    ``(grid, losses)``: a new grid (the argument is left as it was) and the
    ``(steps,)`` per-step NLLs, each taken before its update (at the
    optimum: the empirical entropy of the data)."""
    from ..ops.optim import Adam, descend

    grid = _grid(grid)
    rows, cols = len(grid), len(grid[0])
    device = grid[0][0].device
    data = as_tensor(data, device, torch.int64)
    params = [t.detach().clone().requires_grad_(True) for row in grid for t in row]
    opt = Adam(params, lr=lr)
    losses = []
    for _ in range(int(steps)):
        if batch is None:
            mb = data
        else:
            mb = data[torch.randint(0, data.shape[0], (batch,), generator=generator,
                                    device=device)]
        g = [params[r * cols:(r + 1) * cols] for r in range(rows)]
        loss = peps_born_nll(g, mb, chi)
        descend(opt, params, torch.autograd.grad(loss, params))
        losses.append(loss.detach())
    out = [[params[r * cols + c].detach() for c in range(cols)] for r in range(rows)]
    return out, torch.stack(losses) if losses else torch.zeros(0)


def peps_born_machine(rows, cols, phys_dim=2, bond_dim=2, dtype=torch.float64,
                      generator=None, device=None):
    """Fresh random PEPS Born machine: ``grid[r][c]`` site tensors ``(d, u, l,
    dn, r)`` with size-1 boundary bonds, uniform in ``[0.3, 1.0]`` (all
    positive, so every configuration's log-amplitude is finite at step 0)
    over ``sqrt(bond_dim)``.  Draws from ``generator`` on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    grid = []
    for r in range(rows):
        row = []
        for c in range(cols):
            shape = (phys_dim, bond_dim if r > 0 else 1, bond_dim if c > 0 else 1,
                     bond_dim if r < rows - 1 else 1, bond_dim if c < cols - 1 else 1)
            t = 0.3 + 0.7 * torch.rand(shape, dtype=dtype, device=device,
                                       generator=generator)
            row.append(t / (bond_dim ** 0.5))
        grid.append(row)
    return grid
