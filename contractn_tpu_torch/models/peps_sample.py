"""Direct (autoregressive) sampling of finite open PEPS.

Counterpart of ``contractn_tpu/models/peps_sample.py``.  Sites are drawn in
raster order from their exact conditionals

    ``p(s_rc | s_<) = <traced below, projected above, s_rc patch>``

in the double layer: sampled sites are projected onto their drawn values,
unsampled ones traced, and the two half-plane contractions ride the
boundary-MPS machinery:

* **below environments** (rows under the current one, traced): built once,
  bottom-up, with :func:`~.boundary.apply_mpo_to_mps` and
  :func:`~.canonical.compress_fixed`; they do not depend on the sample;
* **above environment** (sampled rows, projected): per sample, absorbed row
  by row with the same two steps;
* **within the row**: right partial contractions of the (above) x (row) x
  (below) sandwich and a left vector that grows as sites are drawn.

The JAX package ``vmap``s one sample's program over a batch of keys.  Here
every sample rides a leading batch axis of the same sequence of einsums,
QR/SVD compressions at the fixed bond ``chi`` (the boundary module's
sweeps, batched) and ``searchsorted`` draws, so a batch is one pass over
the sites; the uniforms come from one ``torch.Generator`` draw.  With ``chi`` at the exact half-plane rank the
conditionals, and the returned ``log_prob``, are exact.

Departure: ``generator=`` (a ``torch.Generator`` on the grid's device, or
the global one) takes the place of the JAX ``key`` argument: the same
distribution, other samples.
"""

import torch

from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device
from .boundary import apply_mpo_to_mps
from .canonical import _fixed_svd_sweep, _left_qr_sweep, compress_fixed
from .mpo import MPO
from .mps import MPS


def _check_grid(grid, device=None):
    rows, cols = len(grid), len(grid[0])
    device = resolve_device(device, [t for row in grid for t in row])
    grid = [[as_tensor(grid[r][c], device) for c in range(cols)] for r in range(rows)]
    dt = grid[0][0].dtype
    for row in grid:
        for t in row:
            dt = torch.promote_types(dt, t.dtype)
    grid = [[t.to(dt) for t in row] for row in grid]
    for r in range(rows):
        for c in range(cols):
            _, u_, l_, dn_, r_ = grid[r][c].shape
            if r == 0 and u_ != 1:
                raise ValueError(f"site (0, {c}): up dim must be 1")
            if r == rows - 1 and dn_ != 1:
                raise ValueError(f"site ({r}, {c}): down dim must be 1")
            if c == 0 and l_ != 1:
                raise ValueError(f"site ({r}, 0): left dim must be 1")
            if c == cols - 1 and r_ != 1:
                raise ValueError(f"site ({r}, {c}): right dim must be 1")
    for r in range(rows):
        shapes = {tuple(grid[r][c].shape[:2]) + tuple(grid[r][c].shape[3:4])
                  for c in range(cols)}
        if len(shapes) != 1:
            raise ValueError(f"row {r}: (d, up, down) dims must match across the row")
    return grid, rows, cols, dt


def _open_dbl(t):
    """Open-physical double layer of ``t (d, u, l, dn, r)``: ``(d, u^2, l^2,
    dn^2, r^2)``, diagonal in the physical index."""
    d, u, l, dn, r = t.shape
    return peinsum("suldr,sULDR->suUlLdDrR", t, t.conj()).reshape(d, u * u, l * l, dn * dn,
                                                                  r * r)


def _pad_h(t, h):
    """Zero-pad the two horizontal axes (2 and 4) of an open double layer to
    the uniform width ``h`` (live block at 0)."""
    d, pu, lw, pd, rw = t.shape
    out = torch.zeros((d, pu, h, pd, h), dtype=t.dtype, device=t.device)
    out[:, :, :lw, :, :rw] = t
    return out


def _e0(h, dtype, device):
    e0 = torch.zeros((h,), dtype=dtype, device=device)
    e0[0] = 1.0
    return e0


def _trivial_mps(cols, dtype, device):
    one = torch.ones((1,), dtype=dtype, device=device)
    return MPS(torch.ones((cols, 1, 1, 1), dtype=dtype, device=device), one, one)


def _below_envs(rows_open, w, h, chi):
    """``below[r]``: boundary MPS of the rows ``r+1 ..`` (free sites traced,
    observed ones projected by the weight vectors ``w[r, c] (d,)``) with open
    legs on row ``r``'s down bonds; independent of the samples."""
    rows, cols = len(rows_open), len(rows_open[0])
    like = rows_open[0][0]
    below = [None] * rows
    below[rows - 1] = _trivial_mps(cols, like.dtype, like.device)
    e0 = _e0(h, like.dtype, like.device)
    for r in range(rows - 2, -1, -1):
        # absorbing from below: the row maps its dn legs to its u legs
        cores = torch.stack([
            peinsum("s,suldr->uldr", w[r + 1, c], rows_open[r + 1][c]).permute(0, 2, 1, 3)
            for c in range(cols)])
        grown = apply_mpo_to_mps(MPO(cores, e0, e0), below[r + 1])
        below[r], _, _ = compress_fixed(grown, chi)
    return below


def _amax(t, dims):
    return torch.clamp(t.abs().amax(dim=dims), min=1e-300)


def sample_peps(grid, num_samples, chi, observed=None, generator=None):
    """Draw ``num_samples`` configurations from ``|<s|P>|^2 / <P|P>``.

    Args:
        grid: ``grid[r][c]`` site tensors ``(d, u, l, dn, r)`` with boundary
            bond dims 1 (torch tensors keep their device; numpy goes to
            ``cuda``).
        num_samples: batch size (one batched pass over the sites).
        chi: boundary bond of both half-plane environments; at the exact
            half-plane rank the conditionals and ``log_prob`` are exact.
        observed: optional ``(rows, cols)`` ints, ``-1`` = free: exact
            conditional sampling from ``p(free | observed)`` (both
            environments and the in-row closures carry the observations as
            projections).
        generator: ``torch.Generator`` on the grid's device for the uniforms
            (default: the global one).

    Returns:
        ``(samples, log_probs)``: ``(num_samples, rows, cols)`` int32
        (observed values copied in) and each sample's exact log model
        probability (conditional ``log p(free | observed)`` when
        ``observed`` is given), on the grid's device.
    """
    grid, rows, cols, dt = _check_grid(grid)
    device = grid[0][0].device
    rdt = real_dtype(dt)
    d = grid[0][0].shape[0]
    if observed is None:
        observed = -torch.ones((rows, cols), dtype=torch.int64, device=device)
    else:
        observed = as_tensor(observed, device, torch.int64)
        if tuple(observed.shape) != (rows, cols):
            raise ValueError(f"observed must be ({rows}, {cols})")
    obs_mask = observed >= 0
    w = torch.where(obs_mask[:, :, None],
                    torch.nn.functional.one_hot(torch.clamp(observed, min=0), d).to(dt),
                    torch.ones((rows, cols, d), dtype=dt, device=device))
    h = max(max(t.shape[2], t.shape[4]) for row in grid for t in row) ** 2
    rows_open = [[_pad_h(_open_dbl(t), h) for t in row] for row in grid]
    below = _below_envs(rows_open, w, h, chi)

    b = int(num_samples)
    uniforms = torch.rand((b, rows, cols), dtype=rdt, device=device, generator=generator)
    e0 = _e0(h, dt, device)
    # the above environment starts trivial for every sample
    a_cores = torch.ones((b, cols, 1, 1, 1), dtype=dt, device=device)
    a_left = torch.ones((b, 1), dtype=dt, device=device)
    a_right = torch.ones((b, 1), dtype=dt, device=device)
    log_p = torch.zeros((b,), dtype=rdt, device=device)
    samples = []
    for r in range(rows):
        row_open = rows_open[r]
        row_tr = [peinsum("s,suldr->uldr", w[r, c], row_open[c]) for c in range(cols)]
        bm = below[r]
        # right partials: R[c] (z, a, r, b) closes the columns right of c
        r_vec = peinsum("za,l,b->zalb", a_right, _e0(row_tr[0].shape[3], dt, device),
                        bm.right)
        parts = [r_vec]
        for c in range(cols - 1, 0, -1):
            r_vec = path_einsum("zuax,uldr,dby,zxry->zalb", a_cores[:, c], row_tr[c],
                            bm.cores[c], r_vec)
            r_vec = r_vec / _amax(r_vec, (1, 2, 3))[:, None, None, None]
            parts.append(r_vec)
        rps = parts[::-1]
        l_vec = peinsum("za,l,b->zalb", a_left, e0, bm.left)
        row_samp, sel_cores = [], []
        for c in range(cols):
            wv = path_einsum("zalb,zuax,suldr,dby,zxry->zs", l_vec, a_cores[:, c],
                         row_open[c], bm.cores[c], rps[c])
            wv = torch.clamp(torch.real(wv), min=0.0) + 1e-300
            p = wv / wv.sum(dim=1, keepdim=True)
            drawn = torch.searchsorted(torch.cumsum(p, dim=1),
                                       uniforms[:, r, c, None].contiguous())[:, 0]
            drawn = torch.clamp(drawn, 0, d - 1)
            s = torch.where(obs_mask[r, c], observed[r, c], drawn)
            p_s = torch.gather(p, 1, s[:, None])[:, 0]
            log_p = log_p + torch.where(obs_mask[r, c], torch.zeros_like(p_s),
                                        torch.log(p_s))
            row_samp.append(s)
            t_sel = row_open[c][s]  # (z, u, l, dn, r)
            sel_cores.append(t_sel.permute(0, 3, 1, 2, 4))
            l_vec = path_einsum("zalb,zuax,zuldr,dby->zxry", l_vec, a_cores[:, c], t_sel,
                            bm.cores[c])
            l_vec = l_vec / _amax(l_vec, (1, 2, 3))[:, None, None, None]
        if r < rows - 1:
            # the projected row on the above environment, compressed back to
            # chi: every sample its own chain on the leading axis
            grown = apply_mpo_to_mps(MPO(torch.stack(sel_cores, dim=1), e0, e0),
                                     MPS(a_cores, a_left, a_right))
            qs, e0_db, wv, _ = _left_qr_sweep(grown.cores, grown.left, grown.right)
            a_cores, a_left, a_right, _, _ = _fixed_svd_sweep(qs, e0_db, wv, chi)
            a_right = a_right.expand(b, chi)
        samples.append(torch.stack(row_samp, dim=1))
    return torch.stack(samples, dim=1).to(torch.int32), log_p
