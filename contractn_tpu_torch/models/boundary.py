"""Boundary-MPS contraction of 2D (PEPS) grid networks.

Counterpart of ``contractn_tpu/models/boundary.py``.  Row 1 of the grid is
an MPS over its vertical bonds, every interior row acts on it as an MPO, and
after each absorption the boundary is SVD-compressed back to bond ``chi``
(:mod:`.canonical`).  Cost is polynomial with a controllable truncation
error, and the log of the contracted value accumulates in split format.

The site tensors go to ``device`` (default: the node tensors' own device if
they are torch tensors, else ``cuda``; ``device="cpu"`` on request).  The
JAX package's scanned row sweep (one compiled program over rows) is a loop
over rows here, with the same fixed-``chi`` sweeps.
"""

import torch

from ..ops.stabilize import destabilize, peinsum
from ..utils.device import as_tensor, resolve_device
from .canonical import _fixed_svd_sweep, _left_qr_sweep, compress, compress_fixed
from .mpo import MPO
from .mps import MPS


def apply_mpo_to_mps(mpo, mps):
    """Exact MPO application: bond dimensions multiply (``W * D``).  Axes of
    the cores and boundary vectors before their own are a batch (broadcast
    between the two)."""
    w = mpo.cores  # (..., N, do, di, W, W)
    a = mps.cores  # (..., N, di, D, D)
    wb, bond = w.shape[-1], a.shape[-1]
    new = peinsum("...nabwv,...nbij->...nawivj", w, a)
    new = new.reshape(*new.shape[:-4], wb * bond, wb * bond)
    dtype = new.dtype

    def kron(x, y):
        z = x.to(dtype)[..., :, None] * y.to(dtype)[..., None, :]
        return z.reshape(*z.shape[:-2], -1)

    return MPS(new, kron(mpo.left, mps.left), kron(mpo.right, mps.right))


def _grid_device(grid, device):
    return resolve_device(device, [node.tensor for row in grid for node in row])


def _padded_site(grid, r, c, rows, cols, device):
    """Site tensor with all four (up, left, down, right) axes present."""
    t = as_tensor(grid[r][c].tensor, device)
    if r == 0:
        t = t[None]
    if c == 0:
        t = t[:, None]
    if r == rows - 1:
        t = t[:, :, None]
    if c == cols - 1:
        t = t[..., None]
    return t  # (up, left, down, right)


def _embed(mats, phys_first):
    """Stack per-column tensors into uniform cores, zero-padding horizontal
    bonds; returns ``(stacked, e)`` with ``e`` the boundary basis vector."""
    h = max(max(m.shape[-2], m.shape[-1]) for m in mats)
    dtype, device = mats[0].dtype, mats[0].device
    out = torch.zeros((len(mats),) + tuple(phys_first) + (h, h), dtype=dtype,
                      device=device)
    for i, m in enumerate(mats):
        out[(i,) + tuple(slice(0, s) for s in m.shape)] = m
    e = torch.zeros((h,), dtype=dtype, device=device)
    e[0] = 1.0
    return out, e


def _absorb_rows(cores, left, right, w_rows, chi):
    """Absorb a stack of interior rows into the boundary MPS.

    ``cores (C, dv, chi, chi)``: boundary at fixed bond ``chi``;
    ``w_rows (R, C, dd, du, h, h)``: the interior rows as uniform MPO
    stacks.  Per row: exact MPO application (bond ``h * chi``), QR
    canonicalization, fixed-``chi`` SVD truncation.

    Returns ``(cores, left, right, log, err_sq)``.
    """
    _, c, dd, _, h, _ = w_rows.shape
    e_row = torch.zeros((h,), dtype=cores.dtype, device=cores.device)
    e_row[0] = 1.0
    log = torch.zeros((), dtype=torch.real(e_row).dtype, device=cores.device)
    err = torch.zeros_like(log)
    for w in w_rows:
        grown = peinsum("nabwv,nbij->nawivj", w, cores).reshape(
            c, dd, h * chi, h * chi)
        l2 = torch.kron(e_row, left)
        r2 = torch.kron(e_row, right)
        qs, e0, wv, log_qr = _left_qr_sweep(grown, l2, r2)
        cores, left, right, log_svd, err_sq = _fixed_svd_sweep(qs, e0, wv, chi)
        log = log + log_qr + log_svd
        err = err + err_sq
    return cores, left, right, log, err


def _row_cores(tensor_grid, r):
    """Interior row ``r`` as uniform MPO cores ``(C, down, up, h, h)``."""
    mats = [t.permute(2, 0, 1, 3) for t in tensor_grid[r]]  # (down, up, l, r)
    return _embed(mats, mats[0].shape[:2])


def _rows_uniform(tensor_grid):
    """Whether all interior rows share one (padded) embedding shape."""
    shapes = {tuple(_row_cores(tensor_grid, r)[0].shape)
              for r in range(1, len(tensor_grid) - 1)}
    return len(shapes) <= 1


def _boundary_sweep_fixed(tensor_grid, chi):
    """Fixed-``chi`` sweep with no host round trip per row.

    Requires all interior rows to share one (padded) shape — true for
    uniform-bond PEPS grids; the caller checks and uses the host sweep
    otherwise.  Returns split-format ``(mantissa, log)``.
    """
    rows = len(tensor_grid)
    mats = [t[0].permute(1, 0, 2) for t in tensor_grid[0]]
    cores0, e = _embed(mats, (mats[0].shape[0],))
    boundary, total_log, _ = compress_fixed(MPS(cores0, e, e.clone()), chi)
    if rows > 2:
        w_rows = torch.stack([_row_cores(tensor_grid, r)[0]
                              for r in range(1, rows - 1)])
        cores, left, right, log, _ = _absorb_rows(
            boundary.cores, boundary.left, boundary.right, w_rows, int(chi)
        )
        boundary = MPS(cores, left, right)
        total_log = total_log + log
    mats = [t[:, :, 0] for t in tensor_grid[rows - 1]]
    cores, e = _embed(mats, (mats[0].shape[0],))
    val, log = MPS(cores, e, e.clone()).inner(boundary, conjugate=False)
    return val, log + total_log


def _single_row_sweep(row):
    """A 1-row grid is a plain matrix chain over the horizontal bonds.

    The boundary sweep would use row 0 both as the opening boundary and as
    the closing row (squaring the value), so the single-row case gets its
    own stabilized left-to-right product.  Returns split-format
    ``(mantissa, log)`` with ``|mantissa| = 1``.
    """
    v = row[0][0, :, 0, :]  # (left=1, right)
    log = torch.zeros((), dtype=torch.real(v).dtype, device=v.device)
    for t in row[1:]:
        v = v @ t[0, :, 0, :]
        norm = v.abs().mean()
        safe = torch.where(norm > 1e-7, norm, torch.ones_like(norm))
        v, log = v / safe, log + torch.log(safe)
    val = v[0, 0]
    mag = val.abs()
    safe = torch.where(mag > 1e-7, mag, torch.ones_like(mag))
    return val / safe, log + torch.log(safe)


def _sweep_dispatch(tensor_grid, chi):
    """Fixed-``chi`` sweep when a ``chi`` is given and the grid is uniform;
    exact host sweep otherwise."""
    if len(tensor_grid) == 1:
        return _single_row_sweep(tensor_grid[0])
    if chi is not None and _rows_uniform(tensor_grid):
        return _boundary_sweep_fixed(tensor_grid, chi)
    return _boundary_sweep(tensor_grid, chi)


def _boundary_sweep(tensor_grid, chi):
    """Core sweep over a grid of full ``(up, left, down, right)`` tensors.

    Host loop (exact when ``chi`` is None; also used for non-uniform grids).
    Returns split-format ``(mantissa, log)``.
    """
    rows = len(tensor_grid)
    # Row 0 as a boundary MPS over its down-bonds
    mats = [t[0].permute(1, 0, 2) for t in tensor_grid[0]]
    cores, e = _embed(mats, (mats[0].shape[0],))
    boundary = MPS(cores, e, e.clone())
    total_log = 0.0
    for r in range(1, rows - 1):
        cores, e = _row_cores(tensor_grid, r)
        boundary = apply_mpo_to_mps(MPO(cores, e, e.clone()), boundary)
        if chi is not None and boundary.bond_dim > chi:
            boundary, log_norm, _ = compress(boundary, max_bond=chi)
            total_log += log_norm
    # Last row as an MPS over its up-bonds; value = <last_row | boundary>
    mats = [t[:, :, 0] for t in tensor_grid[rows - 1]]
    cores, e = _embed(mats, (mats[0].shape[0],))
    # Bilinear pairing, NOT the Hermitian inner product: the closing row's
    # tensors enter the network as-is, so no conjugation anywhere
    val, log = MPS(cores, e, e.clone()).inner(boundary, conjugate=False)
    return val, log + total_log


def boundary_contract(tn, grid, chi=None, split_format=True, device=None):
    """Contract a closed PEPS grid by boundary-MPS sweeping.

    Args:
        tn: the TN returned by :func:`~.peps.peps_tn` (with
            ``phys_dim=None`` — a closed, scalar-valued network).
        grid: the node grid returned alongside it.
        chi: maximum boundary bond dimension (None = no truncation: exact,
            but bonds grow as ``D^row``).
        split_format: return ``(mantissa, log)`` or the dense scalar.
        device: where to contract (see the module doc).

    Returns:
        The contracted scalar in split or dense format.
    """
    rows, cols = len(grid), len(grid[0])
    if any(n.ndim not in (2, 3, 4) for row in grid for n in row):
        raise ValueError(
            "boundary_contract expects a closed grid (phys_dim=None)"
        )
    device = _grid_device(grid, device)
    tensor_grid = [
        [_padded_site(grid, r, c, rows, cols, device) for c in range(cols)]
        for r in range(rows)
    ]
    val, log = _sweep_dispatch(tensor_grid, chi)
    return (val, log) if split_format else destabilize(val, log)


def _double_layer_site(grid, r, c, rows, cols, device, op=None):
    """One closed double-layer site of an open PEPS, optionally with a
    one-site operator inserted between the layers."""
    node = grid[r][c]
    # virtual legs = number of existing lattice neighbors
    n_virtual = (r > 0) + (c > 0) + (r < rows - 1) + (c < cols - 1)
    if node.ndim != n_virtual + 1:
        raise ValueError("expected an open grid (phys_dim set)")
    t = as_tensor(node.tensor, device)
    # pad the four virtual bonds (phys stays last)
    if r == 0:
        t = t[None]
    if c == 0:
        t = t[:, None]
    if r == rows - 1:
        t = t[:, :, None]
    if c == cols - 1:
        t = t[:, :, :, None]
    if op is not None:
        # <bra| O |ket>: O[P, p] with the bra index first
        dbl = peinsum("uldrp,Pp,ULDRP->uUlLdDrR", t, as_tensor(op, device),
                      t.conj())
    else:
        dbl = peinsum("uldrp,ULDRp->uUlLdDrR", t, t.conj())
    s = t.shape
    return dbl.reshape(s[0] ** 2, s[1] ** 2, s[2] ** 2, s[3] ** 2)


def _double_layer_grid(grid, device):
    """Closed double-layer tensor grid of an open PEPS."""
    rows, cols = len(grid), len(grid[0])
    return [
        [_double_layer_site(grid, r, c, rows, cols, device) for c in range(cols)]
        for r in range(rows)
    ]


def peps_expectation(tn, grid, op, site, chi=None, device=None):
    """``<P| O_site |P> / <P|P>`` for an open finite PEPS.

    Two boundary-MPS sweeps (impurity and norm) of the double-layer grid;
    ``op (d, d)``, ``site = (row, col)``.
    """
    rows, cols = len(grid), len(grid[0])
    r, c = site
    if not (0 <= r < rows and 0 <= c < cols):
        raise ValueError(f"site {site} outside the {rows}x{cols} grid")
    device = _grid_device(grid, device)
    norm_grid = _double_layer_grid(grid, device)
    # the impurity grid differs at exactly one site: build just that one
    dressed = _double_layer_site(grid, r, c, rows, cols, device, op=op)
    num_grid = [
        [dressed if (rr, cc) == (r, c) else norm_grid[rr][cc]
         for cc in range(cols)]
        for rr in range(rows)
    ]
    num_v, num_l = _sweep_dispatch(num_grid, chi)
    den_v, den_l = _sweep_dispatch(norm_grid, chi)
    return (num_v / den_v) * torch.exp(num_l - den_l)


def peps_norm(tn, grid, chi=None, split_format=True, device=None):
    """``<P|P>`` of an OPEN PEPS (physical modes) via the double layer.

    Each double-layer site is ``T (x) conj(T)`` with the physical index
    contracted, giving a closed grid with squared bond dimensions that the
    boundary sweep contracts at polynomial cost.
    """
    tensor_grid = _double_layer_grid(grid, _grid_device(grid, device))
    val, log = _sweep_dispatch(tensor_grid, chi)
    return (val, log) if split_format else destabilize(val, log)
