"""Directional CTMRG for arbitrary rectangular unit cells (Corboz).

Counterpart of ``contractn_tpu/models/ctmrg_cell.py``.  The symmetric CTMRG
of :mod:`.ctmrg` needs one C4v-invariant site tensor; this module converges
the environment of a generic ``Lx x Ly`` cell of (possibly all-distinct,
non-symmetric) site tensors: every site ``(x, y)`` carries its own corners
``C1..C4`` and edges ``T1..T4``, one lattice column is absorbed per *left
move*, and the other three directions are the same move after a lattice
rotation of the cell and of every environment tensor (one code path).

Geometry and leg conventions (x = column rightward, y = row downward; cell
indices wrap mod ``Lx`` / ``Ly``):

* site ``a[x][y]`` legs ``(u, l, d, r)``;
* ``C1[x,y] (r, d)`` the quadrant up-left of ``(x, y)``; ``C2 (l, d)``
  up-right; ``C3 (u, l)`` down-right; ``C4 (u, r)`` down-left;
* ``T1[x,y] (l, q, r)`` the top edge (``q`` points down onto the site),
  ``T2 (u, q, d)`` right, ``T3 (l, q, r)`` bottom, ``T4 (u, q, d)`` left.

Projectors (left move, bond between rows ``y-1`` and ``y``): with the
enlarged corners ``Q1[x, y-1]`` and ``Q4[x, y]`` as ``(fat, right)``
matrices, ``F = Q1^T Q4 = U S Vh`` and ``P = Q4 Vh_k^H S_k^{-1/2}``, ``Pt =
Q1 conj(U_k) S_k^{-1/2}`` (the inverse square root cut at ``_SVD_TOL``
relative to the largest weight, branchlessly with ``torch.where``).

The JAX package converges inside one jitted ``lax.fori_loop``; here the
fixed-point is a plain loop of device work that reads nothing on the host.
The growth phase (environment legs expanding to ``chi``) stops when the
shape signature stops changing, a decision on shapes made on the host for
free.  Every function is also correct under ``torch.func.vmap`` (no host
read, no data-dependent Python branch), which is how
:func:`~.ipeps_cell.ipeps_cell_scan` batches a family of cells.

The projector SVDs go through :func:`~..ops.linalg_ad.small_svd` (on the
card, cuSOLVER with the driver measured fastest for their size).
Environments are gauge-dependent (decompositions sign and rotate singular
vectors differently): compare them through the observables below.
"""

import numpy as np
import torch

from ..ops.linalg_ad import small_svd
from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, resolve_device

_SVD_TOL = 1e-12  # relative cutoff for projector inverse sqrt weights


def _norm(t):
    return t / torch.clamp(t.abs().max(), min=1e-300)


def _cell(fn, lx, ly):
    return tuple(tuple(fn(x, y) for y in range(ly)) for x in range(lx))


def _as_cell(a):
    """The cell as nested tuples of tensors on one device (numpy to ``cuda``)."""
    leaves = [t for col in a for t in col]
    device = resolve_device(None, leaves)
    return tuple(tuple(as_tensor(t, device) for t in col) for col in a)


def init_env(a):
    """Free-boundary seed: partial traces of the neighboring site tensors
    (the generic-cell analog of ``ctmrg_environment``'s seed)."""
    lx, ly = len(a), len(a[0])

    def at(x, y):
        return a[x % lx][y % ly]

    # the axis order follows each tensor's leg convention (C1 (r, d)) even
    # where leg dims differ: anisotropic cells bind shapes strictly
    c1 = _cell(lambda x, y: _norm(peinsum("uldr->rd", at(x - 1, y - 1))), lx, ly)
    c2 = _cell(lambda x, y: _norm(peinsum("uldr->ld", at(x + 1, y - 1))), lx, ly)
    c3 = _cell(lambda x, y: _norm(peinsum("uldr->ul", at(x + 1, y + 1))), lx, ly)
    c4 = _cell(lambda x, y: _norm(peinsum("uldr->ur", at(x - 1, y + 1))), lx, ly)
    t1 = _cell(lambda x, y: _norm(peinsum("uldr->ldr", at(x, y - 1))), lx, ly)
    t2 = _cell(lambda x, y: _norm(peinsum("uldr->uld", at(x + 1, y))), lx, ly)
    t3 = _cell(lambda x, y: _norm(peinsum("uldr->lur", at(x, y + 1))), lx, ly)
    t4 = _cell(lambda x, y: _norm(peinsum("uldr->urd", at(x - 1, y))), lx, ly)
    return (c1, c2, c3, c4, t1, t2, t3, t4)


def _norm_rows(t):
    """:func:`_norm` of each row of a stack, unstacked."""
    dims = tuple(range(1, t.dim()))
    return (t / torch.clamp(t.abs().amax(dim=dims, keepdim=True), min=1e-300)).unbind(0)


def _left_move(a, env, x, chi, svd_fn=small_svd):
    """Absorb lattice column ``x`` into the left environment; the new
    ``C1/T4/C4`` replace those of column ``x + 1``.  ``svd_fn`` lets the
    variational layer substitute :func:`~..ops.linalg_ad.svd_safe`.

    The column's rows ride a leading axis ``Y`` (every site of a cell has the
    same leg dims, so every row's tensors have the same shapes): one batched
    contraction and one batched SVD per step instead of one per row."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env
    lx, ly = len(a), len(a[0])
    cc1, ct1, ct4, ca, cc4, ct3 = (torch.stack(part[x]) for part in (c1, t1, t4, a, c4, t3))

    # enlarged corners of every row: Q1[(e d), (c r)] fat down x fat right,
    # Q4[(b u), (h r)] fat up x fat right
    q1 = path_einsum("Yab,Yauc,Yble,Yuldr->Yedcr", cc1, ct1, ct4, ca)
    q4 = path_einsum("Yfg,Ygdh,Yblf,Yuldr->Ybuhr", cc4, ct3, ct4, ca)

    # projectors of the fat bond between rows (y-1, y), from Q1 of the row
    # above and Q4 of the row: Pup absorbed by the upper tensors, Plo by the
    # lower
    q1m = torch.roll(q1, 1, dims=0)
    q1m = q1m.reshape(ly, q1m.shape[1] * q1m.shape[2], q1m.shape[3] * q1m.shape[4])
    q4m = q4.reshape(ly, q4.shape[1] * q4.shape[2], q4.shape[3] * q4.shape[4])
    f = q1m.transpose(1, 2) @ q4m
    uu, ss, vh = svd_fn(f)
    k = min(chi, f.shape[1], f.shape[2])
    uu, ss, vh = uu[..., :k], ss[..., :k], vh[..., :k, :]
    isq = torch.where(ss > _SVD_TOL * ss[:, :1],
                      1.0 / torch.sqrt(torch.clamp(ss, min=1e-300)),
                      torch.zeros_like(ss)).to(f.dtype)[:, None, :]
    pup = (q4m @ vh.conj().transpose(1, 2)) * isq
    plo = (q1m @ uu.conj()) * isq

    c1t = peinsum("Yab,Yauc->Ycbu", cc1, ct1)
    c1n = c1t.reshape(ly, c1t.shape[1], -1) @ pup
    t4t = peinsum("Yble,Yuldr->Ybured", ct4, ca)
    t4t = t4t.reshape(ly, t4t.shape[1] * t4t.shape[2], t4t.shape[3],
                      t4t.shape[4] * t4t.shape[5])
    t4n = path_einsum("Ybk,Ybqe,Yem->Ykqm", plo, t4t, torch.roll(pup, -1, dims=0))
    c4t = peinsum("Yfg,Ygdh->Yfdh", cc4, ct3)
    c4n = torch.roll(plo, -1, dims=0).transpose(1, 2) @ c4t.reshape(ly, -1, c4t.shape[3])
    new_c1, new_t4, new_c4 = _norm_rows(c1n), _norm_rows(t4n), _norm_rows(c4n)

    xn = (x + 1) % lx

    def repl(old, new_col):
        return tuple(tuple(new_col[y] if xx == xn else old[xx][y] for y in range(ly))
                     for xx in range(lx))

    return (repl(c1, new_c1), c2, c3, repl(c4, new_c4),
            t1, t2, t3, repl(t4, new_t4))


# lattice rotation u->l, l->d, d->r, r->u (cell: new[x', y'] = old[(-y') % Lx, x'])


def _rot_cell(old, legperm=None):
    lx, ly = len(old), len(old[0])

    def get(xp, yp):
        t = old[(-yp) % lx][xp]
        return t.permute(legperm) if legperm else t

    return _cell(get, ly, lx)


def rotate(a, env):
    """Rotate the whole state one quarter turn; four applications are the
    identity."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env
    return _rot_cell(a, (3, 0, 1, 2)), (
        _rot_cell(c2, (1, 0)),     # C1' <- C2 swapped
        _rot_cell(c3),             # C2' <- C3
        _rot_cell(c4, (1, 0)),     # C3' <- C4 swapped
        _rot_cell(c1),             # C4' <- C1
        _rot_cell(t2),             # T1' <- T2
        _rot_cell(t3, (2, 1, 0)),  # T2' <- T3 reversed
        _rot_cell(t4),             # T3' <- T4
        _rot_cell(t1, (2, 1, 0)),  # T4' <- T1 reversed
    )


def _iteration(a, env, chi, svd_fn=small_svd):
    """One full CTMRG iteration: left, up, right, down sweeps."""
    for _ in range(4):
        for x in range(len(a)):
            env = _left_move(a, env, x, chi, svd_fn=svd_fn)
        a, env = rotate(a, env)
    return env


def _converge(a, env, chi, iters):
    for _ in range(int(iters)):
        env = _iteration(a, env, chi)
    return env


def _signature(env):
    return tuple(tuple(t.shape) for part in env for col in part for t in col)


def _grow(a, chi):
    """The seed environment grown until no leg changes width."""
    env = init_env(a)
    prev = None
    while _signature(env) != prev:
        prev = _signature(env)
        env = _iteration(a, env, chi)
    return env


def ctmrg_cell(a, chi, iters=100):
    """Converged directional-CTMRG environment of the unit cell ``a``.

    Args:
        a: nested sequence ``a[x][y]`` of site tensors ``(q, q, q, q)`` in
            ``(up, left, down, right)`` order (dims equal per axis across
            the cell; no symmetry needed).  Torch tensors keep their device;
            numpy arrays go to ``cuda``.
        chi: environment bond dimension.
        iters: fixed-point iterations at full width.

    Returns:
        ``(C1, C2, C3, C4, T1, T2, T3, T4)``, each a nested tuple indexed
        ``[x][y]`` like ``a``.
    """
    a = _as_cell(a)
    return _converge(a, _grow(a, chi), chi, iters)


# --------------------------------------------------------------------- #
# Observables
# --------------------------------------------------------------------- #


def _imp(t, like):
    # promote, never narrow (a complex impurity on a real cell)
    return as_tensor(t, like.device)


def site_expectation(a, env, impurity, x=0, y=0):
    """``<impurity> / <a>`` at cell site ``(x, y)`` inside the converged
    environment (the 3x3 ring patch)."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env

    def ring(center):
        return path_einsum("ab,auc,ce,blf,uldr,erg,fh,hdi,gi->",
                           c1[x][y], t1[x][y], c2[x][y], t4[x][y], center,
                           t2[x][y], c4[x][y], t3[x][y], c3[x][y])

    return ring(_imp(impurity, a[x][y])) / ring(a[x][y])


def pair_weight_h(a, env, left_center, right_center, x=0, y=0):
    """Weight of the horizontal 1x2 patch over sites ``(x, y)`` and
    ``(x+1, y)`` with the given center tensors substituted."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env
    x2 = (x + 1) % len(a)
    return path_einsum(
        "ab,auc,cve,ef,blg,uldw,vwyr,frh,gi,idj,jyk,hk->",
        c1[x][y], t1[x][y], t1[x2][y], c2[x2][y], t4[x][y],
        left_center, right_center, t2[x2][y], c4[x][y], t3[x][y],
        t3[x2][y], c3[x2][y])


def pair_expectation_h(a, env, left_imp, right_imp, x=0, y=0):
    """``<left_imp right_imp> / <a a>`` on the horizontal bond
    ``(x, y) - (x+1, y)``."""
    x2 = (x + 1) % len(a)
    num = pair_weight_h(a, env, _imp(left_imp, a[x][y]), _imp(right_imp, a[x][y]), x, y)
    return num / pair_weight_h(a, env, a[x][y], a[x2][y], x, y)


# --------------------------------------------------------------------- #
# Row correlators and 2D correlation lengths
# --------------------------------------------------------------------- #


def _row_start(env, center, x, y):
    """Left cap ``[C1 T1; T4 center; C4 T3]`` -> open ``(top, q, bot)``
    channel vector."""
    c1, _, _, c4, t1, _, t3, t4 = env
    return path_einsum("ab,auc,blg,uldr,gi,idj->crj",
                       c1[x][y], t1[x][y], t4[x][y], center, c4[x][y], t3[x][y])


def _row_apply(env, a, vec, x, y):
    """Absorb one interior column ``[T1; a; T3]`` into the channel."""
    _, _, _, _, t1, _, t3, _ = env
    t = peinsum("crj,cve->vrje", vec, t1[x][y])
    t = peinsum("vrje,vrys->jeys", t, a[x][y])
    return peinsum("jeys,jyk->esk", t, t3[x][y])


def _row_end(env, center, vec, x, y):
    """Close the channel with ``[T1 C2; center T2; T3 C3]``."""
    _, c2, c3, _, t1, t2, t3, _ = env
    return path_einsum("crj,cve,ef,vrys,fsh,jyk,hk->",
                       vec, t1[x][y], c2[x][y], center, t2[x][y], t3[x][y], c3[x][y])


def row_correlator(a, env, imp1, imp2, distances, x=0, y=0, connected=True,
                   mid=None):
    """``<imp1_(x,y) imp2_(x+r,y)>`` along a row, for each ``r`` in
    ``distances`` (``r >= 1``), inside the converged environment.

    One left cap, ``r - 1`` column absorptions and one right cap per
    distance, the channel reused incrementally (cost ``O(max(distances))``).
    ``connected=True`` subtracts ``<imp1> <imp2>``.  ``mid`` (nested
    ``[x][y]`` like ``a``) substitutes the intervening columns of the
    numerator sweep (the string channel of fermionic correlators); the
    denominator always uses ``a``.  ``imp2`` may be a nested ``[x][y]`` grid
    (the impurity of the cell position the distance lands on) or one
    tensor used everywhere.  Returns a list of 0-d tensors.
    """
    lx = len(a)
    distances = [int(r) for r in distances]
    if any(r < 1 for r in distances):
        raise ValueError("row_correlator needs distances >= 1")
    like = a[0][0]
    imp1 = _imp(imp1, like)
    if isinstance(imp2, (tuple, list)):
        imp2_at = tuple(tuple(_imp(t, like) for t in col) for col in imp2)
    else:
        i2 = _imp(imp2, like)
        imp2_at = tuple(tuple(i2 for _ in col) for col in a)

    def sweep(center1, center2_of, between):
        vec = _row_start(env, center1, x, y)
        out = {}
        for r in range(1, max(distances) + 1):
            xe = (x + r) % lx
            if r in distances:
                out[r] = _row_end(env, center2_of(xe), vec, xe, y)
            if r < max(distances):
                vec = _row_apply(env, between, vec, xe, y)
        return out

    num = sweep(imp1, lambda xe: imp2_at[xe][y], a if mid is None else mid)
    den = sweep(a[x][y], lambda xe: a[xe][y], a)
    if connected:
        e1 = site_expectation(a, env, imp1, x, y)
        e2_cache = {}
    vals = []
    for r in distances:
        val = num[r] / den[r]
        if connected:
            xe = (x + r) % lx
            if xe not in e2_cache:
                e2_cache[xe] = site_expectation(a, env, imp2_at[xe][y], xe, y)
            val = val - e1 * e2_cache[xe]
        vals.append(val)
    return vals


def row_transfer_spectrum(a, env, y=0, iters=40):
    """Leading two eigenvalues of the row-channel transfer operator (the
    product of the cell's ``Lx`` column maps) and the 2D correlation length
    along the row, ``xi = -Lx / log |lam2/lam1|`` (lattice units; ``inf``
    when degenerate).

    Arnoldi (:func:`~..ops.krylov.arnoldi_eigs`): the ``iters`` transfer
    matvecs run on the cell's device, only the small Hessenberg
    eigenproblem on the host.  Returns ``(numpy [lam1, lam2], xi)``.
    """
    from ..ops.krylov import arnoldi_eigs

    lx = len(a)
    _, _, _, _, t1, _, t3, _ = env
    shp = (t1[0][y].shape[0], a[0][y].shape[1], t3[0][y].shape[0])

    def apply_m(vec):
        for x in range(lx):
            vec = _row_apply(env, a, vec, x, y)
        return vec

    like = a[0][y]
    n = int(np.prod(shp))
    v0 = torch.ones(shp, dtype=like.dtype, device=like.device)
    v0 = v0 + 0.3 * torch.arange(n, dtype=like.dtype, device=like.device).reshape(shp) / n
    vals, _ = arnoldi_eigs(apply_m, v0, int(iters), k=2)
    lam1, lam2 = complex(vals[0]), complex(vals[1])
    ratio = abs(lam2) / abs(lam1) if lam1 else 0.0
    xi = float("inf") if ratio >= 1.0 - 1e-12 or ratio == 0.0 else -lx / np.log(ratio)
    return np.asarray([lam1, lam2]), float(xi)
