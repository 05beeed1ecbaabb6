"""iPEPS full update: environment-metric bond truncation (checkerboard).

Counterpart of ``contractn_tpu/models/full_update.py``.  The simple update
(:mod:`.ipeps_cell`) truncates each gated bond in the mean-field metric of
its bond weights; the full update (Jordan-Orus-Vidal, with the fast-full-
update environment recycling of Phien et al.) truncates every Trotter gate
in the metric of the true CTMRG environment of its bond.  Per bond:

1. **Reduced split.**  QR splits leave only the (physical, bond-leg)
   factors ``aR (k, d, D)`` / ``bR (k, d, D)`` in the gate; the isometric
   spectators ``X (u, l, dn, k)`` and ``Y (u, dn, r, k)`` stay fixed.
2. **Bond metric.**  The 1x2 ring patch with the double layers of ``X`` and
   ``Y`` and the four reduced-bond legs open, ``N[m, M, n, N]``, made
   Hermitian and eigen-clipped to its positive approximant.
3. **Gated ALS truncation.**  ``theta = gate (aR . bR)`` truncated to rank
   ``D`` by alternating least squares in the metric; the normal equations
   are solved by eigh pseudo-inverse (relative cutoff ``_PINV_TOL``).
4. **Recycle.**  ``X aR'`` / ``Y bR'`` replace the sites and the standing
   environment is refreshed with ``n_ctm`` CTMRG iterations.

Only the horizontal A-B bond is coded: B-A is the same patch one cell column
over, and the vertical orientations ride one lattice rotation of state and
environment.  A Trotter stage is a plain loop on the device (the JAX
package's jitted ``fori_loop``); the eighs go through
:func:`~..ops.linalg_ad.dense_eigh` (the CPU build's MKL driver can raise on
the degenerate spectra these metrics have).
"""

import torch

from ..ops.linalg_ad import dense_eigh, small_svd
from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .ctmrg_cell import _iteration, ctmrg_cell, rotate
from .ipeps_cell import (_VPERM, cell_energy_from_env, checkerboard_cell,
                         simple_update_cell, su_cell_absorb)

_PINV_TOL = 1e-12  # relative eigenvalue cutoff for metric pseudo-inverses


def _norm(t):
    return t / torch.clamp(t.abs().max(), min=1e-300)


def _h(m):
    return m.conj().transpose(0, 1)


# reduced splits (QR): spectator isometry x (phys, bond-leg) factor


def _split_right(t):
    """``t (s,u,l,dn,r) = X (u,l,dn,k) . aR (k,s,r)`` (right-bond role)."""
    d, u, l, dn, r = t.shape
    q, rr = torch.linalg.qr(t.permute(1, 2, 3, 0, 4).reshape(u * l * dn, d * r))
    k = q.shape[1]
    return q.reshape(u, l, dn, k), rr.reshape(k, d, r)


def _split_left(t):
    """``t (s,u,l,dn,r) = Y (u,dn,r,k) . bR (k,s,l)`` (left-bond role)."""
    d, u, l, dn, r = t.shape
    q, rr = torch.linalg.qr(t.permute(1, 3, 4, 0, 2).reshape(u * dn * r, d * l))
    k = q.shape[1]
    return q.reshape(u, dn, r, k), rr.reshape(k, d, l)


def _open_right_dbl(x):
    """Double layer of ``X (u,l,dn,k)`` with the ``(k, k*)`` pair open:
    ``(q_u, q_l, q_d, k, k*)``."""
    u, l, dn, k = x.shape
    return peinsum("uldk,ULDK->uUlLdDkK", x, x.conj()).reshape(u * u, l * l, dn * dn, k, k)


def _open_left_dbl(y):
    """Double layer of ``Y (u,dn,r,k)``: ``(q_u, q_d, q_r, k, k*)``."""
    u, dn, r, k = y.shape
    return peinsum("udrk,UDRK->uUdDrRkK", y, y.conj()).reshape(u * u, dn * dn, r * r, k, k)


def _bond_env(env, x, y, xx, yy, lx):
    """``N[m, M, n, N]``: the 1x2 ring patch of ``pair_weight_h`` with the
    reduced-bond double layers substituted and their ``(ket, bra)`` legs open
    (``m, M`` on the left site, ``n, N`` on the right)."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env
    x2 = (x + 1) % lx
    return path_einsum(
        "ab,auc,cve,ef,blg,uldmM,vyrnN,frh,gi,idj,jyk,hk->mMnN",
        c1[x][y], t1[x][y], t1[x2][y], c2[x2][y], t4[x][y],
        xx, yy, t2[x2][y], c4[x][y], t3[x][y], t3[x2][y], c3[x2][y])


def _metric(nmat):
    """Positive approximant ``g4[m, n, M, N]`` of the bond environment:
    Hermitian over (ket pair, bra pair), eigh, negatives clipped to zero,
    normalized to unit spectral radius."""
    k1, k2 = nmat.shape[0], nmat.shape[2]
    m = nmat.permute(0, 2, 1, 3).reshape(k1 * k2, k1 * k2)
    m = 0.5 * (m + _h(m))
    m = m / torch.clamp(m.abs().max(), min=1e-300)
    w, v = dense_eigh(m)
    w = torch.clamp(w, min=0.0)
    g = (v * w.to(v.dtype)[None, :]) @ _h(v)
    return g.reshape(k1, k2, k1, k2)


def _psolve(h, rhs):
    """``h x = rhs`` for Hermitian PSD ``h`` by eigh pseudo-inverse (relative
    cutoff: the normal matrix is singular whenever the environment does not
    resolve the reduced bond space)."""
    w, v = dense_eigh(h)
    wmax = torch.clamp(w.abs().max(), min=1e-300)
    inv = torch.where(w > _PINV_TOL * wmax, 1.0 / torch.clamp(w, min=1e-300),
                      torch.zeros_like(w))
    return v @ (inv.to(v.dtype)[:, None] * (_h(v) @ rhs))


def _als_truncate(g4, theta, bond, n_als):
    """Rank-``bond`` pair ``aR (m,s,a), bR (n,t,a)`` minimizing ``|theta -
    aR.bR|^2`` in the metric ``g4[m,n,M,N] (x) 1_{s,t}``: seeded by the
    truncated SVD of ``theta``, then ``n_als`` sweeps of the two
    normal-equation solves."""
    k1, d, _, k2 = theta.shape
    u, s, vh = small_svd(theta.reshape(k1 * d, d * k2))
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    rs = torch.sqrt(s).to(u.dtype)
    ar = (u * rs[None, :]).reshape(k1, d, bond)
    br = (rs[:, None] * vh).reshape(bond, d, k2).permute(2, 1, 0)

    for _ in range(n_als):
        # aR with bR held
        bp = peinsum("nta,Ntb->nNab", br, br.conj())
        rmat = peinsum("mnMN,nNab->Mbma", g4, bp)
        rhs = path_einsum("mnMN,mstn,Ntb->Mbs", g4, theta, br.conj())
        sol = _psolve(rmat.reshape(k1 * bond, k1 * bond), rhs.reshape(k1 * bond, d))
        ar = sol.reshape(k1, bond, d).permute(0, 2, 1)
        # bR with aR held
        ap = peinsum("msa,Msb->mMab", ar, ar.conj())
        rmat = peinsum("mnMN,mMab->Nbna", g4, ap)
        rhs = path_einsum("mnMN,mstn,Msb->Nbt", g4, theta, ar.conj())
        sol = _psolve(rmat.reshape(k2 * bond, k2 * bond), rhs.reshape(k2 * bond, d))
        br = sol.reshape(k2, bond, d).permute(0, 2, 1)
    return ar, br


def _bond_update(a, b, env, gate4, x, bond, n_als):
    """Gate + environment-metric truncation of the horizontal bond at cell
    column ``x`` (row 0): ``x = 0`` is A.r--B.l, ``x = 1`` B.r--A.l."""
    left, right = (a, b) if x == 0 else (b, a)
    xs, ar = _split_right(left)
    ys, br = _split_left(right)
    g4 = _metric(_bond_env(env, x, 0, _open_right_dbl(xs), _open_left_dbl(ys), 2))
    theta = peinsum("msc,ntc->mstn", ar, br)
    theta = peinsum("STst,mstn->mSTn", gate4, theta)
    ar, br = _als_truncate(g4, theta, bond, n_als)
    new_left = _norm(peinsum("uldk,ksr->suldr", xs, ar))
    new_right = _norm(peinsum("udrk,ksl->suldr", ys, br))
    return (new_left, new_right) if x == 0 else (new_right, new_left)


def _fu_step(a, b, env, gate4, chi, bond, n_als, n_ctm):
    """One Trotter step: all four bond orientations (two in the native
    frame, two in the once-rotated one), the environment refreshed after
    every bond."""
    for frame in range(4):
        if frame < 2:
            for x in (0, 1):
                a, b = _bond_update(a, b, env, gate4, x, bond, n_als)
                cell = checkerboard_cell(a, b)
                for _ in range(n_ctm):
                    env = _iteration(cell, env, chi)
        # rotate into the next frame (four quarter turns = identity)
        _, env = rotate(checkerboard_cell(a, b), env)
        a, b = a.permute(_VPERM), b.permute(_VPERM)
    return a, b, env


def _fu_stage(a, b, env, gate4, n_iter, chi, bond, n_als, n_ctm):
    for _ in range(int(n_iter)):
        a, b, env = _fu_step(a, b, env, gate4, chi, bond, n_als, n_ctm)
    return a, b, env


def full_update_cell(h2, bond_dim, chi, d=2,
                     schedule=((0.05, 30), (0.01, 30)),
                     su_schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                     n_als=6, n_ctm=1, ctm_iters=60,
                     dtype=torch.float64, init=None):
    """Checkerboard fast-full-update imaginary-time flow.

    Args:
        h2: swap-symmetric nearest-neighbor bond term ``(d^2, d^2)`` (a torch
            tensor keeps its device, with ``init``'s; numpy goes to
            ``cuda``).
        bond_dim: PEPS virtual dimension D.
        chi: environment dimension of the standing CTMRG metric.
        schedule: ``((dt, n_steps), ...)`` full-update Trotter ladder.
        su_schedule: simple-update warm-start ladder (skipped when ``init``
            supplies ``(a_site, b_site)``).
        n_als: ALS sweeps per bond.
        n_ctm: CTMRG refresh iterations per bond.
        ctm_iters: iterations of the initial environment convergence.

    Returns:
        ``(a_site, b_site, env)``: the updated pair and its standing
        environment.
    """
    from .itebd import two_site_gate

    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,) + (tuple(init) if init is not None else ()))
    h2 = as_tensor(h2, device, dtype)
    if init is None:
        ga, gb, lams = simple_update_cell(h2, bond_dim, d=d, schedule=su_schedule,
                                          dtype=dtype)
        a, b = su_cell_absorb(ga, gb, lams)
    else:
        a, b = (as_tensor(t, device, dtype) for t in init)
    a, b = _norm(a), _norm(b)
    env = ctmrg_cell(checkerboard_cell(a, b), chi, iters=ctm_iters)
    for dt, n_iter in schedule:
        gate4 = two_site_gate(h2, dt).reshape(d, d, d, d)
        a, b, env = _fu_stage(a, b, env, gate4, n_iter, chi, bond_dim, n_als, n_ctm)
    return a, b, env


def full_update_ground_state(h2, bond_dim, chi, d=2,
                             schedule=((0.05, 30), (0.01, 30)),
                             iters=150, **kwargs):
    """Ground state by fast full update; the energy is measured in a FRESHLY
    converged environment (never the recycled one).

    Returns ``(a_site, b_site, energy_per_site)`` (a 0-d tensor).
    """
    a, b, _ = full_update_cell(h2, bond_dim, chi, d=d, schedule=schedule, **kwargs)
    cell = checkerboard_cell(a, b)
    env = ctmrg_cell(cell, chi, iters=iters)
    return a, b, cell_energy_from_env(a, b, h2, cell, env)
