"""Multi-site-cell VUMPS: uniform ground states with native unit cells.

Counterpart of ``contractn_tpu/models/vumps_cell.py`` (Zauner-Stauber et
al., "Variational optimization algorithms for uniform matrix product
states", sec. IV):

* per-site mixed gauge ``AL_i, AR_i, AC_i`` with one ``C_i`` per bond (bond
  ``i`` sits LEFT of site ``i``; ``AC_i = AL_i C_{i+1} = C_i AR_i``), from
  a fixed number of QR sweeps around the cell;
* per-bond MPO environments ``FL_i, FR_i``: triangular channels solved
  ascending as in :mod:`.vumps`, each channel's fixed point on bond 0 with
  the CELL transfer (corner channels by the energy-subtracted geometric
  :func:`~..ops.krylov.gmres` against it), then propagated site by site;
* per-site Lanczos updates of ``AC_i`` from ``(FL_i, W_i, FR_{i+1})`` and
  ``C_i`` from ``(FL_i, FR_i)``, polar gauge updates per site.

The corner divergence rate is the energy per CELL; ``energy`` is per site.

Departure: the random start takes a ``torch.Generator`` (``generator=``)
where the JAX package takes a key.
"""

import numpy as np
import torch

from ..ops.krylov import gmres, lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .vumps import _h_ac, _h_c, _polar_left, _qr_pos, _t_dressed, _tr_pair

# --------------------------------------------------------------------- #
# Cell mixed gauge
# --------------------------------------------------------------------- #


def left_gauge_cell(cell, iters=60):
    """``(ALs, Ls)`` for an n-site cell: ``iters`` QR sweeps around the
    cell.  ``Ls[i]`` is the gauge on bond ``i`` (left of site ``i``)."""
    n = len(cell)
    bond = cell[0].shape[1]
    ls = tuple(torch.eye(bond, dtype=cell[0].dtype, device=cell[0].device)
               for _ in range(n))
    als = tuple(torch.zeros_like(a) for a in cell)
    for _ in range(int(iters)):
        lmat = ls[0]
        new_l, new_al = [], []
        for i in range(n):
            d = cell[i].shape[0]
            big = peinsum("ij,djk->dik", lmat, cell[i]).reshape(d * bond, bond)
            q, r = _qr_pos(big)
            r = r / torch.clamp(torch.linalg.norm(r), min=1e-300)
            new_al.append(q.reshape(d, bond, bond))
            new_l.append(r)
            lmat = r
        # new_l[i] is the gauge on bond i+1; roll so Ls[i] = bond i
        ls = tuple([new_l[-1]] + new_l[:-1])
        als = tuple(new_al)
    return als, ls


def right_gauge_cell(cell, iters=60):
    """Mirror: right-isometric ``ARs`` with per-bond gauges ``Rs``."""
    n = len(cell)
    flipped = tuple(cell[n - 1 - i].transpose(1, 2) for i in range(n))
    als, ls = left_gauge_cell(flipped, iters)
    ars = tuple(als[n - 1 - i].transpose(1, 2) for i in range(n))
    # flipped bond j = original bond n - j (mod n)
    rs = tuple(ls[(n - i) % n].T for i in range(n))
    return ars, rs


def mixed_gauge_cell(cell, iters=60):
    """``(ALs, ARs, Cs)`` for an n-site cell; ``Cs[i]`` on bond ``i``,
    gauge-fixed by per-bond SVDs of ``C`` (diagonal bond bases)."""
    n = len(cell)
    als, ls = left_gauge_cell(cell, iters)
    ars, rs = right_gauge_cell(cell, iters)
    us, vhs, cs = [], [], []
    for i in range(n):
        u, s, vh = torch.linalg.svd(peinsum("ij,jk->ik", ls[i], rs[i]))
        s = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
        us.append(u)
        vhs.append(vh)
        cs.append(torch.diag(s.to(cell[0].dtype)))
    new_al = tuple(peinsum("ai,dij,jb->dab", us[i].conj().T, als[i],
                           us[(i + 1) % n]) for i in range(n))
    new_ar = tuple(peinsum("ai,dij,jb->dab", vhs[i], ars[i],
                           vhs[(i + 1) % n].conj().T) for i in range(n))
    return new_al, new_ar, tuple(cs)


# --------------------------------------------------------------------- #
# Cell MPO environments
# --------------------------------------------------------------------- #


def _cell_transfer(cores, x, left=True):
    """Plain cell transfer (identity channel) of the core list."""
    if left:
        for core in cores:
            t = peinsum("ij,djk->dik", x, core)
            x = peinsum("dji,djk->ik", core.conj(), t)
        return x
    for core in reversed(cores):
        t = peinsum("dij,jk->dik", core, x)
        x = peinsum("dik,dlk->il", t, core.conj())
    return x


def _geometric_solve_cell(cores, b, density, left=True, tol=1e-10):
    """Energy-subtracted geometric GMRES against the CELL transfer."""
    eye = torch.eye(cores[0].shape[1], dtype=b.dtype, device=b.device)

    def matvec(x):
        return x - _cell_transfer(cores, x, left=left) + _tr_pair(density, x) * eye

    sol, _ = gmres(matvec, b - _tr_pair(density, b) * eye, tol=tol, atol=0.0,
                   maxiter=200)
    return sol


def _interior_solve_cell(cores, ops, b, left=True, tol=1e-10):
    """``x = b + T_cell^aa(x)`` for a contracting interior diagonal."""
    def dressed(x):
        if left:
            for core, op in zip(cores, ops):
                x = _t_dressed(x, core, op, left=True)
            return x
        for core, op in zip(reversed(cores), reversed(ops)):
            x = _t_dressed(x, core, op, left=False)
        return x

    sol, _ = gmres(lambda x: x - dressed(x), b, tol=tol, atol=0.0, maxiter=200)
    return sol


def _is_identity(ws, a_idx):
    return all(np.allclose(w[:, :, a_idx, a_idx].cpu().numpy(),
                           np.eye(w.shape[0])) for w in ws)


def mpo_environments_cell(als, ars, cs, ws, tol=1e-10):
    """Per-bond environments ``(FLs, FRs, energy_per_cell)``.

    ``FLs[i] (W, D, D)`` summarizes sites ``.. i-1`` (bond ``i``);
    ``FRs[i]`` summarizes sites ``i ..``.  Triangular MPOs with identity
    corners, the same ``W`` on every site.  The energy is a host float."""
    n = len(als)
    nw = ws[0].shape[2]
    if nw < 2:
        raise ValueError("triangular MPO with W >= 2 required")
    bond = als[0].shape[1]
    dt = als[0].dtype
    dev = als[0].device
    eye = torch.eye(bond, dtype=dt, device=dev)
    is_zero = [(w.abs().sum(dim=(0, 1)) == 0).cpu().numpy() for w in ws]

    def zeros():
        return torch.zeros((bond, bond), dtype=dt, device=dev)

    # ---- left: FL[i][a], solve channel a on bond 0, propagate ------- #
    rho_r = peinsum("ij,kj->ik", cs[0], cs[0].conj())
    rho_r = rho_r / torch.trace(rho_r)
    fl = [[None] * nw for _ in range(n)]
    e_left = torch.zeros((), dtype=dt, device=dev)
    for a_idx in range(nw):
        s = zeros()
        for i in range(n):
            nxt = zeros()
            if not is_zero[i][a_idx, a_idx]:
                nxt = _t_dressed(s, als[i], ws[i][:, :, a_idx, a_idx], True)
            for b_idx in range(a_idx):
                if fl[i][b_idx] is not None and not is_zero[i][b_idx, a_idx]:
                    nxt = nxt + _t_dressed(fl[i][b_idx], als[i],
                                           ws[i][:, :, b_idx, a_idx], True)
            s = nxt
        diag_all_zero = all(is_zero[i][a_idx, a_idx] for i in range(n))
        if a_idx == 0:
            fl0 = eye
        elif a_idx == nw - 1 and _is_identity(ws, a_idx):
            e_left = _tr_pair(rho_r, s)
            fl0 = _geometric_solve_cell(als, s, rho_r, left=True, tol=tol)
        elif diag_all_zero:
            fl0 = s
        else:
            fl0 = _interior_solve_cell(als, [w[:, :, a_idx, a_idx] for w in ws],
                                       s, left=True, tol=tol)
        fl[0][a_idx] = fl0
        cur = fl0
        for i in range(n - 1):
            nxt = zeros()
            if not is_zero[i][a_idx, a_idx]:
                nxt = _t_dressed(cur, als[i], ws[i][:, :, a_idx, a_idx], True)
            for b_idx in range(a_idx):
                if not is_zero[i][b_idx, a_idx]:
                    nxt = nxt + _t_dressed(fl[i][b_idx], als[i],
                                           ws[i][:, :, b_idx, a_idx], True)
            if a_idx == 0:
                nxt = cur  # identity channel: FL[i][0] = I everywhere
            fl[i + 1][a_idx] = nxt
            cur = nxt

    # ---- right: FR[i][b], solve on bond 0, propagate backwards ------ #
    rho_l = peinsum("ji,jk->ik", cs[0].conj(), cs[0])
    rho_l = rho_l / torch.trace(rho_l)
    fr = [[None] * nw for _ in range(n)]
    e_right = torch.zeros((), dtype=dt, device=dev)
    for a_idx in range(nw - 1, -1, -1):
        s = zeros()
        for i in range(n - 1, -1, -1):
            nxt = zeros()
            if not is_zero[i][a_idx, a_idx]:
                nxt = _t_dressed(s, ars[i], ws[i][:, :, a_idx, a_idx], False)
            for b_idx in range(a_idx + 1, nw):
                if fr[(i + 1) % n][b_idx] is not None and \
                        not is_zero[i][a_idx, b_idx]:
                    nxt = nxt + _t_dressed(fr[(i + 1) % n][b_idx], ars[i],
                                           ws[i][:, :, a_idx, b_idx], False)
            s = nxt
        diag_all_zero = all(is_zero[i][a_idx, a_idx] for i in range(n))
        if a_idx == nw - 1:
            fr0 = eye
        elif a_idx == 0 and _is_identity(ws, a_idx):
            e_right = _tr_pair(rho_l, s)
            fr0 = _geometric_solve_cell(ars, s, rho_l, left=False, tol=tol)
        elif diag_all_zero:
            fr0 = s
        else:
            fr0 = _interior_solve_cell(ars, [w[:, :, a_idx, a_idx] for w in ws],
                                       s, left=False, tol=tol)
        fr[0][a_idx] = fr0
        cur = fr0
        for i in range(n - 1, 0, -1):
            nxt = zeros()
            if not is_zero[i][a_idx, a_idx]:
                nxt = _t_dressed(cur, ars[i], ws[i][:, :, a_idx, a_idx], False)
            for b_idx in range(a_idx + 1, nw):
                if not is_zero[i][a_idx, b_idx]:
                    nxt = nxt + _t_dressed(fr[(i + 1) % n][b_idx], ars[i],
                                           ws[i][:, :, a_idx, b_idx], False)
            if a_idx == nw - 1:
                nxt = cur
            fr[i][a_idx] = nxt
            cur = nxt

    fls = tuple(torch.stack(fl[i]) for i in range(n))
    frs = tuple(torch.stack(fr[i]) for i in range(n))
    return fls, frs, float(0.5 * torch.real(e_left + e_right))


# --------------------------------------------------------------------- #
# The VUMPS loop
# --------------------------------------------------------------------- #


def _gauge_update_cell(ac, c_left, c_right):
    """Per-site polar gauge update: ``AL_i`` pairs ``AC_i`` with its RIGHT
    bond ``C_{i+1}``, ``AR_i`` with its LEFT bond ``C_i``."""
    d_, bond = ac.shape[0], ac.shape[1]
    al = peinsum("ij,kj->ik", _polar_left(ac.reshape(d_ * bond, bond)),
                 _polar_left(c_right).conj()).reshape(d_, bond, bond)
    ar_mat = _polar_left(ac.transpose(1, 2).reshape(d_ * bond, bond))
    cl = _polar_left(c_left.T)
    ar = peinsum("ij,kj->ik", ar_mat, cl.conj()).reshape(
        d_, bond, bond).transpose(1, 2)
    grad = torch.linalg.norm(ac - peinsum("dij,jk->dik", al, c_right))
    return al, ar, grad


def _cell_dtype(mpo_cores, dtype):
    dtype = torch_dtype(dtype)
    for w in mpo_cores:
        src = w.dtype if isinstance(w, torch.Tensor) else torch_dtype(
            np.asarray(w).dtype)
        dtype = torch.promote_types(dtype, src)
    return dtype


def vumps_cell(mpo_cores, bond_dim, iters=60, dtype=torch.float64,
               lanczos_iters=40, generator=None, tol=1e-12, device=None):
    """Ground state of an infinite period-n chain, natively.

    Args:
        mpo_cores: sequence of n triangular bulk cores ``(d, d, W, W)`` (one
            per cell site; physical dimensions may differ per site).
        bond_dim: uMPS bond dimension (every bond).
        generator: ``torch.Generator`` on ``device`` for the n standard-normal
            start cores (or the global one).
        device: where to compute (default: the cores' device, else ``cuda``).

    Returns a dict with per-site tuples ``als, ars, acs`` and per-bond
    ``cs``, plus ``energy`` (per SITE), ``energies`` and ``gradient_norm``
    (max over sites).
    """
    device = resolve_device(device, tuple(mpo_cores))
    # promote a complex MPO rather than silently dropping its imaginary part
    dtype = _cell_dtype(mpo_cores, dtype)
    ws = [as_tensor(w, device, dtype) for w in mpo_cores]
    n = len(ws)
    cell = tuple(torch.randn((ws[i].shape[0], bond_dim, bond_dim),
                             dtype=dtype, device=device, generator=generator)
                 for i in range(n))
    als, ars, cs = mixed_gauge_cell(cell)
    acs = tuple(peinsum("dij,jk->dik", als[i], cs[(i + 1) % n])
                for i in range(n))

    energies = []
    grad_norm = np.inf
    for _ in range(int(iters)):
        fls, frs, e_cell = mpo_environments_cell(als, ars, cs, ws, tol=tol)
        new_acs = [lanczos_ground(
            lambda t, i=i: _h_ac(fls[i], ws[i], frs[(i + 1) % n], t),
            acs[i], lanczos_iters)[1] for i in range(n)]
        new_c = [lanczos_ground(lambda t, i=i: _h_c(fls[i], frs[i], t), cs[i],
                                lanczos_iters)[1] for i in range(n)]
        new_al, new_ar, grads = [], [], []
        for i in range(n):
            al, ar, grad = _gauge_update_cell(new_acs[i], new_c[i],
                                              new_c[(i + 1) % n])
            new_al.append(al)
            new_ar.append(ar)
            grads.append(grad)
        als, ars = tuple(new_al), tuple(new_ar)
        cs, acs = tuple(new_c), tuple(new_acs)
        grad_norm = float(torch.stack(grads).max())
        energies.append(e_cell / n)
        if grad_norm < 1e-11:
            break

    return {
        "als": als, "ars": ars, "acs": acs, "cs": cs,
        "energy": energies[-1], "energies": energies,
        "gradient_norm": grad_norm,
    }


# --------------------------------------------------------------------- #
# Cell-ground observables
# --------------------------------------------------------------------- #


def _value(x, cplx):
    v = complex(x.item())
    return v if cplx else float(v.real)


def expect_local_cell(ground, op, site):
    """``<O_site>`` on a converged cell ground: the mixed gauge puts the
    norm entirely in ``AC_site``, so no transfer solves are needed."""
    ac = ground["acs"][site % len(ground["acs"])]
    op = as_tensor(op, ac.device, ac.dtype)
    num = peinsum("sab,st,tab->", ac.conj(), op, ac)
    den = peinsum("sab,sab->", ac.conj(), ac)
    return _value(num / den, ac.is_complex())


def correlate_cell(ground, op1, op2, site, distances, string=None):
    """Connected ``<O1_site O2_{site+x}>_c`` on a cell ground for each ``x``
    in ``distances`` (all >= 1), in one pass over the right-canonical
    ``AR`` tensors.  ``string`` (optional ``(d, d)``) acts on the KET on
    every site strictly between the two operators (Jordan-Wigner
    correlators; with a string the disconnected part is not subtracted)."""
    distances = [int(x) for x in distances]
    if any(x < 1 for x in distances):
        raise ValueError("distances must be >= 1")
    acs, ars = ground["acs"], ground["ars"]
    n = len(acs)
    i = site % n
    ac = acs[i]
    op1 = as_tensor(op1, ac.device, ac.dtype)
    op2 = as_tensor(op2, ac.device, ac.dtype)
    nrm = peinsum("sab,sab->", ac.conj(), ac)
    rho = peinsum("sab,st,tac->bc", ac.conj(), op1, ac) / nrm
    e1 = expect_local_cell(ground, op1, i) if string is None else 0.0
    max_x = max(distances)
    out = {}
    for x in range(1, max_x + 1):
        j = (i + x) % n
        if x in distances:
            val = peinsum("bc,sbd,st,tcd->", rho, ars[j].conj(), op2, ars[j])
            out[x] = complex(val.item()) - (
                e1 * expect_local_cell(ground, op2, j) if string is None else 0.0)
        if x < max_x:
            ket = ars[j] if string is None else peinsum(
                "st,tbf->sbf", as_tensor(string, ac.device, ac.dtype), ars[j])
            rho = peinsum("bc,sbd,scf->df", rho, ars[j].conj(), ket)
    cplx = ac.is_complex()
    return [out[x] if cplx else float(np.real(out[x])) for x in distances]


def static_structure_factor_cell(ground, op, kappas, max_distance=60):
    """``S(kappa) = sum_x e^{i kappa x} <O_j O_{j+x}>_c`` averaged over the
    cell base sites (``kappa`` the PER-SITE momentum): connected correlators
    out to ``max_distance`` from each base site, cosine-transformed."""
    acs = ground["acs"]
    n = len(acs)
    op = as_tensor(op, acs[0].device, acs[0].dtype)
    op2 = peinsum("st,tu->su", op, op)
    xs = list(range(1, int(max_distance) + 1))
    scalar_in = np.ndim(kappas) == 0
    kappas = np.atleast_1d(np.asarray(kappas, float))
    acc = np.zeros(kappas.shape)
    for i in range(n):
        m1 = expect_local_cell(ground, op, i)
        m2 = expect_local_cell(ground, op2, i)
        c0 = np.real(m2 - m1 * m1)
        cx = np.real(np.asarray(correlate_cell(ground, op, op, i, xs)))
        acc = acc + c0 + 2.0 * np.matmul(np.cos(np.outer(kappas, xs)), cx)
    out = acc / n
    return float(out[0]) if scalar_in else out
