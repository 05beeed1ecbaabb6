"""Native multi-site-cell quasiparticle excitations.

Counterpart of ``contractn_tpu/models/excitations_cell.py``: the multi-site
tangent ansatz (Vanderstraeten-Haegeman-Verstraete review, non-trivial unit
cells) on a :func:`~.vumps_cell.vumps_cell` ground state,

    ``|Phi_K({B})> = sum_m e^{iKm} sum_i  ... AL [B_i]_{cell m} AR ...``

one left-gauge-fixed perturbation per cell site (``B_i = VL_i X_i``), so the
variational problem is one Hermitian eigenproblem over the concatenated
``X = (X_0 .. X_{n-1})`` at CELL momentum ``K``.  Per bra site the
effective Hamiltonian keeps the single-site structure: the on-site map plus
excitation environments summing every ket-``B_j`` placement strictly
left/right, built like the ground-state cell environments (one-cell source
accumulation, a momentum-phased geometric GMRES against the CELL mixed
transfer on bond 0, then intra-cell propagation).  Each diagonal block is
offset by its own site's ground Rayleigh quotient ``lam_i``.

As in :mod:`.excitations`, the JAX package's ``vmap`` over the tangent
basis (the dense ``H_eff`` and the spectral-weight overlaps) is a leading
batch axis here: every environment solve is ONE batched
:func:`~..ops.krylov.gmres` over all basis vectors.

Departure: :func:`excitation_minimum_cell` takes a ``torch.Generator``
(``generator=``) for its Lanczos start where the JAX package takes a key.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_ground
from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor
from .excitations import _fro, _null_space_left, _phase_solve, _power_pair
from .vumps import _h_ac, _t_mix_left, _t_mix_right


def _lb_cell(als, ars, c0, fls, ws, bs, k, is_zeros, diag_prod_zero,
             eye_diag_cell, tol=1e-10):
    """Per-bond left excitation environments ``LB_i (..., W, D, D)``: every
    ket-``B`` placement strictly left of bond ``i`` (bra ``AL``, ket ``AR``
    after its ``B``), ``e^{-iK}`` per cell wrap; ``bs`` batched."""
    n = len(als)
    nw = ws[0].shape[2]
    ph = complex(np.exp(-1j * k))
    zero = torch.zeros(bs[0].shape[:-3] + bs[0].shape[-2:], dtype=bs[0].dtype,
                       device=bs[0].device)
    lb = [[None] * nw for _ in range(n)]

    def site_step(x, i, ch, lb_i):
        """One site of the affine cell map for channel ``ch``: diagonal
        transfer of ``x`` + lower-channel feeds + ``B_i`` insertion."""
        nxt = zero
        if not is_zeros[i][ch][ch]:
            nxt = _t_mix_left(x, als[i], ars[i], ws[i][:, :, ch, ch])
        for a in range(ch):
            if not is_zeros[i][a][ch]:
                nxt = nxt + _t_mix_left(lb_i[a], als[i], ars[i],
                                        ws[i][:, :, a, ch])
        for a in range(ch + 1):
            if not is_zeros[i][a][ch]:
                nxt = nxt + _t_mix_left(fls[i][a], als[i], bs[i],
                                        ws[i][:, :, a, ch])
        return nxt

    for ch in range(nw):
        s = zero
        for i in range(n):
            s = site_step(s, i, ch, lb[i])
        if diag_prod_zero[ch]:
            lb[0][ch] = ph * s
        else:
            def dcell(x, ch=ch):
                for i in range(n):
                    x = _t_mix_left(x, als[i], ars[i], ws[i][:, :, ch, ch])
                return x

            lb[0][ch] = _phase_solve(dcell, ph * s, ph,
                                     pvec=c0 if eye_diag_cell[ch] else None,
                                     tol=tol)
        cur = lb[0][ch]
        for i in range(n - 1):
            cur = site_step(cur, i, ch, lb[i])
            lb[i + 1][ch] = cur
    return [torch.stack(lb[i], dim=-3) for i in range(n)]


def _rb_cell(als, ars, c0, frs, ws, bs, k, is_zeros, diag_prod_zero,
             eye_diag_cell, tol=1e-10):
    """Per-bond right excitation environments ``RB_i``: ket-``B`` strictly
    right of bond ``i`` (bra ``AR``, ket ``AL`` before its ``B``); phases
    relative to the cell whose left edge is the bond (callers add
    ``e^{+iK}`` when wrapping bond ``n`` to 0)."""
    n = len(als)
    nw = ws[0].shape[2]
    ph = complex(np.exp(+1j * k))
    zero = torch.zeros(bs[0].shape[:-3] + bs[0].shape[-2:], dtype=bs[0].dtype,
                       device=bs[0].device)
    rb = [[None] * nw for _ in range(n)]

    def site_step(x, i, ch):
        nxt = zero
        if not is_zeros[i][ch][ch]:
            nxt = _t_mix_right(x, ars[i], als[i], ws[i][:, :, ch, ch])
        for b in range(ch + 1, nw):
            if not is_zeros[i][ch][b]:
                rbn = rb[i + 1][b] if i < n - 1 else ph * rb[0][b]
                nxt = nxt + _t_mix_right(rbn, ars[i], als[i], ws[i][:, :, ch, b])
        for b in range(ch, nw):
            if not is_zeros[i][ch][b]:
                nxt = nxt + _t_mix_right(frs[(i + 1) % n][b], ars[i], bs[i],
                                         ws[i][:, :, ch, b])
        return nxt

    for ch in range(nw - 1, -1, -1):
        s = zero
        for i in range(n - 1, -1, -1):
            s = site_step(s, i, ch)
        if diag_prod_zero[ch]:
            rb[0][ch] = s
        else:
            def dcell(x, ch=ch):
                for i in range(n - 1, -1, -1):
                    x = _t_mix_right(x, ars[i], als[i], ws[i][:, :, ch, ch])
                return x

            rb[0][ch] = _phase_solve(dcell, s, ph,
                                     pvec=c0 if eye_diag_cell[ch] else None,
                                     tol=tol)
        for i in range(n - 1, 0, -1):
            rb[i][ch] = site_step(ph * rb[0][ch] if i == n - 1
                                  else rb[i + 1][ch], i, ch)
    return [torch.stack(rb[i], dim=-3) for i in range(n)]


def _heff_b_cell(bs, p, k, tol):
    """The cell effective Hamiltonian on full per-site ``B`` tensors
    (batched), each site's regularization constant NOT yet subtracted."""
    als, ars, ws, fls, frs = p["als"], p["ars"], p["ws"], p["fls"], p["frs"]
    n = len(als)
    args = (p["is_zeros"], p["diag_prod_zero"], p["eye_diag_cell"])
    lbs = _lb_cell(als, ars, p["cs"][0], fls, ws, bs, k, *args, tol=tol)
    rbs = _rb_cell(als, ars, p["cs"][0], frs, ws, bs, k, *args, tol=tol)
    ph_r = complex(np.exp(+1j * k))
    outs = []
    for i in range(n):
        out = _h_ac(fls[i], ws[i], frs[(i + 1) % n], bs[i])
        out = out + _h_ac(lbs[i], ws[i], frs[(i + 1) % n], ars[i])
        rbu = rbs[(i + 1) % n] if i < n - 1 else ph_r * rbs[0]
        outs.append(out + _h_ac(fls[i], ws[i], rbu, als[i]))
    return outs


def _split_x(xv, p):
    """Per-site ``B_i (..., d_i, D, D)`` from concatenated tangent
    coordinates ``xv (..., sum_i (d_i - 1) D)`` rows of ``D``."""
    bond = p["als"][0].shape[1]
    bs, lo = [], 0
    for vl, al in zip(p["vls"], p["als"]):
        n_t = vl.shape[1]
        x = xv[..., lo:lo + n_t * bond].reshape(xv.shape[:-1] + (n_t, bond))
        bs.append(peinsum("ij,...jk->...ik", vl, x).reshape(
            xv.shape[:-1] + tuple(al.shape)))
        lo += n_t * bond
    return bs


def _dense_heff_cell(p, k, tol=1e-10):
    """Dense ``H_eff(K)`` over the concatenated tangent basis (every basis
    vector as one batch), each diagonal block shifted by its own
    regularization constant."""
    bond = p["als"][0].shape[1]
    dims = [vl.shape[1] * bond for vl in p["vls"]]
    m = sum(dims)
    basis = torch.eye(m, dtype=p["cdt"], device=p["als"][0].device)
    outs = _heff_b_cell(_split_x(basis, p), p, k, tol)
    cols = torch.cat([
        peinsum("ji,...jk->...ik", vl.conj(),
                o.reshape((m, vl.shape[0], bond))).reshape(m, -1)
        for vl, o in zip(p["vls"], outs)], dim=-1)
    h = cols.T
    shift = torch.cat([torch.full((dims[i],), p["lams"][i], dtype=h.dtype,
                                  device=h.device) for i in range(len(dims))])
    h = h - torch.diag(shift)
    return 0.5 * (h + h.conj().T)


def prepare_excitations_cell(ground, mpo_cores, tol=1e-10):
    """Momentum-independent preparation: energy-subtracted complex MPO
    cores, ground cell environments, per-site tangent bases and
    regularization constants, static sparsity flags."""
    from .vumps_cell import mpo_environments_cell

    als, ars, cs, acs = ground["als"], ground["ars"], ground["cs"], ground["acs"]
    n = len(als)
    dev = als[0].device
    e_site = ground["energy"]
    cdt = torch.promote_types(als[0].dtype, torch.complex64)
    ws = []
    for i in range(n):
        w = as_tensor(mpo_cores[i], dev).clone()
        d = w.shape[0]
        w[:, :, 0, -1] = w[:, :, 0, -1] - e_site * torch.eye(
            d, dtype=w.dtype, device=dev)
        ws.append(w.to(cdt))
    als = tuple(a.to(cdt) for a in als)
    ars = tuple(a.to(cdt) for a in ars)
    cs = tuple(c.to(cdt) for c in cs)
    acs = tuple(a.to(cdt) for a in acs)
    fls, frs, _ = mpo_environments_cell(als, ars, cs, ws, tol=tol)
    vls = tuple(_null_space_left(als[i]) for i in range(n))
    nw = ws[0].shape[2]
    ws_np = [w.cpu().numpy() for w in ws]
    is_zeros = tuple(
        tuple(tuple(bool(v) for v in row)
              for row in (np.abs(w).sum(axis=(0, 1)) == 0.0))
        for w in ws_np)
    diag_prod_zero = tuple(any(is_zeros[i][ch][ch] for i in range(n))
                           for ch in range(nw))
    eye_diag_cell = tuple(
        all(np.allclose(w[:, :, ch, ch], np.eye(w.shape[0])) for w in ws_np)
        for ch in range(nw))
    lams = tuple(
        float(torch.real((acs[i].conj()
                          * _h_ac(fls[i], ws[i], frs[(i + 1) % n], acs[i])).sum()
                         / (acs[i].conj() * acs[i]).sum()))
        for i in range(n))
    return {
        "als": als, "ars": ars, "cs": cs, "acs": acs,
        "ws": tuple(ws), "fls": fls, "frs": frs, "vls": vls,
        "is_zeros": is_zeros, "diag_prod_zero": diag_prod_zero,
        "eye_diag_cell": eye_diag_cell, "lams": lams, "cdt": cdt,
    }


def excitation_spectrum_cell(ground, mpo_cores, k, tol=1e-10, prep=None):
    """All quasiparticle bands at CELL momentum ``k`` above a
    :func:`~.vumps_cell.vumps_cell` ground state (a per-site momentum
    ``kappa`` maps to ``k = n * kappa``).  ``prep`` (from
    :func:`prepare_excitations_cell`) is reused across momenta.

    Returns an ascending ``(sum_i (d_i - 1) D^2,)`` tensor of excitation
    energies relative to the ground state.
    """
    p = prep if prep is not None else prepare_excitations_cell(
        ground, mpo_cores, tol=tol)
    return dense_eigh(_dense_heff_cell(p, float(k), tol=tol))[0]


def _deflation_pair_cell(als, ars, dtype, iters=80):
    """Dominant (right, left) eigenvectors of the marginal CELL mixed
    transfer (bra ``AL``-cell, ket ``AR``-cell, one cell leftwards)."""
    n = len(als)

    def e_left_cell(z):
        for j in range(n - 1, -1, -1):
            t = peinsum("sjk,bk->sbj", ars[j], z)
            z = peinsum("sib,sbj->ij", als[j].conj(), t)
        return z

    def e_left_cell_adj(y):
        for j in range(n):
            y = peinsum("sib,ij,sjk->bk", als[j], y, ars[j].conj())
        return y

    return _power_pair(e_left_cell, e_left_cell_adj, als[0].shape[1], dtype,
                       als[0].device, iters)


def _overlap_g_cell(bs, als, ars, acs, ops, kappa, defl, tol=1e-10,
                    parities=None, cell_sign=1.0):
    """``G({B}) = <Phi_K({B})| O(kappa) |GS> / sqrt(n)`` for batched
    per-site ``bs``: on-site, strictly left within the cell, and previous
    cells (a geometric solve against the deflated marginal cell mixed
    transfer, ``e^{-i kappa n}`` per wrap); the strictly-right class
    vanishes by the left gauge fixing."""
    n = len(als)
    oacs = [peinsum("st,tij->sij", ops[j], acs[j]) for j in range(n)]
    if parities is not None:
        # semi-infinite JW string left of the insertion, telescoped to the
        # single bond diagonal P_j
        oacs = [oacs[j] * parities[j][None, :, None].to(oacs[j].dtype)
                for j in range(n)]
    ph_cell = complex(np.exp(-1j * kappa * n)) * cell_sign
    rv, lv, denom = defl

    def deflate(x):
        return x - rv * (_fro(lv, x) / denom)[..., None, None]

    def step_left(z, j):
        t = peinsum("sjk,...bk->...sbj", ars[j], z)
        return peinsum("sib,...sbj->...ij", als[j].conj(), t)

    def close(z, j):
        return peinsum("sab,sak,...bk->...", als[j].conj(), oacs[j], z)

    def t_cell(z):
        for j in range(n - 1, -1, -1):
            z = step_left(z, j)
        return z

    def walk_close_cell(z):
        """One cell to the LEFT: closes at each site j with absolute phase
        e^{i kappa (j - n)}."""
        g = 0
        for j in range(n - 1, -1, -1):
            g = g + complex(np.exp(1j * kappa * (j - n))) * close(z, j)
            if j > 0:
                z = step_left(z, j)
        return g

    g = 0
    for i in range(n):
        g = g + complex(np.exp(1j * kappa * i)) * peinsum(
            "...sij,sij->...", bs[i].conj(), oacs[i])
        z = peinsum("...sbc,skc->...bk", bs[i].conj(), ars[i])
        for j in range(i - 1, -1, -1):
            g = g + complex(np.exp(1j * kappa * j)) * close(z, j)
            if j > 0:
                z = step_left(z, j)
        if i > 0:
            z = step_left(z, 0)
        zsolve = _phase_solve(lambda x: t_cell(deflate(x)), deflate(z),
                              ph_cell, tol=tol)
        # cell -c carries cell_sign^c while the geometric expansion in
        # ph_cell supplies only cell_sign^(c-1): one explicit factor
        g = g + cell_sign * walk_close_cell(deflate(zsolve))
    return g / np.sqrt(n)


def spectral_weights_cell(ground, mpo_cores, op, kappa, tol=1e-10, prep=None,
                          string_parities=None, cell_sign=1.0):
    """Excitation energies and spectral weights of a one-site operator at
    PER-SITE momentum ``kappa`` on a cell ground: ``H_eff`` at cell
    momentum ``K = n kappa`` and pole weights ``|<Phi_K(B_a)| O(kappa)
    |GS>|^2`` per site.  ``string_parities``/``cell_sign`` (from
    :func:`~.u1_vumps_cell.string_parities_cell`) make ``op`` fermionic,
    ``c(kappa) = sum_j e^{i kappa j} (prod_{m<j} Z_m) op_j``.

    Returns ``(omegas, weights)`` tensors over the concatenated tangent
    space.
    """
    p = prep if prep is not None else prepare_excitations_cell(
        ground, mpo_cores, tol=tol)
    als, ars, acs, cdt = p["als"], p["ars"], p["acs"], p["cdt"]
    n = len(als)
    dev = als[0].device
    op = as_tensor(op, dev, cdt)
    ops = []
    for i in range(n):
        d = als[i].shape[0]
        dis = (peinsum("st,tij,sij->", op, acs[i], acs[i].conj())
               / peinsum("sij,sij->", acs[i], acs[i].conj()))
        if string_parities is not None:
            dis = torch.zeros_like(dis)  # charge-offset op: <op> == 0
        ops.append(op - dis * torch.eye(d, dtype=cdt, device=dev))
    if string_parities is not None:
        string_parities = [as_tensor(q, dev) for q in string_parities]
    # a negative cell wrap sign IS the Jordan-Wigner pi-shift: the matching
    # tangent sector sits at K = n kappa + pi
    shift = 0.0 if cell_sign >= 0 else np.pi
    h = _dense_heff_cell(p, float(kappa) * n + shift, tol=tol)
    omegas, vecs = dense_eigh(h)
    defl = p.get("defl")
    if defl is None:
        defl = _deflation_pair_cell(als, ars, cdt)
        p["defl"] = defl  # kappa-independent: cache for reuse
    basis = torch.eye(h.shape[0], dtype=cdt, device=dev)
    src = _overlap_g_cell(_split_x(basis, p), als, ars, acs, ops, float(kappa),
                          defl, tol=tol, parities=string_parities,
                          cell_sign=cell_sign)
    amps = peinsum("ji,j->i", vecs.conj(), src)
    return omegas, amps.abs() ** 2


def _minimum_lanczos(p, k, project, iters, generator, tol):
    """Lowest eigenpair of the (projected) cell ``H_eff(K)`` on full
    per-site ``B`` tensors by projected Lanczos, each site's regularization
    constant subtracted in the matvec."""
    als = p["als"]
    n = len(als)
    shapes = [tuple(a.shape) for a in als]
    offs = np.concatenate([[0], np.cumsum([int(np.prod(s)) for s in shapes])])

    def split(v):
        return [v[offs[i]:offs[i + 1]].reshape(shapes[i]) for i in range(n)]

    def matvec(v):
        bs = split(v)
        outs = _heff_b_cell(bs, p, k, tol)
        return project(torch.cat([(o - p["lams"][i] * bs[i]).reshape(-1)
                                  for i, o in enumerate(outs)]))

    total = int(offs[-1])
    rdt = p["cdt"].to_real()
    dev = als[0].device
    v0 = torch.complex(
        torch.randn((total,), dtype=rdt, device=dev, generator=generator),
        torch.randn((total,), dtype=rdt, device=dev, generator=generator))
    energy, vec = lanczos_ground(matvec, project(v0.to(p["cdt"])), iters,
                                 project=project)
    return float(np.real(energy)), tuple(split(vec))


def _gauge_projector(p, masks=None):
    """The dense left-tangent gauge projector ``B_i - AL_i (AL_i^H B_i)`` on
    concatenated per-site tensors, times optional 0/1 ``masks``."""
    als = p["als"]
    bond = als[0].shape[1]
    shapes = [tuple(a.shape) for a in als]
    offs = np.concatenate([[0], np.cumsum([int(np.prod(s)) for s in shapes])])
    al_mats = [a.reshape(s[0] * bond, bond) for a, s in zip(als, shapes)]

    def project(v):
        outs = []
        for i, s in enumerate(shapes):
            m = v[offs[i]:offs[i + 1]].reshape(s[0] * bond, bond)
            m = m - al_mats[i] @ (al_mats[i].conj().T @ m)
            m = m.reshape(s)
            outs.append((m if masks is None else m * masks[i]).reshape(-1))
        return torch.cat(outs)

    return project


def excitation_minimum_cell(ground, mpo_cores, k, iters=60, tol=1e-8,
                            prep=None, generator=None):
    """Lowest excitation at cell momentum ``k`` by projected Lanczos (no
    dense ``H_eff``), with the left-tangent gauge projector applied INSIDE
    Lanczos (``project=``).  ``generator`` draws the complex start vector.

    Returns ``(energy, b_tensors)``.
    """
    p = prep if prep is not None else prepare_excitations_cell(
        ground, mpo_cores, tol=tol)
    return _minimum_lanczos(p, float(k), _gauge_projector(p), iters, generator,
                            tol)


def dynamic_structure_factor_cell(ground, mpo_cores, op, kappas, omegas,
                                  eta=0.05, tol=1e-10, string_parities=None,
                                  cell_sign=1.0):
    """Lorentzian-broadened ``S(kappa, w)`` map on a cell ground from the
    tangent-space poles, per-site momenta over the full extended zone;
    returns a ``(len(kappas), len(omegas))`` numpy array."""
    kappas = np.atleast_1d(np.asarray(kappas, float))
    omegas = np.atleast_1d(np.asarray(omegas, float))
    out = np.zeros((kappas.size, omegas.size))
    prep = prepare_excitations_cell(ground, mpo_cores, tol=tol)
    for i, kap in enumerate(kappas):
        om, wt = spectral_weights_cell(
            ground, mpo_cores, op, float(kap), tol=tol, prep=prep,
            string_parities=string_parities, cell_sign=cell_sign)
        om, wt = om.cpu().numpy(), wt.cpu().numpy()
        lor = (eta / np.pi) / ((omegas[None, :] - om[:, None]) ** 2 + eta * eta)
        out[i] = np.matmul(wt, lor)
    return out


def quasiparticle_dispersion_cell(mpo_cores, ks, bond_dim=12, ground=None,
                                  n_bands=1, tol=1e-10, **vumps_kwargs):
    """Lowest ``n_bands`` excitation energies of a period-n chain at each
    cell momentum (VUMPS once unless ``ground`` is given).  Returns
    ``(ground, omegas)`` with ``omegas`` a ``(len(ks), n_bands)`` array."""
    from .vumps_cell import vumps_cell

    if ground is None:
        ground = vumps_cell(mpo_cores, bond_dim, **vumps_kwargs)
    prep = prepare_excitations_cell(ground, mpo_cores, tol=tol)
    omegas = np.stack([
        excitation_spectrum_cell(ground, mpo_cores, k, tol=tol,
                                 prep=prep).cpu().numpy()[:n_bands]
        for k in ks])
    return ground, omegas
