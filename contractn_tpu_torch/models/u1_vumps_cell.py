"""Charge-masked multi-site-cell VUMPS: exact U(1) with PER-BOND charge
ladders.

Counterpart of ``contractn_tpu/models/u1_vumps_cell.py``.  Each bond ``i``
carries its own static ladder ``q_i`` and site ``i``'s mask ties them,
``mask_i[s, a, b] = [q_i[a] + p_{i,s} == q_{i+1}[b]]``, so cells whose
physical charges shift the ladder's lattice every site (spin-1/2 XXZ with
``p = +-1``, the half-filled d=4 Hubbard site) run natively without
folding.  Masks enter only the Lanczos matvecs and the gauge updates; the
environments are the unmasked cell environments of
:func:`~.vumps_cell.mpo_environments_cell`, and the charge-aligned
polar/ortho algebra of :mod:`.u1_vumps` runs with per-site selector
bundles (each aligned polar one batched SVD over its classes).

Departure: random starts take a ``torch.Generator`` (``generator=``) where
the JAX package takes a key.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .mpo import MPO
from .u1 import _DEAD_VALUE, _aligned_ortho, _per_site, mpo_channel_charges
from .u1_vumps import (
    _alloc_plain,
    _alloc_symmetric,
    _gauge_update_u1,
    _ladder,
    _live_rows,
    _rank,
)
from .vumps import _h_ac, _h_c
from .vumps_cell import _cell_dtype, mpo_environments_cell


def u1_cell_charges(phys_list, bond_dim, n_walk=8):
    """Per-bond charge ladders for an n-site cell: a charge random walk
    through ``n_walk`` full cells, its squared-count snapshot at each bond
    weighting that bond's allocation (mirrored pairs with >= 2 slots per
    sign per kept class where the distribution is mirror-symmetric; an
    unpairable slot of a centerless ladder stays dead).  Returns a list of
    ``(bond_dim,)`` int arrays."""
    n = len(phys_list)
    dist = {0: 1}
    snapshots = [None] * n
    for _ in range(n_walk):
        for i in range(n):
            snapshots[i] = dist
            nxt = {}
            for q, c in dist.items():
                for p in phys_list[i]:
                    nxt[q + p] = nxt.get(q + p, 0) + c
            dist = nxt
    return [_allocate_mirror({q: c * c for q, c in snap.items()}, bond_dim)
            for snap in snapshots]


def _allocate_mirror(weights, bond_dim):
    """One bond's ladder from its charge weights (see
    :func:`u1_cell_charges`)."""
    cap = min(len(weights), max(3, int(2 * np.sqrt(bond_dim)) + 1), bond_dim)
    if all(weights.get(-q) == c for q, c in weights.items()):
        slots = _alloc_symmetric(weights, bond_dim, cap, 0 in weights)
    else:
        slots = _alloc_plain(weights, bond_dim, cap)
    return _ladder(slots, bond_dim)


def u1_cell_sector(phys_list, bond_dim, charges=None, dtype=torch.float64,
                   n_walk=8, device=None):
    """Per-site masks and per-bond selector bundles for a masked cell, on
    ``device`` (default ``cuda``).

    Returns a dict of tuples indexed by site/bond: ``charges``,
    ``site_masks[i] (d_i, D, D)``, ``bond_masks[i] (D, D)``,
    ``row_sels[i]`` (classes of bond ``i+1`` over rows ``(s, a)`` of
    ``AC_i``), ``row_t_sels[i]`` (classes of bond ``i``), ``slot_sels[i]``
    (classes of bond ``i`` over its slots) and their ``slot_ranks``.
    """
    device = resolve_device(device)
    n = len(phys_list)
    qs = ([np.asarray(c, np.int64) for c in charges] if charges is not None
          else u1_cell_charges(phys_list, bond_dim, n_walk=n_walk))
    if len(qs) != n or any(q.shape != (bond_dim,) for q in qs):
        raise ValueError("need one (bond_dim,) ladder per bond")
    lives = [q != _DEAD_VALUE for q in qs]

    def put(a, dt=torch.float64):
        return torch.from_numpy(np.asarray(a, np.float64)).to(device, dt)

    site_masks, bond_masks = [], []
    row_sels, row_t_sels, slot_sels = [], [], []
    for i in range(n):
        phys = [int(p) for p in phys_list[i]]
        d = len(phys)
        ql, qr = qs[i], qs[(i + 1) % n]
        ll, lr = lives[i], lives[(i + 1) % n]
        sm = np.zeros((d, bond_dim, bond_dim))
        for s, p in enumerate(phys):
            sm[s] = (ql[:, None] + p == qr[None, :]) & ll[:, None] & lr[None, :]
        site_masks.append(put(sm, dtype))
        bond_masks.append(put((ql[:, None] == ql[None, :])
                              & ll[:, None] & ll[None, :], dtype))
        cls_r = sorted({int(c) for c in qr[lr]})
        cls_l = sorted({int(c) for c in ql[ll]})
        rs = np.zeros((max(len(cls_r), 1), d * bond_dim))
        for ci, c in enumerate(cls_r):
            for s, p in enumerate(phys):
                rs[ci, s * bond_dim:(s + 1) * bond_dim] = ll & (ql + p == c)
        rts = np.zeros((max(len(cls_l), 1), d * bond_dim))
        for ci, c in enumerate(cls_l):
            for s, p in enumerate(phys):
                rts[ci, s * bond_dim:(s + 1) * bond_dim] = lr & (qr - p == c)
        ss = np.zeros((max(len(cls_l), 1), bond_dim))
        for ci, c in enumerate(cls_l):
            ss[ci] = ll & (ql == c)
        row_sels.append(put(rs))
        row_t_sels.append(put(rts))
        slot_sels.append(put(ss))
    return {
        "charges": tuple(qs),
        "phys_list": tuple(tuple(int(p) for p in pl) for pl in phys_list),
        "bond_dim": int(bond_dim),
        "site_masks": tuple(site_masks),
        "bond_masks": tuple(bond_masks),
        "row_sels": tuple(row_sels),
        "row_t_sels": tuple(row_t_sels),
        "slot_sels": tuple(slot_sels),
        "slot_ranks": tuple(_rank(s) for s in slot_sels),
    }


def string_parities_cell(sector, z_diag):
    """Per-bond Jordan-Wigner boundary signs of a masked cell sector.

    On a charge-masked cell ground ``Z AL_i = P_i (.) AL_i (.) P_{i+1}``
    with diagonal ``P_j[b] = sign(q_j[b])`` fixed by the charge recursion
    ``sign(q + p_s) = sign(q) z_s``, so a semi-infinite string reduces to
    the single diagonal ``P_j`` on bond ``j`` (host bookkeeping; raises if
    ``z_diag`` is not a parity function of the conserved charge).

    Returns ``(parities, cell_sign)``: n ``(D,)`` float64 tensors (0.0 on
    dead slots) on the sector's device and the per-cell wrap sign.
    """
    qs = [np.asarray(q) for q in sector["charges"]]
    n = len(qs)
    phys = sector["phys_list"]
    zs = _per_site(z_diag, n)
    n_walk = 8
    levels = n_walk * n + 1
    sign = [dict() for _ in range(levels)]
    live0 = sorted(int(q) for q in qs[0][qs[0] != _DEAD_VALUE])
    sign[0][live0[0]] = 1.0
    for lvl in range(levels - 1):
        i = lvl % n
        for q, sg in sign[lvl].items():
            for s, p in enumerate(phys[i]):
                val = sg * float(zs[i][s])
                prev = sign[lvl + 1].get(q + int(p))
                if prev is not None and prev != val:
                    raise ValueError(
                        f"string eigenvalues {tuple(zs[i])} are not a "
                        "parity function of the conserved charge at "
                        f"site {i} — no telescoping string sign")
                sign[lvl + 1][q + int(p)] = val
    cell_sign = None
    for lvl in range(levels - n):
        common = set(sign[lvl]) & set(sign[lvl + n])
        ratios = {sign[lvl + n][q] * sign[lvl][q] for q in common}
        if len(ratios) > 1:
            raise ValueError("inconsistent cell wrap sign")
        if ratios:
            r = ratios.pop()
            if cell_sign is not None and r != cell_sign:
                raise ValueError("inconsistent cell wrap sign")
            cell_sign = r
    if cell_sign is None:
        raise ValueError("charge walk never revisits a charge — "
                         "cannot fix the cell wrap sign")
    device = sector["site_masks"][0].device
    parities = []
    for jb in range(n):
        merged = dict()
        for lvl in range(jb, levels, n):
            scale = cell_sign ** ((lvl - jb) // n)
            for q, sg in sign[lvl].items():
                val = sg * scale
                prev = merged.get(q)
                if prev is not None and prev != val:
                    raise ValueError("string sign is not a function of the "
                                     f"bond charge on bond {jb}")
                merged[q] = val
        missing = [int(q) for q in qs[jb]
                   if q != _DEAD_VALUE and int(q) not in merged]
        if missing:
            raise ValueError(
                f"live charges {missing} on bond {jb} unreachable "
                "from the walk — cannot assign string signs")
        parities.append(torch.tensor([merged.get(int(q), 0.0) for q in qs[jb]],
                                     dtype=torch.float64, device=device))
    return parities, float(cell_sign)


def excitation_charge_masks_cell(sector, delta_q):
    """Per-site ``(d_i, D, D)`` 0/1 masks of tangent directions carrying
    EXACT excitation charge ``delta_q``: ``B_i[s, a, b]`` lives where
    ``q_i[a] + p_{i,s} - q_{i+1}[b] == delta_q``."""
    qs = [np.asarray(q) for q in sector["charges"]]
    n = len(qs)
    bond = qs[0].shape[0]
    lives = [q != _DEAD_VALUE for q in qs]
    device = sector["site_masks"][0].device
    masks = []
    for i in range(n):
        phys = sector["phys_list"][i]
        ql, qr = qs[i], qs[(i + 1) % n]
        m = np.zeros((len(phys), bond, bond))
        for s, p in enumerate(phys):
            m[s] = ((ql[:, None] + int(p) - qr[None, :] == int(delta_q))
                    & lives[i][:, None] & lives[(i + 1) % n][None, :])
        masks.append(torch.from_numpy(m).to(device))
    return masks


def sector_excitation_minimum_cell(ground, mpo_cores, delta_q, k, iters=60,
                                   tol=1e-8, prep=None, generator=None):
    """Lowest cell tangent-space excitation at CELL momentum ``k`` carrying
    EXACT charge offset ``delta_q`` above a :func:`vumps_u1_cell` ground
    state: the cell ``H_eff`` composed with the per-site gauge projector and
    the charge masks (restricted to the live ranges of the neighbouring
    partial isometries), by projected Lanczos.  ``generator`` draws the
    start.

    Returns ``(energy, b_tensors)``, the energy relative to the ground state.
    """
    from .excitations_cell import (
        _gauge_projector,
        _minimum_lanczos,
        prepare_excitations_cell,
    )

    p = prep if prep is not None else prepare_excitations_cell(
        ground, mpo_cores, tol=tol)
    n = len(p["als"])
    als, ars = p["als"], p["ars"]
    qmasks = excitation_charge_masks_cell(ground["sector"], delta_q)
    for i in range(n):
        live_l, live_r = _live_rows(als[(i - 1) % n], ars[(i + 1) % n])
        qmasks[i] = qmasks[i] * live_l[None, :, None] * live_r[None, None, :]
    if float(sum(float(m.sum()) for m in qmasks)) == 0.0:
        raise ValueError(
            f"no live tangent directions carry charge {delta_q} on "
            "these ladders — widen them or pick a reachable offset")
    qmasks = [m.to(p["cdt"]) for m in qmasks]
    return _minimum_lanczos(p, float(k), _gauge_projector(p, qmasks), iters,
                            generator, tol)


def vumps_u1_cell(mpo_cores, bond_dim, phys_list, iters=60, dtype=torch.float64,
                  lanczos_iters=40, generator=None, tol=1e-12, charges=None,
                  left=None, right=None, n_walk=8, device=None):
    """Infinite period-n ground state confined EXACTLY to a U(1) manifold
    with per-bond charge ladders.

    Args:
        mpo_cores: n triangular bulk cores (one per cell site).
        phys_list: per-site physical charge lists (a flat list means every
            site identical).
        charges: optional explicit per-bond ladders.
        generator: ``torch.Generator`` on ``device`` for the n random start
            cores (or the global one).
        device: where to compute (default: the cores' device, else ``cuda``).

    Returns the :func:`~.vumps_cell.vumps_cell` result dict plus ``sector``;
    every ``als/ars/acs[i]`` satisfies ``a * (1 - site_masks[i]) == 0``
    identically.
    """
    device = resolve_device(device, tuple(mpo_cores))
    dtype = _cell_dtype(mpo_cores, dtype)
    ws = [as_tensor(w, device, dtype) for w in mpo_cores]
    n = len(ws)
    phys_list = _per_site(phys_list, n)
    for i in range(n):
        if len(phys_list[i]) != ws[i].shape[0]:
            raise ValueError(f"site {i}: {len(phys_list[i])} charges "
                             f"for phys dim {ws[i].shape[0]}")
    # channel definiteness on a 3-cell repetition with per-site charges
    wdim = ws[0].shape[2]
    lvec = torch.zeros(wdim, dtype=dtype, device=device)
    rvec = torch.zeros(wdim, dtype=dtype, device=device)
    lvec[0], rvec[-1] = 1.0, 1.0
    lvec = lvec if left is None else as_tensor(left, device, dtype)
    rvec = rvec if right is None else as_tensor(right, device, dtype)
    mpo_channel_charges(MPO(torch.stack([ws[i % n] for i in range(3 * n)]),
                            lvec, rvec),
                        [phys_list[i % n] for i in range(3 * n)])

    sector = u1_cell_sector(phys_list, bond_dim, charges=charges, dtype=dtype,
                            n_walk=n_walk, device=device)
    sms, bms = sector["site_masks"], sector["bond_masks"]
    cell0 = [torch.randn((ws[i].shape[0], bond_dim, bond_dim), dtype=dtype,
                         device=device, generator=generator)
             for i in range(n)]
    als, ars, cs = [], [], []
    for i in range(n):
        d = ws[i].shape[0]
        a0 = cell0[i] * sms[i]
        j = (i + 1) % n
        al_q, _ = _aligned_ortho(a0.reshape(d * bond_dim, bond_dim),
                                 sector["row_sels"][i], sector["slot_sels"][j],
                                 sector["slot_ranks"][j])
        als.append(al_q.reshape(d, bond_dim, bond_dim) * sms[i])
        ar_q, _ = _aligned_ortho(a0.transpose(1, 2).reshape(d * bond_dim, bond_dim),
                                 sector["row_t_sels"][i], sector["slot_sels"][i],
                                 sector["slot_ranks"][i])
        ars.append(ar_q.reshape(d, bond_dim, bond_dim).transpose(1, 2) * sms[i])
        live = torch.from_numpy((np.asarray(sector["charges"][i]) != _DEAD_VALUE
                                 ).astype(np.float64)).to(device, dtype)
        cs.append(torch.diag(live) / torch.sqrt(live.sum()))
    als, ars, cs = tuple(als), tuple(ars), tuple(cs)
    acs = tuple(peinsum("dij,jk->dik", als[i], cs[(i + 1) % n]) * sms[i]
                for i in range(n))

    energies = []
    grad_norm = np.inf
    for _ in range(int(iters)):
        fls, frs, e_cell = mpo_environments_cell(als, ars, cs, ws, tol=tol)
        new_acs = [lanczos_ground(
            lambda t, i=i: sms[i] * _h_ac(fls[i], ws[i], frs[(i + 1) % n], t),
            acs[i], lanczos_iters)[1] for i in range(n)]
        new_c = [lanczos_ground(
            lambda t, i=i: bms[i] * _h_c(fls[i], frs[i], t), cs[i],
            lanczos_iters)[1] for i in range(n)]
        new_al, new_ar, grads = [], [], []
        for i in range(n):
            j = (i + 1) % n
            al, ar, grad = _gauge_update_u1(
                new_acs[i], new_c[i], new_c[j], sms[i], sector["row_sels"][i],
                sector["row_t_sels"][i], sector["slot_sels"][i],
                sector["slot_sels"][j])
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
        "gradient_norm": grad_norm, "sector": sector,
    }
