"""Charge-masked VUMPS: exact-U(1) uniform MPS in the thermodynamic limit.

Counterpart of ``contractn_tpu/models/u1_vumps.py``.  A one-site uniform
MPS repeats the SAME bond on every link, so its bond charge ladder is one
static ``q (D,)`` and ``mask[s, i, j] = [q[i] + p_s == q[j]]``; cells whose
physical charges shift the ladder's lattice every site are folded first
(:func:`~.mpo.block_mpo`).  The sector stays structurally exact through the
VUMPS loop (``cores * (1 - mask) == 0`` identically at every iterate):

1. mask-projected effective Hamiltonians in the Lanczos matvecs (the
   GMRES environment systems are solved in the full static space);
2. charge-aligned polar decompositions (:func:`_aligned_polar`) for the
   gauge updates: per-class SVDs with null directions zeroed, here as ONE
   batched ``torch.linalg.svd`` of the ``C`` class-masked matrices;
3. mask scrubbing of every updated tensor.

Ladders, masks and class selectors are host numpy (they depend only on the
charges) and go to the device once.

Departure: random starts and noise take a ``torch.Generator``
(``generator=``) where the JAX package takes a key.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .mpo import MPO
from .u1 import _DEAD_VALUE, _aligned_ortho, _per_site, mpo_channel_charges
from .vumps import _h_ac, _h_c, mpo_environments


def _alloc_symmetric(weights, bond_dim, cap, has0):
    """Mirrored allocation (proportional first, then drop the thinnest pair
    until every kept class holds >= 2 slots per sign); any unpairable slot
    of a centerless ladder stays unassigned."""
    pos = sorted((q for q in weights if q > 0), key=lambda q: (-weights[q], q))
    n_pairs = min(len(pos), (cap - (1 if has0 else 0)) // 2,
                  (bond_dim - (1 if has0 else 0)) // 2)
    while True:
        groups = ([(0, weights[0], 1)] if has0 else []) + [
            (q, 2 * weights[q], 2) for q in pos[:n_pairs]]
        total_w = sum(g[1] for g in groups)
        alloc = {q: mult for q, _, mult in groups}
        rest = bond_dim - sum(alloc.values())
        fracs = []
        for q, wgt, mult in groups:
            share = rest * wgt / max(total_w, 1)
            units = int(share // mult)
            alloc[q] += units * mult   # pairs stay mirrored
            fracs.append((share - units * mult, q, mult))
        leftover = bond_dim - sum(alloc.values())
        for _, q, mult in sorted(fracs, reverse=True):
            if leftover >= mult:
                alloc[q] += mult
                leftover -= mult
        if has0:
            alloc[0] += leftover       # odd slot: center class
        min_pair = min((alloc[q] for q in pos[:n_pairs]), default=bond_dim)
        if n_pairs > 1 and ((has0 and alloc[0] < 2) or min_pair < 4):
            n_pairs -= 1
            continue
        break
    slots = []
    for q, cnt in alloc.items():
        if q == 0:
            slots.extend([0] * cnt)
        else:
            slots.extend([q] * (cnt // 2) + [-q] * (cnt // 2))
    return slots


def _alloc_plain(weights, bond_dim, cap):
    """Proportional allocation over the ``cap`` heaviest classes."""
    qs = sorted(weights, key=lambda q: (-weights[q], abs(q), q))[:cap]
    total_w = sum(weights[q] for q in qs)
    alloc = {q: 1 for q in qs}
    rest = bond_dim - len(qs)
    if rest > 0:
        fracs = []
        for q in qs:
            share = rest * weights[q] / total_w
            alloc[q] += int(share)
            fracs.append((share - int(share), q))
        leftover = bond_dim - sum(alloc.values())
        for _, q in sorted(fracs, reverse=True)[:leftover]:
            alloc[q] += 1
    slots = []
    for q in sorted(alloc):
        slots.extend([q] * alloc[q])
    return slots


def _ladder(slots, bond_dim):
    slots = sorted(slots)[:bond_dim]
    arr = np.full((bond_dim,), _DEAD_VALUE, np.int64)
    arr[: len(slots)] = slots
    return arr


def u1_uniform_charges(phys_charges, bond_dim, n_walk=16):
    """Translation-invariant bond charge ladder for a uniform cell: slots
    over the charge lattice reachable from 0 by ``n_walk`` cell steps,
    weighted by the squared walk count.  Returns a ``(bond_dim,)`` int
    array; unassigned slots hold the dead sentinel."""
    phys = [int(p) for p in phys_charges]
    walks = {0: 1}
    for _ in range(n_walk):
        nxt = {}
        for q, c in walks.items():
            for p in phys:
                nxt[q + p] = nxt.get(q + p, 0) + c
        walks = nxt
    weights = {q: c * c for q, c in walks.items()}
    # cap the DISTINCT charges well below bond_dim: each kept class needs
    # several slots (a 1-slot class has Schmidt rank 1)
    cap = min(len(weights), max(3, int(2 * np.sqrt(bond_dim)) + 1), bond_dim)
    symmetric = (0 in weights) and all(weights.get(-q) == c
                                       for q, c in weights.items())
    if symmetric:
        return _ladder(_alloc_symmetric(weights, bond_dim, cap, True), bond_dim)
    return _ladder(_alloc_plain(weights, bond_dim, cap), bond_dim)


def _rank(slot_sel):
    """Each slot's 0-based rank within its class (the aligned
    orthogonalization's static gather index)."""
    return torch.clamp(torch.cumsum(slot_sel, dim=-1) - 1, min=0).to(torch.int64)


def u1_uniform_sector(phys_charges, bond_dim, charges=None,
                      dtype=torch.float64, device=None):
    """Masks and class selectors for a charge-masked uniform MPS, on
    ``device`` (default ``cuda``).

    Returns a dict: ``charges``, ``site_mask (d, D, D)``, ``bond_mask (D,
    D)``, and the per-class selectors ``row_sel / row_t_sel (C, d*D)`` and
    ``slot_sel (C, D)`` of the aligned gauge algebra (row index ``s * D +
    i``), plus ``slot_rank (C, D)``.
    """
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    phys = [int(p) for p in phys_charges]
    d = len(phys)
    q = (np.asarray(charges, np.int64) if charges is not None
         else u1_uniform_charges(phys, bond_dim))
    if q.shape != (bond_dim,):
        raise ValueError(f"charges must be ({bond_dim},), got {q.shape}")
    live = q != _DEAD_VALUE
    site_mask = np.zeros((d, bond_dim, bond_dim))
    for s, p in enumerate(phys):
        site_mask[s] = ((q[:, None] + p == q[None, :])
                        & live[:, None] & live[None, :])
    bond_mask = (q[:, None] == q[None, :]) & live[:, None] & live[None, :]
    classes = sorted({int(c) for c in q[live]})
    n_cls = max(len(classes), 1)
    row_sel = np.zeros((n_cls, d * bond_dim))
    row_t_sel = np.zeros((n_cls, d * bond_dim))
    slot_sel = np.zeros((n_cls, bond_dim))
    for ci, c in enumerate(classes):
        for s, p in enumerate(phys):
            row_sel[ci, s * bond_dim:(s + 1) * bond_dim] = live & (q + p == c)
            row_t_sel[ci, s * bond_dim:(s + 1) * bond_dim] = live & (q - p == c)
        slot_sel[ci] = live & (q == c)

    def put(a, dt=torch.float64):
        return torch.from_numpy(np.asarray(a, np.float64)).to(device, dt)

    slot = put(slot_sel)
    return {
        "charges": q,
        "phys_charges": tuple(phys),
        "bond_dim": int(bond_dim),
        "site_mask": put(site_mask, dtype),
        "bond_mask": put(bond_mask, dtype),
        "row_sel": put(row_sel),
        "row_t_sel": put(row_t_sel),
        "slot_sel": slot,
        "slot_rank": _rank(slot),
    }


def _aligned_polar(m, row_sel, col_sel):
    """Class-pure polar factor of a block-structured matrix: per charge class
    the SVD of the class block (full static shape), all classes in ONE
    batched ``torch.linalg.svd``, summing ``U_c V_c^H`` with numerically
    null singular directions zeroed outright (no arbitrary orthonormal
    completions that would leak charge)."""
    dt = m.dtype
    sub = m[None] * row_sel[:, :, None].to(dt) * col_sel[:, None, :].to(dt)
    u, s, vh = torch.linalg.svd(sub, full_matrices=False)
    keep = (s > 1e-13 * torch.clamp(s[:, :1], min=1e-300)).to(dt)
    return peinsum("cij,cjk->ik", u * keep[:, None, :], vh)


def _gauge_update_u1(ac, c_left, c_right, site_mask, row_sel, row_t_sel,
                     slot_sel_l, slot_sel_r):
    """Masked Zauner-Stauber gauge update: ``AL = polar(AC) polar(C_r)^H``
    (AR mirrored with ``C_l``), every polar factor charge-aligned, then
    mask-scrubbed.  A one-site cell passes its ``C`` and class selectors as
    both bonds'."""
    d_, bond = ac.shape[0], ac.shape[1]
    pol_c = _aligned_polar(c_right, slot_sel_r, slot_sel_r)
    al = peinsum("ij,kj->ik",
                 _aligned_polar(ac.reshape(d_ * bond, bond), row_sel,
                                slot_sel_r),
                 pol_c.conj()).reshape(d_, bond, bond) * site_mask
    ar_mat = _aligned_polar(ac.transpose(1, 2).reshape(d_ * bond, bond),
                            row_t_sel, slot_sel_l)
    cl = _aligned_polar(c_left.T, slot_sel_l, slot_sel_l)
    ar = peinsum("ij,kj->ik", ar_mat, cl.conj()).reshape(
        d_, bond, bond).transpose(1, 2) * site_mask
    grad = torch.linalg.norm(ac - peinsum("dij,jk->dik", al, c_right))
    return al, ar, grad


def expand_sector_state(result, bond_dim, charges=None, noise=1e-6,
                        generator=None):
    """Embed a converged :func:`vumps_u1` state into a larger ladder.

    Slots map by charge class (old slots of class ``c`` onto the first new
    slots of class ``c``); fresh slots receive masked standard-normal noise
    of relative size ``noise`` drawn from ``generator`` (or the global one),
    so the enlarged directions join the optimization.  Returns an ``init``
    dict for :func:`vumps_u1`.
    """
    old_sec = result["sector"]
    oq = np.asarray(old_sec["charges"])
    c_old = result["c"]
    dev = c_old.device
    new_sec = u1_uniform_sector(old_sec["phys_charges"], bond_dim,
                                charges=charges, dtype=c_old.dtype, device=dev)
    nq = np.asarray(new_sec["charges"])
    idx = np.zeros((int(old_sec["bond_dim"]),), np.int64)
    used = np.zeros((bond_dim,), bool)
    for i, c in enumerate(oq):
        if c == _DEAD_VALUE:
            continue
        free = [j for j in np.nonzero(nq == c)[0] if not used[j]]
        if not free:
            raise ValueError(f"new ladder lacks room for old charge {int(c)}")
        idx[i] = free[0]
        used[free[0]] = True
    sel = np.nonzero(oq != _DEAD_VALUE)[0]
    src = torch.from_numpy(sel).to(dev)
    dst = torch.from_numpy(idx[sel]).to(dev)

    def embed2(m):
        out = torch.zeros((bond_dim, bond_dim), dtype=m.dtype, device=dev)
        out[dst[:, None], dst[None, :]] = m[src[:, None], src[None, :]]
        return out

    def embed3(t):
        out = torch.zeros((t.shape[0], bond_dim, bond_dim), dtype=t.dtype,
                          device=dev)
        out[:, dst[:, None], dst[None, :]] = t[:, src[:, None], src[None, :]]
        return out

    ac = result["ac"]
    c0 = embed2(c_old) + noise * new_sec["bond_mask"] * torch.randn(
        (bond_dim, bond_dim), dtype=c_old.dtype, device=dev, generator=generator)
    ac0 = embed3(ac) + noise * new_sec["site_mask"] * torch.randn(
        (ac.shape[0], bond_dim, bond_dim), dtype=ac.dtype, device=dev,
        generator=generator)
    return {"al": embed3(result["al"]), "ar": embed3(result["ar"]), "ac": ac0,
            "c": c0, "sector": new_sec}


def excitation_charge_masks(sector, delta_q):
    """``(d, D, D)`` 0/1 mask of tangent directions carrying EXACT
    excitation charge ``delta_q``: ``B[s, i, j]`` lives where ``q[i] + p_s
    - q[j] == delta_q``."""
    q = np.asarray(sector["charges"])
    phys = sector["phys_charges"]
    live = q != _DEAD_VALUE
    m = np.zeros((len(phys), q.shape[0], q.shape[0]))
    for s, p in enumerate(phys):
        m[s] = ((q[:, None] + int(p) - q[None, :] == int(delta_q))
                & live[:, None] & live[None, :])
    return torch.from_numpy(m).to(sector["site_mask"].device)


def _live_rows(al, ar):
    """Live columns of ``AL`` and live rows of ``AR`` (the ranges the
    partial isometries keep)."""
    live_l = torch.real(peinsum("sji,sjk->ik", al.conj(), al)).diagonal() > 0.5
    live_r = torch.real(peinsum("sij,skj->ik", ar, ar.conj())).diagonal() > 0.5
    return live_l, live_r


def sector_excitation_minimum(ground, mpo_cell, delta_q, k, iters=60, tol=1e-8,
                              prep=None, generator=None):
    """Lowest tangent-space excitation energy at momentum ``k`` carrying
    EXACT charge offset ``delta_q`` above a masked VUMPS ground state: a
    projected Lanczos whose matvec composes the momentum-``k`` effective
    Hamiltonian with the left-tangent gauge projector and the
    :func:`excitation_charge_masks` sector mask (restricted to the live
    ranges of the neighbouring partial isometries), the projector applied
    INSIDE Lanczos (``project=``).  ``generator`` draws the start.

    Returns ``(energy, b_tensor)``, the energy relative to the ground state.
    """
    from .excitations import _heff_b, prepare_excitations

    p = prep if prep is not None else prepare_excitations(ground, mpo_cell,
                                                          tol=tol)
    al, ar = p["al"], p["ar"]
    d, bond = al.shape[0], al.shape[1]
    al_mat = al.reshape(d * bond, bond)
    live_l, live_r = _live_rows(al, ar)
    qmask = (excitation_charge_masks(ground["sector"], delta_q)
             * live_l[None, :, None] * live_r[None, None, :])
    if float(qmask.sum()) == 0.0:
        raise ValueError(
            f"no live tangent directions carry charge {delta_q} on "
            "this ladder — widen it or pick a reachable offset")
    qmask = qmask.to(p["cdt"])

    def project(b):
        m = b.reshape(d * bond, bond)
        m = m - peinsum("ij,jk->ik", al_mat,
                        peinsum("ji,jk->ik", al_mat.conj(), m))
        return m.reshape(d, bond, bond) * qmask

    def matvec(b):
        return project(_heff_b(b, al, ar, p["c"], p["fl"], p["fr"], p["w"],
                               float(k), p["is_zero"], p["eye_diag"], tol=tol))

    rdt = p["cdt"].to_real()
    b0 = torch.complex(
        torch.randn((d, bond, bond), dtype=rdt, device=al.device,
                    generator=generator),
        torch.randn((d, bond, bond), dtype=rdt, device=al.device,
                    generator=generator))
    b0 = project(b0.to(p["cdt"]) * qmask)
    # project= is ESSENTIAL: the dense gauge projector's eps-residuals in
    # the Krylov rows are re-injected by Gram-Schmidt and grow
    energy, vec = lanczos_ground(matvec, b0, iters, project=project)
    return float(np.real(energy)) - p["lam0"], vec


def _promoted(dtype, cores):
    src = cores.dtype if isinstance(cores, torch.Tensor) else torch_dtype(
        np.asarray(cores).dtype)
    return torch.promote_types(torch_dtype(dtype), src)


def vumps_u1(mpo_cell, bond_dim, phys_charges, iters=60, dtype=torch.float64,
             lanczos_iters=40, generator=None, tol=1e-12, charges=None,
             init=None, device=None):
    """Infinite-chain ground state confined EXACTLY to a U(1)-invariant
    uniform-MPS manifold (zero-density sector by default).

    Args:
        mpo_cell: triangular MPO whose ``cores[0]`` is the repeated bulk
            cell (channel-charge-definiteness under ``phys_charges`` is
            verified on a 3-cell repetition).
        phys_charges: the cell's physical charges (fold charge-alternating
            cells first).
        charges: optional explicit bond ladder.
        init: optional warm start (an :func:`expand_sector_state` bundle or
            a previous result at the same ladder).
        generator: ``torch.Generator`` on ``device`` for the random start
            core (or the global one).
        device: where to compute (default: the MPO's device).

    Returns the :func:`~.vumps.vumps` result dict plus ``sector``;
    ``al/ar/ac`` satisfy ``a * (1 - site_mask) == 0`` identically.
    """
    device = resolve_device(device, (mpo_cell.cores,))
    w = as_tensor(mpo_cell.cores[0], device, _promoted(dtype, mpo_cell.cores))
    dtype = w.dtype
    d = w.shape[0]
    phys = _per_site(phys_charges, 1)[0]
    if len(phys) != d:
        raise ValueError(f"phys_charges has {len(phys)} entries for phys dim {d}")
    rep = MPO(w.expand((3,) + tuple(w.shape)),
              as_tensor(mpo_cell.left, device), as_tensor(mpo_cell.right, device))
    mpo_channel_charges(rep, phys)  # raises if not definite
    if init is not None:
        sector = init["sector"]
        if int(sector["bond_dim"]) != int(bond_dim):
            raise ValueError(f"init bundle is for bond {sector['bond_dim']}, "
                             f"requested {bond_dim}")
        site_mask, bond_mask = sector["site_mask"], sector["bond_mask"]
        c, ac = init["c"], init["ac"]
        # re-isometrize the warm start (noise perturbs the gauge)
        al, ar, _ = _gauge_update_u1(ac, c, c, site_mask, sector["row_sel"],
                                     sector["row_t_sel"], sector["slot_sel"],
                                     sector["slot_sel"])
    else:
        sector = u1_uniform_sector(phys, bond_dim, charges=charges, dtype=dtype,
                                   device=device)
        site_mask, bond_mask = sector["site_mask"], sector["bond_mask"]
        a0 = torch.randn((d, bond_dim, bond_dim), dtype=dtype, device=device,
                         generator=generator) * site_mask
        # masked mixed-gauge start: aligned orthogonalizations give
        # class-pure partial isometries; C = the live-slot identity
        al_q, _ = _aligned_ortho(a0.reshape(d * bond_dim, bond_dim),
                                 sector["row_sel"], sector["slot_sel"],
                                 sector["slot_rank"])
        al = al_q.reshape(d, bond_dim, bond_dim) * site_mask
        ar_q, _ = _aligned_ortho(a0.transpose(1, 2).reshape(d * bond_dim, bond_dim),
                                 sector["row_t_sel"], sector["slot_sel"],
                                 sector["slot_rank"])
        ar = ar_q.reshape(d, bond_dim, bond_dim).transpose(1, 2) * site_mask
        live = torch.from_numpy((sector["charges"] != _DEAD_VALUE).astype(
            np.float64)).to(device, dtype)
        c = torch.diag(live) / torch.sqrt(live.sum())
        ac = peinsum("dij,jk->dik", al, c) * site_mask

    energies = []
    grad_norm = np.inf
    for _ in range(int(iters)):
        fl, fr, energy = mpo_environments(al, ar, c, w, tol=tol)
        _, ac = lanczos_ground(lambda t: site_mask * _h_ac(fl, w, fr, t), ac,
                               lanczos_iters)
        _, c = lanczos_ground(lambda t: bond_mask * _h_c(fl, fr, t), c,
                              lanczos_iters)
        al, ar, grad = _gauge_update_u1(ac, c, c, site_mask, sector["row_sel"],
                                        sector["row_t_sel"], sector["slot_sel"],
                                        sector["slot_sel"])
        grad_norm = float(grad)
        energies.append(energy)
        if grad_norm < 1e-11:
            break

    return {
        "al": al, "ar": ar, "ac": ac, "c": c,
        "energy": energies[-1], "energies": energies,
        "gradient_norm": grad_norm, "sector": sector,
    }
