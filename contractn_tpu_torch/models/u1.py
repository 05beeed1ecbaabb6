"""Charge-masked exact-U(1) cores: symmetry as static block masks.

Counterpart of ``contractn_tpu/models/u1.py``.  Every bond index carries a
static charge label and every site tensor is multiplied by a 0/1 mask

    ``mask[n][s, i, j] = [q_bond[n][i] + q_phys[s] == q_bond[n+1][j]]``

so the dense ``(N, d, D, D)`` stacked-core machinery — the uniform DMRG
sweep of :mod:`.ensemble`, TDVP — runs unchanged while the state lives
exactly in one U(1) sector.  With a channel-charge-definite MPO
(:func:`mpo_channel_charges` verifies it; :func:`xxz_mpo_u1` provides the
XXZ chain in S+/S- channels) the effective Hamiltonians map the masked
subspace into itself, and the charge-ALIGNED split keeps the mid-bond
layout: ``cores * (1 - masks) == 0`` holds identically.

Division of labour: the charge ladders, the masks and the MPO channel
bookkeeping are host numpy (they depend only on the lattice and sector);
the masks go to the device once.  The aligned split
(:func:`_u1_splitter`) computes, as the JAX package does, one full-shape
SVD per global charge class ``C`` on the class-masked ``(d D, d D)``
matrix, here as ONE batched ``torch.linalg.svd`` of the ``C`` stacked
matrices (times any ensemble axis), and gathers each class's top singular
triplets into its mid-bond slots with precomputed static indices.
:func:`dmrg_u1` is an eager call of the uniform sweep; the ensemble runs the
Hamiltonians as a leading batch axis of every op.

Random draws take an explicit ``torch.Generator`` where the JAX package
takes a key.
"""

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .dmrg import _SZ
from .ensemble import _dmrg_uniform_core
from .mpo import MPO, _uniform_mpo
from .mps import MPS

# sentinel charge for unassigned bond slots (never matches a real charge)
_DEAD_VALUE = np.int64(2 ** 40)


def _host(x):
    """A tensor (or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _per_site(phys_charges, n_sites):
    """One int list per site: a flat sequence means every site carries the
    same charges; a sequence of sequences gives each site its own (all
    sites share the physical dimension)."""
    seq = list(phys_charges)
    if seq and hasattr(seq[0], "__len__"):
        if len(seq) != n_sites:
            raise ValueError(
                f"per-site phys_charges has {len(seq)} entries for "
                f"{n_sites} sites")
        out = [[int(p) for p in site] for site in seq]
        if len({len(s) for s in out}) != 1:
            raise ValueError("all sites must share the physical dim")
        return out
    return [[int(p) for p in seq]] * n_sites


def u1_bond_charges(n_sites, phys_charges, total_charge, bond_dim):
    """Assign a static charge label to every slot of every bond.

    Bond ``n``'s allowed charges are the intersection of forward
    reachability and backward consistency; the ``bond_dim`` slots are split
    among them proportionally to the number of lattice paths through each
    charge, largest-remainder rounded, at least one slot per kept charge.
    Bond 0 is ``[0]``, bond N ``[total_charge]``.  Packed multi-U(1)
    charges (``N_up * A + N_dn``, :func:`~.hubbard.hubbard_phys_charges`)
    ride the same ladder.

    Returns ``n_sites + 1`` numpy int arrays of length ``bond_dim``; dead
    slots hold ``_DEAD_VALUE``.
    """
    phys = _per_site(phys_charges, n_sites)
    fwd = [{0: 1}]
    for n in range(n_sites):
        nxt = {}
        for q, c in fwd[-1].items():
            for p in phys[n]:
                nxt[q + p] = nxt.get(q + p, 0) + c
        fwd.append(nxt)
    bwd = [{int(total_charge): 1}]
    for n in range(n_sites - 1, -1, -1):
        nxt = {}
        for q, c in bwd[-1].items():
            for p in phys[n]:
                nxt[q - p] = nxt.get(q - p, 0) + c
        bwd.append(nxt)
    bwd = bwd[::-1]

    charges = []
    for n in range(n_sites + 1):
        weights = {q: fwd[n][q] * bwd[n][q] for q in fwd[n] if q in bwd[n]}
        if not weights:
            raise ValueError(
                f"total charge {total_charge} unreachable with "
                f"phys_charges {phys_charges} on {n_sites} sites"
            )
        qs = sorted(weights, key=lambda q: (-weights[q], q))[:bond_dim]
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
        slots = slots[:bond_dim]
        arr = np.full((bond_dim,), _DEAD_VALUE, np.int64)
        arr[: len(slots)] = slots
        charges.append(arr)
    # boundary bonds: the unique charge in slot 0 (the e_0 convention)
    charges[0] = np.full((bond_dim,), _DEAD_VALUE, np.int64)
    charges[0][0] = 0
    charges[-1] = np.full((bond_dim,), _DEAD_VALUE, np.int64)
    charges[-1][0] = int(total_charge)
    return charges


def _masks_np(bond_charges, phys_charges):
    n_sites = len(bond_charges) - 1
    phys = _per_site(phys_charges, n_sites)
    d = len(phys[0])
    bond = bond_charges[0].shape[0]
    masks = np.zeros((n_sites, d, bond, bond), np.float64)
    for n in range(n_sites):
        qi, qj = bond_charges[n], bond_charges[n + 1]
        vi, vj = qi != _DEAD_VALUE, qj != _DEAD_VALUE
        for s, p in enumerate(phys[n]):
            ok = qi[:, None] + int(p) == qj[None, :]
            masks[n, s] = ok & vi[:, None] & vj[None, :]
    return masks


def _put(array, device, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(array)).to(
        resolve_device(device), torch_dtype(dtype))


def u1_masks(bond_charges, phys_charges, dtype=torch.float64, device=None):
    """``(N, d, D, D)`` 0/1 masks from per-bond charge labels, on ``device``
    (default ``cuda``)."""
    return _put(_masks_np(bond_charges, phys_charges), device, dtype)


def mpo_channel_charges(mpo, phys_charges):
    """Per-bond, per-channel charge labels ``c (n_sites + 1, W)`` of an MPO,
    or raise ``ValueError``.

    Consistent when every nonzero ``W_n[a, b, w, v]`` satisfies ``c[n][w] -
    c[n + 1][v] = q_phys[n][a] - q_phys[n][b]``; such an assignment makes
    the Heff matvec exactly sector-preserving on masked states.  Mixed-basis
    MPOs (the SX / iY channels of :func:`~.dmrg.heisenberg_mpo`) have none.
    Host numpy.
    """
    cores = _host(mpo.cores)
    n_sites = cores.shape[0]
    phys = _per_site(phys_charges, n_sites)
    wdim = cores.shape[-1]
    deltas = np.full((n_sites, wdim, wdim), _DEAD_VALUE, np.int64)
    active = np.zeros((n_sites, wdim, wdim), bool)
    for n in range(n_sites):
        nz = np.nonzero(cores[n])
        seen = {}
        for a, b, wch, vch in zip(*nz):
            dq = phys[n][a] - phys[n][b]
            key = (wch, vch)
            if key in seen and seen[key] != dq:
                raise ValueError(
                    f"site {n} MPO channel pair {key} mixes charge "
                    f"transfers {sorted({seen[key], dq})} — not channel-"
                    "charge-definite; rewrite in raising/lowering "
                    "channels (see xxz_mpo_u1)"
                )
            seen[key] = dq
        for (wch, vch), dq in seen.items():
            deltas[n, wch, vch] = dq
            active[n, wch, vch] = True
    c = [dict() for _ in range(n_sites + 1)]
    for ch in np.nonzero(_host(mpo.left))[0]:
        c[0][int(ch)] = 0
    changed = True
    while changed:  # fixpoint; flows mostly left-to-right, few passes
        changed = False
        for n in range(n_sites):
            for wch, vch in zip(*np.nonzero(active[n])):
                dq = int(deltas[n, wch, vch])
                kw, kv = int(wch) in c[n], int(vch) in c[n + 1]
                if kw and kv:
                    if c[n][wch] - c[n + 1][vch] != dq:
                        raise ValueError(
                            f"inconsistent channel charges at bond "
                            f"{n + 1} channel {vch}: not channel-"
                            "charge-definite"
                        )
                elif kw:
                    c[n + 1][int(vch)] = c[n][wch] - dq
                    changed = True
                elif kv:
                    c[n][int(wch)] = c[n + 1][vch] + dq
                    changed = True
    out = np.zeros((n_sites + 1, wdim), np.int64)
    for b in range(n_sites + 1):
        for i in range(wdim):
            out[b, i] = c[b].get(i, 0)  # disconnected: irrelevant
    return out


def _blocked_split(a, cl, cr, dqi, trunc):
    """Factor ``a (do, di, L, R) = Q R`` per charge class; returns ``(q_core,
    r_mat, new_charges)`` with ``q_core`` left-isometric per class, or None.
    ``trunc``: ``(cutoff, max_bond)`` or None."""
    row_q = cl[None, None, :] - dqi[:, :, None]  # (do, di, L)
    blocks = []
    for q in np.unique(np.concatenate([row_q.ravel(), cr])):
        rmask = row_q == q
        cidx = np.nonzero(cr == q)[0]
        if cidx.size == 0 or not rmask.any():
            continue
        mat = a[:, :, :, cidx][rmask, :]
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        blocks.append((q, rmask, cidx, u, s, vh))
    if not blocks:
        return None
    smax = max((s[0] for _, _, _, _, s, _ in blocks if s.size), default=0.0)
    keep = []
    for q, rmask, cidx, u, s, vh in blocks:
        k = s.size
        if trunc is not None:
            k = int(np.sum(s > trunc[0] * max(smax, 1e-300)))
        keep.append((q, rmask, cidx, u[:, :k], s[:k], vh[:k]))
    if trunc is not None and trunc[1] is not None:
        # global top-max_bond across classes
        allpairs = sorted(
            [(s_val, bi, j) for bi, (_, _, _, _, s, _) in enumerate(keep)
             for j, s_val in enumerate(s)],
            reverse=True,
        )[:trunc[1]]
        counts = {}
        for _, bi, _ in allpairs:
            counts[bi] = counts.get(bi, 0) + 1
        keep = [
            (q, rmask, cidx, u[:, :counts.get(bi, 0)], s[:counts.get(bi, 0)],
             vh[:counts.get(bi, 0)])
            for bi, (q, rmask, cidx, u, s, vh) in enumerate(keep)
        ]
    keep = [blk for blk in keep if blk[4].size > 0]
    width = sum(blk[4].size for blk in keep)
    if width == 0:
        return None
    q_core = np.zeros(a.shape[:3] + (width,), a.dtype)
    r_mat = np.zeros((width, a.shape[3]), a.dtype)
    new_c = np.zeros(width, np.int64)
    off = 0
    for q, rmask, cidx, u, s, vh in keep:
        k = s.size
        q_core[:, :, :, off:off + k][rmask, :] = u
        r_mat[off:off + k][:, cidx] = s[:, None] * vh
        new_c[off:off + k] = q
        off += k
    return q_core, r_mat, new_c


def compress_mpo_u1(mpo, phys_charges, cutoff=1e-12, max_bond=None):
    """Charge-blocked MPO compression: SVD within charge classes.

    A plain :func:`~.canonical.compress_mpo` SVD mixes virtual channels of
    different charge transfer and destroys channel-charge definiteness.
    Here the input's channel labels make every bond matrix block-diagonal
    in charge, so per-class SVDs compress with no mixing: a left rank pass,
    then a right truncating pass (per-bond cutoff relative to the bond's
    largest singular value).  Host numpy; the MPO goes back to the input's
    device.

    Returns ``(mpo, bond_charges)``: the compressed operator (padded uniform
    width) and the live per-bond charge labels, boundaries included.
    """
    c = mpo_channel_charges(mpo, phys_charges)
    cores_in = _host(mpo.cores)
    n, do, di = cores_in.shape[0], cores_in.shape[1], cores_in.shape[2]
    phys = _per_site(phys_charges, n)
    dq = [np.subtract.outer(np.asarray(p), np.asarray(p)) for p in phys]

    sites = [cores_in[i] for i in range(n)]
    sites[0] = np.einsum("w,abwv->abv", _host(mpo.left), sites[0])[:, :, None, :]
    sites[-1] = np.einsum("abwv,v->abw", sites[-1], _host(mpo.right))[:, :, :, None]
    charges = ([np.zeros(1, np.int64)]
               + [np.asarray(c[b], np.int64) for b in range(1, n)]
               + [np.zeros(1, np.int64)])

    for i in range(n - 1):  # left -> right, rank-revealing
        got = _blocked_split(sites[i], charges[i], charges[i + 1], dq[i], None)
        if got is None:
            raise ValueError("operator is identically zero")
        sites[i], r_mat, charges[i + 1] = got
        sites[i + 1] = np.einsum("kv,abvr->abkr", r_mat, sites[i + 1])
    for i in range(n - 1, 0, -1):  # right -> left, truncating (mirrored)
        a = sites[i].transpose(0, 1, 3, 2)
        got = _blocked_split(a, charges[i + 1], charges[i], -dq[i],
                             (cutoff, max_bond))
        if got is None:
            raise ValueError("operator is identically zero")
        q_core, r_mat, charges[i] = got
        sites[i] = q_core.transpose(0, 1, 3, 2)
        sites[i - 1] = np.einsum("ablv,kv->ablk", sites[i - 1], r_mat)

    widths = [s.shape[2] for s in sites] + [1]
    wmax = max(max(widths), 1)
    out = np.zeros((n, do, di, wmax, wmax), cores_in.dtype)
    for i in range(n):
        out[i, :, :, :sites[i].shape[2], :sites[i].shape[3]] = sites[i]
    e0 = np.zeros(wmax, cores_in.dtype)
    e0[0] = 1.0
    device = mpo.cores.device if isinstance(mpo.cores, torch.Tensor) else None
    return MPO(*(torch.from_numpy(x).to(resolve_device(device))
                 for x in (out, e0, e0.copy()))), charges


def xxz_mpo_u1(n_sites, jx=1.0, jz=1.0, dtype=torch.float64, device=None):
    """XXZ chain ``H = sum Jx (XX + YY) + Jz ZZ`` in S+/S- channels (channel
    charges ``[0, -2, +2, 0, 0]`` in ``2 S^z`` units); the same Hamiltonian
    as :func:`~.dmrg.heisenberg_mpo`, all-real."""
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    sm = sp.T
    w = np.zeros((2, 2, 5, 5))
    w[:, :, 0, 0] = np.eye(2)
    w[:, :, 4, 4] = np.eye(2)
    w[:, :, 0, 1] = sp
    w[:, :, 1, 4] = 2.0 * jx * sm
    w[:, :, 0, 2] = sm
    w[:, :, 2, 4] = 2.0 * jx * sp
    w[:, :, 0, 3] = _SZ
    w[:, :, 3, 4] = jz * _SZ
    return _uniform_mpo(w, np.array([1.0, 0, 0, 0, 0]),
                        np.array([0, 0, 0, 0, 1.0]), n_sites, dtype, device)


def _e0(bond, dtype, device, batch=()):
    e0 = torch.zeros(tuple(batch) + (bond,), dtype=dtype, device=device)
    e0[..., 0] = 1.0
    return e0


def random_masked_mps(masks, dtype=torch.float64, generator=None, batch=()):
    """Random MPS supported exactly on the masked (fixed-sector) blocks:
    standard normal cores (drawn from ``generator`` on the masks' device, or
    the global one) times ``masks``; ``batch`` leading axes for ensembles."""
    n, d, bond, _ = masks.shape
    cores = torch.randn(tuple(batch) + (n, d, bond, bond), dtype=dtype,
                        device=masks.device, generator=generator)
    cores = cores * masks.to(dtype)
    e0 = _e0(bond, dtype, masks.device, batch)
    return MPS(cores, e0, e0.clone())


def determinant_mps_u1(occupations, bond_charges, phys_charges,
                       generator=None, noise=1e-2, dtype=torch.float64,
                       device=None):
    """Masked MPS seeded on a product determinant's charge walk (amplitude 1
    along the walk), plus ``noise`` times masked standard-normal draws from
    ``generator`` so the local solves do not start rank-deficient."""
    occ = np.asarray(occupations, int)
    n = occ.shape[0]
    phys = _per_site(phys_charges, n)
    masks = u1_masks(bond_charges, phys_charges, dtype=dtype, device=device)
    bond = masks.shape[-1]
    cores = np.zeros((n, masks.shape[1], bond, bond))
    q = 0
    slot_prev = int(np.nonzero(np.asarray(bond_charges[0]) == 0)[0][0])
    for i in range(n):
        q_next = q + int(phys[i][occ[i]])
        nxt = np.nonzero(np.asarray(bond_charges[i + 1]) == q_next)[0]
        if nxt.size == 0:
            raise ValueError(
                f"determinant leaves the sector ladder at bond {i + 1} "
                f"(charge {q_next} unallocated — raise bond_dim)"
            )
        slot = int(nxt[0])
        cores[i, occ[i], slot_prev, slot] = 1.0
        q, slot_prev = q_next, slot
    out = torch.from_numpy(cores).to(masks.device, dtype)
    if noise:
        out = out + noise * torch.randn(out.shape, dtype=dtype,
                                        device=out.device,
                                        generator=generator) * masks
    e0 = _e0(bond, dtype, masks.device)
    return MPS(out, e0, e0.clone())


def _classes(bond_charges):
    return sorted({int(q) for qc in bond_charges[1:-1] for q in qc
                   if q != _DEAD_VALUE})


def _split_masks(bond_charges, phys_charges, device=None):
    """Static per-bond charge-class selectors for the aligned split, for
    each two-site update at left site ``i`` and global class ``c``:

    * ``row (n-1, C, d*D)``: theta rows ``(s1, l)`` of left charge ``c``;
    * ``col (n-1, C, d*D)``: columns ``(s2, r)`` of right-minus-phys ``c``;
    * ``slot (n-1, C, D)``: mid-bond slots labelled ``c``;
    * ``rank (n-1, C, D)``: each slot's 0-based rank within its class
      (clipped to ``d*D - 1``), the static gather index of the split.
    """
    n_bonds = len(bond_charges) - 1
    phys = _per_site(phys_charges, n_bonds)
    d = len(phys[0])
    bond = bond_charges[0].shape[0]
    classes = _classes(bond_charges)
    n_cls = max(len(classes), 1)
    row = np.zeros((n_bonds - 1, n_cls, d * bond))
    col = np.zeros((n_bonds - 1, n_cls, d * bond))
    slot = np.zeros((n_bonds - 1, n_cls, bond))
    for i in range(n_bonds - 1):
        ql, qm, qr = bond_charges[i], bond_charges[i + 1], bond_charges[i + 2]
        for ci, c in enumerate(classes):
            for s_idx in range(d):
                pl, pr = phys[i][s_idx], phys[i + 1][s_idx]
                row[i, ci, s_idx * bond:(s_idx + 1) * bond] = (
                    (ql != _DEAD_VALUE) & (ql + pl == c))
                col[i, ci, s_idx * bond:(s_idx + 1) * bond] = (
                    (qr != _DEAD_VALUE) & (qr - pr == c))
            slot[i, ci] = (qm != _DEAD_VALUE) & (qm == c)
    rank = np.clip(np.cumsum(slot, axis=-1) - 1, 0, d * bond - 1)
    return (_put(row, device), _put(col, device), _put(slot, device),
            _put(rank, device, torch.int64))


def _gather_classes(u, s, vh, rank, sel):
    """Scatter each class's singular triplets (ranks ``rank (C, D)``) into
    its slots (``sel (C, D)`` weights) and sum over classes: ``u (..., C, m,
    k)``, ``s (..., C, k)``, ``vh (..., C, k, p)`` -> ``(..., m, D)``,
    ``(..., D)``, ``(..., D, p)``."""
    batch = u.shape[:-3]
    c, m, _ = u.shape[-3:]
    p = vh.shape[-1]
    slots = rank.shape[-1]
    dt = u.dtype
    u_g = torch.gather(u, -1, rank[:, None, :].expand(batch + (c, m, slots)))
    s_g = torch.gather(s, -1, rank.expand(batch + (c, slots)))
    v_g = torch.gather(vh, -2, rank[:, :, None].expand(batch + (c, slots, p)))
    return ((u_g * sel[:, None, :].to(dt)).sum(-3),
            (s_g * sel.to(s.dtype)).sum(-2),
            (v_g * sel[:, :, None].to(dt)).sum(-3))


def _u1_splitter(split_masks, phys_dim, bond):
    """Charge-aligned two-site split: one full-shape SVD per global charge
    class on the class-masked theta matrix (rows and columns outside the
    class are zero, so its nonzero singular triplets are exactly the class
    block's), all classes (and ensemble members) in ONE batched SVD call,
    each class's top triplets gathered into its static mid-bond slots.
    Accepts leading batch axes on ``theta``."""
    row_m, col_m, slot_m, rank_m = split_masks

    def splitter(theta, i, to_left):
        *batch, d, _, dl, dr = theta.shape
        batch = tuple(batch)
        mat = theta.transpose(-3, -2).reshape(batch + (d * dl, d * dr))
        dt = mat.dtype
        sub = (mat[..., None, :, :] * row_m[i][:, :, None].to(dt)
               * col_m[i][:, None, :].to(dt))
        u, sv, vh = torch.linalg.svd(sub, full_matrices=False)
        u_acc, s_acc, v_acc = _gather_classes(u, sv, vh, rank_m[i], slot_m[i])
        s_acc = s_acc / torch.clamp(torch.linalg.norm(s_acc, dim=-1,
                                                      keepdim=True), min=1e-300)
        s_acc = s_acc.to(dt)
        if to_left:
            t1 = u_acc.reshape(batch + (d, dl, bond))
            t2 = (s_acc[..., :, None] * v_acc).reshape(
                batch + (bond, d, dr)).transpose(-3, -2)
        else:
            t1 = (u_acc * s_acc[..., None, :]).reshape(batch + (d, dl, bond))
            t2 = v_acc.reshape(batch + (bond, d, dr)).transpose(-3, -2)
        return t1, t2

    return splitter


def _check_mps0(mps0, masks, dtype):
    cores = mps0.cores.to(masks.device, dtype)
    if float(torch.max(torch.abs(cores * (1.0 - masks.to(dtype))))) > 0.0:
        raise ValueError(
            "mps0 has support outside the sector masks; build it on "
            "u1_bond_charges/u1_masks (see determinant_mps_u1)"
        )
    return MPS(cores, mps0.left.to(masks.device, dtype),
               mps0.right.to(masks.device, dtype))


def dmrg_u1(mpo, total_charge, bond_dim, phys_charges=(1, -1), sweeps=6,
            lanczos_iters=40, generator=None, dtype=torch.float64, mps0=None):
    """Exact-sector ground state by charge-masked uniform DMRG, on the MPO's
    device.

    Args:
        mpo: channel-charge-definite Hamiltonian (verified).
        total_charge: target sector in ``phys_charges`` units.
        bond_dim: optimization bond (slots split among the sector's charges,
            :func:`u1_bond_charges`).
        phys_charges: per-physical-state charges (flat or per site).
        generator: ``torch.Generator`` on the MPO's device for the random
            masked start (ignored with ``mps0``).
        mps0: optional start supported on the sector masks (raises
            otherwise; see :func:`determinant_mps_u1`).

    Returns ``(mps, energy, energies, masks)``; ``mps.cores * (1 - masks) ==
    0`` identically.
    """
    n_sites = mpo.n_sites
    phys_dim = len(_per_site(phys_charges, n_sites)[0])
    mpo_channel_charges(mpo, phys_charges)  # raises if not definite
    device = mpo.cores.device
    bond_charges = u1_bond_charges(n_sites, phys_charges, total_charge, bond_dim)
    masks = u1_masks(bond_charges, phys_charges, dtype=dtype, device=device)
    if mps0 is None:
        mps0 = random_masked_mps(masks, dtype=dtype, generator=generator)
    else:
        mps0 = _check_mps0(mps0, masks, dtype)
    split = _split_masks(bond_charges, phys_charges, device)
    mps, energy, energies = _dmrg_uniform_core(
        mpo, mps0, int(sweeps), int(lanczos_iters), masks=masks,
        splitter=_u1_splitter(split, phys_dim, int(bond_dim)))
    return mps, energy, energies, masks


# --------------------------------------------------------------------- #
# Charge-masked time evolution (exact-U(1) TDVP)
# --------------------------------------------------------------------- #


def theta_masks_u1(bond_charges, phys_charges, device=None):
    """``(N-1, d, d, D, D)`` two-site block masks (the middle bond summed
    out), on ``device``."""
    n_bonds = len(bond_charges) - 1
    phys = _per_site(phys_charges, n_bonds)
    d = len(phys[0])
    bond = bond_charges[0].shape[0]
    out = np.zeros((n_bonds - 1, d, d, bond, bond))
    for i in range(n_bonds - 1):
        ql, qr = bond_charges[i], bond_charges[i + 2]
        vl, vr = ql != _DEAD_VALUE, qr != _DEAD_VALUE
        for s1, p1 in enumerate(phys[i]):
            for s2, p2 in enumerate(phys[i + 1]):
                ok = ql[:, None] + int(p1) + int(p2) == qr[None, :]
                out[i, s1, s2] = ok & vl[:, None] & vr[None, :]
    return _put(out, device)


def bond_masks_u1(bond_charges, device=None):
    """``(N+1, D, D)`` zero-site masks: slots of equal live charge."""
    bond = bond_charges[0].shape[0]
    out = np.zeros((len(bond_charges), bond, bond))
    for b, q in enumerate(bond_charges):
        v = q != _DEAD_VALUE
        out[b] = (q[:, None] == q[None, :]) & v[:, None] & v[None, :]
    return _put(out, device)


def u1_sector(n_sites, total_charge, bond_dim, phys_charges=(1, -1),
              dtype=torch.float64, device=None):
    """Everything a fixed-sector computation needs, bundled in a dict: bond
    charges (host), and the site, split, theta and bond masks on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    bond_charges = u1_bond_charges(n_sites, phys_charges, total_charge, bond_dim)
    phys = _per_site(phys_charges, n_sites)
    stored = (tuple(tuple(s) for s in phys)
              if hasattr(list(phys_charges)[0], "__len__")
              else tuple(int(p) for p in phys_charges))
    return {
        "bond_charges": bond_charges,
        "masks": u1_masks(bond_charges, phys_charges, dtype=dtype, device=device),
        "split_masks": _split_masks(bond_charges, phys_charges, device),
        "theta_masks": theta_masks_u1(bond_charges, phys_charges, device),
        "bond_masks": bond_masks_u1(bond_charges, device),
        "phys_charges": stored,
        "phys_dim": len(phys[0]),
        "bond_dim": int(bond_dim),
    }


def tdvp_u1(mpo, mps, sector, dt, n_steps, imaginary=False, iters=16):
    """Two-site TDVP confined exactly to one U(1) sector: the masks and the
    charge-aligned splitter through :func:`~.tdvp.tdvp_evolve`'s hooks.
    Returns ``(mps, [energies])``."""
    from .tdvp import tdvp_evolve

    mpo_channel_charges(mpo, sector["phys_charges"])
    splitter = _u1_splitter(sector["split_masks"], sector["phys_dim"],
                            sector["bond_dim"])
    return tdvp_evolve(mpo, mps, dt, n_steps, imaginary=imaginary, iters=iters,
                       masks=sector["masks"], theta_masks=sector["theta_masks"],
                       splitter=splitter)


def _aligned_ortho(mat, row_sel, slot_sel, rank_sel):
    """Charge-aligned orthogonalization ``mat = Q C`` with ``Q`` a
    class-pure partial isometry: per charge class the SVD of the class's
    rows (all classes in one batched call) gathered into the class's slots,
    numerically-zero singular directions zeroed outright (a plain QR's junk
    completion columns corrupt masked environments)."""
    dt = mat.dtype
    sub = mat[None, :, :] * row_sel[:, :, None].to(dt)
    u, s, vh = torch.linalg.svd(sub, full_matrices=False)
    rank = rank_sel.clamp(max=s.shape[-1] - 1)
    s_g = torch.gather(s, -1, rank)
    keep = ((s_g > 1e-13 * torch.clamp(s[:, :1], min=1e-300)).to(s.dtype)
            * slot_sel.to(s.dtype))
    q_acc, _, c_acc = _gather_classes(u, s, vh * s[:, :, None].to(dt), rank, keep)
    return q_acc, c_acc


def _u1_orth(split_masks):
    """``(fwd, bwd)`` gauge movers for the masked TDVP1 sweeps: ``fwd(mat,
    i)`` over bond ``i+1``'s slots, ``bwd(matT, i)`` over bond ``i``'s."""
    row_m, col_m, slot_m, rank_m = split_masks

    def fwd(mat, i):
        return _aligned_ortho(mat, row_m[i], slot_m[i], rank_m[i])

    def bwd(mat_t, i):
        return _aligned_ortho(mat_t, col_m[i - 1], slot_m[i - 1], rank_m[i - 1])

    return fwd, bwd


def tdvp1_u1(mpo, mps, sector, dt, n_steps, imaginary=False, iters=16):
    """Single-site TDVP in a fixed U(1) sector (exact manifold, fixed bond),
    with the charge-aligned partial-isometry gauge moves.  Returns ``(mps,
    [energies])``."""
    from .tdvp import tdvp1_evolve

    mpo_channel_charges(mpo, sector["phys_charges"])
    return tdvp1_evolve(mpo, mps, dt, n_steps, imaginary=imaginary, iters=iters,
                        masks=sector["masks"], bond_masks=sector["bond_masks"],
                        orth=_u1_orth(sector["split_masks"]))


def dmrg_u1_ensemble(mpos, total_charge, bond_dim, phys_charges=(1, -1),
                     sweeps=6, lanczos_iters=40, generator=None,
                     dtype=torch.float64):
    """Exact-sector ground states for a batch of Hamiltonians at once.

    ``mpos`` carries a leading ensemble axis ``K`` (:func:`~.ensemble.
    stack_pytrees`); the masks and the aligned splitter depend only on the
    sector and lattice, so all members share them and run as one batched
    sweep (every op, the class SVDs included, carries the ``K`` axis).
    The ``K`` starts are one batched draw of :func:`random_masked_mps` from
    ``generator``.

    Returns ``(mpss, energies, traces, masks)`` with leading axis ``K``.
    """
    n_sites = int(mpos.cores.shape[1])
    k_batch = int(mpos.cores.shape[0])
    if k_batch < 1:
        raise ValueError("empty ensemble")
    first = MPO(mpos.cores[0], mpos.left[0], mpos.right[0])
    phys_dim = len(_per_site(phys_charges, n_sites)[0])
    mpo_channel_charges(first, phys_charges)  # shared structure
    device = mpos.cores.device
    bond_charges = u1_bond_charges(n_sites, phys_charges, total_charge, bond_dim)
    masks = u1_masks(bond_charges, phys_charges, dtype=dtype, device=device)
    mps0s = random_masked_mps(masks, dtype=dtype, generator=generator,
                              batch=(k_batch,))
    split = _split_masks(bond_charges, phys_charges, device)
    mpss, energies, traces = _dmrg_uniform_core(
        mpos, mps0s, int(sweeps), int(lanczos_iters), masks=masks,
        splitter=_u1_splitter(split, phys_dim, int(bond_dim)), batch_ndim=1)
    return mpss, energies, traces, masks

