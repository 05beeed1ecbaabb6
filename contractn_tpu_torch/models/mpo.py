"""Matrix product operators and stabilized expectation values.

Counterpart of ``contractn_tpu/models/mpo.py``: ``MPO``, ``rayleigh``,
``mpo_from_bond_term``, the operator algebra (``mpo_sum``, ``mpo_dagger``,
``mpo_multiply``, ``block_mpo``, ``deparallelize_mpo``) and the bulk-core
algebra of infinite chains (``umpo_scale``, ``umpo_sum``, ``umpo_onsite``).
``<psi| O |psi>`` contracts the three-layer sandwich site by site, carrying
the ``(D, W, D)`` boundary environment with a rescale per site — transfer
matrices of size ``(D^2 W)^2`` are never formed.  The batched form over
many MPS with one uniform MPO runs through the hand-written CUDA kernel in
:mod:`..ops.cuda_mpo`.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.scan import _stab_step
from ..ops.stabilize import destabilize, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device


@dataclass
class MPO:
    """Open-boundary MPO: cores ``(N, d_out, d_in, W, W)`` + boundary vectors.

    ``W`` is the operator bond dimension.
    """

    cores: torch.Tensor
    left: torch.Tensor  # (W,)
    right: torch.Tensor  # (W,)

    @classmethod
    def random(cls, n_sites, phys_dim, bond_dim, dtype=torch.float32,
               scale=None, generator=None, device=None):
        device = resolve_device(device)
        if scale is None:
            scale = 1.0 / (bond_dim * phys_dim) ** 0.5

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=dtype)

        cores = scale * normal(n_sites, phys_dim, phys_dim, bond_dim, bond_dim)
        return cls(cores, normal(bond_dim), normal(bond_dim))

    @classmethod
    def identity(cls, n_sites, phys_dim, dtype=torch.float64, device=None):
        """The identity operator as a bond-1 MPO."""
        device = resolve_device(device)
        eye = torch.eye(phys_dim, dtype=dtype, device=device)[None, :, :, None, None]
        cores = eye.expand(n_sites, phys_dim, phys_dim, 1, 1).contiguous()
        one = torch.ones((1,), dtype=dtype, device=device)
        return cls(cores, one, one)

    @property
    def n_sites(self):
        return self.cores.shape[0]

    def expectation(self, mps, split_format=True):
        """Stabilized ``<psi| O |psi>`` for an MPS with matching ``N, d``.

        Environment ``env[i, w, k] = <bra-bond i | op-bond w | ket-bond k>``
        updates per site with three contractions:

        1. ket:   ``env . B[d']``       over the ket bond
        2. op:    ``W[d,d',w,w'] . *``  over ``(d', w)``
        3. bra:   ``conj(A[d]) . *``    over ``(d, i)``
        """
        dtype = torch.promote_types(mps.cores.dtype, self.cores.dtype)
        cores, ops = mps.cores.to(dtype), self.cores.to(dtype)
        left, right = mps.left.to(dtype), mps.right.to(dtype)
        env = torch.einsum(
            "i,w,k->iwk", left.conj(), self.left.to(dtype), left
        )
        log = torch.zeros((), dtype=real_dtype(dtype), device=env.device)
        for a, w in zip(cores, ops):  # (d, D, D), (d_out, d_in, W, W)
            t = torch.einsum("iwk,ekl->iwel", env, a)
            t = torch.einsum("dewv,iwel->idvl", w, t)
            env = torch.einsum("dij,idvl->jvl", a.conj(), t)
            env, log = _stab_step(env, log, 0)
        val = torch.einsum(
            "iwk,i,w,k->", env, right.conj(), self.right.to(dtype), right
        )
        val, log = _stab_step(val, log, 0)
        return (val, log) if split_format else destabilize(val, log)


def mpo_from_bond_term(h2, n_sites, d=2, tol=1e-12, dtype=None, device=None):
    """MPO for ``H = sum_i h2_{i, i+1}`` from the dense bond term.

    Operator-Schmidt decomposition of the term across the bond
    (``h2 = sum_k U_k (x) V_k``, rank ``r``), assembled as the standard
    triangular finite-state MPO with ``W = r + 2``.

    Args:
        h2: two-site term, dense ``(d^2, d^2)`` (numpy or torch).
        n_sites: chain length.
        tol: singular values below ``tol * s[0]`` are dropped.

    Returns:
        An :class:`MPO` with ``cores (N, d, d, W, W)``.
    """
    if isinstance(h2, torch.Tensor):
        h2 = h2.detach().cpu().numpy()
    h2 = np.asarray(h2)
    np_dtype = np.dtype(dtype) if dtype is not None and not isinstance(
        dtype, torch.dtype) else h2.dtype
    h4 = h2.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    u, sv, vh = np.linalg.svd(h4, full_matrices=False)
    keep = sv > tol * (sv[0] if sv[0] > 0 else 1.0)
    u, sv, vh = u[:, keep], sv[keep], vh[keep]
    r = sv.shape[0]
    us = (u * np.sqrt(sv)[None, :]).T.reshape(r, d, d)
    vs = (vh.T * np.sqrt(sv)[None, :]).T.reshape(r, d, d)

    w = np.zeros((d, d, r + 2, r + 2), np_dtype)
    w[:, :, 0, 0] = np.eye(d)
    w[:, :, r + 1, r + 1] = np.eye(d)
    for k in range(r):
        w[:, :, 0, k + 1] = us[k]
        w[:, :, k + 1, r + 1] = vs[k]
    left = np.zeros((r + 2,), np_dtype)
    left[0] = 1.0
    right = np.zeros((r + 2,), np_dtype)
    right[r + 1] = 1.0
    return _uniform_mpo(w, left, right, n_sites, dtype, device)


def _uniform_mpo(w, left, right, n_sites, dtype, device):
    """MPO with the same numpy core ``w`` at every site, on ``device``."""
    device = resolve_device(device)
    dtype = dtype if isinstance(dtype, torch.dtype) else None

    def put(a):  # a copy: broadcast views are read-only
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    cores = put(np.broadcast_to(w, (n_sites,) + w.shape))
    return MPO(cores, put(left), put(right))


def rayleigh(mpo, mps):
    """``Re <psi|H|psi> / <psi|psi>`` as a host float, overflow-safe.

    Both expectation and norm come back in split format; combining the log
    registers BEFORE exponentiating keeps thousand-site chains finite.
    """
    num_v, num_l = mpo.expectation(mps)
    den_v, den_l = mps.norm_squared()
    return float(torch.real(num_v / den_v)) * float(torch.exp(num_l - den_l))


def _operator(mpo):
    """``(cores, left, right)`` of an MPO as tensors on the cores' device."""
    device = mpo.cores.device
    return (mpo.cores, as_tensor(mpo.left, device), as_tensor(mpo.right, device))


def mpo_sum(m1, m2):
    """``H1 + H2`` as one MPO by direct sum of the virtual channels.

    Block-diagonal cores with concatenated boundary vectors represent the
    sum exactly for arbitrary MPOs, at bond ``W1 + W2`` (compressible
    afterwards with :func:`~.canonical.compress_mpo`).
    """
    c1, l1, r1 = _operator(m1)
    c2, l2, r2 = _operator(m2)
    if c1.shape[0] != c2.shape[0] or c1.shape[1] != c2.shape[1]:
        raise ValueError(
            f"mpo_sum needs matching sites/phys dims; got "
            f"{tuple(c1.shape)} vs {tuple(c2.shape)}"
        )
    dt = torch.promote_types(c1.dtype, c2.dtype)
    n, d, _, w1, _ = c1.shape
    w2 = c2.shape[3]
    cores = torch.zeros((n, d, d, w1 + w2, w1 + w2), dtype=dt, device=c1.device)
    cores[:, :, :, :w1, :w1] = c1
    cores[:, :, :, w1:, w1:] = c2.to(c1.device)
    left = torch.cat([l1.to(dt), l2.to(c1.device, dt)])
    right = torch.cat([r1.to(dt), r2.to(c1.device, dt)])
    return MPO(cores, left, right)


def deparallelize_mpo(mpo, tol=1e-12, max_passes=8):
    """EXACT bond reduction that preserves the triangular automaton.

    SVD compression reaches smaller bonds but destroys the
    ``[I C D; 0 A B; 0 0 I]`` channel structure; deparallelisation
    (Hubig-McCulloch-Schollwoeck) merges PARALLEL virtual channels instead —
    drop zero columns, fold ``col_j = c * col_k`` into ``col_k`` by adding
    ``c x row_j`` into the next core's ``row_k`` — which is exact and keeps
    the form.  The first/last identity channels are always kept, and nothing
    merges INTO the last column (forward) or the first row (backward).
    Alternating forward/backward passes until stable, on the host (numpy);
    the result goes back to the MPO's device.
    """
    device = mpo.cores.device
    cores_in = mpo.cores.detach().cpu().numpy()
    n, do, di, _, _ = cores_in.shape
    left = np.asarray(torch.as_tensor(mpo.left).cpu())
    right = np.asarray(torch.as_tensor(mpo.right).cpu())
    if abs(left[0] - 1.0) > 1e-12 or np.any(left[1:] != 0):
        raise ValueError("deparallelize_mpo expects left boundary e_0")
    if abs(right[-1] - 1.0) > 1e-12 or np.any(right[:-1] != 0):
        raise ValueError("deparallelize_mpo expects right boundary e_last")
    sites = [cores_in[i] for i in range(n)]
    # bond 0 carries only the start channel, bond n only the done channel
    sites[0] = sites[0][:, :, :1, :]
    sites[-1] = sites[-1][:, :, :, -1:]

    def fwd_bond(a, b):
        """Dedup columns of ``a``; returns (a', b') or None."""
        wr = a.shape[3]
        cols = a.reshape(-1, wr)
        kept = [0]
        trans = {0: (0, 1.0)}  # old index -> (kept position, coeff)
        for v in range(1, wr - 1):
            c = cols[:, v]
            nc = np.linalg.norm(c)
            if nc <= tol:
                trans[v] = None
                continue
            hit = None
            for pos, k in enumerate(kept):
                if k == wr - 1:
                    continue  # never merge into the done channel
                kc = cols[:, k]
                coef = np.vdot(kc, c) / np.vdot(kc, kc)
                if np.linalg.norm(c - coef * kc) <= tol * nc:
                    hit = (pos, coef)
                    break
            if hit is None:
                trans[v] = (len(kept), 1.0)
                kept.append(v)
            else:
                trans[v] = hit
        trans[wr - 1] = (len(kept), 1.0)
        kept.append(wr - 1)
        if len(kept) == wr:
            return None
        a2 = a[:, :, :, kept]
        b2 = np.zeros((b.shape[0], b.shape[1], len(kept), b.shape[3]), b.dtype)
        for v, hit in trans.items():
            if hit is not None:
                pos, coef = hit
                b2[:, :, pos, :] += coef * b[:, :, v, :]
        return a2, b2

    def transpose_site(a):
        return a.transpose(0, 1, 3, 2)

    for _ in range(max_passes):
        changed = False
        for i in range(n - 1):
            got = fwd_bond(sites[i], sites[i + 1])
            if got is not None:
                sites[i], sites[i + 1] = got
                changed = True
        for i in range(n - 1, 0, -1):
            # backward = forward on the leg-transposed pair with the channel
            # order reversed (0 <-> last), so the done guard protects row 0
            a = transpose_site(sites[i])[:, :, :, ::-1]
            b = transpose_site(sites[i - 1])[:, :, ::-1, :]
            got = fwd_bond(a, b)
            if got is not None:
                a2, b2 = got
                sites[i] = transpose_site(a2[:, :, :, ::-1])
                sites[i - 1] = transpose_site(b2[:, :, ::-1, :])
                changed = True
        if not changed:
            break

    widths = [sites[0].shape[2]] + [s.shape[3] for s in sites]
    w2 = max(max(widths), 2)

    def pos_map(bond, k):
        # bond 0 = [start]; bond n = [done]; internal = [start, interiors..,
        # done] with done pinned at the LAST padded slot
        if bond == 0:
            return np.array([0])
        if bond == n:
            return np.array([w2 - 1])
        return np.concatenate([np.arange(k - 1), [w2 - 1]])

    out = np.zeros((n, do, di, w2, w2), cores_in.dtype)
    for i, s in enumerate(sites):
        pl = pos_map(i, s.shape[2])
        pr = pos_map(i + 1, s.shape[3])
        out[i][:, :, pl[:, None], pr[None, :]] = s
    el = np.zeros(w2, cores_in.dtype)
    el[0] = 1.0
    er = np.zeros(w2, cores_in.dtype)
    er[-1] = 1.0
    return MPO(*(torch.from_numpy(a).to(device) for a in (out, el, er)))


def mpo_dagger(mpo):
    """Hermitian adjoint ``O^+``: conjugate cores, swap the physical legs.

    Virtual bonds keep their orientation, so the adjoint of a triangular
    finite-state MPO is again a valid automaton with the same boundary
    channels.
    """
    cores, left, right = _operator(mpo)
    return MPO(cores.transpose(1, 2).conj(), left.conj(), right.conj())


def mpo_multiply(m1, m2):
    """Exact operator product ``O1 O2`` at bond ``W1 * W2``.

    Per-site Kronecker contraction over the shared physical leg; boundary
    vectors Kronecker.  Enables ``H^2`` variance certificates and normal
    operators ``A^+ A``; compress with :func:`~.canonical.compress_mpo`
    before feeding solvers.
    """
    c1, l1, r1 = _operator(m1)
    c2, l2, r2 = _operator(m2)
    if c1.shape[0] != c2.shape[0] or c1.shape[2] != c2.shape[1]:
        raise ValueError(
            f"mpo_multiply needs matching sites and inner phys dims; "
            f"got {tuple(c1.shape)} vs {tuple(c2.shape)}"
        )
    n, do = c1.shape[0], c1.shape[1]
    di = c2.shape[2]
    w1, v1 = c1.shape[3], c1.shape[4]
    w2, v2 = c2.shape[3], c2.shape[4]
    cores = peinsum("nakwv,nkbWV->nabwWvV", c1, c2).reshape(
        n, do, di, w1 * w2, v1 * v2)
    dt = cores.dtype
    return MPO(cores, torch.kron(l1.to(dt), l2.to(dt)),
               torch.kron(r1.to(dt), r2.to(dt)))


def block_mpo(mpo, block=2):
    """Coarse-grain an MPO by contracting ``block`` consecutive cores.

    The blocked core ``W_blk[(s1..sb), (t1..tb), a, c] = (W_1 ... W_b)[a, c]``
    acts on the ``d^block``-dimensional blocked site; products of triangular
    finite-state MPOs stay triangular with identity corners.  ``n_sites``
    must divide by ``block``; boundary vectors are unchanged.  All blocks
    contract at once (one batched einsum per absorbed core).
    """
    cores = mpo.cores
    n, d, _, wdim, _ = cores.shape
    if n % block:
        raise ValueError(f"n_sites={n} must divide by block={block}")
    blocked = cores.reshape(n // block, block, d, d, wdim, wdim)
    out = blocked[:, 0]  # (nb, d, d, W, W), phys legs accumulate left
    for i in range(1, block):
        out = peinsum("nABxm,nabmc->nAaBbxc", out, blocked[:, i])
        dd = out.shape[1] * out.shape[2]
        out = out.reshape(n // block, dd, dd, wdim, wdim)
    return MPO(out, mpo.left, mpo.right)


# --------------------------------------------------------------------- #
# Infinite-chain bulk-core algebra (triangular, identity corners)
# --------------------------------------------------------------------- #


def _check_umpo(w, name, device=None):
    device = resolve_device(device, (w,))
    w = as_tensor(w, device)
    if w.ndim != 4 or w.shape[2] != w.shape[3] or w.shape[2] < 2:
        raise ValueError(
            f"{name} needs a (d, d, W, W) bulk core with W >= 2; "
            f"got shape {tuple(w.shape)}"
        )
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    for idx in (0, w.shape[2] - 1):
        if float((w[:, :, idx, idx] - eye).abs().max()) > 1e-12:
            raise ValueError(
                f"{name} needs identity corners at [0, 0] and [W-1, W-1] (the "
                f"tfim_mpo / InfiniteOpSum.to_umpo convention); corner "
                f"[{idx}, {idx}] is not identity"
            )
    return w


def umpo_scale(core, c, device=None):
    """``c * H`` for an infinite triangular bulk core.

    Every automaton path leaves the initial state 0 exactly once, so scaling
    row 0's outgoing entries ``w[0, a > 0]`` scales every term by ``c`` while
    the identity corners stay untouched.  A numpy ``core`` goes to
    ``device`` (default ``cuda``).
    """
    w = _check_umpo(core, "umpo_scale", device)
    c = torch.as_tensor(c)
    w = w.to(torch.promote_types(w.dtype, c.dtype)).clone()
    w[:, :, 0, 1:] *= c.to(w.device)
    return w


def umpo_sum(core1, core2, device=None):
    """``H1 + H2`` as ONE infinite triangular bulk core.

    Direct sum of the interior automaton states with the identity corners
    SHARED (``W' = W1 + W2 - 2``) and the one-site corner blocks
    ``w[0, W-1]`` added — the uniform-chain analog of :func:`mpo_sum`,
    keeping the upper-triangular identity-corner form.
    """
    w1 = _check_umpo(core1, "umpo_sum", device)
    w2 = _check_umpo(core2, "umpo_sum", w1.device)
    if w1.shape[0] != w2.shape[0]:
        raise ValueError(
            f"umpo_sum needs matching physical dims; got "
            f"{w1.shape[0]} vs {w2.shape[0]}"
        )
    d = w1.shape[0]
    n1, n2 = w1.shape[2], w2.shape[2]
    nw = n1 + n2 - 2
    dt = torch.promote_types(w1.dtype, w2.dtype)
    w1, w2 = w1.to(dt), w2.to(dt)
    out = torch.zeros((d, d, nw, nw), dtype=dt, device=w1.device)
    eye = torch.eye(d, dtype=dt, device=w1.device)
    out[:, :, 0, 0] = eye
    out[:, :, nw - 1, nw - 1] = eye
    out[:, :, 0, nw - 1] = w1[:, :, 0, n1 - 1] + w2[:, :, 0, n2 - 1]
    # interior states: w1's a in 1..n1-2 -> a; w2's b in 1..n2-2 -> n1-2+b
    out[:, :, 0, 1:n1 - 1] = w1[:, :, 0, 1:n1 - 1]
    out[:, :, 1:n1 - 1, nw - 1] = w1[:, :, 1:n1 - 1, n1 - 1]
    out[:, :, 1:n1 - 1, 1:n1 - 1] = w1[:, :, 1:n1 - 1, 1:n1 - 1]
    out[:, :, 0, n1 - 1:nw - 1] = w2[:, :, 0, 1:n2 - 1]
    out[:, :, n1 - 1:nw - 1, nw - 1] = w2[:, :, 1:n2 - 1, n2 - 1]
    out[:, :, n1 - 1:nw - 1, n1 - 1:nw - 1] = w2[:, :, 1:n2 - 1, 1:n2 - 1]
    return out


def umpo_onsite(op, device=None):
    """``sum_j op_j`` (one term per site) as a ``W = 2`` triangular bulk core
    — the uniform-chain field building block for :func:`umpo_sum`."""
    device = resolve_device(device, (op,))
    op = as_tensor(op, device)
    if op.ndim != 2 or op.shape[0] != op.shape[1]:
        raise ValueError(f"umpo_onsite needs a square (d, d) operator; "
                         f"got {tuple(op.shape)}")
    d = op.shape[0]
    dt = torch.promote_types(op.dtype, torch.float64)
    eye = torch.eye(d, dtype=dt, device=device)
    out = torch.zeros((d, d, 2, 2), dtype=dt, device=device)
    out[:, :, 0, 0] = eye
    out[:, :, 1, 1] = eye
    out[:, :, 0, 1] = op.to(dt)
    return out
