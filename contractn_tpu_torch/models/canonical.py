"""MPS canonicalization and SVD compression.

Counterpart of ``contractn_tpu/models/canonical.py``: bring an MPS into left-
or right-canonical form (QR sweep) and truncate bond dimensions by SVD with a
reported truncation error.  Compressed MPS keep a UNIFORM bond dimension —
per-site effective ranks are zero-padded up to the common bond — so the
result is again a stacked ``(N, d, D', D')`` MPS.

Decompositions run through ``torch.linalg`` (QR/SVD/eigvalsh: cuSOLVER on
the GPU); the JAX package's scanned sweeps are loops over sites here, on the
MPS's device.  Contractions go through :func:`~..ops.stabilize.peinsum`
(IEEE float32 for float32 work).
"""

import math

import torch

from ..ops.stabilize import peinsum
from ..utils.device import real_dtype
from .mps import MPS


def _site_tensors(mps):
    """Absorb boundary vectors: [(d, D), (d, D, D) x (N-2), (d, D)]."""
    cores = mps.cores
    n = cores.shape[0]
    tensors = [peinsum("i,dij->dj", mps.left, cores[0])]
    for i in range(1, n - 1):
        tensors.append(cores[i])
    if n > 1:
        tensors.append(peinsum("dij,j->di", cores[-1], mps.right))
    return tensors


def _single_site_normalized(mps):
    """The n_sites == 1 degenerate case of every sweep: absorb BOTH
    boundaries into the one site and normalize.  Returns
    ``(MPS with core (1, d, 1, 1), log_norm)``."""
    v = peinsum("i,dij,j->d", mps.left, mps.cores[0], mps.right)
    nrm = torch.clamp(torch.linalg.norm(v), min=1e-300)
    core = (v / nrm).reshape(1, -1, 1, 1)
    e = torch.ones((1,), dtype=core.dtype, device=core.device)
    return MPS(core, e, e.clone()), float(torch.log(nrm))


def _e0(bond, dtype, device):
    e0 = torch.zeros((bond,), dtype=dtype, device=device)
    e0[0] = 1.0
    return e0


def _rebuild(tensors, dtype):
    """Uniform stacked MPS from ragged site tensors (zero-padded bonds).

    ``tensors[0]``: (d, r1); middle: (d, r_{i}, r_{i+1}); last: (d, r_{N-1}).
    """
    n = len(tensors)
    d = tensors[0].shape[0]
    device = tensors[0].device
    ranks = [t.shape[-1] for t in tensors[:-1]]
    bond = max(ranks) if ranks else 1
    cores = torch.zeros((n, d, bond, bond), dtype=dtype, device=device)
    # First site: row 0 carries the tensor (left boundary = e0)
    cores[0, :, 0, :tensors[0].shape[1]] = tensors[0]
    for i in range(1, n - 1):
        ri, ro = tensors[i].shape[1], tensors[i].shape[2]
        cores[i, :, :ri, :ro] = tensors[i]
    cores[-1, :, :tensors[-1].shape[1], 0] = tensors[-1]
    e0 = _e0(bond, dtype, device)
    return MPS(cores, e0, e0.clone())


def compress_mpo(mpo, max_bond=None, cutoff=0.0):
    """SVD-compress an MPO's operator bonds.

    An MPO is an MPS whose physical index is the ``(d_out, d_in)`` pair, so
    the state-compression machinery applies verbatim after a reshape.
    Returns ``(compressed_mpo, log_norm, truncation_error)`` — the operator
    is Frobenius-normalized with its scale in ``log_norm``.
    """
    from .mpo import MPO

    n, do, di, w, _ = mpo.cores.shape
    as_mps = MPS(mpo.cores.reshape(n, do * di, w, w), mpo.left, mpo.right)
    comp, log_norm, err = compress(as_mps, max_bond=max_bond, cutoff=cutoff)
    w2 = comp.bond_dim
    out = MPO(comp.cores.reshape(n, do, di, w2, w2), comp.left, comp.right)
    return out, log_norm, err


def imaginary_time_step(mps, mpo, tau, max_bond):
    """One power-method step toward the MPO's ground state:
    ``|psi'> = normalize[(1 - tau H) |psi>]``, compressed to ``max_bond``.

    Returns ``(new_mps, energy_estimate)`` where the energy is the Rayleigh
    quotient of the *input* state.
    """
    from .boundary import apply_mpo_to_mps

    h_psi = apply_mpo_to_mps(mpo, mps)
    num_v, num_l = mpo.expectation(mps)
    den_v, den_l = mps.norm_squared()
    energy = float(num_v) / float(den_v) * math.exp(float(num_l - den_l))
    scaled = MPS(h_psi.cores, -tau * h_psi.left, h_psi.right)
    new_mps, _, _ = mps_add(mps, scaled, max_bond=max_bond)
    return new_mps, energy


def mps_add(a, b, max_bond=None):
    """Sum of two MPS: ``|a> + |b>`` via bond-wise direct sum.

    Cores block-diagonalize (new bond = ``Da + Db``), boundary vectors
    concatenate — an exact representation.  With ``max_bond`` set the sum
    is immediately re-compressed (returning the normalized state with its
    log-norm and truncation error, as :func:`compress` does); otherwise the
    exact direct-sum MPS is returned.

    Scale a state by folding the factor into its boundary
    (``MPS(cores, alpha * left, right)``), so ``a - b`` is
    ``mps_add(a, MPS(b.cores, -b.left, b.right))``.
    """
    if a.n_sites != b.n_sites or a.phys_dim != b.phys_dim:
        raise ValueError("mps_add needs matching n_sites and phys_dim")
    n, d = a.n_sites, a.phys_dim
    da, db = a.bond_dim, b.bond_dim
    dtype = torch.promote_types(a.cores.dtype, b.cores.dtype)
    cores = torch.zeros((n, d, da + db, da + db), dtype=dtype,
                        device=a.cores.device)
    cores[:, :, :da, :da] = a.cores
    cores[:, :, da:, da:] = b.cores
    left = torch.cat([a.left.to(dtype), b.left.to(dtype)])
    right = torch.cat([a.right.to(dtype), b.right.to(dtype)])
    out = MPS(cores, left, right)
    if max_bond is not None:
        return compress(out, max_bond=max_bond)
    return out


def _qr_dtype(dtype):
    """QR needs a real f32/f64 (or complex) dtype; bf16/f16 cores upcast."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _amax(t):
    """Largest magnitude of each matrix of a stack, clamped away from 0."""
    return torch.clamp(t.abs().amax(dim=(-2, -1)), min=1e-300)


def _left_qr_sweep(cores, left, right):
    """Left-canonicalization sweep over the sites.

    Carry: the ``(D, D)`` remainder matrix C (everything to the left,
    QR-factored away) plus the log-scale register.  Per step:
    ``T = C . A_site`` then ``T = Q R`` with Q the new site.
    Returns ``(qs, e0, w, log)`` with ``w`` normalized.  Axes of the cores
    (and boundary vectors) before the ``(N, d, D, D)`` ones are a batch of
    independent chains.
    """
    *batch, n, d, bond, _ = cores.shape
    dt = _qr_dtype(cores.dtype)
    cores = cores.to(dt)
    e0 = _e0(bond, dt, cores.device)
    c = e0[:, None] * left.to(dt)[..., None, :]
    log = torch.zeros((), dtype=real_dtype(dt), device=cores.device)
    qs = []
    for a in cores.unbind(-4):
        t = peinsum("...ab,...dbc->...dac", c, a)
        q, r = torch.linalg.qr(t.reshape(*batch, d * bond, bond))
        scale = _amax(r)
        c, log = r / scale[..., None, None], log + torch.log(scale)
        qs.append(q.reshape(*batch, d, bond, bond))
    w = peinsum("...ab,...b->...a", c, right.to(dt))
    nrm = torch.clamp(torch.linalg.norm(w, dim=-1), min=1e-300)
    return torch.stack(qs, dim=-4), e0, w / nrm[..., None], log + torch.log(nrm)


def left_canonicalize(mps):
    """QR sweep: returns ``(canonical_mps, log_norm)``.

    Every site becomes a left isometry (``sum_d A_d^H A_d = I``); the
    chain's norm is factored out into ``log_norm`` (a float) with the
    remainder absorbed into a normalized RIGHT boundary vector, so
    ``<psi|psi> = exp(2 * log_norm)``.  bf16 cores upcast to f32 for the QR.
    """
    if mps.n_sites == 1:
        return _single_site_normalized(mps)
    qs, e0, w, log = _left_qr_sweep(mps.cores, mps.left, mps.right)
    return MPS(qs, e0, w), float(log)


def _right_qr_sweep(cores, left, right):
    """Mirror sweep: RQ from the right.  Returns ``(qs, w, e0, log)``."""
    n, d, bond, _ = cores.shape
    dt = _qr_dtype(cores.dtype)
    cores = cores.to(dt)
    e0 = _e0(bond, dt, cores.device)
    c = torch.outer(right.to(dt), e0)
    log = torch.zeros((), dtype=real_dtype(dt), device=cores.device)
    qs = []
    for a in reversed(cores):
        t = peinsum("dab,bc->dac", a, c)
        m = t.transpose(0, 1).reshape(bond, d * bond)
        # RQ via QR of the transpose: m = (q r)^T = r^T q^T
        q, r = torch.linalg.qr(m.T)
        scale = torch.clamp(r.abs().max(), min=1e-300)
        c, log = r.T / scale, log + torch.log(scale)
        qs.append(q.T.reshape(bond, d, bond).transpose(0, 1))
    w = peinsum("a,ab->b", left.to(dt), c)
    nrm = torch.clamp(torch.linalg.norm(w), min=1e-300)
    return torch.stack(qs[::-1]), w / nrm, e0, log + torch.log(nrm)


def right_canonicalize(mps):
    """Mirror of :func:`left_canonicalize`: RQ sweep from the right.

    Every site becomes a right isometry (``sum_d A_d A_d^H = I``) — the form
    exact autoregressive sampling needs (:mod:`.sampling`) — with the
    remainder in a normalized LEFT boundary vector.  Returns
    ``(canonical_mps, log_norm)``.
    """
    if mps.n_sites == 1:
        return _single_site_normalized(mps)
    qs, w, e0, log = _right_qr_sweep(mps.cores, mps.left, mps.right)
    return MPS(qs, w, e0), float(log)


def _fixed_svd_sweep(cores, left, right, chi):
    """Right-to-left SVD truncation to a fixed bond ``chi``.

    Input cores must be left-isometric (run :func:`_left_qr_sweep` first)
    so per-bond truncation is globally optimal.  ``(N, d, Db, Db)`` in,
    ``(N, d, chi, chi)`` out; effective ranks below ``chi`` appear as
    zero-padded bonds.  Leading axes are a batch, as in
    :func:`_left_qr_sweep`.

    Returns ``(cores', new_left, new_right, log_norm, err_sq)`` where the
    output state is normalized and ``err_sq`` is the total discarded squared
    weight (relative, since the input is isometric+normalized).
    """
    *batch, n, d, db, _ = cores.shape
    dt = _qr_dtype(cores.dtype)
    cores = cores.to(dt)
    device = cores.device
    k = min(db, d * chi)  # singular values per step
    m = torch.zeros((*right.shape[:-1], db, chi), dtype=dt, device=device)
    m[..., 0] = right.to(dt)
    log = torch.zeros((), dtype=real_dtype(dt), device=device)
    err = torch.zeros((), dtype=real_dtype(dt), device=device)
    sites = []
    for a in reversed(cores.unbind(-4)):
        t = peinsum("...dab,...bc->...dac", a, m)  # (d, Db, chi)
        mat = t.transpose(-3, -2).reshape(*batch, db, d * chi)
        u, s, vh = torch.linalg.svd(mat, full_matrices=False)
        if k > chi:
            # s is in the rescaled frame; exp(2*log) restores true units
            err = err + torch.sum(s[..., chi:] ** 2, dim=-1) * torch.exp(2.0 * log)
            u, s, vh = u[..., :chi], s[..., :chi], vh[..., :chi, :]
        elif k < chi:
            u = torch.nn.functional.pad(u, (0, chi - k))
            s = torch.nn.functional.pad(s, (0, chi - k))
            vh = torch.nn.functional.pad(vh, (0, 0, 0, chi - k))
        sites.append(vh.reshape(*batch, chi, d, chi).transpose(-3, -2))
        m = u * s[..., None, :].to(dt)
        scale = _amax(m)
        m, log = m / scale[..., None, None], log + torch.log(scale)
    new_left = peinsum("...a,...ac->...c", left.to(dt), m)
    nrm = torch.clamp(torch.linalg.norm(new_left, dim=-1), min=1e-300)
    e0 = _e0(chi, dt, device)
    return (torch.stack(sites[::-1], dim=-4), new_left / nrm[..., None], e0,
            log + torch.log(nrm), err)


def compress_fixed(mps, chi):
    """SVD compression to a fixed uniform bond ``chi``, with no host sync.

    A QR sweep (left-canonicalize) followed by a fixed-``chi`` SVD sweep,
    all on the device (effective ranks below ``chi`` are zero-padded).
    This is the building block the boundary-MPS PEPS contraction repeats
    over rows.

    Returns ``(compressed_mps, log_norm, truncation_error)`` with the state
    normalized, as :func:`compress` does; the last two are 0-d tensors.
    """
    if chi < 1:
        raise ValueError(f"chi must be >= 1, got {chi}")
    if mps.n_sites == 1:
        out, log_norm = _single_site_normalized(mps)
        return out, log_norm, 0.0
    qs, e0, w, log_qr = _left_qr_sweep(mps.cores, mps.left, mps.right)
    sites, new_left, new_right, log_svd, err_sq = _fixed_svd_sweep(
        qs, e0, w, int(chi)
    )
    return (MPS(sites, new_left, new_right), log_qr + log_svd,
            torch.sqrt(err_sq))


def compress(mps, max_bond=None, cutoff=0.0):
    """Truncate an MPS's bonds by SVD.

    A left-canonical QR sweep followed by a right-to-left SVD sweep keeping
    at most ``max_bond`` singular values per bond (and none below ``cutoff``
    relative to the largest).

    Returns:
        ``(compressed_mps, log_norm, truncation_error)`` where the state is
        normalized (``<psi|psi> = 1``), its original norm is
        ``exp(log_norm)``, and ``truncation_error`` is the relative 2-norm
        of everything discarded (0 when ``max_bond`` exceeds the ranks);
        both are floats.
    """
    if max_bond is not None and max_bond < 1:
        raise ValueError(f"max_bond must be >= 1, got {max_bond}")
    if mps.n_sites == 1:
        out, log_norm = _single_site_normalized(mps)
        return out, log_norm, 0.0
    canonical, log_norm = left_canonicalize(mps)
    tensors = _site_tensors(canonical)
    n = len(tensors)
    err_sq = 0.0
    # Right-to-left: SVD each site (rows = left bond, cols = phys x right),
    # truncate, absorb U @ diag(s) into the site to the left
    for i in range(n - 1, 0, -1):
        t = tensors[i]
        if t.ndim == 2:  # last site (d, Din)
            mat = t.T  # (Din, d)
        else:  # middle site (d, Din, Dout) -> (Din, d*Dout)
            mat = t.transpose(0, 1).reshape(t.shape[1], -1)
        u, s, vh = torch.linalg.svd(mat, full_matrices=False)
        k = s.shape[0]
        if max_bond is not None:
            k = min(k, max_bond)
        if cutoff > 0:
            above = int((s > cutoff * s[0]).sum())
            k = min(k, max(above, 1))
        err_sq += float(torch.sum(s[k:] ** 2))
        u, s, vh = u[:, :k], s[:k], vh[:k]
        if t.ndim == 2:
            tensors[i] = vh.T  # (d, k)
        else:
            tensors[i] = vh.reshape(k, t.shape[0], t.shape[2]).transpose(0, 1)
        carry = u * s[None, :].to(u.dtype)  # (Din, k)
        tensors[i - 1] = peinsum("...i,ik->...k", tensors[i - 1], carry)
    # Renormalize (truncation removes weight from the state)
    first = tensors[0]
    nrm = torch.linalg.norm(first)
    log_norm += float(torch.log(torch.clamp(nrm, min=1e-300)))
    tensors[0] = first / nrm
    return _rebuild(tensors, mps.cores.dtype), log_norm, math.sqrt(err_sq)


def _bond_spectra(cores, right):
    """Right-density carry ``rho -> sum_d A_d rho A_d^+`` over the
    left-canonical chain, emitting the bond eigenvalues (bond 0 first)."""
    rho = torch.outer(right, right.conj())
    probs = []
    # cores[n-1] gives the bond left of the last site, ... cores[1] bond 0
    for a in reversed(cores[1:]):
        rho = peinsum("dij,jk,dlk->il", a, rho, a.conj())
        tr = torch.clamp(torch.real(torch.trace(rho)), min=1e-300)
        probs.append(torch.linalg.eigvalsh(rho) / tr)
    return torch.clamp(torch.stack(probs[::-1]).flip(1), 0.0, 1.0)


def schmidt_spectra(mps):
    """Squared Schmidt coefficients on every internal bond.

    Left-canonicalize, then carry the right reduced density
    ``rho_i = sum_d A_d rho_{i+1} A_d^+`` whose eigenvalues at bond ``i``
    ARE the Schmidt weights (the left block is orthonormal by canonical
    form).  Returns ``(N-1, D)`` descending-padded probabilities, each row
    summing to 1.
    """
    lc, _ = left_canonicalize(mps)
    return _bond_spectra(lc.cores, lc.right)


def entanglement_entropy(mps, alpha=1):
    """Bipartite entanglement entropy across every internal bond.

    ``alpha=1`` gives von Neumann ``-sum p ln p``; other ``alpha`` the Renyi
    entropy ``ln(sum p^alpha) / (1 - alpha)``.  Returns an ``(N-1,)`` tensor
    (natural log).
    """
    probs = schmidt_spectra(mps)
    if alpha == 1:
        safe = torch.where(probs > 1e-300, probs, torch.ones_like(probs))
        plogp = torch.where(probs > 1e-300, probs * torch.log(safe),
                            torch.zeros_like(probs))
        return -torch.sum(plogp, dim=1)
    if alpha <= 0:
        raise ValueError("Renyi index must be positive")
    return torch.log(torch.sum(probs ** alpha, dim=1)) / (1.0 - alpha)


def truncate_safe(cores, left, right, chi):
    """Differentiable canonicalize-and-truncate of a RAGGED boundary.

    Input is a LIST of ``(d, Dl, Dr)`` cores (per-site bond dims may
    differ), compressed to bond ``chi`` by a left canonicalization sweep and
    a right-to-left truncation sweep.  Both sweeps use
    :func:`~contractn_tpu_torch.ops.linalg_ad.svd_safe` (degeneracy-broadened
    backward), because padded/rank-deficient bonds give stock SVD gradients
    NaNs — autograd flows through the whole compression.

    Leading axes of the cores (and of ``left`` / ``right``, which may also
    be shared) are a batch: each member is compressed on its own, in the
    same launches.

    Returns ``(cores, log_norm)`` with the boundary weights absorbed and the
    state normalized.
    """
    from ..ops.linalg_ad import svd_safe

    n = len(cores)
    carry = left[..., None, :]
    log = torch.zeros((), dtype=real_dtype(cores[0].dtype), device=cores[0].device)
    lcan = []
    for i in range(n):
        t = peinsum("...ai,...dij->...daj", carry, cores[i])
        *batch, d_dim, a_dim, j_dim = t.shape
        m = t.transpose(-3, -2).reshape(*batch, a_dim * d_dim, j_dim)
        u, sv, vh = svd_safe(m)
        k = min(m.shape[-2:])
        lcan.append(u.reshape(*batch, a_dim, d_dim, k).transpose(-3, -2))
        nrm = torch.clamp(torch.linalg.norm(sv, dim=-1), min=1e-300)
        log = log + torch.log(nrm)
        carry = (sv / nrm[..., None])[..., :, None].to(vh.dtype) * vh
    closing = peinsum("...kj,...j->...k", carry, right)
    # right-to-left truncation
    out = [None] * n
    rcarry = closing[..., :, None]  # (..., k, 1)
    for i in reversed(range(n)):
        t = peinsum("...dik,...ka->...dia", lcan[i], rcarry)
        *batch, d_dim, i_dim, a_dim = t.shape
        m = t.transpose(-3, -2).reshape(*batch, i_dim, d_dim * a_dim)
        u, sv, vh = svd_safe(m)
        k = min(min(m.shape[-2:]), int(chi))
        u, sv, vh = u[..., :k], sv[..., :k], vh[..., :k, :]
        out[i] = vh.reshape(*batch, k, d_dim, a_dim).transpose(-3, -2)
        nrm = torch.clamp(torch.linalg.norm(sv, dim=-1), min=1e-300)
        log = log + torch.log(nrm)
        rcarry = u * (sv / nrm[..., None])[..., None, :].to(u.dtype)
    # rcarry collapses to the (1, 1) leftmost residue (left vector was
    # absorbed in the first sweep): fold its sign/scale into core 0
    out[0] = out[0] * rcarry[..., :1, :1, None]
    return out, log
