"""Open quantum systems: Lindblad dynamics on matrix-product density
operators.

Counterpart of ``contractn_tpu/models/lindblad.py``.  The density matrix is
vectorized site by site (``vec(rho)[s, a] = rho[s, a]``, the pair one
``d^2`` index), so ``rho`` is an MPS and the Lindbladian

``L(rho) = -i [H, rho] + sum_k (L_k rho L_k^+ - (1/2) {L_k^+ L_k, rho})``

is an MPO on the doubled space: left multiplication lifts as ``W (x) I``,
right multiplication as ``I (x) W^T``, jump operators enter as on-site (or
Schmidt-split bond) superoperator terms.  Evolution is RK4 over exact MPO
application, direct sums and SVD compression (:func:`lindblad_evolve`), or
the W^II propagator of the Liouvillian automaton
(:func:`lindblad_evolve_wii`).  Traces and observables are overlaps with
product bras.

The superoperator blocks are assembled on the host (numpy) and the MPOs go
to the Hamiltonian's device; every state operation runs on the state's
device.  :func:`ness_dmrg` draws its perturbation from an explicit
``torch.Generator``.
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .boundary import apply_mpo_to_mps
from .canonical import compress, compress_mpo, mps_add
from .fermions2d import string_mpo
from .mpo import MPO, mpo_sum
from .mpo_evolution import _props as _wii_props
from .mps import MPS

_C128 = torch.complex128


def _host(t):
    return t.detach().cpu().numpy()


def _lift(mpo, right_side, dtype=_C128):
    """``A rho`` (``W (x) I``) or ``rho A`` (``I (x) W^T``) as a
    superoperator MPO on the MPO's device: the cores cast to ``dtype``
    (complex128 by default), then lifted in ``dtype`` promoted with float64
    (as the JAX package lifts them against a float64 identity); the
    boundary vectors in ``dtype``."""
    dtype = torch_dtype(dtype)
    wide = torch.promote_types(dtype, torch.float64)
    w = mpo.cores.to(dtype).to(wide)
    n, d, _, wb, _ = w.shape
    eye = torch.eye(d, dtype=wide, device=w.device)
    if right_side:
        out = peinsum("naAwv,sS->nsaSAwv", w.transpose(1, 2), eye)
    else:
        out = peinsum("nsSwv,aA->nsaSAwv", w, eye)
    return MPO(out.reshape(n, d * d, d * d, wb, wb), mpo.left.to(dtype),
               mpo.right.to(dtype))


def _lift_left(mpo, dtype=_C128):
    return _lift(mpo, False, dtype)


def _lift_right(mpo, dtype=_C128):
    return _lift(mpo, True, dtype)


def _dissipator_site(jump, adjoint=False):
    """One-site superoperator ``L (x) conj(L) - (1/2)(L+L (x) I) - (1/2)(I
    (x) (L+L)^T)``; ``adjoint=True`` gives the Hilbert-Schmidt adjoint."""
    el = np.asarray(jump, complex)
    d = el.shape[0]
    ldl = np.matmul(el.conj().T, el)
    eye = np.eye(d)
    if adjoint:
        term = np.einsum("sS,aA->saSA", el.conj().T, el.T)
    else:
        term = np.einsum("sS,aA->saSA", el, el.conj())
    term -= 0.5 * np.einsum("sS,aA->saSA", ldl, eye)
    term -= 0.5 * np.einsum("sS,aA->saSA", eye, ldl.T)
    return term.reshape(d * d, d * d)


def _superop_pair(a_mat, b_mat, d):
    """Two-site superoperator in the site-fused basis: ``a_mat`` on the ket
    pair, ``b_mat`` on the bra pair; rows/cols ordered ``((s1 a1), (s2
    a2))``."""
    a4 = np.asarray(a_mat, complex).reshape(d, d, d, d)
    b4 = np.asarray(b_mat, complex).reshape(d, d, d, d)
    t = np.einsum("ijkl,mnop->imjnkolp", a4, b4)
    return t.reshape(d * d, d * d, d * d, d * d)


def _dissipator_bond(jump, d, adjoint=False):
    """Two-site dissipator of a bond jump operator, Schmidt-split across the
    bond: ``[(U_k, V_k), ...]`` one-site factor pairs."""
    el = np.asarray(jump, complex)
    ldl = np.matmul(el.conj().T, el)
    eye = np.eye(d * d)
    if adjoint:
        t = _superop_pair(el.conj().T, el.T, d)
    else:
        t = _superop_pair(el, el.conj(), d)
    t -= 0.5 * _superop_pair(ldl, eye, d)
    t -= 0.5 * _superop_pair(eye, ldl.T, d)
    dd = d * d
    mat = t.transpose(0, 2, 1, 3).reshape(dd * dd, dd * dd)
    u, sv, vh = np.linalg.svd(mat, full_matrices=False)
    keep = sv > 1e-12 * max(sv[0], 1e-300)
    u, sv, vh = u[:, keep], sv[keep], vh[keep]
    root = np.sqrt(sv)
    us = (u * root[None, :]).T.reshape(-1, dd, dd)
    vs = (vh.T * root[None, :]).T.reshape(-1, dd, dd)
    return list(zip(us, vs))


def _bond_items(bond_jumps, n):
    for item in bond_jumps:
        bonds = [item] if isinstance(item, tuple) else [(i, item)
                                                       for i in range(n - 1)]
        yield from bonds


def liouvillian_mpo(h_mpo, jumps=(), bond_jumps=(), cutoff=1e-12):
    """Lindbladian as a compressed complex128 MPO on the vectorized chain,
    on ``h_mpo``'s device.

    Args:
        h_mpo: Hamiltonian :class:`~.mpo.MPO`.
        jumps: one-site jump operators, ``[(site, matrix), ...]`` or bare
            matrices applied at every site.
        bond_jumps: two-site jump operators (``d^2 x d^2``) as ``[(left_site,
            matrix), ...]`` or bare matrices applied on every bond.
        cutoff: exact-rank compression cutoff.
    """
    n = h_mpo.cores.shape[0]
    d = h_mpo.cores.shape[1]
    hl, hr = _lift_left(h_mpo), _lift_right(h_mpo)
    lv = mpo_sum(MPO(hl.cores, -1j * hl.left, hl.right),
                 MPO(hr.cores, 1j * hr.left, hr.right))
    onsite = []
    for item in jumps:
        if isinstance(item, tuple):
            site, mat = item
            onsite.append((site, _dissipator_site(mat)))
        else:
            onsite.extend((i, _dissipator_site(item)) for i in range(n))
    terms = [(1.0, [(i, uk), (i + 1, vk)], None)
             for i, mat in _bond_items(bond_jumps, n)
             for uk, vk in _dissipator_bond(mat, d)]
    if onsite or terms:
        lv = mpo_sum(lv, string_mpo(n, terms, onsite=onsite, d=d * d,
                                    dtype=_C128, device=h_mpo.cores.device))
    comp, log_norm, err = compress_mpo(lv, cutoff=cutoff)
    if float(err) > 1e-9:
        raise ValueError(f"Liouvillian compression lost weight ({err})")
    return MPO(comp.cores, comp.left * math.exp(log_norm), comp.right)


def liouvillian_automaton(h_mpo, jumps=(), bond_jumps=(), adjoint=False):
    """The Lindbladian in triangular automaton form (uncompressed), what
    :func:`~.mpo_evolution.wii_mpo` needs; ``adjoint=True`` builds the
    Hilbert-Schmidt adjoint ``L+`` (the Heisenberg-picture generator).
    ``h_mpo`` must be in automaton form (``e_0`` / ``e_last``)."""
    cores = _host(h_mpo.cores)
    n, d, _, wdim, _ = cores.shape
    left, right = _host(h_mpo.left), _host(h_mpo.right)
    if abs(left[0] - 1.0) > 1e-12 or np.any(left[1:] != 0):
        raise ValueError("liouvillian_automaton needs automaton form "
                         "(left boundary = e_0)")
    if abs(right[-1] - 1.0) > 1e-12 or np.any(right[:-1] != 0):
        raise ValueError("liouvillian_automaton needs automaton form "
                         "(right boundary = e_last)")
    r = wdim - 2
    eye = np.eye(d)
    ih = 1j if adjoint else -1j

    def _ll(o):
        return np.einsum("sS,aA->saSA", o, eye).reshape(d * d, d * d)

    def _lr(o):
        return np.einsum("aA,sS->saSA", o.T, eye).reshape(d * d, d * d)

    onsite = [[] for _ in range(n)]
    for item in jumps:
        if isinstance(item, tuple):
            site, mat = item
            onsite[site].append(_dissipator_site(mat, adjoint=adjoint))
        else:
            dis = _dissipator_site(item, adjoint=adjoint)
            for i in range(n):
                onsite[i].append(dis)
    bond_channels = [(i, uk, vk) for i, mat in _bond_items(bond_jumps, n)
                     for uk, vk in _dissipator_bond(mat, d, adjoint=adjoint)]

    w2 = 2 * r + len(bond_channels) + 2
    last = w2 - 1
    dd = d * d
    out = np.zeros((n, dd, dd, w2, w2), complex)
    for i in range(n):
        w = cores[i]
        out[i, :, :, 0, 0] = np.eye(dd)
        out[i, :, :, last, last] = np.eye(dd)
        out[i, :, :, 0, last] = (ih * _ll(w[:, :, 0, wdim - 1])
                                 - ih * _lr(w[:, :, 0, wdim - 1]))
        for dis in onsite[i]:
            out[i, :, :, 0, last] += dis
        for a in range(1, r + 1):
            out[i, :, :, 0, a] = ih * _ll(w[:, :, 0, a])
            out[i, :, :, 0, r + a] = -ih * _lr(w[:, :, 0, a])
            out[i, :, :, a, last] = _ll(w[:, :, a, wdim - 1])
            out[i, :, :, r + a, last] = _lr(w[:, :, a, wdim - 1])
            for b in range(1, r + 1):
                out[i, :, :, a, b] = _ll(w[:, :, a, b])
                out[i, :, :, r + a, r + b] = _lr(w[:, :, a, b])
    for c, (site, uk, vk) in enumerate(bond_channels):
        ch = 2 * r + 1 + c
        out[site, :, :, 0, ch] = uk
        out[site + 1, :, :, ch, last] = vk
    lvec = np.zeros(w2, complex)
    lvec[0] = 1.0
    rvec = np.zeros(w2, complex)
    rvec[last] = 1.0
    device = h_mpo.cores.device
    return MPO(*(torch.from_numpy(a).to(device) for a in (out, lvec, rvec)))


def _evolve(rho, props, n_steps, max_bond):
    for u2 in props * n_steps:
        rho = _trim(apply_mpo_to_mps(u2, rho), max_bond)
    return rho


def lindblad_evolve_wii(rho0, h_mpo, t, n_steps, jumps=(), bond_jumps=(),
                        max_bond=32, order=2):
    """``rho(t) = exp(L t) rho(0)`` by the W^II propagator of the
    Liouvillian automaton (two MPO applications a step at ``order=2``,
    globally second order), on the state's device.  Returns the final
    vectorized density MPS (physical scale kept)."""
    la = liouvillian_automaton(h_mpo, jumps=jumps, bond_jumps=bond_jumps)
    return _evolve(rho0, _wii_props(la, t / n_steps, order), n_steps, max_bond)


def superop_apply_left(rho, op, site, d=2):
    """``rho -> O_site rho`` (left multiplication, ``O (x) I`` on the fused
    index) on a vectorized density MPS."""
    dt = rho.cores.dtype if rho.cores.dtype.is_complex else _C128
    m = as_tensor(np.kron(np.asarray(op, complex), np.eye(d)), rho.cores.device, dt)
    cores = rho.cores.to(dt).clone()
    cores[site] = peinsum("mq,qDE->mDE", m, cores[site])
    return MPS(cores, rho.left.to(dt), rho.right.to(dt))


def _product_bra(n, d, site_ops, device, transpose=True):
    """Product bra: ``vec(I)`` everywhere, ``vec(O^T)`` (or ``vec(O)``) at
    the listed sites."""
    cores = np.tile(np.eye(d).reshape(-1)[None, :, None, None],
                    (n, 1, 1, 1)).astype(complex)
    for site, op in site_ops:
        op = np.asarray(op, complex)
        cores[site, :, 0, 0] = (op.T if transpose else op).reshape(-1)
    one = torch.ones((1,), dtype=_C128, device=device)
    return MPS(torch.from_numpy(cores).to(device), one, one.clone())


def _pair(ket, bra):
    v, log = ket.inner(bra, conjugate=False)
    return complex(v) * float(np.exp(float(log)))


def two_time_correlation(rho0, h_mpo, op_a, site_a, op_b, site_b, t1, taus,
                         n_steps_per_unit=40, jumps=(), bond_jumps=(),
                         max_bond=32, order=2):
    """``C(t1, t1 + tau) = Tr(B e^{L tau}[A rho(t1)]) / Tr rho(t1)`` by the
    quantum regression theorem over the lag grid ``taus`` (non-decreasing;
    one trajectory); returns a complex numpy array."""
    la = liouvillian_automaton(h_mpo, jumps=jumps, bond_jumps=bond_jumps)
    rho1 = rho0
    if t1 > 0:
        n1 = max(int(round(t1 * n_steps_per_unit)), 1)
        rho1 = _evolve(rho1, _wii_props(la, t1 / n1, order), n1, max_bond)
    norm = density_trace(rho1)
    sigma = superop_apply_left(rho1, op_a, site_a)
    taus = np.asarray(taus, float)
    if np.any(np.diff(taus) < 0):
        raise ValueError("taus must be non-decreasing")
    n_sites = int(sigma.cores.shape[0])
    d = h_mpo.cores.shape[1]
    bra = _product_bra(n_sites, d, [(site_b, op_b)], sigma.cores.device)
    out = []
    cur_t = 0.0
    for tau in taus:
        span = float(tau) - cur_t
        if span > 1e-12:
            n_tau = max(int(round(span * n_steps_per_unit)), 1)
            sigma = _evolve(sigma, _wii_props(la, span / n_tau, order), n_tau,
                            max_bond)
            cur_t = float(tau)
        out.append(_pair(sigma, bra) / norm)
    return np.asarray(out)


def vectorized_product_state(states, device=None):
    """``rho = (x)_i |psi_i><psi_i|`` as a bond-1 complex128 vectorized MPS
    on ``device`` (default ``cuda``)."""
    cores = []
    for v in states:
        v = np.asarray(v, complex)
        v = v / np.linalg.norm(v)
        cores.append(np.outer(v, v.conj()).reshape(-1)[:, None, None])
    device = resolve_device(device)
    one = torch.ones((1,), dtype=_C128, device=device)
    return MPS(torch.from_numpy(np.stack(cores)).to(device), one, one.clone())


def density_trace(rho, d=2):
    """``Tr(rho)`` of a vectorized density MPS (host complex)."""
    return _pair(rho, _product_bra(rho.n_sites, d, [], rho.cores.device))


def density_expectation(rho, op, site, d=2):
    """``Tr(O_site rho) / Tr(rho)``."""
    return density_expectation_multi(rho, [(site, op)], d=d)


def density_expectation_multi(rho, site_ops, d=2):
    """``Tr(O_{i1} O_{i2} ... rho) / Tr(rho)`` for one-site factors on
    distinct sites, ``site_ops = [(site, matrix), ...]``."""
    bra = _product_bra(rho.n_sites, d, site_ops, rho.cores.device)
    return _pair(rho, bra) / density_trace(rho, d)


def _trim(rho, max_bond):
    out, log_norm, _ = compress(rho, max_bond=max_bond)
    return MPS(out.cores, out.left * math.exp(log_norm), out.right)


def _scaled(rho, alpha):
    return MPS(rho.cores, alpha * rho.left, rho.right)


def lindblad_evolve(rho0, l_mpo, t, n_steps, max_bond=32):
    """``rho(t) = exp(L t) rho(0)`` by RK4 with SVD compression after every
    stage; returns the (un-normalized) vectorized density MPS."""
    dt = t / n_steps
    rho = rho0
    for _ in range(n_steps):
        k1 = _trim(apply_mpo_to_mps(l_mpo, rho), max_bond)
        r2 = _combine([rho, k1], [1.0, 0.5 * dt], max_bond)
        k2 = _trim(apply_mpo_to_mps(l_mpo, r2), max_bond)
        r3 = _combine([rho, k2], [1.0, 0.5 * dt], max_bond)
        k3 = _trim(apply_mpo_to_mps(l_mpo, r3), max_bond)
        r4 = _combine([rho, k3], [1.0, dt], max_bond)
        k4 = _trim(apply_mpo_to_mps(l_mpo, r4), max_bond)
        rho = _combine([rho, k1, k2, k3, k4],
                       [1.0, dt / 6, dt / 3, dt / 3, dt / 6], max_bond)
    return rho


def _mixed_start(n, d, max_bond, noise, generator, device):
    """``I/d^n`` plus ``noise``-scaled random cores (the ``ness_dmrg``
    start)."""
    mixed = _product_bra(n, d, [], device)
    mixed = MPS(mixed.cores / d, mixed.left, mixed.right)
    pert = MPS.random(n, d * d, max(2, max_bond // 2), dtype=_C128,
                      scale=noise, generator=generator, device=device)
    return mps_add(mixed, pert)


def ness_dmrg(l_mpo, max_bond=16, sweeps=8, d=2, generator=None, cutoff=1e-12,
              noise=1e-2, mps0=None):
    """Nonequilibrium steady state without time evolution: the ground state
    of the Hermitian PSD ``L^+ L`` (exact :func:`~.mpo.mpo_multiply` of
    :func:`~.mpo.mpo_dagger`, compressed) by two-site DMRG, from ``I/d^n``
    plus a ``noise`` perturbation drawn from ``generator`` (or from
    ``mps0``).  Returns ``(rho, residual)``: the trace-normalized
    vectorized density MPS and ``sqrt(<L rho|L rho>)`` of the normalized
    state."""
    from .dmrg import dmrg
    from .mpo import mpo_dagger, mpo_multiply

    n = l_mpo.n_sites
    comp, log_norm, _ = compress_mpo(mpo_multiply(mpo_dagger(l_mpo), l_mpo),
                                     cutoff=cutoff)
    ldl = MPO(comp.cores, comp.left * math.exp(log_norm), comp.right)
    if mps0 is None:
        mps0 = _mixed_start(n, d, max_bond, noise, generator, l_mpo.cores.device)
    ground, energy, _ = dmrg(ldl, mps0, max_bond=max_bond, sweeps=sweeps)
    tr = density_trace(ground, d)
    rho = MPS(ground.cores, ground.left / tr, ground.right)
    return rho, float(np.sqrt(max(float(np.real(energy)), 0.0)))


def _combine(states, coeffs, max_bond):
    """``sum_i c_i |s_i>`` compressed to ``max_bond``, physical scale
    restored."""
    acc = _scaled(states[0], coeffs[0])
    for s, c in zip(states[1:], coeffs[1:]):
        acc, log_norm, _ = mps_add(acc, _scaled(s, c), max_bond=max_bond)
        acc = MPS(acc.cores, acc.left * math.exp(log_norm), acc.right)
    return acc
