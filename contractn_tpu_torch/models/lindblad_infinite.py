"""Open quantum systems in the thermodynamic limit.

Counterpart of ``contractn_tpu/models/lindblad_infinite.py``.  A
translation-invariant density operator is ONE vectorized ``(d^2, D, D)``
core, and the Liouvillian

``L = -i (H (x) I - I (x) H^T) + sum_a g_a [L_a (x) conj(L_a)
- 1/2 (L_a^+ L_a) (x) I - 1/2 I (x) (L_a^+ L_a)^T]``

is ONE triangular bulk core (the balanced Hamiltonian lift of
:func:`~.thermal.balanced_umpo` scaled by ``-i``, summed corner-sharing with
a ``W = 2`` one-site dissipator channel via :func:`~.mpo.umpo_sum`), so
``exp(t L)`` rides the uniform W^II evolver
(:func:`~.mpo_evolution.umps_mpo_evolve`) unchanged: its ``wii_core`` is
expm-based and never assumes Hermiticity.

Observables live in the TRACE gauge: for a vectorized core ``A[(s a), i,
j]`` the trace functional telescopes through the ``(D, D)`` trace-transfer
matrix ``T[i, j] = sum_s A[(s s), i, j]``, whose dominant eigenpair plays
the role the transfer fixed point plays for pure states.  These are small
host eigenproblems (numpy, as in the JAX package), so a measurement reads
the core to the host once; :func:`ness_infinite` therefore reads it once per
``t_chunk``.

Departure: the host-array builders :func:`maximally_mixed` and
:func:`product_density` take ``device=`` (default ``cuda``) and return
torch tensors.
"""

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device
from .mpo import umpo_onsite, umpo_scale, umpo_sum
from .thermal import _host, balanced_umpo


def dissipator_local(jumps, rates=None, d=None):
    """The one-site dissipator superoperator ``(d^2, d^2)`` (host numpy) in
    the row-major ``(ket, bra)`` vectorization of ``thermal._fold_op``."""
    jumps = [np.asarray(lj, complex) for lj in jumps]
    if d is None:
        d = jumps[0].shape[0]
    if rates is None:
        rates = [1.0] * len(jumps)
    out = np.zeros((d * d, d * d), complex)
    eye = np.eye(d)
    for lj, g in zip(jumps, rates):
        ldl = np.einsum("ji,jk->ik", np.conj(lj), lj)
        out += g * (np.kron(lj, np.conj(lj))
                    - 0.5 * np.kron(ldl, eye)
                    - 0.5 * np.kron(eye, ldl.T))
    return out


def bond_dissipator_super(jump, d=None):
    """The TWO-site dissipator superoperator of a bond jump operator ``(d^2,
    d^2)``, as a dense ``(d^4, d^4)`` host matrix on the fused folded pair
    ``((s1 a1), (s2 a2))`` — ready for :func:`~.mpo.mpo_from_bond_term`'s
    generic (non-Hermitian-safe) operator-Schmidt channel construction."""
    from .lindblad import _superop_pair

    el = np.asarray(jump, complex)
    if d is None:
        d = int(round(np.sqrt(el.shape[0])))
    ldl = np.einsum("ji,jk->ik", np.conj(el), el)
    eye = np.eye(d * d)
    t = (_superop_pair(el, el.conj(), d)
         - 0.5 * _superop_pair(ldl, eye, d)
         - 0.5 * _superop_pair(eye, ldl.T, d))
    dd = d * d
    return t.reshape(dd * dd, dd * dd)


def _phys_dim(h_core, jumps, bond_jumps):
    if h_core is not None:
        return _host(h_core).shape[0]
    if jumps:
        return np.asarray(jumps[0]).shape[0]
    return int(round(np.sqrt(np.asarray(bond_jumps[0]).shape[0])))


def liouvillian_umpo(h_core, jumps=(), rates=None, bond_jumps=(),
                     bond_rates=None):
    """The Lindblad generator as ONE triangular bulk core on the folded
    ``d^2`` site.

    Args:
        h_core: physical ``(d, d, W, W)`` triangular bulk core, or ``None``
            for purely dissipative dynamics; a torch core sets the device,
            otherwise ``cuda``.
        jumps: one-site jump operators ``(d, d)`` (each acts on every site).
        rates: per-jump rates (default all 1).
        bond_jumps: two-site jump operators ``(d^2, d^2)`` (one per bond,
            uniform), each an operator-Schmidt channel block.
        bond_rates: per-bond-jump rates (default all 1).

    Returns a complex ``(d^2, d^2, W', W')`` core; feed ``umpo_scale(core,
    -1)`` to the W^II evolver with ``imag=True`` (``exp(-t (-L)) = exp(t
    L)``) — :func:`lindblad_evolve_infinite` wraps exactly that.
    """
    if h_core is None and not jumps and not bond_jumps:
        raise ValueError("liouvillian_umpo needs a Hamiltonian core "
                         "or at least one jump operator")
    return _liouvillian(h_core, jumps, rates, bond_jumps, bond_rates,
                        resolve_device(None, (h_core,) if h_core is not None else ()))


def _liouvillian(h_core, jumps, rates, bond_jumps, bond_rates, device):
    from .mpo import mpo_from_bond_term

    d = _phys_dim(h_core, jumps, bond_jumps)
    pieces = []
    if h_core is not None:
        pieces.append(umpo_scale(balanced_umpo(as_tensor(h_core, device)), -1j))
    if jumps:
        pieces.append(umpo_onsite(dissipator_local(jumps, rates, d),
                                  device=device))
    if bond_rates is None:
        bond_rates = [1.0] * len(bond_jumps)
    for bj, g in zip(bond_jumps, bond_rates):
        m = g * bond_dissipator_super(bj, d)
        pieces.append(mpo_from_bond_term(m, 2, d=d * d, device=device).cores[0])
    out = pieces[0]
    for p in pieces[1:]:
        out = umpo_sum(out, p)
    return out


def vectorize_umps(core):
    """``|psi><psi|`` as a vectorized uniform core: ``A (x) conj(A)``,
    physical ``(ket s, bra a)`` fused row-major, bond ``D^2`` (on the core's
    device; a numpy core goes to ``cuda``)."""
    device = resolve_device(None, (core,))
    a = as_tensor(core, device)
    d, dl, dr = a.shape
    out = torch.einsum("sij,akl->saikjl", a, a.conj())
    return out.reshape(d * d, dl * dl, dr * dr)


def maximally_mixed(d=2, device=None):
    """The infinite-temperature state ``vec(I)`` as a bond-1 core on
    ``device`` (default ``cuda``)."""
    v = np.zeros(d * d)
    v[np.arange(d) * d + np.arange(d)] = 1.0
    return torch.from_numpy(v[:, None, None]).to(resolve_device(device))


def product_density(rho1, device=None):
    """A product density operator ``... rho1 (x) rho1 ...`` as a bond-1
    vectorized core on ``device`` (default ``cuda``)."""
    r = np.asarray(rho1, complex)
    return torch.from_numpy(r.reshape(-1)[:, None, None].copy()).to(
        resolve_device(device))


def lindblad_evolve_infinite(rho_core, h_core, jumps=(), rates=None,
                             t=1.0, n_steps=10, bond_dim=16, order=2,
                             callback=None, bond_jumps=(), bond_rates=None):
    """Evolve a uniform vectorized density operator: ``exp(t L) rho``.

    Same contract as :func:`~.mpo_evolution.umps_mpo_evolve` (per-step W^II
    application, dominant-Schmidt truncation to ``bond_dim``, ``order=2``
    keeps ``O(dt^2)`` globally; every trace-gauge observable is a ratio, so
    the per-step 2-norm renormalization is harmless), on ``rho_core``'s
    device.  ``callback(k, core)`` after each step.

    Returns the evolved ``(d^2, D, D)`` core; measure with
    :func:`trace_expect` / :func:`trace_correlate`.
    """
    from .mpo_evolution import umps_mpo_evolve

    device = resolve_device(None, (rho_core,))
    lv = _liouvillian(h_core, jumps, rates, bond_jumps, bond_rates, device)
    return umps_mpo_evolve(rho_core, umpo_scale(lv, -1.0), t, n_steps,
                           bond_dim, imag=True, order=order,
                           callback=callback, device=device)


def _trace_transfer(core, op=None):
    a = _host(core)
    d = int(round(np.sqrt(a.shape[0])))
    a4 = a.reshape(d, d, a.shape[1], a.shape[2])
    if op is None:
        return np.einsum("ssij->ij", a4)
    # Tr(O rho_site): rho carries (ket s, bra a); Tr = sum O[a, s]
    return np.einsum("as,saij->ij", np.asarray(op, complex), a4)


def _dominant_triplet(t_mat):
    """Dominant ``(lam, l, r)`` of the (non-Hermitian) trace transfer,
    normalized to ``l^+ r = 1`` (host ``eig`` of a ``(D, D)`` matrix)."""
    vals, vecs = np.linalg.eig(t_mat)
    k = int(np.argmax(np.abs(vals)))
    r = vecs[:, k]
    wals, wecs = np.linalg.eig(t_mat.T)
    kl = int(np.argmin(np.abs(wals - vals[k])))
    lvec = wecs[:, kl]
    return vals[k], lvec / np.einsum("i,i->", lvec, r), r


def trace_expect(rho_core, op):
    """``Tr(rho op_0) / Tr(rho)`` in the thermodynamic limit (a complex)."""
    a = _host(rho_core)
    lam, lvec, r = _dominant_triplet(_trace_transfer(a))
    return complex(np.einsum("i,ij,j->", lvec, _trace_transfer(a, op), r) / lam)


def trace_correlate(rho_core, op1, op2, distances):
    """``Tr(rho op1_0 op2_r) / Tr(rho)`` for each ``r`` in ``distances``
    (all ``r >= 1``); a numpy array."""
    a = _host(rho_core)
    t_mat = _trace_transfer(a)
    lam, lvec, r = _dominant_triplet(t_mat)
    t1 = _trace_transfer(a, op1)
    t2 = _trace_transfer(a, op2)
    out = []
    for dist in distances:
        if dist < 1:
            raise ValueError("trace_correlate needs distances >= 1")
        cur = np.einsum("i,ij->j", lvec, t1)
        for _ in range(int(dist) - 1):
            cur = np.einsum("i,ij->j", cur, t_mat) / lam
        out.append(np.einsum("i,ij,j->", cur, t2, r) / lam ** 2)
    return np.asarray(out)


def one_site_density(rho_core):
    """The one-site reduced density matrix ``rho_1 (d, d)`` in the
    thermodynamic limit (trace-normalized; host numpy)."""
    a = _host(rho_core)
    d = int(round(np.sqrt(a.shape[0])))
    lam, lvec, rv = _dominant_triplet(_trace_transfer(a))
    a4 = a.reshape(d, d, a.shape[1], a.shape[2])
    rho1 = np.einsum("i,saij,j->sa", lvec, a4, rv) / lam
    return rho1 / np.trace(rho1)


def ness_infinite(h_core, jumps=(), rates=None, bond_jumps=(),
                  bond_rates=None, rho0=None, bond_dim=16,
                  t_chunk=1.0, max_chunks=40, tol=1e-6,
                  steps_per_unit=20):
    """Nonequilibrium steady state of a uniform Lindbladian by long-time
    evolution: evolve in ``t_chunk`` chunks until the one-site reduced
    density matrix drifts less than ``tol`` per unit time (one host read of
    the core per chunk).

    ``h_core`` (or ``rho0``) sets the device: a torch tensor keeps its own,
    otherwise ``cuda``.

    Returns a dict: ``core``, ``rho1``, ``drift`` (per unit time),
    ``t_total``, ``converged``.
    """
    if rho0 is None:
        device = resolve_device(None, (h_core,) if h_core is not None else ())
        rho = maximally_mixed(_phys_dim(h_core, jumps, bond_jumps), device=device)
    else:
        rho = rho0
    prev = one_site_density(rho)
    t_total, drift, converged = 0.0, np.inf, False
    for _ in range(int(max_chunks)):
        rho = lindblad_evolve_infinite(
            rho, h_core, jumps, rates, t=t_chunk,
            n_steps=max(2, int(round(steps_per_unit * t_chunk))),
            bond_dim=bond_dim, bond_jumps=bond_jumps, bond_rates=bond_rates)
        t_total += t_chunk
        cur = one_site_density(rho)
        drift = float(np.max(np.abs(cur - prev))) / t_chunk
        prev = cur
        if drift < tol:
            converged = True
            break
    return {"core": rho, "rho1": prev, "drift": drift,
            "t_total": t_total, "converged": converged}


def steady_state_check(rho_core, h_core, jumps=(), rates=None, ops=(),
                       t_probe=0.2, n_steps=4, bond_dim=None):
    """Cheap stationarity certificate: evolve ``t_probe`` and return the max
    drift of the given one-site observables."""
    if bond_dim is None:
        bond_dim = int(rho_core.shape[1])
    before = [trace_expect(rho_core, o) for o in ops]
    out = lindblad_evolve_infinite(rho_core, h_core, jumps, rates, t_probe,
                                   n_steps, bond_dim)
    after = [trace_expect(out, o) for o in ops]
    return max(abs(a - b) for a, b in zip(after, before))
