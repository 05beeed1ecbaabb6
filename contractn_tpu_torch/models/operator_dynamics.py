"""Heisenberg-picture operator dynamics: operator spreading, OTOCs,
operator entanglement, operator-space Krylov and KPM moments.

Counterpart of ``contractn_tpu/models/operator_dynamics.py``.  A local
operator evolved in the Heisenberg picture (or under the adjoint master
equation) is a vectorized MPO — the same object as the vectorized density
matrix of :mod:`.lindblad` — so the generator is
:func:`~.lindblad.liouvillian_automaton` with ``adjoint=True`` and
propagation its W^II compilation.  Infinite-temperature OTOCs are one-site
superoperator sandwiches ``Tr(A+ X A Y) = <vec(A)| X (x) Y^T |vec(A)>``;
operator entanglement is :func:`~.canonical.entanglement_entropy` of
``vec(O(t))``.  Builders take ``device`` (default ``cuda``); everything else
follows its operands' device.
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .boundary import apply_mpo_to_mps
from .canonical import entanglement_entropy, mps_add
from .lindblad import (
    _lift_left,
    _lift_right,
    _product_bra,
    _trim,
    _wii_props,
    liouvillian_automaton,
)
from .mpo import MPO, mpo_sum
from .mps import MPS


def vectorized_operator(n, site_ops, d=2, device=None):
    """A product of one-site operators (identity elsewhere) as a bond-1
    complex128 vectorized MPS on ``device`` (default ``cuda``):
    ``site_ops`` is ``[(site, matrix), ...]``."""
    return _product_bra(n, d, site_ops, resolve_device(device), transpose=False)


def heisenberg_evolve_wii(op0, h_mpo, t, n_steps, jumps=(),
                          bond_jumps=(), max_bond=32, order=2):
    """Evolve a vectorized operator by the adjoint propagator
    ``exp(L+ t)`` — closed-system Heisenberg evolution ``U+ O U`` when
    ``jumps`` is empty, the adjoint master equation otherwise.

    Args:
        op0: vectorized operator MPS (:func:`vectorized_operator` or
            any ``d^2``-site MPS in the fused convention).
        h_mpo: Hamiltonian MPO in triangular automaton form.
        t, n_steps: total time and step count (W^II error is globally
            ``O(dt^2)`` at ``order=2``).
        jumps, bond_jumps: jump operators as in
            :func:`~.lindblad.liouvillian_mpo`.
        max_bond: SVD compression bond for the operator MPS.

    Returns the evolved vectorized operator MPS (physical scale kept;
    unitary conjugation preserves the Frobenius norm, so any norm loss
    measures the truncation error).
    """
    la = liouvillian_automaton(h_mpo, jumps=jumps, bond_jumps=bond_jumps,
                               adjoint=True)
    op = op0
    for u2 in _wii_props(la, t / n_steps, order) * n_steps:
        op = _trim(apply_mpo_to_mps(u2, op), max_bond)
    return op


def superop_sandwich(vec_a, site_ops, d=2):
    """``Tr(A+ (prod_i X_i) A (prod_i Y_i)) / Tr(A+ A)`` for one-site
    factors: ``site_ops`` is ``[(site, X, Y), ...]`` on distinct sites,
    inserted as the superoperator ``X (x) Y^T`` on the fused index.

    The ratio is self-normalizing under truncation (both numerator and
    denominator use the same compressed ``vec(A)``).
    """
    cores = vec_a.cores.clone()
    for site, x_op, y_op in site_ops:
        m = np.kron(np.asarray(x_op, complex), np.asarray(y_op, complex).T)
        cores[site] = peinsum("mq,qDE->mDE", as_tensor(m, cores.device),
                              cores[site])
    ket = MPS(cores, vec_a.left, vec_a.right)
    num, log_n = vec_a.inner(ket)
    den, log_d = vec_a.norm_squared()
    return complex(num / den) * math.exp(float(log_n - log_d))


def otoc(w_vec, v_op, site, d=2):
    """Infinite-temperature OTOC ``F(t) = Tr(W(t)+ V+ W(t) V) /
    Tr(W(t)+ W(t))`` and the squared commutator
    ``C(t) = Re(1 - F)`` (for unitary Hermitian ``V``, where
    ``C = Tr([W,V]+[W,V]) / (2 Tr(W+W))``).

    Args:
        w_vec: the evolved vectorized operator ``vec(W(t))``.
        v_op: the probe one-site operator ``V``.
        site: the probe site.

    Returns ``(F, C)``.
    """
    v_mat = np.asarray(v_op, complex)
    f_val = superop_sandwich(
        w_vec, [(site, v_mat.conj().T, v_mat)], d=d)
    return f_val, float(np.real(1.0 - f_val))


def vectorized_operator_sum(n, op, phases, d=2, device=None):
    """``sum_j phases[j] O_j`` (identity elsewhere) as a BOND-2
    vectorized MPS — the momentum-resolved probe
    ``O_k = sum_j e^{i k j} O_j`` is ``phases = exp(1j k arange(n))``.
    Vectorization is linear, so the sum is the standard two-state
    insertion automaton on the fused ``(s, a)`` index."""
    eye = np.eye(d).reshape(-1)
    ov = np.asarray(op, complex).reshape(-1)
    cores = np.zeros((n, d * d, 2, 2), complex)
    for j in range(n):
        cores[j, :, 0, 0] = eye
        cores[j, :, 1, 1] = eye
        cores[j, :, 0, 1] = complex(phases[j]) * ov
    device = resolve_device(device)
    return MPS(*(torch.from_numpy(np.asarray(a, complex)).to(device)
                 for a in (cores, [1.0, 0.0], [0.0, 1.0])))


def commutator_superop_mpo(h_mpo, dtype=torch.complex128):
    """The HERMITIAN commutator generator ``K vec(O) = vec([H, O])``
    (``K = H (x) I - I (x) H^T`` in the fused vectorization) — the
    adjoint Heisenberg generator divided by ``i``, so its spectrum is
    the set of TRANSITION frequencies ``E_n - E_m``.  This is what the
    kernel-polynomial machinery expands in.  ``dtype`` (a torch or numpy
    dtype) rounds the Hamiltonian's entries; the MPO comes in ``dtype``
    promoted with float64, as in the JAX package: a real dtype gives a real
    MPO, ``complex64`` a complex128 one."""
    lp = _lift_left(h_mpo, dtype)
    lm = _lift_right(h_mpo, dtype)
    return mpo_sum(lp, MPO(lm.cores, -lm.left, lm.right))


def lanczos_coefficients(h_mpo, op_sites, n_coeffs, max_bond=32, d=2):
    """Operator-growth Lanczos coefficients ``b_1..b_n`` (the Krylov-
    complexity diagnostic).

    The Lanczos recursion in OPERATOR space,

        ``|w) = K|O_k) - b_k |O_{k-1})``,  ``b_{k+1} = ||w||``,

    with ``K = [H, .]`` (:func:`commutator_superop_mpo`) and the
    normalized Hilbert-Schmidt inner product
    (:func:`operator_overlap`).  The diagonal coefficients ``a_k``
    vanish identically for Hermitian ``H`` and ``O`` (``K`` alternates
    the Hermitian and anti-Hermitian sectors), so the pure three-term
    recursion is exact.  Each step is one exact MPO application + one
    direct-sum subtraction + one SVD compression to ``max_bond`` — the
    same primitives as the KPM stack.  The growth rate of
    ``b_k`` bounds the Krylov-complexity growth (linear ``b_k`` =
    exponential operator spreading; bounded ``b_k`` = integrable-like
    dynamics).

    Returns the ``(n_coeffs,)`` float array of ``b`` coefficients.
    """
    n = int(h_mpo.cores.shape[0])
    k_mpo = commutator_superop_mpo(h_mpo)
    v = vectorized_operator(n, op_sites, d, device=h_mpo.cores.device)
    nrm = np.sqrt(operator_overlap(v, v, d).real)
    v = MPS(v.cores, v.left / nrm, v.right)
    v_prev = None
    bs = []
    for _ in range(int(n_coeffs)):
        w = apply_mpo_to_mps(k_mpo, v)
        if v_prev is not None:
            w = mps_add(w, MPS(v_prev.cores, -bs[-1] * v_prev.left,
                               v_prev.right))
        w = _trim(w, max_bond)
        b = float(np.sqrt(operator_overlap(w, w, d).real))
        v_prev = v
        v = MPS(w.cores, w.left / b, w.right)
        bs.append(b)
    return np.array(bs)


def liouvillian_kpm_moments(h_mpo, vec_op, n_moments, h_bounds,
                            max_bond=32, eps=0.025, scanned=False):
    """KPM moments of the INFINITE-TEMPERATURE dynamical correlation
    spectrum

        ``S(w) = d^{-n} sum_{mn} |<n|O|m>|^2 delta(w - (E_n - E_m))``

    — i.e. the Fourier transform of ``Tr(O+(t) O) / Tr(I)``, the
    central object of high-temperature transport.  The moments are
    ``mu_k = d^{-n} <vec(O)| T_k(K') |vec(O)>`` with ``K`` the
    commutator superoperator, evaluated by the SAME Chebyshev MPS
    recurrence as the T=0 spectral functions — the vectorized operator
    is just an MPS (:mod:`.chebyshev`).

    Args:
        h_mpo: Hamiltonian MPO (phys dim ``d``).
        vec_op: the vectorized probe (:func:`vectorized_operator` or
            :func:`vectorized_operator_sum`).
        n_moments: Chebyshev order.
        h_bounds: envelope ``(emin, emax)`` of ``H`` — the transition
            band ``[emin - emax, emax - emin]`` is derived from it.
        max_bond: compression bond of the Chebyshev operator vectors.

    Returns ``(moments, a, b)`` ready for
    :func:`~.chebyshev.spectral_function` (use ``e0=0``; the sum rule is
    ``mu_0 = Tr(O+ O) / d^n``, = 1 for a single Pauli probe).
    """
    from .chebyshev import chebyshev_moments, chebyshev_moments_scanned

    n, dd = h_mpo.cores.shape[0], h_mpo.cores.shape[1]
    k_mpo = commutator_superop_mpo(h_mpo)
    width = float(h_bounds[1]) - float(h_bounds[0])
    fn = chebyshev_moments_scanned if scanned else chebyshev_moments
    moments, a, b = fn(k_mpo, vec_op, [], n_moments, (-width, width),
                       max_bond=max_bond, eps=eps)
    return moments / float(dd) ** n, a, b


def dos_kpm_moments(h_mpo, n_moments, h_bounds, max_bond=32, eps=0.025,
                    scanned=False):
    """EXACT many-body density-of-states moments
    ``mu_k = Tr T_k(H') / d^n`` — no stochastic trace estimator.

    ``Tr T_k(H) = <vec(I)| T_k(H (x) I) |vec(I)>``, and ``vec(I)`` is a
    bond-1 MPS, so the operator Chebyshev recursion rides the standard
    MPS machinery (:mod:`.chebyshev`): the k-th
    Chebyshev vector is the compressed vectorization of the OPERATOR
    ``T_k(H)``.  The usual KPM-DOS route needs random-vector averaging
    with ``1/sqrt(R d^n)`` statistical error (Weisse et al., RMP 78,
    275 section IV); the vectorized trace is exact at every order.

    Returns ``(moments, a, b)`` for :func:`~.chebyshev.spectral_function`
    (``e0=0``, absolute energies;
    ``mu_0 = 1`` and the reconstruction integrates to 1 — the level
    density is normalized per Hilbert-space dimension).
    """
    from .chebyshev import chebyshev_moments, chebyshev_moments_scanned

    n, d = h_mpo.cores.shape[0], h_mpo.cores.shape[1]
    lifted = _lift_left(h_mpo)
    vec_i = vectorized_operator(n, [], d=d, device=h_mpo.cores.device)
    fn = chebyshev_moments_scanned if scanned else chebyshev_moments
    moments, a, b = fn(lifted, vec_i, [], n_moments, h_bounds,
                       max_bond=max_bond, eps=eps)
    return moments / float(d) ** n, a, b


def daoe_mpo(n, gamma, lstar, d=2, device=None):
    """The DAOE dissipator (Rakovszky, von Keyserlingk, Pollmann, PRB
    105, 075131): a diagonal superoperator in the Pauli-string basis
    multiplying each string of weight ``w`` by ``exp(-gamma max(0,
    w - lstar))`` — long operators (which carry no hydrodynamic
    information) are damped, so the operator entanglement stops
    growing and transport coefficients become reachable at long times.

    The weight count is a saturating ``lstar + 1``-state automaton, so
    the dissipator is an exact bond-``(lstar+1)`` MPO on the vectorized
    ``d^2`` sites (diagonal in the per-site Hermitian operator basis;
    built in the Pauli basis and conjugated to the computational fused
    basis).  Weight-``<= lstar`` strings — in particular every
    conserved density — are untouched EXACTLY, which is what makes the
    scheme hydrodynamically safe.
    """
    if d != 2:
        raise ValueError("daoe_mpo currently supports qubits (d=2)")
    lstar = int(lstar)
    if lstar < 0:
        raise ValueError("lstar must be >= 0")
    f = float(np.exp(-float(gamma)))
    # orthonormal Hermitian basis: vec(P)/sqrt(2), P in {I, X, Y, Z}
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]], complex),
              np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
    u = np.stack([p.reshape(-1) / np.sqrt(2.0) for p in paulis],
                 axis=1)  # (fused, pauli)
    w_dim = lstar + 1
    core_p = np.zeros((4, 4, w_dim, w_dim), complex)
    for w in range(w_dim):
        core_p[0, 0, w, w] = 1.0  # identity component: weight unchanged
        w_next = min(w + 1, lstar)
        damp = 1.0 if w < lstar else f
        for k in (1, 2, 3):
            core_p[k, k, w, w_next] = damp
    core = np.einsum("ap,pqwv,bq->abwv", u, core_p, u.conj())
    cores = np.broadcast_to(core, (n, 4, 4, w_dim, w_dim))
    left = np.zeros(w_dim, complex)
    left[0] = 1.0  # start at weight 0
    right = np.ones(w_dim, complex)  # accept any final count
    device = resolve_device(device)
    return MPO(*(torch.from_numpy(np.array(a)).to(device)
                 for a in (cores, left, right)))


def daoe_evolve(op0, h_mpo, t, n_steps, gamma, lstar, jumps=(),
                bond_jumps=(), max_bond=32, order=2):
    """Heisenberg evolution with the DAOE dissipator applied after
    each W^II step — same signature family as
    :func:`heisenberg_evolve_wii` plus ``(gamma, lstar)``.  ``gamma=0``
    (or ``lstar >= n``) reduces to the plain adjoint evolution
    exactly."""
    la = liouvillian_automaton(h_mpo, jumps=jumps, bond_jumps=bond_jumps,
                               adjoint=True)
    n = int(op0.cores.shape[0])
    dis = daoe_mpo(n, gamma, lstar, device=op0.cores.device)
    props = _wii_props(la, t / n_steps, order)
    op = op0
    for _ in range(n_steps):
        for u2 in props:
            op = _trim(apply_mpo_to_mps(u2, op), max_bond)
        op = _trim(apply_mpo_to_mps(dis, op), max_bond)
    return op


def operator_overlap(vec_a, vec_b, d=2):
    """Normalized Hilbert-Schmidt pairing ``Tr(A+ B) / d^n`` of two
    vectorized operators (the infinite-temperature correlation
    functional)."""
    n = int(vec_a.cores.shape[0])
    v, log = vec_a.inner(vec_b)
    return complex(v) * math.exp(float(log)) / float(d) ** n


def thermal_kpm_moments(h_mpo, purified_mps, op, site, n_moments,
                        h_bounds, max_bond=32, eps=0.025,
                        scanned=False):
    """KPM moments of the FINITE-TEMPERATURE dynamical structure factor

        ``S_beta(w) = sum_{mn} p_m |<n|O|m>|^2 delta(w - (E_n - E_m))``

    (``p_m = e^{-beta E_m}/Z``).  The purification
    ``|psi_beta> = (e^{-beta H/2} (x) I)|Phi_0>`` couples bra and ket
    eigenstates pairwise, so propagating ``(O (x) I)|psi_beta>`` under
    the SAME commutator superoperator ``K = H (x) I - I (x) H^T`` used
    at infinite temperature resolves transition frequencies exactly —
    the ancilla half carries ``E_m`` with the opposite sign, no
    two-dimensional (double Chebyshev) expansion needed.

    Args:
        h_mpo: Hamiltonian MPO (phys dim ``d``).
        purified_mps: the purified thermal state over fused ``d^2``
            sites (:func:`~.circuits.thermal_state`
            ``.finalize()``, or any state in that convention);
            normalized internally, so ``mu_0 = Tr(rho O+ O)``.
        op, site: the one-site probe on the SYSTEM half.
        n_moments, h_bounds, max_bond: as in
            :func:`liouvillian_kpm_moments`.

    Returns ``(moments, a, b)`` for :func:`~.chebyshev.spectral_function`
    with ``e0=0``.  Detailed balance
    ``S(-w) = e^{-beta w} S(w)`` is inherited exactly (pinned against
    dense thermal oracles in the tests).
    """
    from .chebyshev import chebyshev_moments, chebyshev_moments_scanned

    d = h_mpo.cores.shape[1]
    op_d = np.kron(np.asarray(op, complex), np.eye(d))
    nv, nl = purified_mps.norm_squared()
    scale = torch.exp(-0.5 * (torch.log(torch.real(nv)) + nl))
    c128 = torch.complex128
    psi = MPS(purified_mps.cores.to(c128), scale * purified_mps.left.to(c128),
              purified_mps.right.to(c128))
    k_mpo = commutator_superop_mpo(h_mpo)
    width = float(h_bounds[1]) - float(h_bounds[0])
    fn = chebyshev_moments_scanned if scanned else chebyshev_moments
    return fn(k_mpo, psi, [(site, op_d)], n_moments, (-width, width),
              max_bond=max_bond, eps=eps)


def operator_entropy(vec_a, alpha=1):
    """Operator entanglement entropy across every internal bond — the
    bipartite entanglement of the vectorized operator, the standard
    diagnostic of operator spreading and simulability."""
    return entanglement_entropy(vec_a, alpha=alpha)
