"""AutoMPO: symbolic operator sums compiled to compressed MPOs.

Counterpart of ``contractn_tpu/models/autompo.py``; the compilers run on the
host (numpy) and the MPO goes to ``device`` (default ``cuda``; raises without
a GPU unless ``device="cpu"``).  ``phys_charges=`` compresses charge-blocked
through :func:`~.u1.compress_mpo_u1`.

The missing convenience layer over the per-case builders
(:func:`~contractn_tpu.models.mpo.mpo_from_bond_term`, the spin2d snake
compilers, the fermions2d string compiler): accumulate terms

    ``H = sum_t c_t  O_{t,1}(s_1) O_{t,2}(s_2) ...``

as ``(coefficient, op, site, op, site, ...)`` tuples — arbitrary sites,
arbitrary ranges, repeated sites, complex coefficients — and compile
them to one MPO in two stages, both host-side setup (the result feeds
the solvers; same split as every other builder here):

1. **Exact finite-state machine.**  One virtual state per term per bond
   it crosses, plus the standard start/done channels.  Correct by
   construction for any term set; bond dim ``2 + (#terms crossing)``.
2. **Exact-rank SVD compression** through the framework's own
   :func:`~contractn_tpu.models.canonical.compress_mpo` (per-bond
   relative cutoff).  This reaches the *linear-combination* optimum the
   classic deparallelisation cannot: e.g. all-pairs ``lambda^{|i-j|}
   Z_i Z_j`` compresses to the W=3 exponential-loop automaton.

Fermions ride for free: ``"Cdag"/"C"/"N"`` are LOCAL Jordan-Wigner
blocks and the compiler inserts their Z strings automatically.  The key
identity — a product of full-lattice JW images is the per-site product
of their tensor factors in global term order, ``(A (x) B)(C (x) D) =
AC (x) BD`` — reduces all anticommutation bookkeeping to per-site
matrix products; strings below an even number of fermionic operators
cancel (``Z^2 = I``) and are dropped by the identity filter.
Convention: occupied = index 1, ``Z = diag(1, -1)`` (matches
:mod:`~contractn_tpu.models.fswap`; OPPOSITE to fermions2d's
occupied-first).

Coefficients are spread as ``|c|^{1/k}`` over a term's ``k`` sites
(phase on the first) so the SVD compression sees balanced scales.

The reference has no operator construction of any kind (operands enter
as raw tensors); this mirrors ITensor's AutoMPO /
TeNPy's CouplingModel surface, the standard way users of those
frameworks build Hamiltonians.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .canonical import compress_mpo
from .mpo import MPO

_SP = np.array([[0.0, 1.0], [0.0, 0.0]])

#: name -> (matrix, is_fermionic)
OP_TABLE = {
    "I": (np.eye(2), False),
    "X": (np.array([[0.0, 1.0], [1.0, 0.0]]), False),
    "Y": (np.array([[0.0, -1.0j], [1.0j, 0.0]]), False),
    "Z": (np.diag([1.0, -1.0]), False),
    "Sx": (np.array([[0.0, 0.5], [0.5, 0.0]]), False),
    "Sy": (np.array([[0.0, -0.5j], [0.5j, 0.0]]), False),
    "Sz": (np.diag([0.5, -0.5]), False),
    "S+": (_SP, False),
    "S-": (_SP.T.copy(), False),
    "Sp": (_SP, False),
    "Sm": (_SP.T.copy(), False),
    # fermions, occupied = index 1: c|1> = |0>, n = diag(0, 1)
    "C": (np.array([[0.0, 1.0], [0.0, 0.0]]), True),
    "Cdag": (np.array([[0.0, 0.0], [1.0, 0.0]]), True),
    "N": (np.diag([0.0, 1.0]), False),
}


def spin_ops(s):
    """Operator table for spin-``s`` sites (``d = 2s + 1``).

    Returns ``{name: matrix}`` for ``I, Sz, Sp/S+, Sm/S-, Sx, Sy`` in
    the standard ``|s, m>`` basis ordered ``m = s .. -s`` — pass as the
    ``ops=`` argument of the compilers (the built-in table only covers
    ``d = 2``).  ``S+|s,m> = sqrt(s(s+1) - m(m+1)) |s,m+1>``.
    """
    d = int(round(2 * s)) + 1
    if abs(2 * s - round(2 * s)) > 1e-12 or d < 2:
        raise ValueError(f"spin must be a half-integer >= 1/2, got {s}")
    m = s - np.arange(d)
    sp = np.zeros((d, d))
    for k in range(1, d):
        sp[k - 1, k] = np.sqrt(s * (s + 1) - m[k] * (m[k] + 1))
    sm = sp.T.copy()
    return {
        "I": np.eye(d),
        "Sz": np.diag(m),
        "Sp": sp, "S+": sp,
        "Sm": sm, "S-": sm,
        "Sx": (sp + sm) / 2.0,
        "Sy": (sp - sm) / 2.0j,
    }


class OpSum:
    """Accumulator for symbolic operator sums.

    Usage::

        h = OpSum()
        h += (-1.0, "Z", i, "Z", i + 1)
        h += (-0.5, "X", i)
        h.add(t, "Cdag", i, "C", j)        # JW string auto-inserted
        mpo = h.to_mpo(n_sites)

    Operators are names from :data:`OP_TABLE`, entries of a custom
    ``ops`` dict passed to :meth:`to_mpo` (value = matrix or
    ``(matrix, is_fermionic)``), or raw ``(d, d)`` matrices (bosonic).
    """

    def __init__(self):
        self.terms = []

    def add(self, coef, *ops_and_sites):
        if len(ops_and_sites) % 2 != 0 or not ops_and_sites:
            raise ValueError(
                "add() takes (coef, op, site, op, site, ...) with at "
                "least one (op, site) pair"
            )
        ops = list(ops_and_sites[0::2])
        sites = list(ops_and_sites[1::2])
        for s in sites:
            if int(s) != s or s < 0:
                raise ValueError(f"sites must be nonneg ints, got {s}")
        self.terms.append((complex(coef), ops, [int(s) for s in sites]))
        return self

    def __iadd__(self, term):
        return self.add(*term)

    def add_gate(self, coef, mat, i, j, cutoff=1e-12):
        """Add ``coef * M(i, j)`` from a two-site ``(d^2, d^2)`` matrix
        (row/col index ``s_i * d + s_j``) via operator-Schmidt SVD —
        one term per singular value above ``cutoff`` (relative).  Real
        matrices yield real factors (see
        :meth:`InfiniteOpSum.add_gate`)."""
        mat = np.asarray(mat)
        d2 = mat.shape[0]
        d = int(round(np.sqrt(d2)))
        if mat.shape != (d2, d2) or d * d != d2:
            raise ValueError(f"mat must be (d^2, d^2), got {mat.shape}")
        if i == j:
            raise ValueError("add_gate needs two distinct sites")
        m = mat.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(
            d2, d2)
        u, s, vt = np.linalg.svd(m)
        for k in np.nonzero(s > cutoff * s[0])[0]:
            root = np.sqrt(s[k])
            self.add(coef, (u[:, k] * root).reshape(d, d), int(i),
                     (vt[k] * root).reshape(d, d), int(j))
        return self

    def __len__(self):
        return len(self.terms)

    def to_mpo(self, n_sites, d=2, ops=None, cutoff=1e-12, dtype=None,
               device=None):
        return op_sum_mpo(self, n_sites, d=d, ops=ops, cutoff=cutoff,
                          dtype=dtype, device=device)


def _resolve(op, d, ops):
    """Resolve an op spec to ``(matrix (d,d), is_fermionic)``."""
    if isinstance(op, str):
        table = dict(OP_TABLE) if d == 2 else {}
        if ops:
            for k, v in ops.items():
                table[k] = v if isinstance(v, tuple) else (v, False)
        if op not in table:
            raise ValueError(f"unknown operator {op!r}")
        mat, fermi = table[op]
    else:
        mat, fermi = op, False
    mat = np.asarray(mat)
    if mat.shape != (d, d):
        raise ValueError(f"operator has shape {mat.shape}, expected "
                         f"({d}, {d})")
    return mat, fermi


def _site_factors(coef, resolved, sites, d):
    """One term -> ``(coef, {site: matrix})`` with JW strings absorbed.

    The per-site product of each operator's tensor factors, taken in
    global term order — exact for any product of tensor-product
    operators.  Sites whose accumulated factor is the identity are
    dropped (this is where even JW strings cancel).
    """
    z = np.diag([1.0, -1.0]) if d == 2 else None
    eye = np.eye(d)
    lo = min(sites)
    if any(f for _, f in resolved):
        lo = 0  # JW strings may reach site 0
    factors = {}
    for j in range(lo, max(sites) + 1):
        acc = None
        for (mat, fermi), s in zip(resolved, sites):
            f = None
            if s == j:
                f = mat
            elif fermi and s > j:
                f = z
            if f is not None:
                # host numpy f64 setup math
                acc = f if acc is None else np.matmul(acc, f)
        if acc is not None and not np.array_equal(acc, eye):
            factors[j] = acc
    if not factors:
        # pure-identity term: a constant energy shift, carried at site 0
        factors[0] = eye
    return coef, factors


def op_sum_mpo(opsum, n_sites, d=2, ops=None, cutoff=1e-12, dtype=None,
               phys_charges=None, compress=True, device=None):
    """Compile an :class:`OpSum` to a compressed :class:`MPO`.

    Args:
        opsum: the accumulated terms.
        n_sites: chain length (all sites must be ``< n_sites``).
        d: local dimension (the built-in op table covers ``d=2``; pass
            ``ops`` for anything else).
        ops: optional ``{name: matrix | (matrix, is_fermionic)}``
            extending/overriding the table.
        cutoff: per-bond relative SVD cutoff for the compression stage.
            Terms whose relative weight at some bond falls below it are
            truncated — keep it well under the smallest meaningful
            coefficient ratio.
        dtype: result dtype (default: inferred, f64/c128).
        phys_charges: optional per-state U(1) charges (flat, or one
            sequence per site).  When given, compression is CHARGE-
            BLOCKED (:func:`~.u1.compress_mpo_u1`) so the result stays
            channel-charge-definite for the masked solvers — a plain SVD
            mixes charge channels and the operator then fails
            :func:`~.u1.mpo_channel_charges`.  The finite-state machine
            itself is definite by construction (one channel per crossing
            term).
        device: where the MPO goes (default ``cuda``).

    Returns:
        An :class:`MPO` with uniform (padded) bond dimension equal to
        the largest compressed bond.
    """
    if not opsum.terms:
        raise ValueError("empty OpSum")
    device = resolve_device(device)
    dtype = torch_dtype(dtype)

    def put(*arrays):
        out = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
        return [t if dtype is None else t.to(dtype) for t in out]

    prepped = []
    complex_any = False
    for coef, raw_ops, sites in opsum.terms:
        if max(sites) >= n_sites:
            raise ValueError(
                f"term touches site {max(sites)} but n_sites={n_sites}"
            )
        resolved = [_resolve(o, d, ops) for o in raw_ops]
        if any(f for _, f in resolved) and d != 2:
            raise ValueError("fermionic ops require d=2 (JW strings)")
        coef, factors = _site_factors(coef, resolved, sites, d)
        complex_any = complex_any or np.iscomplex(coef) or any(
            np.iscomplexobj(m) for m in factors.values()
        )
        prepped.append((coef, factors))

    np_dt = np.complex128 if complex_any else np.float64
    eye = np.eye(d)

    # balanced coefficient spread: |c|^(1/k) per factor, phase first
    balanced = []
    for coef, factors in prepped:
        keys = sorted(factors)
        k = len(keys)
        mag = abs(coef) ** (1.0 / k)
        phase = coef / abs(coef) if coef != 0 else 0.0
        if not complex_any:
            # coef is stored as python complex; real term sets carry
            # exactly zero imag, so this is lossless
            phase = phase.real
        fac = {j: (factors[j] * (mag * phase if idx == 0 else mag)
                   ).astype(np_dt)
               for idx, j in enumerate(keys)}
        balanced.append((keys, fac))

    # --- exact finite-state machine, per-bond varying width ---------- #
    # bond b sits between sites b and b+1; states: 0=start, 1=done,
    # then one per crossing term
    bond_states = [dict() for _ in range(n_sites - 1)]
    for t, (keys, _) in enumerate(balanced):
        for b in range(keys[0], keys[-1]):
            bond_states[b][t] = 2 + len(bond_states[b])
    widths = [2] + [2 + len(s) for s in bond_states] + [2]

    cores = [np.zeros((d, d, widths[i], widths[i + 1]), np_dt)
             for i in range(n_sites)]
    for i in range(n_sites):
        cores[i][:, :, 0, 0] = eye
        cores[i][:, :, 1, 1] = eye
    for t, (keys, fac) in enumerate(balanced):
        lo, hi = keys[0], keys[-1]
        if lo == hi:
            cores[lo][:, :, 0, 1] += fac[lo]
            continue
        cores[lo][:, :, 0, bond_states[lo][t]] += fac[lo]
        for j in range(lo + 1, hi):
            m = fac.get(j, eye)
            cores[j][:, :, bond_states[j - 1][t],
                     bond_states[j][t]] = m
        cores[hi][:, :, bond_states[hi - 1][t], 1] += fac[hi]

    wmax = max(widths)
    stacked = np.zeros((n_sites, d, d, wmax, wmax), np_dt)
    for i in range(n_sites):
        wl, wr = widths[i], widths[i + 1]
        stacked[i, :, :, :wl, :wr] = cores[i]
    left = np.zeros((wmax,), np_dt)
    left[0] = 1.0
    right = np.zeros((wmax,), np_dt)
    right[1] = 1.0
    if not compress:
        # Triangular automaton form (done channel LAST, boundary vectors
        # e_0 / e_last) — what the W^II propagator builder requires; any SVD
        # compression would destroy triangularity.
        perm = np.concatenate([[0], np.arange(2, wmax), [1]])
        tri = stacked[:, :, :, perm][:, :, :, :, perm]
        el = np.zeros((wmax,), np_dt)
        el[0] = 1.0
        er = np.zeros((wmax,), np_dt)
        er[-1] = 1.0
        return MPO(*put(tri, el, er))

    # compress at the stacked (f64/c128) precision, cast after
    naive = MPO(*(torch.from_numpy(a).to(device) for a in (stacked, left, right)))
    if phys_charges is not None:
        from .u1 import compress_mpo_u1

        comp, _ = compress_mpo_u1(naive, phys_charges, cutoff=cutoff)
        if dtype is not None:
            return MPO(comp.cores.to(dtype), comp.left.to(dtype), comp.right.to(dtype))
        return comp
    comp, log_norm, _ = compress_mpo(naive, cutoff=cutoff)
    # compress_mpo Frobenius-normalizes; restore the operator scale spread
    # across sites (one boundary factor overflows at ~2000 sites)
    out_cores = comp.cores * math.exp(float(log_norm) / n_sites)
    if dtype is not None:
        return MPO(out_cores.to(dtype), comp.left.to(dtype), comp.right.to(dtype))
    return MPO(out_cores, comp.left, comp.right)


class InfiniteOpSum:
    """Translation-invariant operator sums for infinite chains.

    ``add(coef, op, off, op, off, ...)`` adds
    ``sum_i c * O_1(i + off_1) O_2(i + off_2) ...`` (offsets are
    shifted so the leftmost factor sits at the base site); fermionic
    terms must contain an EVEN number of ``Cdag/C`` factors (their JW
    strings then cancel below the support — odd counts have no
    translation-invariant bulk automaton and are rejected).

    ``add_exp(coef, op1, lam, op2, string=None)`` adds the
    exponentially decaying two-point sum
    ``sum_i sum_{r>=1} c lam^(r-1) O_1(i) S(i+1)..S(i+r-1) O_2(i+r)``
    as ONE geometric channel (``W`` grows by 1, not by range);
    ``string="Z"`` gives the Jordan-Wigner insertion for long-range
    fermion bilinears.

    :meth:`to_umpo` compiles the terms into a single UPPER-TRIANGULAR
    bulk core with identity corners — exactly the form
    :func:`~contractn_tpu.models.vumps.vumps` /
    :func:`~contractn_tpu.models.vumps_cell.vumps_cell` environments
    require (their interior solver handles the |lam| < 1 diagonal
    channels by geometric linear solves).  Unlike :func:`op_sum_mpo`,
    NO SVD compression runs here: it would destroy the triangularity
    the infinite environment solver depends on.
    """

    def __init__(self):
        self.terms = []
        self.exp_terms = []

    def add(self, coef, *ops_and_offsets):
        if len(ops_and_offsets) % 2 != 0 or not ops_and_offsets:
            raise ValueError(
                "add() takes (coef, op, offset, op, offset, ...)")
        ops = list(ops_and_offsets[0::2])
        offs = [int(x) for x in ops_and_offsets[1::2]]
        self.terms.append((complex(coef), ops, offs))
        return self

    def add_exp(self, coef, op1, lam, op2, string=None):
        self.exp_terms.append((complex(coef), op1, complex(lam), op2,
                               string))
        return self

    def add_gate(self, coef, mat, r=1, cutoff=1e-12):
        """Add ``sum_i coef * M(i, i+r)`` from a two-site matrix.

        ``mat`` is the ``(d^2, d^2)`` operator on sites ``(i, i+r)``
        (row/col index = ``s1 * d + s2``), decomposed by operator-
        Schmidt SVD into per-site factor pairs — one
        :meth:`add` term per singular value above ``cutoff`` (relative).
        A real ``mat`` yields REAL factors even when the natural
        per-site operators are complex (e.g. the ``Sy Sy`` pieces of a
        Heisenberg or biquadratic bond term), keeping the compiled core
        real.
        """
        mat = np.asarray(mat)
        d2 = mat.shape[0]
        d = int(round(np.sqrt(d2)))
        if mat.shape != (d2, d2) or d * d != d2:
            raise ValueError(f"mat must be (d^2, d^2), got {mat.shape}")
        if int(r) < 1:
            raise ValueError("r must be >= 1")
        m = mat.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(
            d2, d2)
        u, s, vt = np.linalg.svd(m)
        keep = s > cutoff * s[0]
        for k in np.nonzero(keep)[0]:
            root = np.sqrt(s[k])
            self.add(coef, (u[:, k] * root).reshape(d, d), 0,
                     (vt[k] * root).reshape(d, d), int(r))
        return self

    def add_power_law(self, coef, op1, alpha, op2, n_exp=8, r_max=60,
                      string=None):
        """Add ``sum_i sum_{r>=1} c r^-alpha O_1(i) O_2(i+r)`` as
        ``n_exp`` fitted geometric channels (:func:`fit_exp_sum`).

        The fit window ``r_max`` bounds the ranges represented
        faithfully; beyond it the fitted tail keeps decaying but drifts
        from the true power law (for ``alpha >= 2`` the neglected
        weight is tiny).  Returns the max relative fit error over the
        window so callers can tighten ``n_exp`` when needed.
        """
        c, lam = fit_exp_sum(lambda r: float(r) ** -float(alpha),
                             n_exp, r_max)
        for ck, lk in zip(c, lam):
            self.add_exp(coef * ck, op1, lk, op2, string=string)
        r = np.arange(1.0, r_max + 1)
        fit = (c[None, :] * lam[None, :] ** (r[:, None] - 1)).sum(1)
        return float(np.max(np.abs(fit * r ** float(alpha) - 1.0)))

    def __iadd__(self, term):
        return self.add(*term)

    def to_umpo(self, d=2, ops=None, dtype=None, device=None):
        """Compile to one ``(d, d, W, W)`` triangular bulk core on ``device``
        (default ``cuda``)."""
        if not self.terms and not self.exp_terms:
            raise ValueError("empty InfiniteOpSum")
        prepped = []
        complex_any = False
        for coef, raw_ops, offs in self.terms:
            resolved = [_resolve(o, d, ops) for o in raw_ops]
            n_fermi = sum(1 for _, f in resolved if f)
            if n_fermi % 2:
                raise ValueError(
                    "infinite terms need an even number of fermionic "
                    "operators (JW strings must cancel below the "
                    "support)")
            if n_fermi and d != 2:
                raise ValueError("fermionic ops require d=2")
            lo = min(offs)
            offs = [o - lo for o in offs]
            coef, factors = _site_factors(coef, resolved, offs, d)
            base = min(factors)  # base factor may have dropped to I
            factors = {k - base: v for k, v in factors.items()}
            complex_any = complex_any or np.iscomplex(coef) or any(
                np.iscomplexobj(m) for m in factors.values())
            prepped.append((coef, factors))
        exps = []
        for coef, op1, lam, op2, string in self.exp_terms:
            m1, _ = _resolve(op1, d, ops)
            m2, _ = _resolve(op2, d, ops)
            ms = (np.eye(d) if string is None
                  else _resolve(string, d, ops)[0])
            complex_any = complex_any or np.iscomplex(coef) or \
                np.iscomplex(lam) or any(
                    np.iscomplexobj(m) for m in (m1, m2, ms))
            exps.append((coef, m1, lam, m2, ms))

        np_dt = np.complex128 if complex_any else np.float64

        def cast(x):
            x = np.asarray(x)
            if np_dt == np.float64 and np.iscomplexobj(x):
                x = x.real  # lossless: real term sets carry 0 imag
            return x.astype(np_dt)

        eye = np.eye(d)
        # states: 0 = start, then term-progress states, then one per
        # exp channel, last = done
        n_states = 2 + sum(max(fac) for _, fac in prepped) \
            + len(exps)
        w = np.zeros((d, d, n_states, n_states), np_dt)
        done = n_states - 1
        w[:, :, 0, 0] = eye
        w[:, :, done, done] = eye
        nxt = 1
        for coef, factors in prepped:
            span = max(factors)
            if span == 0:
                w[:, :, 0, done] += cast(coef * factors[0])
                continue
            states = list(range(nxt, nxt + span))
            nxt += span
            w[:, :, 0, states[0]] += cast(coef * factors[0])
            for m in range(1, span):
                w[:, :, states[m - 1], states[m]] = cast(
                    factors.get(m, eye))
            w[:, :, states[-1], done] += cast(factors[span])
        for coef, m1, lam, m2, ms in exps:
            e = nxt
            nxt += 1
            w[:, :, 0, e] += cast(coef * m1)
            w[:, :, e, e] = cast(lam * ms)
            w[:, :, e, done] += cast(m2)
        return torch.from_numpy(w).to(resolve_device(device), torch_dtype(dtype))


def fit_exp_sum(f, n_exp, r_max):
    """Fit ``f(r) ~= sum_k c_k lam_k^(r-1)`` on ``r = 1..r_max``.

    Prony's extended method: a linear-prediction least-squares pass
    finds the recurrence whose characteristic roots are the ``lam_k``
    (growing roots discarded; near-real roots realified, genuinely
    complex pairs dropped — the amplitude refit compensates), then a
    relative-error-weighted least squares sets the ``c_k``.  This is
    the standard route for compiling power-law couplings into the
    geometric MPO channels of :meth:`InfiniteOpSum.add_exp` (TeNPy's
    CouplingModel does the same reduction).

    Args:
        f: callable ``r -> float`` on positive integers (decaying).
        n_exp: number of exponentials requested (fewer may return if
            roots are discarded).
        r_max: fit window; needs ``r_max >= 2 * n_exp + 1``.

    Returns:
        ``(c, lam)`` float64 arrays sorted by decreasing ``|lam|``.
    """
    n = int(n_exp)
    r_max = int(r_max)
    if r_max < 2 * n + 1:
        raise ValueError(f"r_max={r_max} too small for n_exp={n} "
                         f"(need >= {2 * n + 1})")
    r = np.arange(1, r_max + 1)
    y = np.array([float(f(int(k))) for k in r])
    # linear prediction y[m] = sum_{k=1..n} a_k y[m-k]; rows weighted
    # 1/|y[m]| so tail roots are resolved too (12x better on r^-3)
    lhs = np.stack([y[n - k:r_max - k] for k in range(1, n + 1)],
                   axis=1)
    rhs = y[n:]
    pw = 1.0 / np.maximum(np.abs(rhs), 1e-300)
    a, *_ = np.linalg.lstsq(lhs * pw[:, None], rhs * pw, rcond=None)
    roots = np.roots(np.concatenate(([1.0], -a)))
    roots = roots[np.abs(roots) < 1.0 - 1e-12]
    keep = np.abs(roots.imag) <= 1e-8 * np.maximum(np.abs(roots), 1e-30)
    lam = np.real(roots[keep])
    if lam.size == 0:
        raise ValueError("no decaying real exponentials found — is f "
                         "monotonically decaying on the window?")
    # amplitudes, weighted for uniform RELATIVE error over the window
    van = lam[None, :] ** (r[:, None] - 1)
    wgt = 1.0 / np.maximum(np.abs(y), 1e-300)
    c, *_ = np.linalg.lstsq(van * wgt[:, None], y * wgt, rcond=None)
    order = np.argsort(-np.abs(lam))
    return c[order], lam[order]


def umpo_finite(core, n_sites, device=None):
    """Wrap a triangular bulk core into a finite :class:`MPO` (boundary
    vectors select start/done) — cross-validation against the finite
    compiler and direct finite use.  A torch ``core`` keeps its device; a
    numpy one goes to ``device`` (default ``cuda``)."""
    device = resolve_device(device, (core,))
    core = torch.as_tensor(core).to(device)
    nw = core.shape[2]
    cores = core.expand((n_sites,) + tuple(core.shape)).contiguous()
    left = torch.zeros((nw,), dtype=core.dtype, device=device)
    left[0] = 1.0
    right = torch.zeros((nw,), dtype=core.dtype, device=device)
    right[nw - 1] = 1.0
    return MPO(cores, left, right)
