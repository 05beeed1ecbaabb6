"""Tensor cross interpolation (TCI): learn an MPS from adaptively chosen
samples of a black-box tensor.

Counterpart of ``contractn_tpu/models/tci.py``.  The cross-approximation
sweeps (two-site full-pivot ACA over pivot multi-index sets ``(I_k, J_k)``,
the CUR chain ``F ~ T_0 P_1^{-1} T_1 ... T_{n-1}``, and the certification
rounds that promote the worst random samples to global pivots) are host
numpy, as in the JAX package, whose TCI has no device code either: the
adaptive control flow is dynamic, and every function evaluation is one
batched call ``f((N, n) int array) -> (N,)`` on not-yet-seen indices.  Only
the assembled cores become tensors, in the uniform stacked MPS
(:func:`~.dmrg._rebuild_uniform`) on ``device`` (default ``cuda``).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from .dmrg import _rebuild_uniform


class _CachedFn:
    """Memoized batched wrapper around ``f((N, n) ints) -> (N,)``.

    Every distinct multi-index is evaluated exactly once across the
    whole TCI run; each slab request turns into ONE batched call on the
    not-yet-seen rows.
    """

    def __init__(self, f):
        self._f = f
        self._cache = {}
        self.scale = 0.0  # max |f| seen so far

    @property
    def n_evals(self):
        return len(self._cache)

    def __call__(self, idx):
        idx = [tuple(int(v) for v in row) for row in idx]
        missing = list(dict.fromkeys(t for t in idx if t not in self._cache))
        if missing:
            vals = np.asarray(self._f(np.asarray(missing, dtype=np.int64)))
            vals = vals.reshape(len(missing))
            for t, v in zip(missing, vals):
                self._cache[t] = v
            m = float(np.abs(vals).max())
            if m > self.scale:
                self.scale = m
        return np.array([self._cache[t] for t in idx])


def _full_pivot_cross(a, max_rank, tol):
    """Greedy full-pivot ACA on the dense slab ``a``.

    Returns ``(rows, cols, residual)`` — the selected pivot rows/cols
    (in order of decreasing pivot magnitude) and the max-abs residual
    after elimination.  Stops at ``max_rank`` pivots or when the next
    pivot drops below ``tol * max|a|``.
    """
    e = np.array(a, copy=True)
    m, n = e.shape
    scale = float(np.abs(a).max())
    if scale == 0.0:
        return [], [], 0.0
    rows, cols = [], []
    for _ in range(min(max_rank, m, n)):
        flat = int(np.abs(e).argmax())
        i, j = divmod(flat, n)
        p = e[i, j]
        if abs(p) <= tol * scale:
            break
        rows.append(i)
        cols.append(j)
        e = e - np.outer(e[:, j], e[i, :]) / p
    return rows, cols, float(np.abs(e).max())


@dataclass
class TCIInfo:
    """Run diagnostics: unique evaluations, final bond ranks, the
    certified random-sample error ``max |f - interp|``, the max ``|f|``
    seen, total sweeps used."""

    n_evals: int
    ranks: tuple
    error: float
    scale: float
    sweeps: int


def _assemble(fn, I, J, dims):
    """The CUR-chain cores ``T_k P_{k+1}^{-1}`` as ``(d, l, r)``
    tensors (host numpy)."""
    n = len(dims)
    tensors = []
    for k in range(n):
        rows, cols_j = I[k], J[k + 1]
        idx = [r + (s,) + c
               for r in rows for s in range(dims[k]) for c in cols_j]
        t = fn(idx).reshape(len(rows), dims[k], len(cols_j))
        if k < n - 1:
            p = fn([a + b for a in I[k + 1] for b in J[k + 1]])
            p = p.reshape(len(I[k + 1]), len(J[k + 1]))
            # M = T P^{-1}  <=>  P^T M^T = T^T   (pinv on the rare
            # non-square/singular P left by a zero-slab edge case)
            flat = t.reshape(-1, p.shape[1])
            if p.shape[0] == p.shape[1]:
                try:
                    m = np.linalg.solve(p.T, flat.T).T
                except np.linalg.LinAlgError:
                    m = np.matmul(flat, np.linalg.pinv(p))
            else:
                m = np.matmul(flat, np.linalg.pinv(p))
            t = m.reshape(t.shape[0], t.shape[1], p.shape[0])
        tensors.append(t.transpose(1, 0, 2))  # (d, left, right)
    return tensors


def _eval_tensors(tensors, idx):
    """Interpolant values at the ``(N, n)`` multi-indices (host)."""
    idx = np.asarray(idx)
    v = None
    for k, t in enumerate(tensors):
        sel = t[idx[:, k]]  # (N, l, r)
        v = sel[:, 0, :] if v is None else np.einsum(
            "nl,nlr->nr", v, sel)
    return v[:, 0]


def _initial_pivot(fn, dims, n_probe, seed):
    """A nonzero starting multi-index: argmax ``|f|`` over deterministic
    corners plus ``n_probe`` seeded random candidates."""
    n = len(dims)
    rng = np.random.default_rng(seed)
    cand = [tuple(0 for _ in range(n)),
            tuple(d - 1 for d in dims),
            tuple(d // 2 for d in dims)]
    for _ in range(n_probe):
        cand.append(tuple(int(rng.integers(d)) for d in dims))
    cand = list(dict.fromkeys(cand))
    vals = fn(cand)
    k = int(np.abs(vals).argmax())
    if vals[k] == 0:
        raise ValueError(
            "all pivot probes evaluated to zero — supply pivot0 with "
            "f(pivot0) != 0")
    return cand[k]


def tci_cross(f, dims, max_bond=32, tol=1e-10, sweeps=8, pivot0=None,
              n_probe=64, seed=0, n_check=256, rounds=6, device=None):
    """MPS approximation of the black-box tensor ``F`` by tensor cross
    interpolation.

    Args:
        f: batched evaluator ``f((N, n) int64 array) -> (N,)`` values.
        dims: per-site physical dimensions.
        max_bond: rank cap per bond (adaptive below it).
        tol: relative pivot tolerance — elimination on each slab stops
            once the next pivot is below ``tol * max|f|`` on that slab.
        sweeps: max full left-right+right-left sweep pairs; stops early
            when the pivot sets reach a fixed point.
        pivot0: optional starting multi-index with ``f(pivot0) != 0``;
            probed automatically when omitted.
        n_probe: random probe count for the automatic starting pivot.
        seed: probe rng seed.
        n_check: random certification samples per round.  The sweeps'
            slab residual only certifies the *sampled* cross (nested
            pivot sets can reach a fixed point far from the tensor —
            the classic TCI ergodicity failure); each round therefore
            checks ``|f - interp|`` on fresh random multi-indices and
            inserts the worst offenders as global pivots before
            re-sweeping (xfac's ``addGlobalPivots``).
        rounds: max certification rounds.
        device: where the assembled MPS goes (default ``cuda``).

    Returns:
        ``(mps, info)`` — the uniform stacked
        :class:`~.mps.MPS` (bonds zero-padded to the
        max rank, per the framework's static-shape invariant) and a
        :class:`TCIInfo`.
    """
    dims = tuple(int(d) for d in dims)
    n = len(dims)
    if n < 2:
        raise ValueError("need at least 2 sites")
    fn = _CachedFn(f)
    if pivot0 is None:
        pivot0 = _initial_pivot(fn, dims, n_probe, seed)
    pivot0 = tuple(int(v) for v in pivot0)

    # I[k]: row prefixes of length k (bond k lives left of site k);
    # J[k]: column suffixes of length n-k.  I[0] = J[n] = [()].
    I = [[pivot0[:k]] for k in range(n + 1)]
    J = [[pivot0[k:]] for k in range(n + 1)]

    rng = np.random.default_rng(seed + 1)
    used = 0
    err_global = np.inf
    tensors = None
    for rnd in range(rounds):
        for it in range(sweeps):
            snapshot = ([list(x) for x in I], [list(x) for x in J])
            err = 0.0
            order = list(range(n - 1)) + list(range(n - 2, -1, -1))
            for k in order:
                rows = [p + (s,) for p in I[k] for s in range(dims[k])]
                cols = [(t,) + q
                        for t in range(dims[k + 1]) for q in J[k + 2]]
                idx = [r + c for r in rows for c in cols]
                pi = fn(idx).reshape(len(rows), len(cols))
                ri, ci, res = _full_pivot_cross(pi, max_bond, tol)
                if not ri:  # slab numerically zero — keep old pivots
                    continue
                I[k + 1] = [rows[i] for i in ri]
                J[k + 1] = [cols[j] for j in ci]
                err = max(err, res)
            used += 1
            if ([list(x) for x in I], [list(x) for x in J]) == snapshot:
                break
            if err <= tol * max(fn.scale, 1e-300):
                break

        # certify on fresh random samples; promote offenders to pivots
        tensors = _assemble(fn, I, J, dims)
        check = np.stack([rng.integers(0, d, size=n_check) for d in dims],
                         axis=1)
        diff = np.abs(fn(check) - _eval_tensors(tensors, check))
        err_global = float(diff.max())
        if err_global <= tol * max(fn.scale, 1e-300) or rnd == rounds - 1:
            break
        worst = np.argsort(diff)[::-1][:4]
        for w in worst:
            if diff[w] <= tol * max(fn.scale, 1e-300):
                continue
            x = tuple(int(v) for v in check[w])
            for k in range(1, n):
                if x[:k] not in I[k]:
                    I[k] = I[k] + [x[:k]]
                if x[k:] not in J[k]:
                    J[k] = J[k] + [x[k:]]

    ranks = tuple(len(I[k]) for k in range(1, n))
    info = TCIInfo(n_evals=fn.n_evals, ranks=ranks, error=err_global,
                   scale=fn.scale, sweeps=used)
    device = resolve_device(device)
    cores = [torch.from_numpy(np.ascontiguousarray(t)).to(device)
             for t in tensors]
    return _rebuild_uniform(cores, cores[0].dtype), info


# -- quantics front ends ---------------------------------------------- #


def _bit_weights(n_bits):
    return 2 ** np.arange(n_bits - 1, -1, -1, dtype=np.int64)  # MSB first


def function_tci(f, n_bits, domain=(0.0, 1.0), max_bond=16, tol=1e-10,
                 sweeps=8, seed=0, device=None):
    """Quantics MPS of ``f`` on the ``2**n_bits`` dyadic grid by TCI —
    the scalable counterpart of :func:`~.quantics.function_mps` (no dense
    sample vector; ``f`` is called on the adaptively chosen grid points
    only).

    ``f`` must be vectorized over a 1D array of ``x`` values.  Site
    ordering matches ``function_mps`` (site 0 = most significant bit),
    so all quantics MPOs/integrals apply unchanged.  Returns
    ``(mps, info)``.
    """
    a, b = float(domain[0]), float(domain[1])
    h = (b - a) / 2 ** n_bits
    w = _bit_weights(n_bits)

    def fn(idx):
        return np.asarray(f(a + h * np.matmul(idx, w)))

    return tci_cross(fn, (2,) * n_bits, max_bond=max_bond, tol=tol,
                     sweeps=sweeps, seed=seed, device=device)


def function_tci_2d(f, n_bits, domains=((0.0, 1.0), (0.0, 1.0)),
                    max_bond=24, tol=1e-10, sweeps=8, seed=0, device=None):
    """2D quantics MPS by TCI, stacked register ordering (x bits =
    sites ``0..n-1``, y bits = the rest) — same layout as
    :func:`~.quantics.function_mps_2d`, so
    ``register_mpo`` operators and ``quantics_to_dense_2d`` apply.

    ``f`` must be elementwise-vectorized over equal-length ``(x, y)``
    arrays.  Returns ``(mps, info)``.
    """
    (ax, bx), (ay, by) = domains
    hx = (float(bx) - float(ax)) / 2 ** n_bits
    hy = (float(by) - float(ay)) / 2 ** n_bits
    w = _bit_weights(n_bits)

    def fn(idx):
        jx = np.matmul(idx[:, :n_bits], w)
        jy = np.matmul(idx[:, n_bits:], w)
        return np.asarray(f(float(ax) + hx * jx, float(ay) + hy * jy))

    return tci_cross(fn, (2,) * (2 * n_bits), max_bond=max_bond, tol=tol,
                     sweeps=sweeps, seed=seed, device=device)
