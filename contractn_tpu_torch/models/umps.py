"""Uniform (infinite) MPS: thermodynamic-limit quantities.

Counterpart of ``contractn_tpu/models/umps.py``.  A translation-invariant
state is one core ``A (d, D, D)`` repeated forever; everything observable
flows from the transfer operator ``T(rho) = sum_s A_s rho A_s^H``, never
built as a ``D^2 x D^2`` matrix (each application is two GEMM-shaped
einsums):

* ``log lambda_1``, the log-norm per site of the infinite chain;
* ``lambda_2 / lambda_1``, the correlation length
  ``xi = -1 / log |lambda_2/lambda_1|``;
* fixed points ``l, r``, the environments of local expectation values
  ``<O> = tr(l T_O(r)) / (lambda_1 tr(l r))``.

Eigenpairs come from power iteration for a FIXED number of steps on the
core's device (per-step rescale, no host read inside the loop), the
subleading one by deflation against the leading left/right fixed points.

Departures: random starts and the sampler's draws come from a
``torch.Generator`` where the JAX package takes a key; the sampler draws
each site of all samples at once by inverse-CDF on uniforms from that
generator (the JAX package uses ``jax.random.categorical``), so the two
packages draw from the same distribution but not the same samples.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device


def _core(core, device):
    device = resolve_device(device, (core,))
    return as_tensor(core, device)


def _apply_T(core, rho):
    """``sum_s A_s rho A_s^H`` via two GEMM-shaped einsums."""
    x = peinsum("sij,jk->sik", core, rho)
    return peinsum("sik,slk->il", x, core.conj())


def _apply_Tt(core, rho):
    """Adjoint map ``sum_s A_s^H rho A_s`` (left fixed point)."""
    x = peinsum("sji,jk->sik", core.conj(), rho)
    return peinsum("sik,skl->il", x, core)


def _power_leading(core, rho0, deflate, iters):
    """Leading eigenpair of T (or of T deflated against ``deflate = (l, r,
    lam)``, the leading left/right fixed points, so the iteration converges
    to ``lambda_2``).  Returns ``(lam, rho)`` with ``rho`` the
    Frobenius-normalized eigenmatrix and ``lam`` its Rayleigh estimate."""
    rho = rho0 / torch.clamp(torch.linalg.norm(rho0), min=1e-300)
    if deflate is not None:
        l0, r0, _ = deflate
        denom = torch.trace(l0 @ r0)

        def project(x):
            return x - (torch.trace(l0 @ x) / denom) * r0
    else:
        def project(x):
            return x

    lam = torch.zeros((), dtype=core.dtype, device=core.device)
    for _ in range(int(iters)):
        new = _apply_T(core, project(rho))
        nrm = torch.clamp(torch.linalg.norm(new), min=1e-300)
        lam = peinsum("ij,ij->", rho.conj(), new)
        rho = new / nrm
    return lam, rho


def _scalar(x, cplx):
    v = complex(x.item())
    return v if cplx else float(v.real)


def transfer_spectrum(core, iters=300, generator=None, device=None):
    """Leading two transfer-operator eigenvalues and fixed points.

    Returns a dict with ``lam1`` (leading eigenvalue), ``lam2``
    (subleading, may be negative/complex), ``xi`` (correlation length in
    sites, ``inf`` when degenerate), and the fixed points ``l, r``
    (Frobenius-normalized).  ``generator`` draws the power iterations'
    starts.
    """
    core = _core(core, device)
    bond = core.shape[1]
    rdt = core.real.dtype if core.is_complex() else core.dtype
    noise = torch.randn((bond, bond), dtype=rdt, device=core.device,
                        generator=generator)
    rho0 = (torch.eye(bond, dtype=core.dtype, device=core.device)
            + 0.01 * noise.to(core.dtype))
    lam1, r = _power_leading(core, rho0, None, iters)
    left = rho0
    for _ in range(int(iters)):
        new = _apply_Tt(core, left)
        left = new / torch.clamp(torch.linalg.norm(new), min=1e-300)
    rho2 = torch.randn((bond, bond), dtype=rdt, device=core.device,
                       generator=generator).to(core.dtype)
    lam2, _ = _power_leading(core, rho2, (left, r, lam1), iters)

    cplx = core.is_complex()
    lam1_f, lam2_f = complex(lam1.item()), complex(lam2.item())
    ratio = abs(lam2_f) / abs(lam1_f) if lam1_f else 0.0
    xi = float("inf") if ratio >= 1.0 - 1e-12 else (
        float("inf") if ratio == 0 else -1.0 / np.log(ratio))
    return {
        "lam1": lam1_f if cplx else float(lam1_f.real),
        "lam2": lam2_f if cplx else float(lam2_f.real),
        "xi": xi,
        "l": left,
        "r": r,
    }


def log_norm_per_site(core, iters=300, device=None):
    """``lim_N (1/N) log <psi_N|psi_N>`` of the infinite chain: ``log
    lambda_1`` of the transfer operator."""
    spec = transfer_spectrum(core, iters=iters, device=device)
    return float(np.log(abs(spec["lam1"])))


def correlation_length(core, iters=300, device=None):
    """``xi = -1 / log |lam2 / lam1|`` in units of sites."""
    return transfer_spectrum(core, iters=iters, device=device)["xi"]


def _dressed(core, op, rho):
    x = peinsum("st,tij->sij", op, core)
    x = peinsum("sij,jk->sik", x, rho)
    return peinsum("sik,slk->il", x, core.conj())


def correlate(core, op1, op2, distances, iters=300, device=None):
    """Connected two-point correlators ``<O1_0 O2_x> - <O1><O2>`` in the
    thermodynamic limit, for each separation in ``distances`` (one pass of
    transfer applications to the ``O2``-dressed right environment,
    rescaled by ``lambda_1`` every step)."""
    distances = [int(x) for x in distances]
    if any(x < 1 for x in distances):
        raise ValueError("distances must be >= 1")
    core = _core(core, device)
    spec = transfer_spectrum(core, iters=iters)
    left, r, lam1 = spec["l"], spec["r"], spec["lam1"]
    op1 = as_tensor(op1, core.device, core.dtype)
    op2 = as_tensor(op2, core.device, core.dtype)
    norm = torch.trace(left @ r)
    e1 = torch.trace(left @ _dressed(core, op1, r)) / (lam1 * norm)
    e2 = torch.trace(left @ _dressed(core, op2, r)) / (lam1 * norm)
    env = _dressed(core, op2, r)
    out = {}
    for x in range(1, max(distances) + 1):
        if x in distances and x not in out:
            num = torch.trace(left @ _dressed(core, op1, env))
            out[x] = num / (lam1 ** 2 * norm) - e1 * e2
        env = _apply_T(core, env) / lam1
    cplx = core.is_complex()
    return [_scalar(out[x], cplx) for x in distances]


def _local(core, spec, op):
    left, r, lam1 = spec["l"], spec["r"], spec["lam1"]
    num = torch.trace(left @ _dressed(core, op, r))
    den = lam1 * torch.trace(left @ r)
    return complex(num.item()) / complex(den.item())


def expect_local(core, op, iters=300, device=None):
    """``<psi| O_i |psi> / <psi|psi>`` for a one-site operator ``O`` in the
    thermodynamic limit: ``tr(l T_O(r)) / (lam1 tr(l r))``."""
    core = _core(core, device)
    spec = transfer_spectrum(core, iters=iters)
    val = _local(core, spec, as_tensor(op, core.device, core.dtype))
    return val if core.is_complex() else float(val.real)


def static_structure_factor(core, op, ks, max_distance=60, iters=300,
                            device=None):
    """``S(k) = sum_x e^{ikx} <O_0 O_x>_c`` of a uniform MPS: connected
    real-space correlators out to ``max_distance`` plus the on-site term,
    cosine-transformed at each momentum."""
    core = _core(core, device)
    op = as_tensor(op, core.device, core.dtype)
    xs = list(range(1, int(max_distance) + 1))
    cx = np.real(np.asarray(correlate(core, op, op, xs, iters=iters)))
    spec = transfer_spectrum(core, iters=iters)
    m1 = float(np.real(_local(core, spec, op)))
    m2 = float(np.real(_local(core, spec, peinsum("st,tu->su", op, op))))
    c0 = m2 - m1 * m1
    scalar_in = np.ndim(ks) == 0
    ks = np.atleast_1d(np.asarray(ks, float))
    out = c0 + 2.0 * np.matmul(np.cos(np.outer(ks, xs)), cx)
    return float(out[0]) if scalar_in else out


# --------------------------------------------------------------------- #
# Perfect (Born-rule) sampling of a window of the infinite state
# --------------------------------------------------------------------- #


def _sample_env(core, gauge_iters):
    from .vumps import mixed_gauge

    _, ar, c = mixed_gauge(core, iters=gauge_iters)
    rho0 = peinsum("ji,jk->ik", c.conj(), c)
    return ar, rho0 / torch.trace(rho0)


def umps_sample(core, n_sites, n_samples, generator=None, gauge_iters=60,
                device=None):
    """Perfect Born-rule samples of an ``n_sites`` window of the INFINITE
    state (Ferris/Vidal, PRB 85, 165146).

    Mixed gauge puts the window right of the center bond, so the chain
    rule is exact: ``p(s | prefix) = tr(AR^s^H rho AR^s)`` with ``rho <-
    AR^s^H rho AR^s / p``.  All samples advance one site at a time as one
    batch on the core's device; each site's outcomes are drawn by
    inverse-CDF from one batch of uniforms out of ``generator`` (no host
    read until the end).

    Returns an ``(n_samples, n_sites)`` int numpy array of local outcomes.
    Exact oracle: :func:`umps_window_distribution`.
    """
    core = _core(core, device)
    ar, rho0 = _sample_env(core, gauge_iters)
    n_samples, n_sites = int(n_samples), int(n_sites)
    rho = rho0.expand((n_samples,) + tuple(rho0.shape))
    rdt = ar.real.dtype if ar.is_complex() else ar.dtype
    rows = torch.arange(n_samples, device=ar.device)
    out = []
    for _ in range(n_sites):
        t = peinsum("sji,njk,skl->nsil", ar.conj(), rho, ar)
        p = torch.clamp(torch.real(torch.diagonal(t, dim1=-2, dim2=-1).sum(-1)),
                        min=0.0)
        cdf = torch.cumsum(p, dim=-1)
        u = torch.rand((n_samples, 1), dtype=rdt, device=ar.device,
                       generator=generator) * cdf[:, -1:]
        s = torch.clamp((cdf <= u).sum(-1), max=p.shape[-1] - 1)
        rho = t[rows, s] / torch.clamp(p[rows, s], min=1e-300)[:, None, None].to(
            t.dtype)
        out.append(s)
    return torch.stack(out, dim=1).cpu().numpy()


def umps_window_distribution(core, n_sites, gauge_iters=60, device=None):
    """The EXACT joint distribution ``p(s_1 .. s_n)`` of an ``n_sites``
    window (``d^n`` outcomes enumerated through the chain rule
    :func:`umps_sample` draws from).  Returns a ``(d,) * n_sites`` numpy
    array summing to 1."""
    core = _core(core, device)
    ar, rho0 = _sample_env(core, gauge_iters)
    ar = ar.cpu().numpy()
    d = ar.shape[0]
    mats = [np.conj(ar[s]).T for s in range(d)]
    out = np.zeros((d,) * int(n_sites))

    def rec(rho, prefix):
        if len(prefix) == n_sites:
            out[prefix] = np.real(np.trace(rho))
            return
        for s in range(d):
            rec(np.einsum("ij,jk,lk->il", mats[s], rho, np.conj(mats[s])),
                prefix + (s,))

    rec(rho0.cpu().numpy(), ())
    return out

