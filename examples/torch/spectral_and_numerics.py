"""Spectral functions, quantics numerics and decompositions on the PyTorch
port: TTN-DMRG, T=0 and T=inf KPM spectra, a quantics derivative, screened
Poisson solve and QFT, CP-ALS and AD-HOTRG.

Run with: ``python3 examples/torch/spectral_and_numerics.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    MPS,
    cp_als,
    cp_reconstruct,
    chebyshev_moments,
    dmrg,
    derivative_mpo,
    function_mps,
    grid,
    ising_internal_energy_ad,
    kpm_spectral_function,
    laplacian_mpo,
    liouvillian_kpm_moments,
    mpo_sum,
    mps_linear_solve,
    qft_mps,
    quantics_to_dense,
    tfim_mpo,
    ttn_dmrg,
    vectorized_operator,
)
from contractn_tpu_torch.models.boundary import apply_mpo_to_mps
from contractn_tpu_torch.models.linsolve import linear_residual
from contractn_tpu_torch.models.mpo import MPO

Z = np.diag([1.0, -1.0])


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(device="cuda"):
    # --- TTN-DMRG: tree ground state, machine-precision sweeps ------- #
    n = 16
    h_mpo = tfim_mpo(n, h=1.05, device=device)
    params, es = ttn_dmrg(h_mpo, chi=24, sweeps=4)
    print(f"TTN-DMRG  n={n} TFIM energy {es[-1]:.10f} "
          f"(sweeps: {[f'{e:.6f}' for e in es]})")

    # --- T=0 spectral function by CheMPS/KPM -------------------------- #
    n = 10
    h_mpo = tfim_mpo(n, h=1.2, device=device)
    mps0 = MPS.random(n, 2, 16, generator=torch.Generator(device).manual_seed(0),
                      device=device)
    gs, e0, _ = dmrg(h_mpo, mps0, max_bond=24, sweeps=5)
    e0 = float(np.real(complex(e0)))
    bounds = (e0 - 0.5, -e0 + 2.0)  # crude rigorous envelope
    mom, a, b = chebyshev_moments(h_mpo, gs, [(n // 2, Z)], 128, bounds,
                                  max_bond=32)
    mom = _host(mom)
    w = np.linspace(-0.5, 8.0, 500)
    s = _host(kpm_spectral_function(mom, a, b, w, e0=e0))
    print(f"KPM T=0   sum rule {np.trapezoid(s, w):.6f} "
          f"(mu_0 = {mom[0].real:.6f}); peak at w = {w[np.argmax(s)]:.3f}")

    # --- infinite-temperature transport spectrum ---------------------- #
    mom_inf, a2, b2 = liouvillian_kpm_moments(
        h_mpo, vectorized_operator(n, [(n // 2, Z)], device=device), 48,
        (1.3 * e0, -1.3 * e0), max_bond=24)
    band = 2.6 * abs(e0)  # the transition band is +-(emax - emin)
    w2 = np.linspace(-band, band, 2001)
    s2 = _host(kpm_spectral_function(_host(mom_inf), a2, b2, w2))
    print(f"KPM T=inf sum rule {np.trapezoid(s2, w2):.6f} (expect 1); "
          f"S(0) = {s2[np.argmin(np.abs(w2))]:.4f}")

    # --- quantics: derivative + screened Poisson solve ---------------- #
    nb = 12
    x = grid(nb)
    f = function_mps(np.sin(2 * np.pi * x), nb, cutoff=1e-13, device=device)
    df = _host(quantics_to_dense(apply_mpo_to_mps(derivative_mpo(nb, device=device), f)))
    print(f"quantics  d/dx sin on 2^{nb} grid: max err "
          f"{np.max(np.abs(df - 2 * np.pi * np.cos(2 * np.pi * x))):.2e} "
          f"(bond {f.bond_dim})")
    lap = laplacian_mpo(nb, device=device)
    ident = MPO.identity(nb, 2, device=device)
    a_op = mpo_sum(MPO(lap.cores, -lap.left, lap.right),
                   MPO(ident.cores, 25.0 * ident.left, ident.right))
    u, _ = mps_linear_solve(a_op, f, sweeps=6, max_bond=8)
    res = float(linear_residual(a_op, u, f))
    u_d = _host(quantics_to_dense(u))
    cont = np.sin(2 * np.pi * x) / ((2 * np.pi) ** 2 + 25.0)
    print(f"quantics  (-Lap + 25) u = sin: residual {res:.2e}, "
          f"continuum err {np.max(np.abs(u_d - cont)):.2e}")
    g = qft_mps(f, inverse=True)
    peaks = np.argsort(np.abs(_host(quantics_to_dense(g))))[-2:]
    print(f"quantics  QFT of sin peaks at bins {sorted(peaks.tolist())} "
          f"(expect [1, {2**nb - 1}])")

    # --- decomposition algorithms + differentiable RG ----------------- #
    gen = torch.Generator(device).manual_seed(7)
    xs = cp_reconstruct([torch.randn((4, d), generator=gen, device=device)
                         for d in (9, 8, 7)])
    _, errs = cp_als(xs, rank=4, steps=150)
    print(f"CP-ALS    exact-rank recovery rel err {float(errs[-1]):.2e}")
    u03 = ising_internal_energy_ad(0.3, chi=12, steps=28, device=device)
    print(f"AD-HOTRG  u(0.3) = {u03:.8f} (Onsager -0.70449907)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
