"""ARPES on the infinite Hubbard chain: exact-charge photoemission.

On the PyTorch port: the single-particle spectral function ``A(kappa, w)`` of the
half-filled 1D Hubbard model, computed entirely in the thermodynamic
limit on the NATIVE d=4 charge-masked cell ground state
(``vumps_u1_cell`` — no d^16 folding):

1. the Jordan-Wigner string of the electron operator TELESCOPES on the
   exact-U(1) manifold (``string_parities_cell``; the site parity
   ``Z x Z`` has eigenvalues ``(+1, -1, -1, +1)`` = ``(-1)^n``), so
   ``c_up(kappa)`` rides the bosonic tangent machinery unchanged;
2. removal (ARPES) poles come from ``spectral_weights_cell`` with the
   string parities — their TOTAL weight is the momentum distribution
   ``n_up(kappa)``, cross-checked against independent string
   correlators (``correlate_cell(string=...)``, the finite
   ``c^d_i Z .. Z c_j`` route);
3. the removal/addition band EDGES straddle the exact Lieb-Wu Mott
   gap, with ``E_add - E_rem == U`` pointwise (particle-hole symmetry
   holds structurally on the masked manifold).

Run with: ``python3 examples/torch/hubbard_arpes.py [--device cpu]`` (raise D
for quantitative band edges).
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.excitations_cell import (
    prepare_excitations_cell,
    spectral_weights_cell,
)
from contractn_tpu_torch.models.hubbard import (
    hubbard_chain_cell,
    hubbard_charge_gap,
)
from contractn_tpu_torch.models.u1_vumps_cell import (
    sector_excitation_minimum_cell,
    string_parities_cell,
    vumps_u1_cell,
)
from contractn_tpu_torch.models.vumps_cell import (
    correlate_cell,
    expect_local_cell,
)

U = 8.0
D = 16  # demo scale; D >= 32 for quantitative band edges
A_PACK = 32

_I2 = np.eye(2)
_Z = np.diag([1.0, -1.0])
_SM = np.array([[0.0, 0.0], [1.0, 0.0]])
_SP = _SM.T

c_up = np.kron(_SM, _I2)          # annihilate an up electron
site_parity = np.kron(_Z, _Z)     # (-1)^(n_up + n_dn)
n_up = np.kron(np.diag([1.0, 0.0]), _I2)


def _host(v):
    """A tensor, or a list of scalars, as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.array([complex(x) for x in v]) if isinstance(v, (list, tuple)) else np.asarray(v)


def main(device="cuda"):
    q4 = (A_PACK + 1, A_PACK - 1, -A_PACK + 1, -A_PACK - 1)
    cell = hubbard_chain_cell(t=1.0, u=U, device=device)
    w = cell.cores[0]
    print(f"masked cell VUMPS (U={U}, D={D}) ...")
    g = vumps_u1_cell([w, w], D, q4, iters=60,
                      left=cell.left, right=cell.right)
    print(f"  grad={g['gradient_norm']:.2e}  e/site={g['energy']:.6f}")

    parities, cell_sign = string_parities_cell(
        g["sector"], tuple(np.diag(site_parity)))
    print(f"  cell wrap sign = {cell_sign:+.0f} "
          "(2 electrons/cell at half filling)")

    # momentum distribution from string correlators (sum-rule oracle)
    xs = list(range(1, 30))
    cdag_up = np.kron(_SP @ _Z, _Z)  # c^d_up, own site parity absorbed
    c1 = _host(correlate_cell(
        g, cdag_up, c_up, 0, xs, string=site_parity))
    c2 = _host(correlate_cell(
        g, cdag_up, c_up, 1, xs, string=site_parity))
    nbar = 0.5 * (complex(expect_local_cell(g, n_up, 0))
                  + complex(expect_local_cell(g, n_up, 1))).real

    def n_of(kappa):
        v = nbar
        for r, (a, b) in enumerate(zip(c1, c2), start=1):
            v += 2 * np.real(np.exp(-1j * kappa * r) * 0.5 * (a + b))
        return v

    prep = prepare_excitations_cell(g, [w, w], tol=1e-8)
    gap = hubbard_charge_gap(U)
    print(f"exact Lieb-Wu charge gap: {gap:.4f}  "
          f"(removal edge {(gap - U) / 2:+.4f}, "
          f"addition edge {(gap + U) / 2:+.4f} at mu=0)")

    # removal band edge + particle-hole partner (Lanczos, cheap)
    e_rem, _ = sector_excitation_minimum_cell(
        g, [w, w], -2 * A_PACK, np.pi, prep=prep, iters=40)
    e_add, _ = sector_excitation_minimum_cell(
        g, [w, w], +2 * A_PACK, np.pi, prep=prep, iters=40)
    print(f"removal band bottom:  {float(e_rem):+.4f}")
    print(f"addition band bottom: {float(e_add):+.4f}   "
          f"E_add - E_rem = {float(e_add) - float(e_rem):.6f} == U")

    # ARPES poles at a few momenta: lower Hubbard band + sum rule
    print("kappa   n_up(kappa)   sum_a w_a   dominant poles (w, wt)")
    for kappa in (0.5, 1.5, 2.6):
        om, wt = spectral_weights_cell(
            g, [w, w], c_up, kappa, prep=prep,
            string_parities=parities, cell_sign=cell_sign)
        om, wt = _host(om), _host(wt)
        tot = float(np.sum(wt))
        top = np.argsort(wt)[::-1][:2]
        poles = ", ".join(f"({om[i]:+.3f}, {wt[i]:.4f})" for i in top)
        print(f"{kappa:5.2f}   {n_of(kappa):10.6f}   {tot:9.6f}   "
              f"{poles}")
    print("note: in the Mott insulator the removal weight spreads "
          "into the spinon-holon continuum — the sum rule is exact, "
          "single poles are not the whole story (unlike the free "
          "chain, where one pole carries > 99.9%).")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
