"""The JAX package's charge-masked chemistry DMRG on the hydrogen chain.

    JAX_PLATFORMS=cpu python scripts/chemistry_u1_reference.py N_ATOMS BOND SWEEPS [N_KEYS]

Runs ``contractn_tpu.models.chemistry.chemistry_dmrg_u1`` on the linear
H_n chain (STO-3G, 1.8 bohr spacing, RHF orbitals) from the Hartree-Fock
determinant plus its default masked noise, drawn from ``PRNGKey(k)`` for k
below ``N_KEYS`` (default 1), and prints the electronic energy each start
reaches, unrounded, beside the nuclear repulsion, the RHF total energy and
the seconds the run took, then the spread over the starts.  The masked
route splits its bond among the charge classes by ``u1_bond_charges``, so
below the bond that holds every sector's Schmidt rank it stops above the
exact energy, at a level that depends on its start only as far as that
spread shows; ``chip_smoke.py`` pins the ``PRNGKey(0)`` readings (``"u1_ref"``
of ``INFINITE["h_chain"]`` and ``INFINITE_TINY["h_chain"]``) and holds the
port's masked route to them.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from contractn_tpu.models import chemistry as chem  # noqa: E402


def main(argv):
    n, bond, sweeps, n_keys = (int(a) for a in (argv + ["1"])[:4])
    syms, xyz = chem.h_chain_geometry(n, 1.8)
    basis, charges = chem.sto3g_basis(syms, xyz)
    s, hcore, eri, e_nuc = chem.molecular_integrals(basis, charges, xyz)
    e_hf, c, _ = chem.restricted_hartree_fock(s, hcore, eri, n)
    h1, g2 = chem.mo_transform(hcore, eri, c)
    mpo = chem.chemistry_mpo(h1, g2, symmetric=True)
    energies = []
    for k in range(n_keys):
        t0 = time.perf_counter()
        e, _, _, _ = chem.chemistry_dmrg_u1(h1, g2, n, bond_dim=bond, sweeps=sweeps,
                                            mpo=mpo, key=jax.random.PRNGKey(k))
        energies.append(e)
        print(f"H{n} bond {bond}, {sweeps} sweeps, PRNGKey({k}): electronic {e!r}, "
              f"nuclear {float(e_nuc)!r}, total {e + float(e_nuc)!r}; RHF total "
              f"{float(e_hf + e_nuc)!r}; {time.perf_counter() - t0:.1f} s on "
              f"{jax.devices()[0].platform}", flush=True)
    print(f"spread over {n_keys} start(s): {max(energies) - min(energies)!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
