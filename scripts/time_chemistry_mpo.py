"""Time the host compile of the hydrogen-chain Hamiltonian's MPO.

    python scripts/time_chemistry_mpo.py [n_atoms ...] [--device cpu|cuda]

For each linear H_n chain (STO-3G, 1.8 bohr spacing, RHF orbitals) prints
the number of second-quantized terms and the seconds ``chemistry_mpo``
takes to compile them charge-blocked (``symmetric=True``, the operator
``chemistry_dmrg_u1`` needs): the chunked AutoMPO runs in Python and the
block SVDs of ``compress_mpo_u1`` in numpy, so the time is mostly the
host's.  ``chip_smoke.py`` sizes its hydrogen chain by this time, taken on
the card's machine.  Default: H8 and H10 on ``cuda`` (raises without a GPU
unless ``--device cpu`` is given).
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from contractn_tpu_torch.models import chemistry as chem  # noqa: E402
from contractn_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv):
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
        argv = [a for a in argv if a not in ("--device", device)]
    device = resolve_device(device)
    where = str(device)
    if device.type == "cuda":
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()[0]
    for n in [int(a) for a in argv] or [8, 10]:
        syms, xyz = chem.h_chain_geometry(n, 1.8)
        basis, charges = chem.sto3g_basis(syms, xyz)
        s, hcore, eri, _ = chem.molecular_integrals(basis, charges, xyz)
        _, c, _ = chem.restricted_hartree_fock(s, hcore, eri, n)
        h1, g2 = chem.mo_transform(hcore, eri, c)
        n_terms = len(chem.chemistry_terms(h1, g2))
        print(f"H{n}: {n_terms} terms, compiling...", flush=True)
        t0 = time.perf_counter()
        mpo = chem.chemistry_mpo(h1, g2, symmetric=True, device=device)
        print(f"H{n}: charge-blocked MPO, W {mpo.cores.shape[3]}, compiled in "
              f"{time.perf_counter() - t0:.1f} s ({device}; {where})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
