"""The JAX package's ternary MERA of the critical transverse-field Ising chain.

    JAX_PLATFORMS=cpu python scripts/mera_reference.py SWEEPS [CHI] [SEED]

Runs ``contractn_tpu.models.mera.mera_ground_state`` on ``tfim_h2()`` (J = h
= 1) at bond ``CHI`` (default 4) for ``SWEEPS`` sweeps from the numpy start
``chip_smoke.mera_start(CHI, 2, SEED)`` (default seed 0) and prints,
unrounded, the energy per site and its distance to the exact -4/pi, the
second scaling dimension (the Ising sigma field, exactly 1/8) and the
seconds the run took.  ``chip_smoke.py`` pins these readings (``"e_ref"`` and
``"dim_ref"`` of ``TWO_D["mera"]``) and holds the port's MERA on the card to
them: the Evenbly-Vidal sweeps from a random start need about 6,000 sweeps
to bring the energy within 3e-4 of -4/pi and 12,000 to bring the sigma
dimension within 0.02 of 1/8 (the JAX package's test), more than the card's
time budget allows.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

from chip_smoke import mera_start  # noqa: E402
from contractn_tpu.models.itebd import tfim_h2  # noqa: E402
from contractn_tpu.models.mera import mera_ground_state, scaling_dimensions  # noqa: E402


def main(argv):
    sweeps, chi, seed = (int(a) for a in (argv + ["4", "0"][len(argv) - 1:])[:3])
    start = mera_start(chi, 2, seed)
    init = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in start.items()}
    t0 = time.perf_counter()
    params, energy = mera_ground_state(tfim_h2(), chi, sweeps=sweeps, init=init)
    dim = float(scaling_dimensions(params, n=2)[1])
    print(f"chi {chi}, seed {seed}, {sweeps} sweeps: energy {energy!r}, "
          f"energy + 4/pi {energy + 4.0 / np.pi!r}, sigma dimension {dim!r}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.devices()[0].platform}")


if __name__ == "__main__":
    main(sys.argv[1:])
