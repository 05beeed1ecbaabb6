"""METTS: minimally entangled typical thermal states.

Counterpart of ``contractn_tpu/models/metts.py``.  Finite-temperature
averages by sampling: the thermal trace ``Tr(e^{-beta H} O)/Z = sum_s p_s
<phi_s| O |phi_s>`` over ``|phi_s> = e^{-beta H / 2} |s> / ||...||`` is
estimated by the Markov chain collapse -> imaginary-time evolve -> measure
(White, PRL 102, 190601), from :func:`~.circuits.tebd_evolve` and the exact
sampler :func:`~.sampling.sample_canonical`.  Collapse bases alternate (X
then Z by default) to decorrelate the chain.

Every collapse draws from one explicit ``torch.Generator`` (on the state's
device) where the JAX package splits a key per step.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .canonical import right_canonicalize
from .circuits import tebd_evolve
from .mps import MPS
from .sampling import sample_canonical

_HAD = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)


def _collapse(mps, generator, u_basis, d):
    """Projectively collapse ``|phi>`` in the basis whose bras are the rows
    of ``u_basis``; returns the outcome product state (bond 1)."""
    device = mps.cores.device
    if u_basis is not None:
        u = as_tensor(u_basis, device, mps.cores.dtype)
        mps = MPS(peinsum("st,ntij->nsij", u, mps.cores), mps.left, mps.right)
    rc, _ = right_canonicalize(mps)
    config, _ = sample_canonical(rc, 1, generator)
    config = config[0].cpu().numpy()
    if u_basis is None:
        vecs = np.eye(d)[config]  # (n, d) rows e_{x_i}
    else:
        vecs = np.asarray(u_basis).conj()[config]  # conj(U[s, :]) = U^+ e_s
    cores = as_tensor(vecs[:, :, None, None], device, mps.cores.dtype)
    one = torch.ones((1,), dtype=mps.cores.dtype, device=device)
    return MPS(cores, one, one.clone())


def metts(h2, n_sites, beta, n_samples, max_bond, measure, n_steps=None,
          warmup=3, d=2, bases=("x", "z"), init=None, generator=None,
          device=None):
    """Run the METTS chain and collect measurements.

    Args:
        h2: dense Hermitian bond term ``(d^2, d^2)``; ``H = sum_i
            h2_{i,i+1}``.
        beta: inverse temperature (each METTS evolves ``beta/2``).
        n_samples: retained measurements (after ``warmup`` chain steps).
        max_bond: TEBD truncation bond.
        measure: ``measure(mps) -> value`` on each normalized METTS.
        n_steps: Trotter steps for ``beta/2`` (default ``max(20,
            ceil(20 * beta))``).
        bases: cycle of collapse bases, ``"z"``, ``"x"`` or a ``(d, d)``
            unitary.
        init: starting product configuration (default all-0).
        generator: ``torch.Generator`` on ``device`` driving every collapse
            (or the global one).
        device: where the chain runs (default ``cuda``).

    Returns ``np.ndarray`` of the ``n_samples`` measured values.
    """
    device = resolve_device(device)
    if n_steps is None:
        n_steps = max(20, int(np.ceil(20 * beta)))
    if init is None:
        vec = np.zeros(d)
        vec[0] = 1.0
        init = [vec] * n_sites
    cores = np.stack([np.asarray(v, float)[:, None, None] for v in init])
    one = torch.ones((1,), dtype=torch.float64, device=device)
    state = MPS(as_tensor(cores, device), one, one.clone())
    h2 = as_tensor(h2, device)

    out = []
    for step in range(warmup + n_samples):
        phi, _ = tebd_evolve(state, h2, beta / 2.0, n_steps, max_bond,
                             imaginary=True)
        if step >= warmup:
            out.append(measure(phi))
        b = bases[step % len(bases)]
        if isinstance(b, str):
            if b == "z":
                u = None
            elif b == "x":
                if d != 2:
                    raise ValueError('basis "x" needs d = 2')
                u = _HAD
            else:
                raise ValueError(f"unknown basis {b!r}")
        else:
            u = np.asarray(b)
        state = _collapse(phi, generator, u, d)
    return np.array(out)
