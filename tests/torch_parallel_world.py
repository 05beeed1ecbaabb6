"""What the parallel-layer test files share: one world of CPU ranks a module.

Each ``tests/test_torch_parallel*.py`` runs every scenario in ONE spawned
world of 8 gloo ranks (``run``), each rank saving its outputs with ``save``,
while the JAX package's references are computed in the pytest process; the
tests then compare, one test a scenario.  The ranks import the test module
and this one under the ``spawn`` start method, so both import torch, numpy and
the port only at their top level.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from contractn_tpu_torch.parallel.dryrun import run_cpu_world

WORLD = 8


def run(rank_fn, tmp, references, timeout=300):
    """Run ``rank_fn(rank, world, str(tmp))`` on ``WORLD`` ranks and
    ``references()`` here meanwhile; returns ``(references' value, [each
    rank's saved outputs])``."""
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_cpu_world, rank_fn, WORLD, (str(tmp),), timeout)
        ref = references()
        job.result()
    return ref, [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(WORLD)]


def save(tmp, rank, out):
    """One rank's outputs (tensors, numbers, strings) as ``tmp/rank{rank}.npz``."""
    np.savez(f"{tmp}/rank{rank}.npz",
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()})


def replicated(ranks, key, members=range(WORLD)):
    """An output that every rank in ``members`` computed: the same on each."""
    vals = [ranks[r][key] for r in members]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def message(fn):
    """The text of the ``ValueError`` that ``fn()`` raises ("" if none)."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def mps_arrays(rng, n, d, bond):
    """Random ``(cores, left, right)`` scaled as ``MPS.random`` scales them."""
    cores = rng.standard_normal((n, d, bond, bond)) / np.sqrt(bond * d)
    return cores, rng.standard_normal(bond), rng.standard_normal(bond)
