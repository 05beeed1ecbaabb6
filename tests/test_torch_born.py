"""Born machines and exact sampling in the PyTorch port against the JAX
package and dense enumeration, on the CPU.

``mps_log_prob``/``born_nll`` and ``fit_born_machine`` (full batch, torch
Adam against optax Adam) run on the same numpy-seeded float64 parameters in
both packages, to 1e-10.  The samplers' random streams differ between the
packages, so their samples are held through what does not depend on the
stream: each sample's reported ``log_prob`` against the JAX package's
``mps_log_prob`` of that sample (and against dense enumeration), and the
empirical distribution against the dense one (as ``tests/test_sampling.py``
holds the JAX sampler).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPS as JMPS
from contractn_tpu.models.born import born_nll as j_born_nll
from contractn_tpu.models.born import fit_born_machine as j_fit
from contractn_tpu.models.born import mps_log_prob as j_log_prob
from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import (
    MPS,
    born_machine,
    born_nll,
    fit_born_machine,
    mps_log_prob,
    right_canonicalize,
    sample,
    sample_canonical,
    sample_conditional,
)

torch.set_num_threads(1)

RTOL = 1e-10


def _born_arrays(n=6, bond=4, seed=0):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((n, 2, bond, bond)) / np.sqrt(2 * bond)
    return cores, np.abs(rng.standard_normal(bond)) + 0.1, np.abs(rng.standard_normal(bond)) + 0.1


def _configs(n):
    return np.array(np.meshgrid(*[[0, 1]] * n, indexing="ij")).reshape(n, -1).T


def _dense_probs(cores, left, right):
    amps = []
    for c in _configs(cores.shape[0]):
        v = left
        for i, x in enumerate(c):
            v = v @ cores[i, x]
        amps.append(v @ right)
    amps = np.abs(np.array(amps)) ** 2
    return amps / amps.sum()


def _index(samples):
    idx = np.zeros(samples.shape[0], np.int64)
    for site in range(samples.shape[1]):
        idx = idx * 2 + samples[:, site]
    return idx


def test_log_prob_matches_jax_and_dense_enumeration():
    arrays = _born_arrays()
    configs = _configs(6)
    mt = mps_from_numpy(*arrays, device="cpu")
    mj = JMPS(*(jnp.asarray(a) for a in arrays))
    lp = mps_log_prob(mt, configs)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_log_prob(mj, jnp.asarray(configs))),
                               rtol=RTOL)
    np.testing.assert_allclose(np.exp(lp.numpy()), _dense_probs(*arrays), rtol=RTOL, atol=1e-14)
    assert abs(float(torch.exp(lp).sum()) - 1.0) < 1e-12
    nll = born_nll(mt, configs[:7])
    np.testing.assert_allclose(float(nll), float(j_born_nll(mj, jnp.asarray(configs[:7]))),
                               rtol=RTOL)
    np.testing.assert_allclose(float(nll), -np.log(_dense_probs(*arrays)[:7]).mean(), rtol=RTOL)


def test_full_batch_fit_matches_optax_adam():
    arrays = _born_arrays(seed=1)
    data = np.random.default_rng(2).integers(0, 2, (40, 6))
    mj, lj = j_fit(JMPS(*(jnp.asarray(a) for a in arrays)), jnp.asarray(data), steps=5, lr=0.02)
    start = mps_from_numpy(*arrays, device="cpu")
    mt, lt = fit_born_machine(start, data, steps=5, lr=0.02)
    assert lt.shape == (5,) and not mt.cores.requires_grad
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL)
    for got, want in zip(mps_to_numpy(mt), (mj.cores, mj.left, mj.right)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(start.cores.numpy(), arrays[0])  # left as it was


def test_minibatch_fit_improves_nll_and_is_reproducible():
    arrays = _born_arrays(seed=3)
    data = np.zeros((256, 6), np.int64)
    data[128:] = 1  # GHZ-like: half all-zeros, half all-ones
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        runs.append(fit_born_machine(mps_from_numpy(*arrays, device="cpu"), data,
                                     steps=60, batch=32, lr=0.05, generator=gen))
    (m1, l1), (m2, l2) = runs
    assert torch.equal(l1, l2) and torch.equal(m1.cores, m2.cores)
    assert float(born_nll(m1, data)) < float(l1[0]) - 1.0


def test_born_machine_init():
    gen = torch.Generator().manual_seed(0)
    m = born_machine(5, 2, 3, generator=gen, device="cpu")
    assert m.cores.shape == (5, 2, 3, 3) and m.cores.dtype == torch.float64
    assert bool((m.left > 0).all() and (m.right > 0).all())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sampler_log_prob_matches_jax(dtype):
    rng = np.random.default_rng(4)
    cores, left, right = _born_arrays(seed=4)
    if dtype == np.complex128:
        cores = cores + 1j * rng.standard_normal(cores.shape) / 3
    mt = mps_from_numpy(cores, left, right, device="cpu")
    samples, logp = sample(mt, 64, generator=torch.Generator().manual_seed(5))
    assert samples.shape == (64, 6) and samples.dtype == torch.int64
    s = samples.numpy()
    np.testing.assert_allclose(logp.numpy(), np.log(_dense_probs(cores, left, right)[_index(s)]),
                               rtol=RTOL)
    if dtype == np.float64:  # the JAX package's mps_log_prob takes real cores
        mj = JMPS(*(jnp.asarray(a) for a in (cores, left, right)))
        np.testing.assert_allclose(logp.numpy(), np.asarray(j_log_prob(mj, jnp.asarray(s))),
                                   rtol=RTOL)
        np.testing.assert_allclose(logp.numpy(), mps_log_prob(mt, samples).numpy(), rtol=RTOL)


def test_sample_distribution_statistics():
    # empirical frequencies approach the dense distribution (5-sigma bins)
    arrays = _born_arrays(n=4, bond=2, seed=6)
    probs = _dense_probs(*arrays)
    n = 20000
    samples, _ = sample(mps_from_numpy(*arrays, device="cpu"), n,
                        generator=torch.Generator().manual_seed(7))
    freq = np.bincount(_index(samples.numpy()), minlength=16) / n
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) < 5 * sigma + 1e-3)


def test_sample_canonical_reuse():
    arrays = _born_arrays(n=5, bond=3, seed=8)
    mt = mps_from_numpy(*arrays, device="cpu")
    rc, log_norm = right_canonicalize(mt)
    s1, lp1 = sample_canonical(rc, 8, generator=torch.Generator().manual_seed(1))
    s2, lp2 = sample(mt, 8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(s1, s2) and torch.equal(lp1, lp2)
    assert bool(((s1 >= 0) & (s1 < 2)).all() and torch.isfinite(lp1).all())


def test_conditional_sampling_matches_dense():
    rng = np.random.default_rng(3)
    n = 6
    cores = rng.standard_normal((n, 2, 3, 3)) / np.sqrt(3)
    left, right = rng.standard_normal(3), rng.standard_normal(3)
    p = _dense_probs(cores, left, right)
    obs = np.array([-1, 1, -1, -1, 0, -1])
    samples, lp = sample_conditional(mps_from_numpy(cores, left, right, device="cpu"), 32, obs,
                                     generator=torch.Generator().manual_seed(2))
    s = samples.numpy()
    assert np.all(s[:, 1] == 1) and np.all(s[:, 4] == 0)
    bits = _configs(n)
    p_obs = p[(bits[:, 1] == 1) & (bits[:, 4] == 0)].sum()
    np.testing.assert_allclose(lp.numpy(), np.log(p[_index(s)]) - np.log(p_obs), rtol=RTOL)


def test_conditional_ghz_future_observation():
    # observing only the LAST site of a GHZ chain forces every earlier site
    n = 8
    cores = np.zeros((n, 2, 2, 2))
    for i in range(n):
        cores[i, 0, 0, 0] = 1.0
        cores[i, 1, 1, 1] = 1.0
    obs = -np.ones(n, np.int64)
    obs[-1] = 1
    s, lp = sample_conditional(MPS(torch.from_numpy(cores), torch.ones(2, dtype=torch.float64),
                                   torch.ones(2, dtype=torch.float64)),
                               12, obs, generator=torch.Generator().manual_seed(0))
    assert bool((s == 1).all()) and float(lp.abs().max()) < 1e-12
