"""CP-ALS and Tucker HOSVD/HOOI of the PyTorch port against the JAX package,
on the CPU.

CP-ALS starts from a random draw: both packages get the same numpy draws
(``jax.random.normal`` patched on the JAX side, ``torch.randn`` on the
port's) and are compared at 1e-10 through the per-sweep relative errors and
the reconstructions.  Tucker factors are gauge-dependent (signs, rotations
inside degenerate singular subspaces), so Tucker fits are compared through
the reconstruction, the discarded mass and the error trace.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jf = import_module("contractn_tpu.models.factorize")
tf = import_module("contractn_tpu_torch.models.factorize")
tdec = import_module("contractn_tpu_torch.models.decompositions")

torch.set_num_threads(1)

TOL = 1e-10
RNG = np.random.default_rng(0)
X_REAL = RNG.normal(size=(6, 5, 7, 4))
X_CPLX = RNG.normal(size=(6, 6, 5)) + 1j * RNG.normal(size=(6, 6, 5))


def _draws(x, rank, seed):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(rank, d)) for d in x.shape]
    if np.iscomplexobj(x):
        out = [a + 1j * rng.normal(size=a.shape) for a in out]
    return out


def _jax_cp(x, rank, steps, draws, monkeypatch):
    it = iter(draws)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(next(it), dtype))
    factors, errs = jf.cp_als(x, rank, steps=steps)
    monkeypatch.undo()
    return [np.asarray(f) for f in factors], np.asarray(errs)


def _port_cp(x, rank, steps, draws, monkeypatch):
    it = iter(draws)
    monkeypatch.setattr(torch, "randn", lambda shape, dtype=None, device=None,
                        generator=None: torch.from_numpy(next(it)).to(device, dtype))
    factors, errs = tf.cp_als(torch.from_numpy(x), rank, steps=steps)
    monkeypatch.undo()
    return factors, errs


@pytest.mark.parametrize("x,rank", [(X_REAL, 10), (X_CPLX, 3)], ids=["real", "complex"])
def test_cp_als_matches_jax(x, rank, monkeypatch):
    draws = _draws(x, rank, seed=1)
    want_f, want_e = _jax_cp(x, rank, 40, draws, monkeypatch)
    got_f, got_e = _port_cp(x, rank, 40, draws, monkeypatch)
    np.testing.assert_allclose(got_e.numpy(), want_e, atol=TOL)
    assert np.all(np.diff(got_e.numpy()) < 1e-10)
    np.testing.assert_allclose(tf.cp_reconstruct(got_f).numpy(),
                               np.asarray(jf.cp_reconstruct(want_f)), atol=TOL)


def test_cp_graph_and_generator(monkeypatch):
    """The factors dropped into ``cp_tn`` reproduce the algorithm's
    reconstruction; the port's own start is reproducible from a seeded
    generator."""
    factors, _ = _port_cp(X_REAL, 5, 10, _draws(X_REAL, 5, seed=11), monkeypatch)
    got = tdec.cp_tn(factors).contract()
    np.testing.assert_allclose(got.numpy(), tf.cp_reconstruct(factors).numpy(), atol=1e-12)
    x = torch.from_numpy(X_REAL)
    f1, _ = tf.cp_als(x, 4, steps=2, generator=torch.Generator().manual_seed(0))
    f2, _ = tf.cp_als(x, 4, steps=2, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    with pytest.raises(ValueError, match="orders 2..16"):
        tf.cp_als(torch.zeros(3), 2)


@pytest.mark.parametrize("x,ranks", [(X_REAL, (3, 3, 4, 2)), (X_CPLX, (3, 3, 3))],
                         ids=["real", "complex"])
def test_tucker_matches_jax(x, ranks):
    core, facs, disc = tf.tucker_hosvd(torch.from_numpy(x), ranks)
    jcore, jfacs, jdisc = jf.tucker_hosvd(x, ranks)
    assert abs(disc - jdisc) < TOL
    rec = tf.tucker_reconstruct(core, facs).numpy()
    np.testing.assert_allclose(rec, np.asarray(jf.tucker_reconstruct(jcore, jfacs)),
                               atol=TOL)
    assert np.sum(np.abs(rec - x) ** 2) <= disc * (1.0 + 1e-10)
    for f in facs:
        g = (f @ f.conj().T).numpy()
        assert np.abs(g - np.eye(g.shape[0])).max() < 1e-12
    core, facs, errs = tf.tucker_hooi(torch.from_numpy(x), ranks, steps=6)
    jcore, jfacs, jerrs = jf.tucker_hooi(x, ranks, steps=6)
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), atol=TOL)
    rec = tf.tucker_reconstruct(core, facs).numpy()
    np.testing.assert_allclose(rec, np.asarray(jf.tucker_reconstruct(jcore, jfacs)),
                               atol=TOL)
    assert abs(errs[-1].item() - np.linalg.norm(rec - x) / np.linalg.norm(x)) < 1e-10
    got = tdec.tucker_tn(core, facs).contract()
    np.testing.assert_allclose(got.numpy(), rec, atol=1e-12)
    with pytest.raises(ValueError, match="one rank per mode"):
        tf.tucker_hosvd(torch.from_numpy(x), ranks[:-1])
