"""Quantics, TCI and circuit compilation of the PyTorch port against the JAX
package, on the CPU.

Quantics MPOs are built without decompositions and compare entry by entry;
states compare as dense sample vectors (the gauge-free form of a quantics
MPS) at 1e-10, integrals and the QFT against numpy closed forms.  TCI's
pivot search is host numpy in both packages, so pivots, ranks, evaluation
counts and the interpolant agree; circuit compilation compares the gates'
action (fidelities, dense states).  ``quantics_to_dense`` goes through
``MPS.evaluate``, the plain version of kernel #1 on the CPU.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy, mps_from_numpy, mps_to_numpy

jq = import_module("contractn_tpu.models.quantics")
tq = import_module("contractn_tpu_torch.models.quantics")
jt = import_module("contractn_tpu.models.tci")
tt = import_module("contractn_tpu_torch.models.tci")
jc = import_module("contractn_tpu.models.circuit_compile")
tc = import_module("contractn_tpu_torch.models.circuit_compile")
jmps = import_module("contractn_tpu.models.mps")
tdmrg = import_module("contractn_tpu_torch.models.dmrg")

torch.set_num_threads(1)

TOL = 1e-10
NB = 6


def _f(x):
    return np.exp(-x) * np.cos(2 * np.pi * 3 * x)


def _tdense(mps):
    return tq.quantics_to_dense(mps).numpy()


def _jmps(mps):
    return jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(mps)))


def _same(jmpo, tmpo):
    for a, b in zip((jmpo.cores, jmpo.left, jmpo.right), mpo_to_numpy(tmpo)):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("build, args", [
    ("adder_mpo", (NB, 3)), ("adder_mpo", (NB, -5, "open")),
    ("shift_mpo", (NB, 2, "open")), ("derivative_mpo", (NB,)),
    ("laplacian_mpo", (NB, (0.0, 2.0))), ("position_mpo", (NB, (-1.0, 1.0))),
])
def test_quantics_mpos_match_jax(build, args):
    _same(getattr(jq, build)(*args), getattr(tq, build)(*args, device="cpu"))


def test_function_mps_dense_and_integral():
    tm = tq.function_mps(_f, NB, device="cpu")
    jm = jq.function_mps(_f, NB)
    want = np.asarray(jq.quantics_to_dense(jm))
    np.testing.assert_allclose(_tdense(tm), want, atol=TOL)
    np.testing.assert_allclose(want, _f(tq.grid(NB)), atol=TOL)
    assert np.array_equal(tq.grid(NB, (0.5, 2.0)), jq.grid(NB, (0.5, 2.0)))
    assert abs(tq.quantics_integral(tm) - jq.quantics_integral(jm)) < TOL
    # an operator applied through the port's machinery acts on the samples
    from contractn_tpu_torch.models.boundary import apply_mpo_to_mps

    moved = apply_mpo_to_mps(tq.shift_mpo(NB, 1, device="cpu"), tm)
    np.testing.assert_allclose(_tdense(moved), np.roll(want, -1), atol=TOL)
    rev = tq.reverse_mps(tm)
    bits = (np.arange(2 ** NB)[:, None] >> np.arange(NB)[None, :]) & 1
    perm = bits @ (2 ** np.arange(NB - 1, -1, -1))
    np.testing.assert_allclose(_tdense(rev), want[perm], atol=TOL)


def test_register_and_2d():
    g = lambda x, y: np.sin(np.pi * x) * np.exp(-y)  # noqa: E731
    n = 3
    tm = tq.function_mps_2d(g, n, device="cpu")
    jm = jq.function_mps_2d(g, n)
    np.testing.assert_allclose(tq.quantics_to_dense_2d(tm).numpy(),
                               np.asarray(jq.quantics_to_dense_2d(jm)), atol=TOL)
    assert abs(tq.quantics_integral_2d(tm) - jq.quantics_integral_2d(jm)) < TOL
    lap = tq.laplacian_mpo(n, device="cpu")
    _same(jq.register_mpo(jq.laplacian_mpo(n), 2 * n, n),
          tq.register_mpo(lap, 2 * n, n))


def test_qft_matches_fft_and_jax():
    nb = 5
    x = np.random.default_rng(0).standard_normal(2 ** nb)
    tm = tq.function_mps(x, nb, device="cpu")
    got = _tdense(tq.qft_mps(tm))
    np.testing.assert_allclose(got, np.sqrt(2 ** nb) * np.fft.ifft(x), atol=TOL)
    inv = _tdense(tq.qft_mps(tm, inverse=True))
    np.testing.assert_allclose(inv, np.fft.fft(x) / np.sqrt(2 ** nb), atol=TOL)
    jgot = np.asarray(jq.quantics_to_dense(jq.qft_mps(jq.function_mps(x, nb))))
    np.testing.assert_allclose(got, jgot, atol=TOL)


def test_tci_matches_jax():
    tm, ti = tt.function_tci(_f, 12, max_bond=8, tol=1e-12, device="cpu")
    jm, ji = jt.function_tci(_f, 12, max_bond=8, tol=1e-12)
    assert (ti.n_evals, ti.ranks, ti.sweeps) == (ji.n_evals, ji.ranks, ji.sweeps)
    assert abs(ti.error - ji.error) < TOL and ti.error < 1e-9
    np.testing.assert_allclose(_tdense(tm), np.asarray(jq.quantics_to_dense(jm)),
                               atol=TOL)
    exact = (1 - np.exp(-1.0)) / (1 + (6 * np.pi) ** 2)  # int_0^1 e^-x cos(6 pi x)
    assert abs(tq.quantics_integral(tm).real - exact) < 1e-3  # Riemann sum, 4096 pts
    rank3 = np.random.default_rng(1).standard_normal((4, 3, 5))

    def f3(idx):  # a low-rank black box over (5, 5, 5)
        a = rank3[:, :, idx[:, 0]]
        return np.einsum("ikn,jkn->n", rank3[:, :, idx[:, 1]] * a,
                         rank3[:, :, idx[:, 2]])

    tm3, ti3 = tt.tci_cross(f3, (5, 5, 5), device="cpu")
    jm3, ji3 = jt.tci_cross(f3, (5, 5, 5))
    assert ti3.ranks == ji3.ranks
    full = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_allclose(
        tdmrg.MPS.evaluate(tm3, torch.nn.functional.one_hot(
            torch.from_numpy(full), 5).double(), split_format=False).numpy(),
        f3(full), atol=1e-8)
    t2, i2 = tt.function_tci_2d(lambda x, y: np.exp(-x - 2 * y), 3, device="cpu")
    j2, k2 = jt.function_tci_2d(lambda x, y: np.exp(-x - 2 * y), 3)
    assert i2.ranks == k2.ranks
    np.testing.assert_allclose(tq.quantics_to_dense_2d(t2).numpy(),
                               np.asarray(jq.quantics_to_dense_2d(j2)), atol=TOL)
    with pytest.raises(ValueError, match="zero"):
        tt.function_tci(lambda x: 0 * x, 4, device="cpu")


def _random_state(n, bond, seed, complex_=False):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((n, 2, bond, bond))
    if complex_:
        cores = cores + 1j * rng.standard_normal((n, 2, bond, bond))
    e0 = np.zeros(bond, cores.dtype)
    e0[0] = 1.0
    return cores, e0


@pytest.mark.parametrize("complex_", [False, True])
def test_staircase_compiles_chi2_exactly(complex_):
    cores, e0 = _random_state(6, 2, 3, complex_)
    tm = mps_from_numpy(cores, e0, e0, device="cpu")
    gates, last = tc.staircase_layer(tm)
    jgates, jlast = jc.staircase_layer(_jmps(tm))
    for g in gates + [last]:
        np.testing.assert_allclose(g.conj().T @ g, np.eye(g.shape[0]), atol=1e-12)
    out = tc.circuit_mps([(gates, last)], 6, device="cpu")
    assert abs(tc.mps_fidelity(out, tm) - 1.0) < TOL
    jout = jc.circuit_mps([(jgates, jlast)], 6)
    assert abs(jc.mps_fidelity(jout, _jmps(tm)) - 1.0) < TOL


def test_layers_match_jax_fidelity():
    cores, e0 = _random_state(6, 4, 5)
    tm = mps_from_numpy(cores, e0, e0, device="cpu")
    tl = tc.mps_to_circuit(tm, n_layers=2)
    jl = jc.mps_to_circuit(_jmps(tm), n_layers=2)
    tf = tc.mps_fidelity(tc.circuit_mps(tl, 6, device="cpu"), tm)
    jf = jc.mps_fidelity(jc.circuit_mps(jl, 6), _jmps(tm))
    assert abs(tf - jf) < 1e-9 and tf > 0.5
