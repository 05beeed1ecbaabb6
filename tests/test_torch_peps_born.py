"""PEPS sampling, Born machines and VMC in the PyTorch port against the JAX
package and dense enumeration, on the CPU.

Log-probabilities, the exact NLL and its gradient, one Adam step and the VMC
estimators (all configurations with their Born weights, where they are the
exact Rayleigh quotient and its gradient) are held to the JAX package at
1e-10.  The sampler draws from a ``torch.Generator`` (the JAX package from a
key), so its samples differ; what it returns is held to the dense
distribution instead: each sample's log-probability exactly, the
observations honored, conditional log-probabilities exactly, and the
empirical frequencies within their statistical spread.
"""

import itertools
from importlib import import_module

import numpy as np
import pytest
import torch

jb = import_module("contractn_tpu.models.peps_born")
jvm = import_module("contractn_tpu.models.peps_vmc")
tb = import_module("contractn_tpu_torch.models.peps_born")
ts = import_module("contractn_tpu_torch.models.peps_sample")
tv = import_module("contractn_tpu_torch.models.peps_vmc")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
CHI = 4
LR = 0.02
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])
H2 = -np.kron(Z, Z) - 0.75 * (np.kron(X, np.eye(2)) + np.kron(np.eye(2), X))


def grid_np(rows, cols, bond=2, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(2, bond if r > 0 else 1, bond if c > 0 else 1,
                              bond if r < rows - 1 else 1, bond if c < cols - 1 else 1))
             for c in range(cols)] for r in range(rows)]


def grid_t(g):
    return [[torch.from_numpy(t) for t in row] for row in g]


def configs(rows, cols):
    return np.array(list(itertools.product([0, 1], repeat=rows * cols))).reshape(-1, rows, cols)


def _amplitude(g, s):
    """<s|P> by a direct einsum over every bond (numpy)."""
    rows, cols = len(g), len(g[0])
    letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    h = {(r, c): next(letters) for r in range(rows) for c in range(cols + 1)}
    v = {(r, c): next(letters) for r in range(rows + 1) for c in range(cols)}
    subs, ops = [], []
    for r in range(rows):
        for c in range(cols):
            subs.append(v[(r, c)] + h[(r, c)] + v[(r + 1, c)] + h[(r, c + 1)])
            ops.append(g[r][c][s[r, c]])
    return np.einsum(",".join(subs) + "->", *ops)


def probs(g):
    amps = np.array([_amplitude(g, s) for s in configs(len(g), len(g[0]))])
    return amps ** 2 / np.sum(amps ** 2)


@pytest.fixture(scope="module")
def ref():
    import jax
    import optax

    g = grid_np(2, 3)
    allc = configs(2, 3)
    lp = jax.jit(lambda g, s: jb.peps_log_prob(g, s, CHI))(g, allc)
    g = grid_np(2, 2)
    data = configs(2, 2)[[0, 5, 5, 7, 9, 15]]
    nll, grads = jax.jit(jax.value_and_grad(lambda g, s: jb.peps_born_nll(g, s, CHI)))(g, data)

    def step(params, grads):
        opt = optax.adam(LR)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    stepped = jax.jit(step)(g, grads)
    g2 = grid_np(2, 2, seed=1)
    w = probs(g2)
    e, vg, var = jvm.vmc_energy_and_grad(g2, configs(2, 2), H2, H2, weights=w)
    flat = lambda tree: [np.asarray(x) for row in tree for x in row]  # noqa: E731
    return {"lp": np.asarray(lp), "data": data, "nll": float(nll), "grads": flat(grads),
            "stepped": flat(stepped), "e": float(e), "vg": flat(vg), "var": float(var),
            "w": w}


def test_log_probs_match_jax_and_dense(ref):
    g = grid_np(2, 3)
    lp = tb.peps_log_prob(grid_t(g), torch.from_numpy(configs(2, 3)), CHI)
    np.testing.assert_allclose(lp.numpy(), ref["lp"], rtol=0, atol=TOL)
    np.testing.assert_allclose(np.exp(lp.numpy()), probs(g), rtol=0, atol=1e-12)


def test_nll_gradient_and_one_fit_step_match_jax(ref):
    g = grid_t(grid_np(2, 2))
    leaves = [t.clone().requires_grad_(True) for row in g for t in row]
    nll = tb.peps_born_nll([leaves[:2], leaves[2:]], ref["data"], CHI)
    grads = torch.autograd.grad(nll, leaves)
    assert abs(float(nll) - ref["nll"]) < TOL
    for got, want in zip(grads, ref["grads"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    fitted, losses = tb.fit_peps_born(g, ref["data"], steps=1, chi=CHI, lr=LR)
    assert abs(float(losses[0]) - ref["nll"]) < TOL
    for got, want in zip([t for row in fitted for t in row], ref["stepped"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_samples_carry_their_exact_log_probs():
    g = grid_np(2, 3)
    p = probs(g)
    gen = torch.Generator().manual_seed(0)
    n = 3000
    samples, log_p = ts.sample_peps(grid_t(g), n, CHI, generator=gen)
    assert samples.shape == (n, 2, 3) and samples.dtype == torch.int32
    index = (samples.reshape(n, -1).long() * (2 ** torch.arange(5, -1, -1))).sum(1).numpy()
    np.testing.assert_allclose(log_p.numpy(), np.log(p[index]), rtol=0, atol=1e-10)
    freq = np.bincount(index, minlength=64) / n
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / n) + 1e-3)


def test_conditional_sampling_matches_dense():
    g = grid_np(2, 3, seed=2)
    p = probs(g).reshape((2,) * 6)
    observed = -np.ones((2, 3), np.int64)
    observed[0, 1], observed[1, 2] = 1, 0
    gen = torch.Generator().manual_seed(1)
    samples, log_p = ts.sample_peps(grid_t(g), 200, CHI, observed=observed, generator=gen)
    assert bool((samples[:, 0, 1] == 1).all()) and bool((samples[:, 1, 2] == 0).all())
    cond = p[:, 1, :, :, :, 0]
    cond = cond / cond.sum()
    flat = samples.reshape(200, -1).long().numpy()
    want = np.log(cond[flat[:, 0], flat[:, 2], flat[:, 3], flat[:, 4]])
    np.testing.assert_allclose(log_p.numpy(), want, rtol=0, atol=1e-10)


def test_vmc_estimators_by_enumeration_match_jax(ref):
    g = grid_np(2, 2, seed=1)
    e, grads, var = tv.vmc_energy_and_grad(grid_t(g), configs(2, 2), H2, H2,
                                           weights=ref["w"])
    assert abs(float(e) - ref["e"]) < TOL and abs(float(var) - ref["var"]) < TOL
    for got, want in zip([t for row in grads for t in row], ref["vg"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the exact identity: the Rayleigh quotient of the dense state
    amps = np.array([_amplitude(g, s) for s in configs(2, 2)])
    h = np.zeros((16, 16))
    for (i1, i2) in [(0, 1), (2, 3), (0, 2), (1, 3)]:
        for s in range(16):
            bits = [(s >> (3 - k)) & 1 for k in range(4)]
            for a in range(2):
                for b in range(2):
                    t = list(bits)
                    t[i1], t[i2] = a, b
                    h[s, sum(x << (3 - k) for k, x in enumerate(t))] += H2[
                        bits[i1] * 2 + bits[i2], a * 2 + b]
    assert abs(float(e) - amps @ h @ amps / (amps @ amps)) < 1e-10
    le = tv.local_energy(grid_t(g), configs(2, 2)[5], H2, H2)
    assert abs(float(le) - (h[5] @ amps) / amps[5]) < 1e-10


def test_born_machine_draw_and_vmc_fit_run():
    gen = torch.Generator().manual_seed(3)
    grid = tb.peps_born_machine(2, 2, bond_dim=2, generator=gen, device=CPU)
    assert [tuple(t.shape) for t in grid[0]] == [(2, 1, 1, 2, 2), (2, 1, 2, 2, 1)]
    assert all(bool((t > 0).all()) for row in grid for t in row)
    fitted, es = tv.fit_peps_vmc(grid, H2, H2, steps=2, num_samples=16, chi=CHI,
                                 generator=torch.Generator().manual_seed(4))
    assert len(es) == 2 and all(np.isfinite(es))
    with pytest.raises(ValueError, match="real-only"):
        tv.vmc_energy_and_grad([[t.to(torch.complex128) for t in row] for row in grid],
                               configs(2, 2), H2, H2)
