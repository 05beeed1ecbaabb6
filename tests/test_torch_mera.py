"""Ternary MERA of the PyTorch port against the JAX package, on the CPU.

Both packages optimize from the same start parameters (``init=``, built here
with numpy), and the optimized MERA is compared at 1e-10 through what it
computes, never tensor by tensor (each tensor is fixed only up to the gauge
of the layer below): the energy after the sweeps, the cold fixed-point
energy, one-site expectations, correlators and the scaling dimensions.  The
superoperator identities (``A(I) = 3 I``, the ascend/descend pairing and the
matrix form of the scale-invariant layer) are checked in the port alone.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import state_from_numpy, state_to_numpy

jm = import_module("contractn_tpu.models.mera")
tm = import_module("contractn_tpu_torch.models.mera")
ji = import_module("contractn_tpu.models.itebd")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
H2 = ji.tfim_h2()
CHI, SWEEPS = 3, 15


def _isometry(rng, out_dim, in_dim):
    q, _ = np.linalg.qr(rng.normal(size=(in_dim, out_dim)))
    return q.T


def start_params(chi, d=2, seed=0):
    """A MERA start as ``mera_ground_state`` draws one (identity
    disentanglers, random isometries), from a numpy generator."""
    rng = np.random.default_rng(seed)
    chi1 = min(d ** 3, chi)

    def eye4(m):
        return np.eye(m * m).reshape(m, m, m, m)

    return {"u": [eye4(d), eye4(chi1)],
            "w": [_isometry(rng, chi1, d ** 3).reshape(chi1, d, d, d),
                  _isometry(rng, chi, chi1 ** 3).reshape(chi, chi1, chi1, chi1)],
            "u_s": eye4(chi),
            "w_s": _isometry(rng, chi, chi ** 3).reshape(chi, chi, chi, chi)}


def _jax_params(p):
    return {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in p.items()}


@pytest.fixture(scope="module")
def ref():
    params, energy = jm.mera_ground_state(H2, CHI, sweeps=SWEEPS,
                                          init=_jax_params(start_params(CHI)))
    _, corr = jm.mera_correlator(params, SZ, kmax=4)
    return {"params": params, "energy": energy,
            "cold": jm.mera_energy(params, H2),
            "sx": jm.mera_site_expectation(params, SX),
            "corr": corr, "dims": jm.scaling_dimensions(params, n=4)}


def test_superoperator_identities():
    rng = np.random.default_rng(1)
    m, big = 3, 4
    w = torch.from_numpy(_isometry(rng, big, m ** 3).reshape(big, m, m, m))
    u = torch.from_numpy(_isometry(rng, m * m, m * m).reshape(m, m, m, m))
    eye = torch.eye(m * m, dtype=torch.float64).reshape(m, m, m, m)
    ai = tm._ascend(eye, u, w).reshape(big * big, big * big)
    assert (ai - 3 * torch.eye(big * big, dtype=torch.float64)).abs().max() < 1e-12
    h = rng.normal(size=(m * m, m * m))
    h = torch.from_numpy((h + h.T) / 2).reshape(m, m, m, m)
    r = rng.normal(size=(big * big, big * big))
    r = torch.from_numpy((r + r.T) / 2).reshape(big, big, big, big)
    lhs = tm._trace_pair(r, tm._ascend(h, u, w))
    assert abs(float(lhs - 3 * tm._trace_pair(tm._descend(r, u, w), h))) < 1e-12
    jmat = tm._ascend_matrix(u, w)
    np.testing.assert_allclose((jmat @ h.reshape(-1)).numpy(),
                               tm._ascend(h, u, w).reshape(-1).numpy(), atol=1e-13)
    np.testing.assert_allclose((r.reshape(-1) @ jmat).numpy() / 3,
                               tm._descend(r, u, w).reshape(-1).numpy(), atol=1e-13)
    # the JAX package's ascent on the same tensors
    want = jm._ascend(jnp.asarray(h.numpy()), jnp.asarray(u.numpy()), jnp.asarray(w.numpy()),
                      None)
    np.testing.assert_allclose(tm._ascend(h, u, w).numpy(), np.asarray(want), atol=1e-13)


def test_ground_state_matches_jax(ref):
    init = state_from_numpy(start_params(CHI), device=CPU)
    params, energy = tm.mera_ground_state(torch.from_numpy(H2), CHI, sweeps=SWEEPS,
                                          init=init)
    assert abs(energy - ref["energy"]) < TOL
    h2 = torch.from_numpy(H2)
    assert abs(tm.mera_energy(params, h2) - ref["cold"]) < TOL
    assert abs(tm.mera_site_expectation(params, SX) - ref["sx"]) < TOL
    dists, corr = tm.mera_correlator(params, SZ, kmax=4)
    np.testing.assert_array_equal(dists, [9, 27, 81])
    np.testing.assert_allclose(corr, ref["corr"], atol=TOL)
    np.testing.assert_allclose(tm.scaling_dimensions(params, n=4), ref["dims"], atol=1e-8)
    # the JAX package's params carried across measure the same
    moved = state_from_numpy(state_to_numpy(ref["params"]), device=CPU)
    assert abs(tm.mera_energy(moved, h2) - ref["cold"]) < TOL
    assert energy >= -4.0 / np.pi - 1e-9  # variational


def test_expand_mera_is_exact():
    """The JAX test's contract: the chi-ramp warm start is the same state
    (energies to the fixed point's 1e-8), with exact isometries."""
    h2 = torch.from_numpy(H2)
    params, _ = tm.mera_ground_state(h2, CHI, sweeps=5,
                                     init=state_from_numpy(start_params(CHI), device=CPU))
    big = tm.expand_mera(params, chi=4, generator=torch.Generator().manual_seed(3))
    assert abs(tm.mera_energy(big, h2, rho_iters=400)
               - tm.mera_energy(params, h2, rho_iters=400)) < 1e-8
    w = big["w_s"].reshape(4, -1)
    assert (w @ w.T - torch.eye(4, dtype=w.dtype)).abs().max() < 1e-12
    u = big["u_s"].reshape(16, 16)
    assert (u @ u.T - torch.eye(16, dtype=u.dtype)).abs().max() < 1e-12
    jbig = jm.expand_mera(_jax_params(state_to_numpy(params)), chi=4)
    assert abs(jm.mera_energy(jbig, H2, rho_iters=400)
               - tm.mera_energy(big, h2, rho_iters=400)) < 1e-8


def test_generator_start_and_validation():
    h2 = torch.from_numpy(H2)
    e1 = tm.mera_ground_state(h2, CHI, sweeps=2, generator=torch.Generator().manual_seed(5))[1]
    e2 = tm.mera_ground_state(h2, CHI, sweeps=2, generator=torch.Generator().manual_seed(5))[1]
    assert e1 == e2
    with pytest.raises(ValueError, match="expected 4"):
        tm.mera_ground_state(h2, 4, sweeps=1,
                             init=state_from_numpy(start_params(CHI), device=CPU))
