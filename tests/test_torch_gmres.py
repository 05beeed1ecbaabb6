"""The port's GMRES against ``jax.scipy.sparse.linalg.gmres``, on the CPU.

Both solve the same systems (numpy-generated with a seed) with the
arguments the JAX package's infinite-chain environments pass (``tol``,
``atol=0``, ``maxiter=200``, ``solve_method="batched"``); the solutions
agree within the solve's tolerance times the system's condition number.
The batched form equals member-by-member solves.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import gmres as jax_gmres

from contractn_tpu_torch.ops.krylov import gmres

jv = import_module("contractn_tpu.models.vumps")
tv = import_module("contractn_tpu_torch.models.vumps")

torch.set_num_threads(1)

TOL = 1e-10


def _system(n, cplx, seed, shift=3.0):
    rng = np.random.default_rng(seed)
    a = shift * np.eye(n) + rng.normal(size=(n, n)) / np.sqrt(n)
    b = rng.normal(size=n)
    if cplx:
        a = a + 1j * rng.normal(size=(n, n)) / np.sqrt(n)
        b = b + 1j * rng.normal(size=n)
    return a, b


def _jax_solve(a, b, tol):
    x, _ = jax_gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=tol,
                     atol=0.0, maxiter=200, solve_method="batched")
    return np.asarray(x)


@pytest.mark.parametrize("n, cplx, shift", [
    (5, False, 3.0),    # restart clipped to the system size
    (40, False, 3.0),   # two restart cycles of 20
    (40, True, 3.0),
    (60, True, 1.2),    # harder: several cycles
])
def test_matches_jax_gmres(n, cplx, shift):
    a, b = _system(n, cplx, seed=n, shift=shift)
    want = _jax_solve(a, b, TOL)
    ta = torch.from_numpy(a)
    got, info = gmres(lambda v: ta @ v, torch.from_numpy(b), tol=TOL, atol=0.0,
                      maxiter=200)
    assert info == 0
    cond = np.linalg.cond(a)
    scale = np.linalg.norm(want)
    assert np.abs(got.numpy() - want).max() <= TOL * cond * scale
    assert np.linalg.norm(a @ got.numpy() - b) <= TOL * np.linalg.norm(b) * 1.0001


def test_breakdown_at_an_invariant_subspace_matches_jax():
    """A right-hand side inside a 3-dimensional invariant subspace: Arnoldi
    breaks down at step 3 and the identity-padded normal equations give
    the exact solution, as in jax."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    a = q @ np.diag([1.0, 2.0, 3.0] * 4) @ q.T
    b = q[:, :3] @ rng.normal(size=3)
    want = _jax_solve(a, b, 1e-12)
    ta = torch.from_numpy(a)
    got, _ = gmres(lambda v: ta @ v, torch.from_numpy(b), tol=1e-12, maxiter=200)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-13)
    np.testing.assert_allclose(a @ got.numpy(), b, atol=1e-12)


def test_maxiter_counts_restart_cycles_like_jax():
    a, b = _system(60, False, seed=7, shift=0.6)
    ta = torch.from_numpy(a)
    for maxiter in (1, 2):
        want, _ = jax_gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                            tol=1e-14, atol=0.0, restart=5, maxiter=maxiter,
                            solve_method="batched")
        got, _ = gmres(lambda v: ta @ v, torch.from_numpy(b), tol=1e-14,
                       restart=5, maxiter=maxiter)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_vumps_transfer_system_matches_jax():
    """The corner-channel system of the VUMPS environments (energy-
    subtracted geometric series of a left isometry's transfer map), through
    each package's own solver function on the same core."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(2, 6, 6))
    al, _, c = jv.mixed_gauge(jnp.asarray(a))
    al, c = np.array(al), np.array(c)
    rho = c @ c.conj().T
    rho = rho / np.trace(rho)
    b = rng.normal(size=(6, 6))
    want = np.asarray(jv._geometric_solve(jnp.asarray(al), jnp.asarray(b),
                                          jnp.asarray(rho), left=True, tol=TOL))
    got = tv._geometric_solve(torch.from_numpy(al), torch.from_numpy(b),
                              torch.from_numpy(rho), left=True, tol=TOL)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


def test_batched_equals_member_by_member():
    """Members converge after different numbers of cycles; each is frozen
    once converged, so the batch equals solving one member at a time."""
    a, _ = _system(30, True, seed=5, shift=1.5)
    rng = np.random.default_rng(6)
    bs = rng.normal(size=(5, 30)) + 1j * rng.normal(size=(5, 30))
    bs[1] *= 1e-3   # a different scale converges at a different cycle
    bs[3] = 0.0     # a zero right-hand side never iterates
    ta = torch.from_numpy(a)
    got, info = gmres(lambda v: v @ ta.T, torch.from_numpy(bs), tol=TOL,
                      maxiter=200, batch_ndim=1)
    assert info.tolist() == [0] * 5
    for i in range(5):
        one, _ = gmres(lambda v: ta @ v, torch.from_numpy(bs[i]), tol=TOL,
                       maxiter=200)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-14)
    assert not got[3].any()
