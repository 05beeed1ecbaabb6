"""Lanczos and Arnoldi of the PyTorch port against the JAX package, on the CPU.

The same numpy-drawn operators and start vectors go through
``contractn_tpu.ops.krylov`` and ``contractn_tpu_torch.ops.krylov`` in float64
(complex128 where stated).  Krylov bases are gauge-free given the start
vector (Gram-Schmidt fixes them up to rounding), so tridiagonals, Hessenberg
matrices, Ritz values and ground vectors compare directly; tolerance 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.ops import krylov as jk
from contractn_tpu_torch.ops import krylov as tk

torch.set_num_threads(1)

TOL = 1e-10


def _hermitian(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    if complex_:
        h = h + 1j * rng.standard_normal((n, n))
    return (h + h.conj().T) / 2, rng.standard_normal(n) + (0j if complex_ else 0)


@pytest.mark.parametrize("complex_", [False, True])
def test_lanczos_basis_and_ground_match_jax(complex_):
    h, v0 = _hermitian(30, 1, complex_)
    iters = 12
    jb, ja, jbeta, jn = jk.lanczos_basis(lambda v: jnp.asarray(h) @ v,
                                         jnp.asarray(v0), iters)
    ht = torch.from_numpy(h)
    tb, ta, tbeta, tn = tk.lanczos_basis(lambda v: ht @ v, torch.from_numpy(v0),
                                         iters)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tbeta.numpy(), np.asarray(jbeta), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-9)
    assert abs(float(tn) - float(jn)) < TOL * float(jn)
    np.testing.assert_allclose(
        tk.masked_tridiagonal(ta, tbeta).numpy(),
        np.asarray(jk.masked_tridiagonal(ja, jbeta)), rtol=TOL, atol=TOL)

    ej, vj = jk.lanczos_ground(lambda v: jnp.asarray(h) @ v, jnp.asarray(v0), 30)
    et, vt = tk.lanczos_ground(lambda v: ht @ v, torch.from_numpy(v0), 30)
    assert abs(et - float(ej)) < TOL
    assert abs(et - np.linalg.eigvalsh(h)[0]) < 1e-9
    assert abs(abs(np.vdot(np.asarray(vj), vt.numpy())) - 1.0) < 1e-9


def test_lanczos_exhaustion_is_masked_like_jax():
    """A start vector in a 4-dim invariant subspace exhausts at step 4:
    later alphas carry the 1e30 marker, betas and basis rows are zero, and
    the ground value is the subspace's."""
    rng = np.random.default_rng(2)
    h = np.diag(np.arange(20.0))
    block = rng.standard_normal((4, 4))
    h[:4, :4] = (block + block.T) / 2
    v0 = np.zeros(20)
    v0[:4] = rng.standard_normal(4)
    _, ja, jbeta, _ = jk.lanczos_basis(lambda v: jnp.asarray(h) @ v,
                                       jnp.asarray(v0), 10)
    _, ta, tbeta, _ = tk.lanczos_basis(lambda v: torch.from_numpy(h) @ v,
                                       torch.from_numpy(v0), 10)
    np.testing.assert_array_equal(ta.numpy() >= 1e29, np.asarray(ja) >= 1e29)
    assert (ta.numpy()[5:] == 1e30).all()
    np.testing.assert_allclose(tbeta.numpy(), np.asarray(jbeta), atol=1e-9)
    et, _ = tk.lanczos_ground(lambda v: torch.from_numpy(h) @ v,
                              torch.from_numpy(v0), 10)
    assert abs(float(et) - np.linalg.eigvalsh(h[:4, :4])[0]) < 1e-10


def test_batched_lanczos_equals_members():
    """``batch_ndim=1``: each member of a batch gets the unbatched result."""
    hs, v0s = zip(*(_hermitian(16, s) for s in (3, 4, 5)))
    ht = torch.from_numpy(np.stack(hs))
    et, vt = tk.lanczos_ground(lambda v: torch.einsum("bij,bj->bi", ht, v),
                               torch.from_numpy(np.stack(v0s)), 16, batch_ndim=1)
    for k, (h, v0) in enumerate(zip(hs, v0s)):
        e1, v1 = tk.lanczos_ground(lambda v: torch.from_numpy(h) @ v,
                                   torch.from_numpy(v0), 16)
        assert abs(float(et[k]) - float(e1)) < TOL
        assert abs(abs(float(torch.dot(vt[k], v1))) - 1.0) < 1e-10


def test_projected_lanczos_matches_jax_and_stays_in_subspace():
    rng = np.random.default_rng(5)
    n, r = 60, 23
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    q, _ = np.linalg.qr(rng.standard_normal((n, r)))
    p = q @ q.T
    v0 = p @ rng.standard_normal(n)
    ej, _ = jk.lanczos_ground(lambda v: jnp.asarray(p) @ (jnp.asarray(h) @ v),
                              jnp.asarray(v0), 50,
                              project=lambda v: jnp.asarray(p) @ v)
    pt, hts = torch.from_numpy(p), torch.from_numpy(h)
    et, vt = tk.lanczos_ground(lambda v: pt @ (hts @ v), torch.from_numpy(v0), 50,
                               project=lambda v: pt @ v)
    want = np.linalg.eigvalsh(q.T @ h @ q)[0]
    assert abs(float(et) - float(ej)) < 1e-9
    assert abs(float(et) - want) < 1e-9
    assert np.linalg.norm(p @ vt.numpy() - vt.numpy()) < 1e-12


def test_arnoldi_basis_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((25, 25)) + 1j * rng.standard_normal((25, 25))
    v0 = rng.standard_normal(25) + 0j
    jb, jh, _ = jax.jit(lambda v: jk.arnoldi_basis(
        lambda x: jnp.asarray(a) @ x, v, 12))(jnp.asarray(v0))
    tb, th, _ = tk.arnoldi_basis(lambda x: torch.from_numpy(a) @ x,
                                 torch.from_numpy(v0), 12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-10)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-10)
    v = tb.numpy()
    np.testing.assert_allclose(v.conj() @ v.T, np.eye(13), atol=1e-12)
    np.testing.assert_allclose(a @ v[:12].T, v.T @ th.numpy(), atol=1e-12)


@pytest.mark.parametrize("case", ["full", "complex_pair", "breakdown"])
def test_arnoldi_eigs_match_jax(case):
    rng = np.random.default_rng(0)
    if case == "full":
        a, v0, iters, k = rng.standard_normal((40, 40)), rng.standard_normal(40), 40, 6
    elif case == "complex_pair":
        th = 0.7
        a = np.zeros((10, 10))
        a[:2, :2] = 1.5 * np.array([[np.cos(th), -np.sin(th)],
                                    [np.sin(th), np.cos(th)]])
        a[2:, 2:] = np.diag(np.linspace(0.1, 0.9, 8))
        v0, iters, k = np.ones(10), 10, 2
    else:
        a = np.zeros((30, 30))
        a[:3, :3] = [[2.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.5]]
        v0 = np.zeros(30)
        v0[:3] = 1.0
        iters, k = 20, 5
    jv, jlead = jk.arnoldi_eigs(lambda v: jnp.asarray(a) @ v, jnp.asarray(v0),
                                iters, k=k)
    tv, tlead = tk.arnoldi_eigs(lambda v: torch.from_numpy(a) @ v,
                                torch.from_numpy(v0), iters, k=k)
    np.testing.assert_allclose(tv, jv, atol=1e-10)
    resid = np.linalg.norm(a @ tlead - tv[0] * tlead)
    assert resid < 1e-9 * np.linalg.norm(tlead)
    assert abs(abs(np.vdot(jlead, tlead)) / (np.linalg.norm(jlead)
                                              * np.linalg.norm(tlead)) - 1) < 1e-9


def test_axis_name_raises_until_the_mesh_layer():
    # the mesh layer has landed: axis_name takes a process group, and over a
    # group of one rank the factorizations equal the unsharded ones (the
    # 2-rank parity is in tests/test_torch_parallel.py)
    import socket

    import torch.distributed as dist

    h, v0 = _hermitian(12, 3)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        a = torch.from_numpy(h)
        for fn in (tk.lanczos_basis, tk.arnoldi_basis):
            want = fn(lambda v: a @ v, torch.from_numpy(v0), 6)
            got = fn(lambda v: a @ v, torch.from_numpy(v0), 6, axis_name=group)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=1e-12)
        e, vec = tk.lanczos_ground(lambda v: a @ v, torch.from_numpy(v0), 8,
                                   axis_name=group)
        assert e == tk.lanczos_ground(lambda v: a @ v, torch.from_numpy(v0), 8)[0]
    finally:
        dist.destroy_process_group()
