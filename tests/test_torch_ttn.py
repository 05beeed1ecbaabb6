"""Tree tensor networks (TTN and TTN-TDVP) of the PyTorch port against the
JAX package and dense oracles, on the CPU.

Both packages start from the same tree: the JAX package's draw carried
across with ``convert.state_from_numpy`` (the port's ``random_ttn`` is patched
to return it), and ``random_ttn`` itself is held to the JAX function on the
same numpy draws.  Block flows, overlaps and dense reconstructions compare
on random NON-isometric trees; the sweeps, the Adam descent and a TDVP step
compare through energies and dense state vectors (gauge invariants).
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import state_from_numpy, state_to_numpy

jt = import_module("contractn_tpu.models.ttn")
jd = import_module("contractn_tpu.models.ttn_tdvp")
tt = import_module("contractn_tpu_torch.models.ttn")
td = import_module("contractn_tpu_torch.models.ttn_tdvp")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
N, H = 8, 1.05
Z = np.diag([1.0, -1.0])
X = np.array([[0.0, 1.0], [1.0, 0.0]])


def _site_op(op, i, n):
    return np.kron(np.kron(np.eye(2 ** i), op), np.eye(2 ** (n - i - 1)))


def dense_tfim(n, h):
    hd = np.zeros((2 ** n, 2 ** n))
    for i in range(n - 1):
        hd -= _site_op(Z, i, n) @ _site_op(Z, i + 1, n)
    for i in range(n):
        hd -= h * _site_op(X, i, n)
    return hd


def _jax_tree(seed, chi, deform=0.0):
    """A JAX-drawn tree as host arrays, optionally deformed off isometry by
    numpy noise."""
    import jax

    tree = jax.tree_util.tree_map(np.asarray, jt.random_ttn(jax.random.PRNGKey(seed), N, 2,
                                                           chi))
    rng = np.random.default_rng(seed)
    return {"levels": [w + deform * rng.normal(size=w.shape) for w in tree["levels"]],
            "top": tree["top"] + deform * rng.normal(size=tree["top"].shape)}


@pytest.fixture(scope="module")
def mpos():
    from contractn_tpu.models import tfim_mpo as jtfim

    from contractn_tpu_torch.models import tfim_mpo

    return jtfim(N, h=H), tfim_mpo(N, h=H, device=CPU)


@pytest.fixture(scope="module")
def ref(mpos):
    jm, _ = mpos
    start = _jax_tree(0, 4)
    sweeps, energies = jt.ttn_dmrg(jm, 4, sweeps=1)
    _, adam = jt.ttn_ground_state(jm, 4, steps=20)
    tdvp = _jax_tree(3, 4)
    return {
        "start": start, "dmrg": (np.asarray(jt.ttn_to_dense(sweeps)), energies),
        "adam": np.asarray(adam), "tdvp": tdvp,
        "real": np.asarray(jt.ttn_to_dense(jd.ttn_tdvp_step(jm, tdvp, 0.05, iters=8))),
    }


def _on_cpu(tree):
    return state_from_numpy(tree, device=CPU)


def test_random_ttn_matches_jax_on_shared_draws(monkeypatch):
    """Both packages QR the same numpy normal draws into the same tree."""
    import jax

    draws = []

    def numpy_normal(shape):
        rng = np.random.default_rng(len(draws))
        draws.append(rng.normal(size=shape))
        return draws[-1]

    monkeypatch.setattr(jt.jax.random, "normal",
                        lambda key, shape, dtype: jax.numpy.asarray(numpy_normal(shape), dtype))
    want = jax.tree_util.tree_map(np.asarray, jt.random_ttn(jax.random.PRNGKey(0), N, 2, 4))
    draws.clear()
    monkeypatch.setattr(tt, "_normal", lambda shape, dtype, generator: torch.from_numpy(
        numpy_normal(shape)).to(dtype))
    got = state_to_numpy(tt.random_ttn(N, 2, 4, device=CPU))
    for g, w in zip(got["levels"] + [got["top"]], want["levels"] + [want["top"]]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-13)


def test_random_ttn_generator_and_shapes():
    a = tt.random_ttn(16, 2, 6, device=CPU)
    b = tt.random_ttn(16, 2, 6, device=CPU)  # no generator: seeded 0
    assert all(torch.equal(x, y) for x, y in zip(a["levels"], b["levels"]))
    assert [tuple(w.shape) for w in a["levels"]] == [(8, 2, 2, 4), (4, 4, 4, 6), (2, 6, 6, 6)]
    c = tt.random_ttn(16, 2, 6, generator=torch.Generator().manual_seed(1))
    assert c["top"].device == CPU and not torch.equal(a["top"], c["top"])
    q = a["levels"][1].reshape(4, 16, 6)
    torch.testing.assert_close(q.transpose(1, 2) @ q, torch.eye(6, dtype=q.dtype).expand(4, 6, 6))
    with pytest.raises(ValueError, match="power of two"):
        tt.random_ttn(12, 2, 4, device=CPU)


def test_block_flows_match_jax_and_dense(mpos):
    """Random non-isometric tree: the energy, one- and two-site observables,
    the overlap and the dense vector against the JAX package, and the energy
    against the dense Rayleigh quotient."""
    import jax

    jm, tm = mpos
    pa, pb = _jax_tree(1, 6, 0.3), _jax_tree(2, 6, 0.2)
    ta, tb = _on_cpu(pa), _on_cpu(pb)
    v = tt.ttn_to_dense(ta).numpy()
    np.testing.assert_allclose(v, np.asarray(jax.jit(jt.ttn_to_dense)(pa)), rtol=0, atol=1e-13)
    e = float(tt.ttn_energy(ta, tm))
    assert abs(e - float(jax.jit(jt.ttn_energy)(pa, jm))) < TOL
    assert abs(e - v @ dense_tfim(N, H) @ v / (v @ v)) < 1e-12
    expectation = jax.jit(jt.ttn_expectation)
    for ops in ([(3, Z)], [(1, Z), (6, X)]):
        got = complex(tt.ttn_expectation(ta, tt.product_mpo(N, ops, dtype=torch.float64,
                                                            device=CPU)))
        want = complex(expectation(pa, jt.product_mpo(N, ops, dtype=np.float64)))
        assert abs(got - want) < TOL
    assert abs(complex(tt.ttn_inner(ta, tb)) - complex(jax.jit(jt.ttn_inner)(pa, pb))) < 1e-11
    assert abs(complex(tt.ttn_inner(ta, tb)) - np.vdot(v, tt.ttn_to_dense(tb).numpy())) < 1e-11


def test_ttn_dmrg_matches_jax(ref, mpos, monkeypatch):
    _, tm = mpos
    monkeypatch.setattr(tt, "random_ttn", lambda *a, **k: _on_cpu(ref["start"]))
    params, energies = tt.ttn_dmrg(tm, 4, sweeps=1)
    want_v, want_e = ref["dmrg"]
    np.testing.assert_allclose(energies, want_e, rtol=0, atol=TOL)
    v = tt.ttn_to_dense(params).numpy()
    assert abs(abs(np.vdot(v, want_v)) - 1.0) < TOL
    e = float(tt.ttn_energy(params, tm))
    assert abs(e - v @ dense_tfim(N, H) @ v) < TOL and e <= energies[-1] + TOL


def test_adam_descent_matches_jax(ref, mpos, monkeypatch):
    """The first 20 steps of ``ttn_ground_state``: optax's Adam under the
    cosine schedule, step for step."""
    _, tm = mpos
    monkeypatch.setattr(tt, "random_ttn", lambda *a, **k: _on_cpu(ref["start"]))
    _, energies = tt.ttn_ground_state(tm, 4, steps=20)
    np.testing.assert_allclose(energies.numpy(), ref["adam"], rtol=0, atol=TOL)
    assert energies[-1] < energies[0]


def test_tdvp_step_matches_jax(ref, mpos):
    _, tm = mpos
    real = td.ttn_tdvp_step(tm, _on_cpu(ref["tdvp"]), 0.05, iters=8)
    assert real["top"].dtype == torch.complex128
    np.testing.assert_allclose(tt.ttn_to_dense(real).numpy(), ref["real"], rtol=0, atol=TOL)
    # imaginary time: the energy falls, the norm is restored
    imag = td.ttn_tdvp_step(tm, real, 0.1, imaginary=True, iters=8)
    assert float(tt.ttn_energy(imag, tm)) < float(tt.ttn_energy(real, tm))
    assert abs(float(torch.linalg.norm(tt.ttn_to_dense(imag))) - 1.0) < 1e-12


def test_tdvp_exact_on_the_saturated_manifold(mpos):
    """The JAX test's anchor, steps cut: at chi 16 the tree spans the whole
    space and TDVP is ``exp(-i dt H)`` to machine precision, phase included."""
    _, tm = mpos
    w, u = np.linalg.eigh(dense_tfim(N, H))
    params = tt.random_ttn(N, 2, 16, generator=torch.Generator().manual_seed(3))
    v0 = tt.ttn_to_dense(params).numpy()
    dt, steps = 0.05, 2
    params, values = td.ttn_tdvp_evolve(tm, params, dt, steps)
    v = tt.ttn_to_dense(params).numpy()
    vd = u @ (np.exp(-1j * w * dt * steps) * (u.conj().T @ v0))
    assert np.linalg.norm(v - vd) < TOL
    assert abs(values[-1] - float(np.real(vd.conj() @ dense_tfim(N, H) @ vd))) < TOL


def test_host_constructors_raise_without_gpu(monkeypatch):
    from contractn_tpu_torch.utils.errors import TNError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TNError, match="device='cpu'"):
        tt.random_ttn(8, 2, 4)
    with pytest.raises(TNError, match="device='cpu'"):
        tt.product_mpo(8, [(0, Z)])
