"""METTS and quantum trajectories of the PyTorch port against the JAX
package, on the CPU.

The two packages draw from different random streams, so each path is held
on the same draws: METTS with both packages' collapse sampler patched to
one numpy sequence of outcomes (the measured values then agree at 1e-10),
trajectories through the explicit ``uniforms=`` seam (jump records and
measurements agree, the final states' |overlap| is 1).  One fixed-seed run
of each path's own draws is held statistically: METTS against the exact
thermal averages, the MCWF ensemble against dense Lindblad evolution.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models.mps import MPS

jm = import_module("contractn_tpu.models.metts")
tm = import_module("contractn_tpu_torch.models.metts")
jt = import_module("contractn_tpu.models.trajectories")
tt = import_module("contractn_tpu_torch.models.trajectories")
jmps = import_module("contractn_tpu.models.mps")
titebd = import_module("contractn_tpu_torch.models.itebd")
tcirc = import_module("contractn_tpu_torch.models.circuits")
tmpo = import_module("contractn_tpu_torch.models.mpo")

torch.set_num_threads(1)

TOL = 1e-10
N = 3
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])
SM = np.array([[0.0, 1.0], [0.0, 0.0]])  # lowering: index 1 -> 0
H2 = np.asarray(titebd.tfim_h2(1.0, 1.2))


def _initial():
    psi = np.zeros(2 ** N)
    psi[-1] = 1.0
    u1 = np.cos(0.2) * np.eye(2) - 1j * np.sin(0.2) * X
    full = np.eye(1)
    for _ in range(N):
        full = np.kron(full, u1)
    psi = full @ psi.astype(complex)
    return psi, MPS.from_dense(psi, 2, device="cpu")


def _dense(mps):
    cores, left, right = mps_to_numpy(mps)
    v = np.einsum("i,dij->dj", left, cores[0])
    for a in cores[1:]:
        v = np.einsum("xj,djk->xdk", v, a).reshape(-1, a.shape[-1])
    return v @ right


def _overlap(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_metts_matches_jax_on_shared_outcomes(monkeypatch):
    rng = np.random.default_rng(5)
    outcomes = [rng.integers(0, 2, size=N) for _ in range(8)]

    def replay(module, as_config):
        it = iter(outcomes)

        def fake(rc, *args):
            return as_config(next(it)), None

        monkeypatch.setattr(module, "sample_canonical", fake)

    replay(jm, lambda c: jnp.asarray(c)[None])
    replay(tm, lambda c: torch.from_numpy(c)[None])

    def measure(phi):
        xs = phi.site_expectations(np.asarray(X))
        return [float(np.real(np.asarray(xs))[i]) for i in range(N)]

    got = tm.metts(H2, N, 0.8, 5, 8, measure, n_steps=8, warmup=3, device="cpu")
    want = jm.metts(H2, N, 0.8, 5, 8, jax.random.PRNGKey(0), measure, n_steps=8,
                    warmup=3)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_metts_fixed_seed_matches_thermal_average():
    beta = 1.0
    hd = sum(np.kron(np.kron(np.eye(2 ** i), H2), np.eye(2 ** (N - i - 2)))
             for i in range(N - 1))
    w, v = np.linalg.eigh(hd)
    boltz = np.exp(-beta * (w - w[0]))
    e_exact = float((w * boltz).sum() / boltz.sum())
    hmpo = tmpo.mpo_from_bond_term(H2, N, device="cpu")
    vals = tm.metts(H2, N, beta, 32, 8, lambda phi: tmpo.rayleigh(hmpo, phi),
                    n_steps=20, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    sem = vals.std(ddof=1) / np.sqrt(len(vals))
    assert abs(vals.mean() - e_exact) < 4.0 * sem + 0.02
    assert vals.std(ddof=1) > 1e-3  # the chain moves


def test_trajectory_matches_jax_on_shared_uniforms():
    psi, mps0 = _initial()
    jumps = [(np.sqrt(0.6) * SM, j) for j in range(N)]
    uniforms = np.random.default_rng(0).uniform(size=(12, 2))
    uniforms[::3, 0] = 0.999  # force some jumps
    out, rec, log = tt.mcwf_trajectory(mps0, H2, jumps, 1.2, 12, max_bond=8,
                                       uniforms=uniforms, op=Z)
    jstart = jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(mps0)))
    jout, jrec, jlog = jt.mcwf_trajectory(jstart, H2, jumps, 1.2, 12, max_bond=8,
                                          uniforms=uniforms, op=Z)
    assert log == jlog and len(log) >= 2
    np.testing.assert_allclose(rec, np.real(jrec), atol=TOL)
    jd = mps_from_numpy(*(np.asarray(a) for a in (jout.cores, jout.left, jout.right)),
                        device="cpu")
    assert abs(_overlap(_dense(out), _dense(jd)) - 1.0) < TOL
    # no channels: the trajectory is deterministic TEBD
    out, _, log = tt.mcwf_trajectory(mps0, H2, [], 1.0, 10, max_bond=8)
    ref, _ = tcirc.tebd_evolve(mps0, H2, 1.0, 10, 8)
    assert log == [] and abs(_overlap(_dense(out), _dense(ref)) - 1.0) < TOL


def test_ensemble_draws_on_the_host_and_approaches_lindblad():
    psi, mps0 = _initial()
    gamma, t, steps, n_traj = 0.8, 1.0, 10, 24
    jumps = [(np.sqrt(gamma) * SM, j) for j in range(N)]
    mean, n_jumps = tt.mcwf_ensemble(mps0, H2, jumps, t, steps, Z, n_traj,
                                     max_bond=8,
                                     generator=torch.Generator().manual_seed(1))
    assert mean.shape == (steps + 1, N) and n_jumps > 0
    # the ensemble consumes consecutive host blocks of one CPU generator
    few, _ = tt.mcwf_ensemble(mps0, H2, jumps, t, steps, Z, 3, max_bond=8,
                              generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(2)
    replayed = sum(tt.mcwf_trajectory(
        mps0, H2, jumps, t, steps, max_bond=8, op=Z,
        uniforms=torch.rand((steps, 2), dtype=torch.float64, generator=gen).numpy()
    )[1] for _ in range(3)) / 3
    np.testing.assert_allclose(few, replayed, atol=1e-12)
    # dense Lindblad (RK4 on the full density matrix) for the same channels
    hd = sum(np.kron(np.kron(np.eye(2 ** i), H2), np.eye(2 ** (N - i - 2)))
             for i in range(N - 1)).astype(complex)
    ls = [np.kron(np.kron(np.eye(2 ** j), op), np.eye(2 ** (N - j - 1)))
          for op, j in jumps]

    def lind(r):
        out = -1j * (hd @ r - r @ hd)
        for lk in ls:
            out += lk @ r @ lk.conj().T - 0.5 * (lk.conj().T @ lk @ r
                                                 + r @ lk.conj().T @ lk)
        return out

    rho = np.outer(psi, psi.conj())
    zs = [np.kron(np.kron(np.eye(2 ** j), Z), np.eye(2 ** (N - j - 1)))
          for j in range(N)]
    dt = t / steps
    exact = [[np.trace(z @ rho).real for z in zs]]
    for _ in range(steps):
        for _ in range(10):
            h = dt / 10
            k1 = lind(rho)
            k2 = lind(rho + 0.5 * h * k1)
            k3 = lind(rho + 0.5 * h * k2)
            k4 = lind(rho + h * k3)
            rho = rho + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        exact.append([np.trace(z @ rho).real for z in zs])
    assert np.max(np.abs(mean - np.asarray(exact))) < 0.35  # shot noise, 24 runs


@pytest.mark.parametrize("bad", ["y"])
def test_metts_rejects_unknown_basis(bad):
    with pytest.raises(ValueError, match="basis"):
        tm.metts(H2, N, 0.5, 1, 4, lambda p: 0.0, n_steps=2, warmup=0,
                 bases=(bad,), device="cpu")
