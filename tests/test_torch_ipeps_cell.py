"""The checkerboard iPEPS layer of the PyTorch port (simple update, cell
energies, the batched scan, the full update, 2D thermal states) against the
JAX package and closed forms, on the CPU.

The simple update starts from the seed both packages draw from
``numpy.random.default_rng(0)``; its state is compared through its bond
weights (singular values) and measured energies, never tensor by tensor
(singular-vector signs are a gauge).  The cell energy is held to the JAX
package's measurement in one shared environment; one full-update stage from
one state and environment (its four bond updates and frame rotations; the
in-stage CTMRG refresh is the cell CTMRG's iteration, held in
``test_torch_ctmrg_cell.py``) is held to the JAX package's through the
energy of its result.  The scan's members equal the unbatched pipeline, the commuting
Ising purification reproduces Onsager, and random singular-vector signs (as
cuSOLVER's differ from LAPACK's) change no measured energy.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import chip_smoke

jic = import_module("contractn_tpu.models.ipeps_cell")
jfu = import_module("contractn_tpu.models.full_update")
jip = import_module("contractn_tpu.models.ipeps")
tic = import_module("contractn_tpu_torch.models.ipeps_cell")
tfu = import_module("contractn_tpu_torch.models.full_update")
tip = import_module("contractn_tpu_torch.models.ipeps")
tcc = import_module("contractn_tpu_torch.models.ctmrg_cell")
tth = import_module("contractn_tpu_torch.models.thermal2d")
tit = import_module("contractn_tpu_torch.models.itebd")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SCHEDULE = ((0.1, 30),)
CHI, ITERS = 4, 12
Z = np.diag([1.0, -1.0])
X = np.array([[0.0, 1.0], [1.0, 0.0]])


def _np(t):
    return np.array(t)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's simple update, its measurement in the port's
    environment of the JAX state, and one full-update stage from there."""
    import jax

    h2 = jip.heisenberg_bond_term_2d()
    ga, gb, lams = jic.simple_update_cell(h2, 2, schedule=SCHEDULE)
    a, b = (_np(x) for x in jic.su_cell_absorb(ga, gb, lams))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    env = tcc.ctmrg_cell(tic.checkerboard_cell(ta, tb), CHI, iters=ITERS)
    env_np = jax.tree_util.tree_map(lambda t: t.numpy(), env)
    energy = jax.jit(lambda a, b, e: jic.cell_energy_from_env(
        a, b, h2, jic.checkerboard_cell(a, b), e))(a, b, env_np)
    gate4 = np.asarray(tit.two_site_gate(torch.from_numpy(np.asarray(h2)), 0.05)).reshape(
        2, 2, 2, 2)
    fa, fb, _ = jfu._fu_stage(a, b, env_np, gate4, 1, CHI, 2, 2, 0)
    return {"lams": [_np(x) for x in lams], "a": a, "b": b, "env": env,
            "energy": float(energy), "gate4": gate4, "fu": (_np(fa), _np(fb))}


def test_simple_update_matches_jax(ref):
    h2 = tip.heisenberg_bond_term_2d(device=CPU)
    ga, gb, lams = tic.simple_update_cell(h2, 2, schedule=SCHEDULE)
    for got, want in zip(lams, ref["lams"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    a, b = tic.su_cell_absorb(ga, gb, lams)
    e_port = float(tic.cell_energy(a, b, h2, CHI, iters=ITERS))
    # the JAX state in the port's environment, measured by both packages
    a, b = torch.from_numpy(ref["a"]), torch.from_numpy(ref["b"])
    e_moved = float(tic.cell_energy_from_env(a, b, h2, tic.checkerboard_cell(a, b),
                                             ref["env"]))
    assert abs(e_moved - ref["energy"]) < TOL
    assert abs(e_port - ref["energy"]) < TOL


def test_full_update_stage_matches_jax(ref):
    h2 = tip.heisenberg_bond_term_2d(device=CPU)
    a, b = torch.from_numpy(ref["a"]), torch.from_numpy(ref["b"])
    fa, fb, _ = tfu._fu_stage(a, b, ref["env"], torch.from_numpy(ref["gate4"]), 1, CHI, 2,
                              2, 0)
    e_port = float(tic.cell_energy(fa, fb, h2, CHI, iters=ITERS))
    e_jax = float(tic.cell_energy(*(torch.from_numpy(t) for t in ref["fu"]), h2, CHI,
                                  iters=ITERS))
    assert abs(e_port - e_jax) < TOL


def test_scan_equals_unbatched_and_sees_the_transition():
    """One vmapped program over the family: each member equals the unbatched
    pipeline; the order parameter tells the phases apart across h_c ~ 3.04."""
    import warnings

    hs = [2.0, 3.5]
    sched = ((0.1, 60), (0.02, 30))
    h2s = torch.stack([tip.tfim_bond_term_2d(1.0, h, device=CPU) for h in hs])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a vmap fallback to a per-member loop warns
        out = tic.ipeps_cell_scan(h2s, 2, CHI, schedule=sched, iters=ITERS, ops=(Z,))
    for i, h in enumerate(hs):
        a, b, e = tic.ipeps_cell_ground_state(tip.tfim_bond_term_2d(1.0, h, device=CPU), 2,
                                              CHI, schedule=sched, iters=ITERS)
        assert abs(float(out["energy"][i]) - float(e)) < TOL
        np.testing.assert_allclose(out["a"][i].numpy(), a.numpy(), rtol=0, atol=TOL)
    mz = out["moments"][:, 0].abs().numpy()
    assert mz[0] > 0.5 and mz[1] < 1e-3


def test_simple_update_is_blind_to_singular_vector_signs(monkeypatch):
    """A sign flip of one singular-vector pair is a gauge change of one bond
    (the cell update does not symmetrize), and the CTMRG projectors are
    covariant under it: random signs leave every measured energy as it was."""
    h2 = tip.heisenberg_bond_term_2d(rotated=False, device=CPU)
    sched = ((0.1, 15),)
    _, _, e_ref = tic.ipeps_cell_ground_state(h2, 2, CHI, schedule=sched, iters=ITERS)
    real = torch.linalg.svd
    rng = np.random.default_rng(1)

    def signed_at_random(m, full_matrices=False, **kwargs):
        u, s, vh = real(m, full_matrices=full_matrices, **kwargs)
        f = torch.from_numpy(rng.choice([-1.0, 1.0], size=s.shape[-1])).to(u.dtype)
        return u * f, s, vh * f[:, None]

    monkeypatch.setattr(torch.linalg, "svd", signed_at_random)
    _, _, e = tic.ipeps_cell_ground_state(h2, 2, CHI, schedule=sched, iters=ITERS)
    assert abs(float(e) - float(e_ref)) < TOL


def test_rotated_bond_term_is_unitary_image():
    h2 = tip.heisenberg_bond_term_2d(rotated=False, device=CPU).numpy()
    h2r = tip.heisenberg_bond_term_2d(rotated=True, device=CPU).numpy()
    w = np.kron(np.eye(2), np.array([[0.0, -1.0], [1.0, 0.0]]))
    assert np.allclose(w @ h2 @ w.T, h2r, atol=1e-12)


def test_commuting_zz_purification_matches_onsager():
    """Pure Ising bonds: the thermal PEPS is exact at D 2, so <ZZ> is
    Onsager's nearest-neighbor correlation and |<Z>| Yang's magnetization;
    <X> vanishes identically."""
    beta = 0.6
    h2 = -np.kron(Z, Z)
    a, b = tth.thermal_ipeps_cell(torch.from_numpy(h2), beta, bond_dim=2, n_steps=6)
    e = float(tth.thermal2d_energy(a, b, h2, chi=8, iters=30))
    assert abs(e - chip_smoke.onsager_energy(beta)) < 1e-10
    for row in tth.thermal2d_site_expectation(a, b, Z, chi=8, iters=30):
        for v in row:
            assert abs(abs(float(v)) - chip_smoke.yang_magnetization(beta)) < 1e-8
    g0 = tth.infinite_temperature_site(2, device=CPU)
    assert g0.shape == (4, 2, 2, 2, 2) and float(g0.abs().sum()) == pytest.approx(np.sqrt(2))
    np.testing.assert_array_equal(tth.lift_onsite(X), np.kron(X, np.eye(2)))
