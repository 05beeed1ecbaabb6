"""Single-site iPEPS of the PyTorch port against the JAX package, on the CPU.

The square-root-Boltzmann PEPS maps ``<psi|psi>`` onto the classical Ising
partition function, so its magnetization and free energy are held against
the JAX package and Onsager-Yang; the simple update and the CTMRG-measured
ground-state energy are compared at 1e-10 on the same deterministic start
(both packages seed the start's noise from ``numpy.random.default_rng(0)``).
The iPEPS tensors are compared where they are deterministic (the C4v
projection, the weight absorption); the simple update's output only through
its bond weights and what it measures (the port signs its singular vectors
for continuity, a gauge), environments never.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import state_from_numpy

jp = import_module("contractn_tpu.models.ipeps")
tp = import_module("contractn_tpu_torch.models.ipeps")
jc = import_module("contractn_tpu.models.ctmrg")
tc = import_module("contractn_tpu_torch.models.ctmrg")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])
SCHEDULE = ((0.1, 30), (0.02, 20))


def sqrt_boltzmann_peps(beta):
    """The PEPS whose norm is the classical Ising partition function."""
    b = np.array([[np.exp(beta / 2), np.exp(-beta / 2)],
                  [np.exp(-beta / 2), np.exp(beta / 2)]])
    vals, vecs = np.linalg.eigh(b)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    return np.einsum("su,sl,sd,sr->suldr", w, w, w, w)


def plus_boundary(beta):
    """Fixed-spin (+1) boundary seed in double-layer bonds."""
    b = np.array([[np.exp(beta / 2), np.exp(-beta / 2)],
                  [np.exp(-beta / 2), np.exp(beta / 2)]])
    vals, vecs = np.linalg.eigh(b)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    y = np.kron(w[0], w[0])
    return np.outer(y, y), np.einsum("l,d,r->ldr", y, y, y)


@pytest.fixture(scope="module")
def ref():
    a = sqrt_boltzmann_peps(0.5)
    h2 = jp.tfim_bond_term_2d(h=3.5)
    a_site, energy = jp.ipeps_ground_state(h2, 2, 8, schedule=SCHEDULE, iters=40)
    return {
        "lam": np.asarray(jp.simple_update(h2, 2, schedule=SCHEDULE)[1]),
        "m": float(jp.ipeps_expect_local(a, SZ, 8, iters=60, boundary=plus_boundary(0.5))),
        "zz": float(jp.ipeps_expect_bond(a, np.kron(SZ, SZ), 8, iters=60,
                                         boundary=plus_boundary(0.5))),
        "f": jc.free_energy_per_site(np.asarray(jp.peps_double_layer(
            sqrt_boltzmann_peps(0.3))), 8, 60),
        "a_site": np.asarray(a_site), "energy": float(energy),
        "mx": float(jp.ipeps_expect_local(a_site, SX, 8, iters=40)),
    }


def test_sqrt_boltzmann_matches_jax_and_onsager(ref):
    a = torch.from_numpy(sqrt_boltzmann_peps(0.5))
    bd = tuple(torch.from_numpy(x) for x in plus_boundary(0.5))
    m = float(tp.ipeps_expect_local(a, SZ, 8, iters=60, boundary=bd))
    assert abs(m - ref["m"]) < TOL
    assert abs(m - (1.0 - np.sinh(1.0) ** -4) ** 0.125) < 1e-8
    zz = float(tp.ipeps_expect_bond(a, np.kron(SZ, SZ), 8, iters=60, boundary=bd))
    assert abs(zz - ref["zz"]) < TOL
    dbl = tp.peps_double_layer(torch.from_numpy(sqrt_boltzmann_peps(0.3)))
    assert abs(tc.free_energy_per_site(dbl, 8, 60) - ref["f"]) < TOL
    assert abs(tc.free_energy_per_site(dbl, 8, 60)
               - tc.free_energy_per_site(tc.ising_tensor(0.3, device=CPU), 8, 60)) < 1e-8


@pytest.mark.parametrize("bond_dim,chi", [(1, 1), (2, 4)])
def test_product_state_closed_form(bond_dim, chi):
    """The JAX test's closed forms on a (zero-padded) product iPEPS."""
    v = np.array([2.0, 1.0])
    a_site = tp.product_peps(v, bond_dim=bond_dim, dtype=np.float64, device=CPU)
    np.testing.assert_array_equal(a_site.numpy(), np.asarray(
        jp.product_peps(v, bond_dim=bond_dim, dtype=np.float64)))
    nrm = v @ v
    got = float(tp.ipeps_expect_local(a_site, SZ, chi=chi, iters=30))
    assert abs(got - (v[0] ** 2 - v[1] ** 2) / nrm) < 1e-9
    h2 = tp.tfim_bond_term_2d(j=1.0, h=1.0, device=CPU)
    vv = np.kron(v, v)
    want_h = (vv @ h2.numpy() @ vv) / nrm ** 2
    assert abs(float(tp.ipeps_energy(a_site, h2, chi=chi, iters=30)) - 2 * want_h) < 1e-9


def test_builders_and_symmetrization_match_jax():
    for rot in (True, False):
        np.testing.assert_array_equal(
            tp.heisenberg_bond_term_2d(rotated=rot, device=CPU).numpy(),
            jp.heisenberg_bond_term_2d(rotated=rot))
    np.testing.assert_array_equal(tp.tfim_bond_term_2d(h=2.5, device=CPU).numpy(),
                                  jp.tfim_bond_term_2d(h=2.5))
    raw = np.random.default_rng(0).normal(size=(2, 3, 3, 3, 3))
    got = tp.symmetrize_c4v(torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.symmetrize_c4v(raw)), atol=1e-15)
    np.testing.assert_allclose(got.numpy(), got.permute(0, 2, 3, 4, 1).numpy(), atol=1e-12)
    np.testing.assert_allclose(tp.symmetrize_c4v(got).numpy(), got.numpy(), atol=1e-12)
    lam = np.array([0.8, 0.6, 0.0])
    np.testing.assert_allclose(
        tp.su_absorb_weights(torch.from_numpy(raw), torch.from_numpy(lam)).numpy(),
        np.asarray(jp.su_absorb_weights(raw, lam)), atol=1e-15)


def test_ground_state_matches_jax(ref):
    h2 = tp.tfim_bond_term_2d(h=3.5, device=CPU)
    a_site, energy = tp.ipeps_ground_state(h2, 2, 8, schedule=SCHEDULE, iters=40)
    assert abs(float(energy) - ref["energy"]) < TOL
    _, lam = tp.simple_update(h2, 2, schedule=SCHEDULE)
    np.testing.assert_allclose(lam.numpy(), ref["lam"], atol=TOL)
    assert abs(float(tp.ipeps_expect_local(a_site, SX, 8, iters=40)) - ref["mx"]) < TOL
    # the JAX tensor carried across measures the same
    moved = state_from_numpy({"a": ref["a_site"]}, device=CPU)["a"]
    assert abs(float(tp.ipeps_energy(moved, h2, 8, iters=40)) - ref["energy"]) < TOL
    # a warm start continues the same evolution
    gamma, lam = tp.simple_update(h2, 2, schedule=((0.02, 2),), init=a_site)
    assert gamma.shape == a_site.shape and lam.dtype == torch.float64


def test_simple_update_is_blind_to_singular_vector_signs(ref, monkeypatch):
    """cuSOLVER signs its singular vectors unlike LAPACK: the symmetric
    simple update stalls at the product state under random signs unless each
    pair is signed for continuity with the old tensor (the port does), and
    then it reaches the JAX package's energy whatever the signs."""
    real = torch.linalg.svd
    rng = np.random.default_rng(1)

    def signed_at_random(m, full_matrices=False):
        u, s, vh = real(m, full_matrices=full_matrices)
        f = torch.from_numpy(rng.choice([-1.0, 1.0], size=s.shape[0]))
        return u * f[None, :], s, vh * f[:, None]

    monkeypatch.setattr(torch.linalg, "svd", signed_at_random)
    h2 = tp.tfim_bond_term_2d(h=3.5, device=CPU)
    _, energy = tp.ipeps_ground_state(h2, 2, 8, schedule=SCHEDULE, iters=40)
    assert abs(float(energy) - ref["energy"]) < TOL


def test_chip_smoke_two_d_rehearsal(monkeypatch):
    """``chip_smoke.py``'s phase 11 on the CPU at ``TWO_D_TINY`` (the "card"
    is the CPU here), its MERA held to the JAX package's readings after the
    same sweeps from the same start; no path may launch a hand kernel."""
    import chip_smoke
    import jax.numpy as jnp

    jm = import_module("contractn_tpu.models.mera")
    ji = import_module("contractn_tpu.models.itebd")
    th = import_module("contractn_tpu_torch.models.hotrg")
    cfg = dict(chip_smoke.TWO_D_TINY)
    m = cfg["mera"]
    start = chip_smoke.mera_start(m["chi"], 2, m["seed"])
    init = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in start.items()}
    params, energy = jm.mera_ground_state(ji.tfim_h2(), m["chi"], sweeps=m["sweeps"],
                                          init=init)
    cfg["mera"] = {**m, "e_ref": energy,
                   "dim_ref": float(jm.scaling_dimensions(params, n=2)[1])}
    # ising_internal_energy_ad builds its tensors on cuda
    monkeypatch.setattr(th, "resolve_device",
                        lambda device=None, tensors=(): torch.device(device or "cpu"))
    runs = chip_smoke.two_d_paths(CPU, "CPU", cfg)
    assert set(runs) == {"ctmrg", "trg", "hotrg", "mera", "thermal", "ibc_thermal",
                         "ibc_dynamic", "lindblad_infinite", "ipeps", "factorize"}
    assert all(not any(counts.values()) for counts, _ in runs.values())
