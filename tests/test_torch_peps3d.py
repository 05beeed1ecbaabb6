"""Cubic-lattice iPEPS and 3D thermal purification of the PyTorch port
against the JAX package, on the CPU.

Both packages start the simple update from the noise drawn by
``numpy.random.default_rng(0)``; states compare through their bond weights
(singular values) and what they measure, never tensor by tensor (singular-
vector signs are a gauge).  The thermal state is also held through a
2x2x2-torus contraction of its double layers, which needs no coarse-graining
flow.  The commuting purification must reproduce the classical 3D Ising bond
correlation of the independent HOTRG impurity flow.  Random singular-vector
signs (cuSOLVER's differ from LAPACK's) change no measured energy, and a
complex ``h2`` raises where the JAX package drops its imaginary part.
"""

import itertools
import string
from importlib import import_module

import numpy as np
import opt_einsum
import pytest
import torch

from contractn_tpu_torch.convert import state_from_numpy, state_to_numpy
from contractn_tpu_torch.utils.errors import TNError

ji = import_module("contractn_tpu.models.ipeps3d")
jt = import_module("contractn_tpu.models.thermal3d")
jh = import_module("contractn_tpu.models.hotrg3d")
ti = import_module("contractn_tpu_torch.models.ipeps3d")
tt = import_module("contractn_tpu_torch.models.thermal3d")
th = import_module("contractn_tpu_torch.models.hotrg3d")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])
SCHEDULE = ((0.1, 30),)
CHI, STEPS = 4, 6


@pytest.fixture(scope="module")
def ref():
    h2 = ji.tfim_bond_term_3d(1.0, 3.0)
    gamma, lam = ji.simple_update_3d(h2, 2, schedule=SCHEDULE)
    a_site = ji.su3d_absorb_weights(gamma, lam)
    ga, gb, lams = jt.thermal_ipeps3d(ji.tfim_bond_term_3d(1.0, 1.0), 0.2, 2, 1)
    cga, cgb, clams = jt.thermal_ipeps3d(ji.tfim_bond_term_3d(1.0, 0.0), 0.3, 2, 1)
    zz = np.kron(Z, Z)
    return {
        "lam": np.asarray(lam), "a_site": np.asarray(a_site),
        "energy": ji.ipeps3d_energy(a_site, h2, CHI, STEPS),
        "mx": ji.ipeps3d_expect_local(a_site, X, CHI, STEPS),
        "thermal": state_to_numpy(tuple(map(np.asarray, (ga, gb))) + (
            {k: np.asarray(v) for k, v in lams.items()},)),
        "zz": jt.thermal3d_bond_expectation(cga, cgb, clams, zz, 6, steps=STEPS - 3),
    }


def test_constructors_match_jax():
    import jax

    np.testing.assert_array_equal(ti.tfim_bond_term_3d(1.0, 2.5, device=CPU).numpy(),
                                  ji.tfim_bond_term_3d(1.0, 2.5))
    raw = np.random.default_rng(0).normal(size=(2,) + (3,) * 6)
    sym = ti.symmetrize_cubic(torch.from_numpy(raw))
    np.testing.assert_allclose(sym.numpy(), np.asarray(jax.jit(ji.symmetrize_cubic)(raw)),
                               atol=1e-15)
    assert len(ti._CUBIC_PERMS) == 48
    v = np.array([2.0, 1.0])
    np.testing.assert_array_equal(
        ti.product_peps3d(v, 2, dtype=torch.float64, device=CPU).numpy(),
        ji.product_peps3d(v, 2, dtype=np.float64))
    lam = np.array([0.8, 0.6, 0.0])
    a = ti.su3d_absorb_weights(torch.from_numpy(raw), torch.from_numpy(lam))
    np.testing.assert_allclose(a.numpy(), np.asarray(ji.su3d_absorb_weights(raw, lam)),
                               atol=1e-15)
    op = np.array([[0.3, 1.0], [1.0, -0.2]])
    np.testing.assert_allclose(ti.peps3d_double_layer(a, op).numpy(),
                               np.asarray(ji.peps3d_double_layer(np.asarray(a), op)),
                               atol=1e-14)
    np.testing.assert_array_equal(tt.infinite_temperature_site3d(2, device=CPU).numpy(),
                                  np.asarray(jt.infinite_temperature_site3d(2)))


def test_simple_update_and_measurement_match_jax(ref):
    h2 = ti.tfim_bond_term_3d(1.0, 3.0, device=CPU)
    gamma, lam = ti.simple_update_3d(h2, 2, schedule=SCHEDULE)
    np.testing.assert_allclose(lam.numpy(), ref["lam"], rtol=0, atol=TOL)
    a_site = ti.su3d_absorb_weights(gamma, lam)
    assert abs(ti.ipeps3d_energy(a_site, h2, CHI, STEPS) - ref["energy"]) < TOL
    assert abs(ti.ipeps3d_expect_local(a_site, X, CHI, STEPS) - ref["mx"]) < TOL
    # the JAX tensor carried across measures the same
    moved = state_from_numpy({"a": ref["a_site"]}, device=CPU)["a"]
    assert abs(ti.ipeps3d_energy(moved, h2, CHI, STEPS) - ref["energy"]) < TOL


def test_simple_update_is_blind_to_singular_vector_signs(ref, monkeypatch):
    """Random signs on every SVD pair reach the JAX package's energy: each
    pair is signed for continuity with the old tensor."""
    real = torch.linalg.svd
    rng = np.random.default_rng(1)

    def signed_at_random(m, full_matrices=False, **kwargs):
        u, s, vh = real(m, full_matrices=full_matrices, **kwargs)
        f = torch.from_numpy(rng.choice([-1.0, 1.0], size=s.shape[0]))
        return u * f[None, :], s, vh * f[:, None]

    monkeypatch.setattr(torch.linalg, "svd", signed_at_random)
    h2 = ti.tfim_bond_term_3d(1.0, 3.0, device=CPU)
    _, energy = ti.ipeps3d_ground_state(h2, 2, CHI, schedule=SCHEDULE, steps=STEPS)
    assert abs(energy - ref["energy"]) < TOL


def test_complex_h2_raises():
    a = ti.product_peps3d(np.array([1.0, 0.0]), 2, dtype=torch.float64, device=CPU)
    h2 = np.kron(Z, Z) + 1j * np.kron(X, Z)
    with pytest.raises(TNError, match="imaginary"):
        ti.ipeps3d_expect_bond(a, h2, CHI, 2)
    g = tt.infinite_temperature_site3d(2, device=CPU)
    lams = {c: torch.tensor([1.0, 0.0], dtype=torch.float64) for c in tt._CLASS_NAMES}
    with pytest.raises(TNError, match="imaginary"):
        tt.thermal3d_bond_expectation(g, g, lams, h2, CHI, steps=2)
    with pytest.raises(TNError, match="imaginary"):
        tt.thermal_ipeps3d(torch.from_numpy(h2), 0.1, 2, 1)
    # a complex dtype with no imaginary part measures as the real term
    zz = np.kron(Z, Z)
    assert ti.ipeps3d_expect_bond(a, zz.astype(complex), CHI, 2) == \
        ti.ipeps3d_expect_bond(a, zz, CHI, 2) == pytest.approx(1.0, abs=1e-12)


def _torus(ts):
    """Closed 2x2x2 periodic contraction of site tensors ``ts[(x, y, z)]``
    with legs (u, l, d, r, f, k)."""
    idx = {}
    letters = iter(string.ascii_letters)

    def bond(s1, s2, tag):
        key = (min(s1, s2), max(s1, s2), tag)
        if key not in idx:
            idx[key] = next(letters)
        return idx[key]

    terms, ops = [], []
    for x, y, z in itertools.product(range(2), repeat=3):
        u = bond((x, y, z), (x, y, 1 - z), f"z{z}")
        d = bond((x, y, 1 - z), (x, y, z), f"z{1 - z}")
        r = bond((x, y, z), (1 - x, y, z), f"x{x}")
        left = bond((1 - x, y, z), (x, y, z), f"x{1 - x}")
        f = bond((x, y, z), (x, 1 - y, z), f"y{y}")
        k = bond((x, 1 - y, z), (x, y, z), f"y{1 - y}")
        terms.append(u + left + d + r + f + k)
        ops.append(ts[(x, y, z)])
    return opt_einsum.contract(",".join(terms) + "->", *ops)


def _torus_values(layers):
    """<Z_A Z_B> on a z bond and <X_A> on the torus from (E_A, E_B, I_A, I_B,
    X_A) double layers (numpy)."""
    ea, eb, ia, ib, xa = layers

    def build(imp):
        return {s: imp.get(s, ea if sum(s) % 2 == 0 else eb)
                for s in itertools.product(range(2), repeat=3)}

    norm = _torus(build({}))
    return (_torus(build({(0, 0, 0): ia, (0, 0, 1): ib})) / norm,
            _torus(build({(0, 0, 0): xa})) / norm)


def test_thermal_sweep_matches_jax(ref):
    """One sweep of the non-commuting purification: the bond weights of all
    six classes, and two torus expectation values of the double layers."""
    h2 = ti.tfim_bond_term_3d(1.0, 1.0, device=CPU)
    ga, gb, lams = tt.thermal_ipeps3d(h2, 0.2, 2, 1)
    jga, jgb, jlams = ref["thermal"]
    for c in tt._CLASS_NAMES:
        np.testing.assert_allclose(lams[c].numpy(), jlams[c], rtol=0, atol=TOL)
    lz, lx = np.kron(Z, np.eye(2)), np.kron(X, np.eye(2))

    def layers(pkg, ga, gb, lams):
        dl = pkg.thermal3d_double_layers
        return [np.asarray(t) for t in (*dl(ga, gb, lams), dl(ga, gb, lams, op_a=lz)[0],
                                        dl(ga, gb, lams, op_b=lz)[1],
                                        dl(ga, gb, lams, op_a=lx)[0])]

    got = _torus_values(layers(tt, ga, gb, lams))
    want = _torus_values(layers(jt, jga, jgb, jlams))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] < 1.0


def test_commuting_purification_is_the_classical_ising_model(ref):
    """At flow chi 6 the purification's checkerboard flow (three seed merges,
    then ``steps``) equals the classical impurity flow of ``steps + 3``
    merges to machine precision."""
    h2 = ti.tfim_bond_term_3d(1.0, 0.0, device=CPU)
    ga, gb, lams = tt.thermal_ipeps3d(h2, 0.3, 2, 1)
    zz = tt.thermal3d_bond_expectation(ga, gb, lams, np.kron(Z, Z), 6, steps=STEPS - 3)
    assert abs(zz - ref["zz"]) < TOL
    ch, sh = np.sqrt(np.cosh(0.3)), np.sqrt(np.sinh(0.3))
    w = np.array([[ch, sh], [ch, -sh]])
    a = np.einsum("su,sl,sd,sr,sf,sk->uldrfk", w, w, w, w, w, w)
    imp = np.einsum("s,su,sl,sd,sr,sf,sk->uldrfk", np.array([1.0, -1.0]), w, w, w, w, w, w)
    want = th.hotrg3d_bond_expectation(torch.from_numpy(a), imp, imp, 6, STEPS)
    assert abs(zz - want) < 1e-9
    for sub in ("A", "B"):
        assert abs(tt.thermal3d_site_expectation(ga, gb, lams, Z, CHI, steps=STEPS - 3,
                                                 sublattice=sub)) < 1e-6


def test_host_constructors_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ti.tfim_bond_term_3d(1.0, 1.0),
                  lambda: ti.product_peps3d(np.ones(2)),
                  lambda: ti.simple_update_3d(np.eye(4), 2),
                  lambda: tt.infinite_temperature_site3d(2),
                  lambda: tt.thermal_ipeps3d(np.eye(4), 0.1, 2, 1)):
        with pytest.raises(TNError, match="device='cpu'"):
            build()


def test_three_dimensions_example_matches_jax():
    """examples/three_dimensions.py's three parts at its bond sizes, steps
    cut (flow steps 6, not 18-22; one 30-sweep stage, not 380 sweeps; one
    Trotter sweep, exact for the commuting state): every printed number of
    the port against the JAX package's."""
    def ising3d(beta, h=0.0):
        ch, sh = np.sqrt(np.cosh(beta)), np.sqrt(np.sinh(beta))
        w = np.array([[ch, sh], [ch, -sh]])
        weight = np.exp(h * np.array([1.0, -1.0]))
        ein = "s,su,sl,sd,sr,sf,sk->uldrfk"
        return (np.einsum(ein, weight, w, w, w, w, w, w),
                np.einsum(ein, weight * np.array([1.0, -1.0]), w, w, w, w, w, w))

    for beta in (0.15, 0.2216, 0.3):
        a, imp = ising3d(beta, h=0.005)
        ta, timp = torch.from_numpy(a), torch.from_numpy(imp)
        assert abs(th.hotrg3d_log_z(ta, 4, STEPS) - jh.hotrg3d_log_z(a, 4, STEPS)) < TOL
        assert abs(th.hotrg3d_expectation(ta, timp, 4, STEPS)
                   - jh.hotrg3d_expectation(a, imp, 4, STEPS)) < TOL
    assert abs(th.ising3d_internal_energy_ad(0.3, 4, STEPS, device=CPU)
               - jh.ising3d_internal_energy_ad(0.3, 4, STEPS)) < TOL
    for h in (0.5, 8.0):
        _, got = ti.ipeps3d_ground_state(ti.tfim_bond_term_3d(1.0, h, device=CPU), 2, 6,
                                         schedule=SCHEDULE, steps=STEPS)
        _, want = ji.ipeps3d_ground_state(ji.tfim_bond_term_3d(1.0, h), 2, 6,
                                          schedule=SCHEDULE, steps=STEPS)
        assert abs(got - want) < TOL
    h2 = ti.tfim_bond_term_3d(1.0, 0.0, device=CPU)
    zz = np.kron(Z, Z)
    got = tt.thermal3d_bond_expectation(*tt.thermal_ipeps3d(h2, 0.2, 2, 1), zz, 6,
                                        steps=STEPS - 3)
    want = jt.thermal3d_bond_expectation(*jt.thermal_ipeps3d(h2.numpy(), 0.2, 2, 1), zz, 6,
                                         steps=STEPS - 3)
    a, imp = ising3d(0.2)
    classical = th.hotrg3d_bond_expectation(torch.from_numpy(a), imp, imp, 6, STEPS)
    assert abs(got - want) < TOL and abs(got - classical) < 1e-9
