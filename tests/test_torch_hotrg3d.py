"""3D HOTRG of the PyTorch port against the JAX package and closed forms, on
the CPU.

The merge's pieces (the density matrix, the GEMM-chain merge) are held to the
JAX package entry by entry; a merge step and the flows through gauge
invariants (log Z, impurity ratios, the mean that normalizes each step, the
discarded weights), since eigenvector signs are a gauge.  Parity runs at beta
0.3 and 0.25: deep in the ordered phase (beta 0.8) the density matrices'
spectra are exactly degenerate at the truncation boundary, so which vectors
of a multiplet are kept is up to each LAPACK build, and both packages' AD
energies move at 1e-9 with it; there the port is held to the closed forms at
the JAX tests' tolerances instead.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.utils.errors import TNError

jh = import_module("contractn_tpu.models.hotrg3d")
th = import_module("contractn_tpu_torch.models.hotrg3d")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
CHI, STEPS = 4, 6
# two generic positive species and their impurities: no mirror symmetry, so no
# tie between a bond's two candidate isometries is left to rounding
AB = tuple(np.random.default_rng(5).uniform(0.5, 1.5, size=(4,) + (2,) * 6))


def ising3d_pair(beta, h=0.0):
    """Cubic Ising site tensor and its sigma impurity (numpy, float64)."""
    ch, sh = np.sqrt(np.cosh(beta)), np.sqrt(np.sinh(beta))
    w = np.array([[ch, sh], [ch, -sh]])
    weight = np.exp(h * np.array([1.0, -1.0]))
    a = np.einsum("s,su,sl,sd,sr,sf,sk->uldrfk", weight, w, w, w, w, w, w)
    imp = np.einsum("s,su,sl,sd,sr,sf,sk->uldrfk", weight * np.array([1.0, -1.0]),
                    w, w, w, w, w, w)
    return a, imp


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ref():
    a, imp = ising3d_pair(0.3, h=0.01)
    return {
        "a": a, "imp": imp,
        "log_z": jh.hotrg3d_log_z(a, CHI, STEPS),
        "m": jh.hotrg3d_expectation(a, imp, CHI, STEPS),
        "ab_pair": jh.hotrg3d_ab_expectation(*AB, CHI, 3),
        "u": jh.ising3d_internal_energy_ad(0.25, CHI, STEPS),
    }


def test_merge_pieces_match_jax():
    """The density matrix and the per-slot merge at chi 3, entry by entry,
    from shared random tensors and isometries."""
    import jax

    rng = np.random.default_rng(0)
    chi = 3
    top, bot = rng.normal(size=(2,) + (chi,) * 6)
    isos = rng.normal(size=(4, chi, chi, chi))
    prec = jax.lax.Precision.HIGHEST
    np.testing.assert_allclose(
        th._density_pair3(_t(top), _t(bot)).numpy(),
        np.asarray(jax.jit(jh._density_pair3, static_argnums=2)(top, bot, prec)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        th._apply_pair3_gen(_t(top), _t(bot), *map(_t, isos)).numpy(),
        np.asarray(jax.jit(jh._apply_pair3_gen, static_argnums=6)(top, bot, *isos, prec)),
        rtol=TOL, atol=TOL)


def test_merge_step_matches_jax_through_invariants():
    import jax

    a, imp = ising3d_pair(0.3, h=0.01)
    a0, i0 = (np.pad(x, [(0, CHI - 2)] * 6) for x in (a, imp))
    step = jax.jit(jh._merge_step3, static_argnums=(2, 3))
    ja, ji, jlog, jerr = step(a0, i0, CHI, jax.lax.Precision.HIGHEST)
    ta, ti, tlog, terr = th._merge_step3(_t(a0), _t(i0), CHI)
    assert abs(float(tlog) - float(jlog)) < TOL
    assert abs(float(terr) - float(jerr)) < TOL
    for t, j in ((ta, ja), (ti, ji)):
        assert abs(float(th._closure3(t)) - float(jh._closure3(j))) < TOL


def test_flows_match_jax(ref):
    a, imp = _t(ref["a"]), _t(ref["imp"])
    assert abs(th.hotrg3d_log_z(a, CHI, STEPS) - ref["log_z"]) < TOL
    assert abs(th.hotrg3d_expectation(a, imp, CHI, STEPS) - ref["m"]) < TOL
    assert abs(th.hotrg3d_ab_expectation(*map(_t, AB), CHI, 3) - ref["ab_pair"]) < TOL
    # a == b: the checkerboard seed is three uniform merges (the JAX test's
    # identities; the bond flow is held to the JAX package through ipeps3d)
    assert abs(th.hotrg3d_ab_log_z(a, a, CHI, STEPS - 3)
               - th.hotrg3d_log_z(a, CHI, STEPS)) < 1e-7
    assert abs(th.hotrg3d_ab_expectation(a, a, imp, imp, CHI, STEPS - 3)
               - th.hotrg3d_bond_expectation(a, imp, imp, CHI, STEPS)) < 1e-8


def test_ad_energy_matches_jax_and_the_flow(ref):
    u = th.ising3d_internal_energy_ad(0.25, CHI, STEPS, device=CPU)
    assert abs(u - ref["u"]) < TOL
    a = th.ising3d_tensor_smooth(0.25, device=CPU)
    np.testing.assert_allclose(a.numpy(), np.asarray(jh.ising3d_tensor_smooth(0.25)),
                               rtol=0, atol=1e-15)
    lz = float(th.hotrg3d_log_z_diff(a, CHI, STEPS))
    assert abs(lz - th.hotrg3d_log_z(a, CHI, STEPS)) < 1e-12


def test_closed_forms():
    """The JAX tests' anchors on the port: decoupled chains exactly, the
    low-temperature series, the z-bond correlation against the energy
    series, the AD energy against the series."""
    a = th.ising3d_tensor_smooth(0.0, beta_z=0.7, device=CPU)
    assert abs(th.hotrg3d_log_z(a, CHI, 25) - np.log(2.0 * np.cosh(0.7))) < 1e-13
    beta = 0.8
    a, imp = map(_t, ising3d_pair(beta))
    exact = 3.0 * beta + np.exp(-12.0 * beta) + 3.0 * np.exp(-20.0 * beta)
    assert abs(th.hotrg3d_log_z(a, CHI, 25) - exact) < 1e-6
    u_exact = -3.0 + 12.0 * np.exp(-12.0 * beta) + 60.0 * np.exp(-20.0 * beta)
    assert abs(th.hotrg3d_bond_expectation(a, imp, imp, CHI, 22) + u_exact / 3.0) < 1e-4
    assert abs(th.ising3d_internal_energy_ad(beta, CHI, 20, device=CPU) - u_exact) < 2e-4


def test_float32_refuses_tf32():
    a = th.ising3d_tensor_smooth(0.3, device=CPU).float()
    assert abs(th.hotrg3d_log_z(a, CHI, 3) - th.hotrg3d_log_z(a.double(), CHI, 3)) < 1e-5
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(TNError, match="TF32"):
            th.hotrg3d_log_z(a, CHI, 3)
    finally:
        torch.set_float32_matmul_precision("highest")


def test_host_constructors_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TNError, match="device='cpu'"):
        th.ising3d_tensor_smooth(0.3)
    with pytest.raises(TNError, match="device='cpu'"):
        th.hotrg3d_log_z(ising3d_pair(0.3)[0], CHI, 2)
    with pytest.raises(TNError, match="device='cpu'"):
        th.ising3d_internal_energy_ad(0.3, CHI, 2)
