"""CTMRG, TRG and HOTRG of the PyTorch port against the JAX package, on the
CPU.

Both packages get the same host-built site tensors (the builders are numpy
in both) and are compared at 1e-10 through the invariants they return: free
energies, impurity expectations, autodiff energies.  The C/T environments
and isometries are gauge-dependent and never compared directly.  Uniform
GILT is the exception: its R matrices agree to 1e-15, but their SVD halves
rotate inside degenerate singular subspaces between LAPACK builds, and the
TRG splits that follow cut through degenerate multiplets, so the two flows
agree only to the size of the truncation error; there the port is held to
the JAX test's own criterion (GILT cuts the plain error threefold against
Onsager) and to the JAX value within that error.
"""

from functools import partial
from importlib import import_module

import jax
import numpy as np
import pytest
import torch

jc = import_module("contractn_tpu.models.ctmrg")
tc = import_module("contractn_tpu_torch.models.ctmrg")
jt = import_module("contractn_tpu.models.trg")
tt = import_module("contractn_tpu_torch.models.trg")
jh = import_module("contractn_tpu.models.hotrg")
th = import_module("contractn_tpu_torch.models.hotrg")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
SIG = [1.0, -1.0]


def onsager_log_z(beta, n=2000):
    th_ = np.linspace(0.0, np.pi, n)
    t1, t2 = np.meshgrid(th_, th_)
    f = np.log(np.cosh(2 * beta) ** 2 - np.sinh(2 * beta) * (np.cos(t1) + np.cos(t2)))
    return np.log(2.0) + np.trapezoid(np.trapezoid(f, th_, axis=1), th_) / (2 * np.pi ** 2)


def _cpu(module, monkeypatch, *names):
    """Point the named host-array builders of a port module at the CPU (the
    wrappers that call them take no ``device=``)."""
    for name in names:
        monkeypatch.setattr(module, name, partial(getattr(module, name), device="cpu"))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's values, computed once for the file."""
    b = 0.43
    out = {
        "f_ctmrg": jc.free_energy_per_site(jc.ising_tensor(b), 8, 60,
                                           boundary=jc.ising_boundary(b)),
        "m_ctmrg": jc.ising_magnetization(0.5, chi=8, iters=60),
        "trg": jt.trg_log_z(jc.ising_tensor(0.3), chi=8, steps=20),
        "trg_gilt": jt.trg_log_z(jc.ising_tensor(0.3), chi=8, steps=30, gilt_eps=1e-4),
        "trg_plain30": jt.trg_log_z(jc.ising_tensor(0.3), chi=8, steps=30),
        "hotrg": jh.hotrg_log_z(jc.ising_tensor(0.5), chi=8, steps=16),
        "hotrg_diff": float(jh.hotrg_log_z_diff(jh.ising_tensor_smooth(0.4), chi=8,
                                                steps=16)),
        "u_ad": jh.ising_internal_energy_ad(0.4, 8, 16),
        "c_ad": jh.ising_specific_heat_ad(0.3, 8, 16),
        "potts_smooth": jh.hotrg_log_z(jh.potts_tensor_smooth(1.2, q=3), chi=8, steps=16),
    }
    bias = np.exp(0.5 * 0.05 * np.array(SIG))
    out["m_hotrg"] = jh.hotrg_expectation(jc.ising_tensor(0.5, field_op=bias),
                                          jc.ising_tensor(0.5, field_op=bias * SIG),
                                          chi=8, steps=16)
    sig = jc.ising_tensor(0.5, field_op=SIG)
    out["ss_hotrg"] = jh.hotrg_bond_expectation(jc.ising_tensor(0.5), sig, sig, chi=8,
                                                steps=16)
    grad = jax.grad(lambda hh: jh.hotrg_log_z_diff(jh.ising_tensor_smooth(0.5, hh),
                                                   chi=8, steps=16))
    out["dh_ad"] = float(grad(jax.numpy.asarray(0.025)))
    return out


def test_ctmrg_free_energy_and_magnetization(ref, monkeypatch):
    b = 0.43
    got = tc.free_energy_per_site(tc.ising_tensor(b, device=CPU), 8, 60,
                                  boundary=tc.ising_boundary(b, device=CPU))
    assert abs(got - ref["f_ctmrg"]) < TOL
    _cpu(tc, monkeypatch, "ising_tensor", "ising_boundary")
    m = tc.ising_magnetization(0.5, chi=8, iters=60)
    assert abs(m - ref["m_ctmrg"]) < TOL
    assert abs(m - (1.0 - np.sinh(1.0) ** -4) ** 0.125) < 1e-8


def test_ctmrg_refuses_complex_and_narrow_chi():
    a = tc.ising_tensor(0.3, device=CPU)
    with pytest.raises(TypeError, match="SYMMETRIC-corner eigh"):
        tc.ctmrg_environment(a.to(torch.complex128), 8)
    with pytest.raises(ValueError, match="must be >="):
        tc.ctmrg_environment(a, 1)


def test_ctmrg_builders_match_jax():
    for got, want in ((tc.ising_tensor(0.4, field_op=SIG, device=CPU),
                       jc.ising_tensor(0.4, field_op=SIG)),
                      (tc.potts_tensor(0.9, q=3, device=CPU), jc.potts_tensor(0.9, q=3))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tc.ising_boundary(0.4, device=CPU), jc.ising_boundary(0.4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trg_matches_jax(ref):
    a = tc.ising_tensor(0.3, device=CPU)
    assert abs(tt.trg_log_z(a, chi=8, steps=20) - ref["trg"]) < TOL


def test_trg_gilt_holds_the_jax_criterion(ref):
    """See the module docstring: GILT's flow is compared within the
    truncation error, at the JAX test's own criterion."""
    a = tc.ising_tensor(0.3, device=CPU)
    exact = onsager_log_z(0.3)
    plain = abs(tt.trg_log_z(a, chi=8, steps=30) - exact)
    gilt = tt.trg_log_z(a, chi=8, steps=30, gilt_eps=1e-4)
    assert abs(plain - abs(ref["trg_plain30"] - exact)) < TOL
    assert abs(gilt - exact) < 0.3 * plain
    assert abs(gilt - ref["trg_gilt"]) < 0.3 * plain


def test_hotrg_flows_match_jax(ref):
    a = tc.ising_tensor(0.5, device=CPU)
    assert abs(th.hotrg_log_z(a, chi=8, steps=16) - ref["hotrg"]) < TOL
    bias = np.exp(0.5 * 0.05 * np.array(SIG))
    m = th.hotrg_expectation(tc.ising_tensor(0.5, field_op=bias, device=CPU),
                             tc.ising_tensor(0.5, field_op=bias * SIG, device=CPU),
                             chi=8, steps=16)
    assert abs(m - ref["m_hotrg"]) < TOL
    sig = tc.ising_tensor(0.5, field_op=SIG, device=CPU)
    assert abs(th.hotrg_bond_expectation(a, sig, sig, chi=8, steps=16)
               - ref["ss_hotrg"]) < TOL
    pot = th.hotrg_log_z(th.potts_tensor_smooth(1.2, q=3, device=CPU), chi=8, steps=16)
    assert abs(pot - ref["potts_smooth"]) < TOL


def test_hotrg_autodiff_matches_jax(ref, monkeypatch):
    """The frozen-projector reverse pass: the primal value, the internal
    energy, the specific heat and a field derivative, each against the JAX
    package's ``jax.grad`` through the same flow."""
    val = th.hotrg_log_z_diff(th.ising_tensor_smooth(0.4, device=CPU), chi=8, steps=16)
    assert abs(float(val) - ref["hotrg_diff"]) < TOL
    assert abs(th.ising_internal_energy_ad(0.4, 8, 16, device=CPU) - ref["u_ad"]) < TOL
    monkeypatch.setattr(th, "resolve_device",
                        lambda device=None, tensors=(): torch.device(device or "cpu"))
    assert abs(th.ising_internal_energy_ad(0.4, 8, 16) - ref["u_ad"]) < TOL
    # a central difference of two energies: the 1e-10 of each, over 2e-4
    assert abs(th.ising_specific_heat_ad(0.3, 8, 16) - ref["c_ad"]) < 1e-6
    hh = torch.tensor(0.025, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(
        th.hotrg_log_z_diff(th.ising_tensor_smooth(torch.tensor(0.5, dtype=torch.float64),
                                                   hh), chi=8, steps=16), hh)
    assert abs(float(g) - ref["dh_ad"]) < TOL
