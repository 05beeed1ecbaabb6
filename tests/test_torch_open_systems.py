"""Open systems of the PyTorch port against the JAX package, on the CPU:
W^II evolution, Lindblad (RK4 and W^II) and noisy circuits (operator
dynamics: ``test_torch_operator_dynamics.py``).

The superoperator automata are host numpy in both packages and compare
entry by entry; compressed MPOs as dense operators; evolved states as dense
vectors (truncation does not bind at these sizes, so the gauge is the only
freedom); scalar observables, moments and coefficients at 1e-10.  The
steady-state search compares the deterministic core on the same numpy
draws (the JAX module's draw is patched, the port takes ``mps0=``) and
checks one fixed-seed run of its own draw.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy, mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models.mps import MPS

je = import_module("contractn_tpu.models.mpo_evolution")
te = import_module("contractn_tpu_torch.models.mpo_evolution")
jl = import_module("contractn_tpu.models.lindblad")
tl = import_module("contractn_tpu_torch.models.lindblad")
jn = import_module("contractn_tpu.models.noisy")
tn = import_module("contractn_tpu_torch.models.noisy")
jmpo = import_module("contractn_tpu.models.mpo")
tmpo = import_module("contractn_tpu_torch.models.mpo")
jmps = import_module("contractn_tpu.models.mps")
tcan = import_module("contractn_tpu_torch.models.canonical")

torch.set_num_threads(1)

TOL = 1e-10
N = 3
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Y = np.array([[0.0, -1j], [1j, 0.0]])
Z = np.diag([1.0, -1.0])
SM = np.array([[0.0, 0.0], [1.0, 0.0]])
XXZ = (np.kron(X, X) + np.kron(Y, Y)).real + 0.6 * np.kron(Z, Z)
MIXED = (np.kron(Z, Z) + 0.5 * (np.kron(X, np.eye(2)) + np.kron(np.eye(2), X))
         + 0.25 * (np.kron(Z, np.eye(2)) + np.kron(np.eye(2), Z)))


def _dense_state(mps):
    cores, left, right = (np.asarray(a) for a in mps)
    v = np.einsum("i,dij->dj", left, cores[0])
    for a in cores[1:]:
        v = np.einsum("xj,djk->xdk", v, a).reshape(-1, a.shape[-1])
    return v @ right


def _td(mps):
    return _dense_state(mps_to_numpy(mps))


def _jd(mps):
    return _dense_state((mps.cores, mps.left, mps.right))


def _dense_op(cores, left, right):
    cores, left, right = (np.asarray(a) for a in (cores, left, right))
    d = cores.shape[1]
    cur = np.einsum("w,abwv->abv", left, cores[0])
    for w in cores[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(d * dd, d * dd, -1)
    return np.einsum("ABv,v->AB", cur, right)


def _hams(h2=XXZ):
    return (jmpo.mpo_from_bond_term(h2, N, dtype=complex),
            tmpo.mpo_from_bond_term(h2, N, dtype=complex, device="cpu"))


def _to_jax(mps):
    return jmps.MPS(*(jnp.asarray(a) for a in mps_to_numpy(mps)))


def _rho0():
    states = [np.array([0.6, 0.8]), np.array([0.0, 1.0]),
              np.array([1.0, 1j]) / np.sqrt(2)]
    return jl.vectorized_product_state(states), tl.vectorized_product_state(
        states, device="cpu")


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert np.max(np.abs(np.asarray(got) - want)) < tol * max(1.0, np.max(np.abs(want)))


def test_wii_builders_match_jax():
    jh, th = _hams()
    w = np.asarray(jh.cores[1])
    assert np.array_equal(je.wii_core(w, -0.1j), te.wii_core(w, -0.1j))
    for delta in (-0.05j, -0.05 * (1 + 1j) / 2):
        jw, tw = je.wii_mpo(jh, delta), te.wii_mpo(th, delta)
        for a, b in zip((jw.cores, jw.left, jw.right), mpo_to_numpy(tw)):
            _close(b, a, 1e-14)
    jx = je.exp_decay_ising_mpo(N, lam=0.4)
    tx = te.exp_decay_ising_mpo(N, lam=0.4, device="cpu")
    for a, b in zip((jx.cores, jx.left, jx.right), mpo_to_numpy(tx)):
        assert np.array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="automaton"):
        te.wii_mpo(tmpo.MPO(th.cores, th.right, th.left), 0.1)


def _site(mat, site, n=N):
    """``mat`` on one fused site of the dense vectorized chain."""
    out = np.eye(1)
    for k in range(n):
        out = np.kron(out, mat if k == site else np.eye(mat.shape[0]))
    return out


def _trace_bra(site_ops, n=N):
    """Dense product bra: ``vec(I)`` on every site, ``vec(O^T)`` at the
    listed ones (``Tr(O rho)`` pairs without conjugation)."""
    vecs = [np.eye(2).reshape(-1)] * n
    for site, op in site_ops:
        vecs[site] = np.asarray(op).T.reshape(-1)
    out = np.ones(1)
    for v in vecs:
        out = np.kron(out, v)
    return out


def _wii_dense(automaton, dt):
    """The JAX package's conjugate-pair W^II step as one dense matrix."""
    u1, u2 = (_dense_op(u.cores, u.left, u.right)
              for u in jl._wii_props(automaton, dt, 2))
    return u2 @ u1


@pytest.mark.parametrize("imag", [False, True])
def test_mpo_evolve_matches_jax(imag):
    tx = te.exp_decay_ising_mpo(N, lam=0.4, device="cpu")
    start = MPS.random(N, 2, 2, dtype=torch.complex128, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    got = te.mpo_evolve(start, tx, 0.4, 4, max_bond=32, imag=imag)
    # the JAX package's propagators applied densely (truncation never binds)
    step = _wii_dense(je.exp_decay_ising_mpo(N, lam=0.4), -0.1 if imag else -0.1j)
    want = _td(start)
    for _ in range(4):
        want = step @ want
        want = want / np.linalg.norm(want)
    assert abs(abs(np.vdot(want, _td(got))) - 1.0) < TOL


def _tfim_core(h):
    from contractn_tpu.models.dmrg import tfim_mpo

    return np.array(tfim_mpo(2, h=h).cores[0])


def _umps_observables(core, pkg):
    """``(<X>, <Z>, <Z_0 Z_1>_c)`` of a uniform core, through ``pkg``'s own
    transfer-matrix tooling."""
    if pkg == "jax":
        from contractn_tpu.models import umps

        core, kw = jnp.asarray(np.asarray(core)), {}
    else:
        from contractn_tpu_torch.models import umps

        kw = {"device": "cpu"}
    return (umps.expect_local(core, X, **kw), umps.expect_local(core, Z, **kw),
            umps.correlate(core, Z, Z, [1], **kw)[0])


def test_umps_apply_matches_jax():
    """One fused W^II application and Schmidt truncation: the same
    discarded weight and the same state (local values) as the JAX
    package's, untruncated and truncated."""
    prop = je.wii_core(_tfim_core(1.1), -0.05)
    v = np.array([1.0, 0.4]) / np.linalg.norm([1.0, 0.4])
    core = v[:, None, None].astype(complex)
    jcore, tcore = jnp.asarray(core), torch.from_numpy(core)
    for bond in (8, 8, 3):
        jcore, jerr = je.umps_apply(jcore, jnp.asarray(prop), bond)
        tcore, terr = te.umps_apply(tcore, torch.from_numpy(prop), bond)
        assert tuple(tcore.shape) == tuple(jcore.shape)
        assert abs(float(terr) - float(jerr)) < TOL
    assert 0.0 < float(terr) < 1e-4
    np.testing.assert_allclose(_umps_observables(tcore, "torch"),
                               _umps_observables(jcore, "jax"), atol=TOL)


@pytest.mark.parametrize("imag", [False, True])
def test_umps_mpo_evolve_matches_jax(imag):
    """Infinite TFIM (h = 1.5) from a product state, bond 6, in imaginary
    or real time: the evolved state's local values equal the JAX
    package's."""
    v = np.array([np.cos(0.3), np.sin(0.3)])
    core0 = v[:, None, None]
    kw = dict(imag=imag)
    want = je.umps_mpo_evolve(jnp.asarray(core0), _tfim_core(1.5), 0.4, 4, 6, **kw)
    got = te.umps_mpo_evolve(core0, _tfim_core(1.5), 0.4, 4, 6, device="cpu", **kw)
    assert got.dtype == torch.complex128 and got.shape == want.shape
    np.testing.assert_allclose(_umps_observables(got, "torch"),
                               _umps_observables(want, "jax"), atol=TOL)


def test_umps_mpo_evolve_driven_matches_jax():
    """A TFIM field ramp h: 2.0 -> 1.4 (midpoint W^II cores rebuilt each
    step), bond 6: the same state as the JAX package's."""
    def h_core(t):
        return _tfim_core(2.0 - 0.6 * t / 0.4)

    v = np.array([np.cos(0.3), np.sin(0.3)])
    core0 = v[:, None, None]
    seen = []
    want = je.umps_mpo_evolve_driven(jnp.asarray(core0), h_core, 0.4, 4, 6)
    got = te.umps_mpo_evolve_driven(core0, h_core, 0.4, 4, 6, device="cpu",
                                    callback=lambda k, c: seen.append(k))
    assert seen == [0, 1, 2, 3]
    np.testing.assert_allclose(_umps_observables(got, "torch"),
                               _umps_observables(want, "jax"), atol=TOL)


def test_liouvillian_and_automaton_match_jax():
    jh, th = _hams()
    jumps = [(0, 0.4 * SM), (2, 0.3 * Z)]
    bond = [(1, 0.2 * np.kron(SM, SM))]
    jlv = jl.liouvillian_mpo(jh, jumps=jumps, bond_jumps=bond)
    tlv = tl.liouvillian_mpo(th, jumps=jumps, bond_jumps=bond)
    assert tlv.cores.shape[3] == jlv.cores.shape[3]
    _close(_dense_op(*mpo_to_numpy(tlv)), _dense_op(jlv.cores, jlv.left, jlv.right))
    for adjoint in (False, True):
        ja_ = jl.liouvillian_automaton(jh, jumps=jumps, bond_jumps=bond,
                                       adjoint=adjoint)
        ta_ = tl.liouvillian_automaton(th, jumps=jumps, bond_jumps=bond,
                                       adjoint=adjoint)
        for a, b in zip((ja_.cores, ja_.left, ja_.right), mpo_to_numpy(ta_)):
            _close(b, a, 1e-14)


def test_lindblad_evolutions_and_observables_match_jax():
    """RK4 and W^II against the same steps on dense vectors through the JAX
    package's Liouvillian and propagators (truncation never binds at three
    sites), and the observables against the JAX package's own."""
    jh, th = _hams()
    jumps = [0.5 * SM]
    jr, tr = _rho0()
    jlv, tlv = jl.liouvillian_mpo(jh, jumps=jumps), tl.liouvillian_mpo(th, jumps=jumps)
    lv = _dense_op(jlv.cores, jlv.left, jlv.right)
    r = _jd(jr)
    dt = 0.05
    for _ in range(2):
        k1 = lv @ r
        k2 = lv @ (r + 0.5 * dt * k1)
        k3 = lv @ (r + 0.5 * dt * k2)
        k4 = lv @ (r + dt * k3)
        r = r + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    _close(_td(tl.lindblad_evolve(tr, tlv, 2 * dt, 2, max_bond=32)), r)
    la = jl.liouvillian_automaton(jh, jumps=jumps)
    step = _wii_dense(la, 0.1)
    got = tl.lindblad_evolve_wii(tr, th, 0.2, 2, jumps=jumps, max_bond=32)
    _close(_td(got), step @ (step @ _jd(jr)))
    want = _to_jax(got)
    assert abs(tl.density_trace(got) - jl.density_trace(want)) < TOL
    for site in range(N):
        assert abs(tl.density_expectation(got, Z, site)
                   - jl.density_expectation(want, Z, site)) < TOL
    pair = [(0, X), (1, Y)]
    assert abs(tl.density_expectation_multi(got, pair)
               - jl.density_expectation_multi(want, pair)) < TOL
    _close(_td(tl.superop_apply_left(got, X, 2)),
           _jd(jl.superop_apply_left(want, X, 2)))
    # quantum regression: evolve to t1, insert A on the left, trace against B
    kw = dict(n_steps_per_unit=10, jumps=jumps, max_bond=32)
    got = tl.two_time_correlation(tr, th, SM.T, 1, SM, 1, 0.1, [0.0, 0.1], **kw)
    rho1 = step @ _jd(jr)
    sigma = _site(np.kron(SM.T, np.eye(2)), 1) @ rho1
    b_bra = _trace_bra([(1, SM)])
    norm = _trace_bra([]) @ rho1
    _close(got, [b_bra @ sigma / norm, b_bra @ (step @ sigma) / norm])


def test_ness_dmrg_matches_jax_on_shared_draws(monkeypatch):
    jh, th = _hams(0.5 * XXZ)
    jumps = [(0, 0.7 * SM), (N - 1, 0.7 * SM.T)]  # boundary-driven chain
    jlv, tlv = jl.liouvillian_mpo(jh, jumps=jumps), tl.liouvillian_mpo(th, jumps=jumps)
    rng = np.random.default_rng(2)
    shape = (N, 4, 3, 3)
    pert = 1e-2 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    e = rng.standard_normal(3) + 0j

    monkeypatch.setattr(jl.MPS, "random", classmethod(
        lambda cls, *a, **k: cls(jnp.asarray(pert), jnp.asarray(e), jnp.asarray(e))))
    jrho, jres = jl.ness_dmrg(jlv, max_bond=8, sweeps=3)
    mixed = tl._product_bra(N, 2, [], torch.device("cpu"))
    mixed = MPS(mixed.cores / 2, mixed.left, mixed.right)
    start = tcan.mps_add(mixed, mps_from_numpy(pert, e, e, device="cpu"))
    trho, tres = tl.ness_dmrg(tlv, max_bond=8, sweeps=3, mps0=start)
    assert abs(tres ** 2 - jres ** 2) < TOL  # the DMRG energy |L rho|^2
    _close(_td(trho), _jd(jrho), 1e-8)
    # the port's own draw, at a fixed seed: a steady state
    rho, res = tl.ness_dmrg(tlv, max_bond=8, sweeps=3,
                            generator=torch.Generator().manual_seed(0))
    assert res < 1e-6 and abs(tl.density_trace(rho) - 1.0) < TOL


def test_noisy_circuit_matches_jax():
    assert all(np.array_equal(a, b) for a, b in zip(
        jn.depolarizing_kraus(0.1), tn.depolarizing_kraus(0.1)))
    cnot = np.eye(4)[[0, 1, 3, 2]]
    had = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)
    circuits = []
    for mod, kw in ((jn, {}), (tn, {"device": "cpu"})):
        c = mod.NoisyCircuit(N, max_bond=32, **kw)
        c.apply_gate(had, 0).apply_gate2(cnot, 0).apply_gate2(cnot, 1)
        c.apply_channel(mod.depolarizing_kraus(0.1), 1)
        c.apply_channel(mod.amplitude_damping_kraus(0.2), 2)
        c.apply_channel2([np.sqrt(0.9) * np.eye(4), np.sqrt(0.1) * np.kron(Z, Z)], 1)
        c.apply_channel(mod.phase_damping_kraus(0.3), 0)
        circuits.append(c)
    jc, tc = circuits
    assert abs(tc.trace() - jc.trace()) < TOL
    assert abs(tc.purity() - jc.purity()) < TOL
    assert abs(tc.expectation(Z, 2) - jc.expectation(Z, 2)) < TOL
    assert abs(tc.expectation_multi([(0, Z), (1, Z)])
               - jc.expectation_multi([(0, Z), (1, Z)])) < TOL
    mixed = tn.NoisyCircuit(2, init="mixed", device="cpu")
    assert abs(mixed.purity() - 0.25) < TOL
