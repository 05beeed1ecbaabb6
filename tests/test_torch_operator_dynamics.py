"""Heisenberg-picture operator dynamics of the PyTorch port against the JAX
package, on the CPU: vectorized operators, W^II Heisenberg evolution,
OTOCs, operator entropy, operator-space Lanczos, the KPM moment families and
the DAOE dissipator.

Builders compare entry by entry, evolved operators as dense vectors,
scalars, moments and coefficients at 1e-10 (helpers shared with
``test_torch_open_systems.py``).
"""

from importlib import import_module

import numpy as np

from contractn_tpu_torch.convert import mpo_to_numpy, mps_from_numpy
from test_torch_open_systems import (
    MIXED,
    N,
    TOL,
    X,
    Z,
    _close,
    _dense_op,
    _hams,
    _jd,
    _site,
    _td,
    _to_jax,
)

jcheb = import_module("contractn_tpu.models.chebyshev")
jl = import_module("contractn_tpu.models.lindblad")
jo = import_module("contractn_tpu.models.operator_dynamics")
to = import_module("contractn_tpu_torch.models.operator_dynamics")


def test_operator_dynamics_matches_jax():
    jh, th = _hams(MIXED)
    jw = jo.vectorized_operator(N, [(0, Z)])
    tw = to.vectorized_operator(N, [(0, Z)], device="cpu")
    _close(_td(tw), _jd(jw))
    # the JAX package's heisenberg_evolve_wii returns NaN on this host (its
    # own test fails the same way), so the reference applies the JAX
    # package's W^II propagators to the dense vector: the same computation
    # where truncation does not bind
    tev = to.heisenberg_evolve_wii(tw, th, 0.4, 2, jumps=[0.1 * Z], max_bond=32)
    la = jl.liouvillian_automaton(jh, jumps=[0.1 * Z], adjoint=True)
    props = [_dense_op(u.cores, u.left, u.right) for u in jl._wii_props(la, 0.2, 2)]
    want = _jd(jw)
    for _ in range(2):
        want = props[1] @ (props[0] @ want)
    _close(_td(tev), want)
    jev = _to_jax(tev)
    for site in range(N):
        f_t, c_t = to.otoc(tev, X, site)
        f_j, c_j = jo.otoc(jev, X, site)
        assert abs(f_t - f_j) < TOL and abs(c_t - c_j) < TOL
    _close(to.operator_entropy(tev).numpy(), np.asarray(jo.operator_entropy(jev)))
    assert abs(to.operator_overlap(tev, tw) - jo.operator_overlap(jev, jw)) < TOL
    # operator-space Lanczos and the KPM families against the same
    # recursions on dense vectors through the JAX package's operators
    jk, tk = jo.commutator_superop_mpo(jh), to.commutator_superop_mpo(th)
    kd = _dense_op(jk.cores, jk.left, jk.right)
    _close(_dense_op(*mpo_to_numpy(tk)), kd)
    scale = 2.0 ** N
    v = _jd(jo.vectorized_operator(N, [(1, Z)]))
    v = v / np.sqrt(np.vdot(v, v).real / scale)
    prev, bs = None, []
    for _ in range(3):
        w = kd @ v - (bs[-1] * prev if prev is not None else 0)
        bs.append(np.sqrt(np.vdot(w, w).real / scale))
        prev, v = v, w / bs[-1]
    _close(to.lanczos_coefficients(th, [(1, Z)], 3, max_bond=32), bs)
    phases = np.exp(0.5j * np.arange(N))
    _close(_td(to.vectorized_operator_sum(N, Z, phases, device="cpu")),
           _jd(jo.vectorized_operator_sum(N, Z, phases)))
    bounds = (-6.0, 6.0)
    got, a, b = to.liouvillian_kpm_moments(th, tw, 4, bounds, max_bond=32)
    _, ja_, jb_ = jcheb.rescaled_mpo(jk, (-12.0, 12.0))
    assert abs(a - ja_) < TOL and abs(b - jb_) < TOL
    _close(got, _cheb(kd, _jd(jw), a, b, 4) / scale)
    got, a, b = to.dos_kpm_moments(th, 4, bounds, max_bond=32)
    e = np.linalg.eigvalsh(_dense_op(jh.cores, jh.left, jh.right))
    _close(got, [np.mean(np.cos(k * np.arccos((e - b) / a))) for k in range(4)])


def _cheb(op, v, a, b, n):
    """``<v| T_k((op - b)/a) |v>`` for ``k < n`` by the dense recursion."""
    rescaled = (op - b * np.eye(op.shape[0])) / a
    t_prev, t_cur = v, rescaled @ v
    out = [np.vdot(v, t_prev), np.vdot(v, t_cur)]
    for _ in range(2, n):
        t_prev, t_cur = t_cur, 2 * rescaled @ t_cur - t_prev
        out.append(np.vdot(v, t_cur))
    return np.asarray(out[:n])


def test_daoe_and_thermal_kpm_match_jax():
    jh, th = _hams(MIXED)
    jd, td = jo.daoe_mpo(N, 0.3, 1), to.daoe_mpo(N, 0.3, 1, device="cpu")
    for a, b in zip((jd.cores, jd.left, jd.right), mpo_to_numpy(td)):
        _close(b, a, 1e-15)
    jw = jo.vectorized_operator(N, [(1, X)])
    tw = to.vectorized_operator(N, [(1, X)], device="cpu")
    step = [_dense_op(u.cores, u.left, u.right) for u in jl._wii_props(
        jl.liouvillian_automaton(jh, adjoint=True), 0.1, 2)]
    dis = _dense_op(jd.cores, jd.left, jd.right)
    want = _jd(jw)
    for _ in range(2):
        want = dis @ (step[1] @ (step[0] @ want))
    _close(_td(to.daoe_evolve(tw, th, 0.2, 2, 0.3, 1, max_bond=32)), want)
    rng = np.random.default_rng(4)
    cores = rng.standard_normal((N, 4, 3, 3))
    e0 = np.zeros(3)
    e0[0] = 1.0
    purified = mps_from_numpy(cores, e0, e0, device="cpu")
    got, a, b = to.thermal_kpm_moments(th, purified, Z, 1, 4, (-6.0, 6.0),
                                       max_bond=32)
    psi = _td(purified)
    psi = _site(np.kron(Z, np.eye(2)), 1) @ (psi / np.linalg.norm(psi))
    kd = _dense_op(*mpo_to_numpy(to.commutator_superop_mpo(th)))
    _close(got, _cheb(kd, psi, a, b, 4))


def test_commutator_superop_mpo_dtype_matches_jax():
    """``dtype=`` as in the JAX package: the entries are rounded to it and
    the MPO comes in it promoted with float64 (a real dtype gives a real
    MPO, complex64 a complex128 one); cores, left and right agree."""
    import jax.numpy as jnp
    import torch

    jmpo = import_module("contractn_tpu.models.mpo")
    tmpo = import_module("contractn_tpu_torch.models.mpo")
    jh = jmpo.mpo_from_bond_term(MIXED, N)
    th = tmpo.mpo_from_bond_term(MIXED, N, device="cpu")
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.complex64, torch.complex64)):
        jk = jo.commutator_superop_mpo(jh, dtype=jdt)
        tk = to.commutator_superop_mpo(th, dtype=tdt)
        for want, got in zip((jk.cores, jk.left, jk.right), (tk.cores, tk.left, tk.right)):
            assert got.numpy().dtype == np.asarray(want).dtype
            _close(got.numpy(), np.asarray(want))
    assert to.commutator_superop_mpo(th, dtype=torch.float64).cores.dtype == torch.float64
    assert to.commutator_superop_mpo(th).cores.dtype == torch.complex128
