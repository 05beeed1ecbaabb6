"""Fermionic PEPS in the PyTorch port (``fswap``, ``fipeps``,
``fipeps_spin``) against the JAX package, Fock-space oracles and stacked
chains, on the CPU.

The host numpy parts (the sign rule, the Fock matrices, the dense
evaluators, the random states) are the port's own copies and are held equal
to the JAX package's.  The boundary contractions reproduce the Fock bridge
to 1e-12; the fermionized double layers reproduce the stacked-chain anchors
(decoupled uniform chains whose energies come from dense transfer matrices,
the JAX tests' oracles) to 1e-9.  One value and gradient of the
differentiable finite-lattice energy and of the iPEPS loss are held to JAX's
``value_and_grad`` at 1e-10; the Hubbard losses' gradients to central
differences.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from tests.test_fipeps import _chain_reference as kitaev_chain
from tests.test_fipeps_spin import _chain_reference as hubbard_chain
from tests.test_fipeps_spin import _chain_tensor, _dimer_chain_reference

jf = import_module("contractn_tpu.models.fswap")
jfi = import_module("contractn_tpu.models.fipeps")
jfs = import_module("contractn_tpu.models.fipeps_spin")
tf = import_module("contractn_tpu_torch.models.fswap")
tfi = import_module("contractn_tpu_torch.models.fipeps")
tfs = import_module("contractn_tpu_torch.models.fipeps_spin")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
BP = np.array([0, 1])
PARS = (BP,) * 4
TRIV = np.zeros(1, np.int64)
SP = np.array([[0.0, 0.0], [1.0, 0.0]])
SM = SP.T


def _fipeps_start():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2,) * 5) * tfi.parity_mask_site(PARS, device=CPU).numpy()


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    tens, ph, pv = jf.random_fpeps(2, 1, seed=1)
    e, g = jax.jit(jax.value_and_grad(lambda ts: jf.fpeps_energy_diff(
        ts, ph, pv, 4, t=1.0, mu=0.0, delta=0.4)))([[jnp.asarray(x) for x in row]
                                                     for row in tens])
    a = _fipeps_start()
    env = tfi.fipeps_env(torch.from_numpy(a), PARS, 4, iters=3)
    loss = jfi.make_fipeps_loss(PARS, 4, t=1.0, mu=-1.0, delta=0.5, refresh_iters=0,
                                grad_iters=0)
    (ef, _), gf = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        a, jax.tree_util.tree_map(lambda t: t.numpy(), env))
    return {"e": float(e), "g": [[np.asarray(x) for x in row] for row in g], "env": env,
            "ef": float(ef), "gf": np.asarray(gf)}


def test_host_parts_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for (ly, lx) in [(2, 2), (3, 3), (2, 4)]:
        for _ in range(40):
            ph = [[int(rng.integers(0, 2)) for _ in range(lx - 1)] for _ in range(ly)]
            pv = [[int(rng.integers(0, 2)) for _ in range(lx)] for _ in range(ly - 1)]
            nb = [[((ph[r][c - 1] if c > 0 else 0) + (ph[r][c] if c < lx - 1 else 0)
                    + (pv[r - 1][c] if r > 0 else 0) + (pv[r][c] if r < ly - 1 else 0)) % 2
                   for c in range(lx)] for r in range(ly)]
            want = jf.fpeps_sign_oracle(ly, lx, nb, ph, pv)
            assert tf.fpeps_sign(ly, lx, ph, pv) == want == tf.fpeps_sign_oracle(
                ly, lx, nb, ph, pv)
    tn, ph, pv = tf.random_fpeps(2, 3, bond_parities=(0, 1, 1), seed=4)
    jtn, _, _ = jf.random_fpeps(2, 3, bond_parities=(0, 1, 1), seed=4)
    for row, jrow in zip(tn, jtn):
        for t, jt in zip(row, jrow):
            np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(tf.fpeps_amplitudes_dense(tn, ph, pv),
                                  jf.fpeps_amplitudes_dense(tn, ph, pv))
    np.testing.assert_array_equal(tf.hopping_fock_matrix(2, 2, 1.0, 0.3, 0.4),
                                  jf.hopping_fock_matrix(2, 2, 1.0, 0.3, 0.4))
    np.testing.assert_array_equal(tfs.hubbard_fock_rowmajor(1, 2, 1.0, 3.0, 0.5, 0.2),
                                  jfs.hubbard_fock_rowmajor(1, 2, 1.0, 3.0, 0.5, 0.2))
    np.testing.assert_array_equal(tfs.hubbard_op4(1.0, 0.3), jfs.hubbard_op4(1.0, 0.3))
    assert tf.fpeps_expectation_sweep(tn, ph, pv) == pytest.approx(
        float(jf.fpeps_norm_sweep(tn, ph, pv)), rel=1e-13)
    np.testing.assert_array_equal(
        tfs.neel_dimer_init(seed=2)[0], jfs.neel_dimer_init(seed=2)[0])
    assert tfi.bdg_energy_2d(1.0, -4.4, 1.0) == jfi.bdg_energy_2d(1.0, -4.4, 1.0)


@pytest.mark.parametrize("ly,lx,seed,t,mu,delta", [(3, 3, 2, 1.0, 0.3, 0.6),
                                                   (2, 3, 1, 1.0, 0.7, 0.4)])
def test_boundary_energy_matches_fock(ly, lx, seed, t, mu, delta):
    tn, ph, pv = tf.random_fpeps(ly, lx, seed=seed)
    psi = tf.fock_state(tn, ph, pv)
    h = tf.hopping_fock_matrix(ly, lx, t=t, mu=mu, delta=delta)
    want = float(psi @ (h @ psi)) / float(psi @ psi)
    assert abs(tf.fpeps_energy(tn, ph, pv, t=t, mu=mu, delta=delta, device=CPU) - want) < 1e-12
    got = tf.fpeps_energy_diff([[torch.from_numpy(x) for x in row] for row in tn], ph, pv,
                               chi=32, t=t, mu=mu, delta=delta)
    assert abs(float(got) - want) < 1e-12


def test_correlator_at_range_matches_fock():
    ly, lx = 3, 3
    tn, ph, pv = tf.random_fpeps(ly, lx, seed=2)
    psi = tf.fock_state(tn, ph, pv)
    for sa, sb in [((0, 0), (2, 2)), ((1, 1), (1, 1))]:
        ops = tf._jw_string_ops(lx, sa, sb, "pdm") if sa != sb else {sa: np.diag([0.0, 1.0])}
        mats = [ops.get((k // lx, k % lx), np.eye(2)) for k in range(ly * lx)]
        op = mats[0]
        for m in mats[1:]:
            op = np.kron(op, m)
        want = float(psi @ (op @ psi)) / float(psi @ psi)
        assert abs(tf.fpeps_correlator(tn, ph, pv, sa, sb, device=CPU) - want) < 1e-12


def test_differentiable_energy_and_gradient_match_jax(ref):
    tens, ph, pv = tf.random_fpeps(2, 1, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_(True) for row in tens for x in row]
    # mu 0: the hopping and pairing terms only (the on-site terms' values are
    # held to Fock above; each term costs the JAX reference a boundary sweep)
    e = tf.fpeps_energy_diff([leaves[:1], leaves[1:]], ph, pv, 4, t=1.0, mu=0.0, delta=0.4)
    grads = torch.autograd.grad(e, leaves)
    assert abs(float(e) - ref["e"]) < TOL
    for got, want in zip(grads, [x for row in ref["g"] for x in row]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_fipeps_loss_and_gradient_match_jax(ref):
    a = torch.from_numpy(_fipeps_start()).requires_grad_(True)
    loss = tfi.make_fipeps_loss(PARS, 4, t=1.0, mu=-1.0, delta=0.5, refresh_iters=0,
                                grad_iters=0)
    e, _ = loss(a, ref["env"])
    (g,) = torch.autograd.grad(e, a)
    assert abs(float(e) - ref["ef"]) < TOL
    np.testing.assert_allclose(g.numpy(), ref["gf"], rtol=0, atol=TOL)


def _chain_site(seed, d, pushes):
    rng = np.random.default_rng(seed)
    par = np.arange(d) % 2 if d == 2 else tfs.PHYS_PAR
    m = 0.35 * rng.standard_normal((d, 2, 2)) if d == 2 else 0.3 * rng.standard_normal(
        (d, 2, 2))
    for n in range(d):
        for l_ in range(2):
            for r in range(2):
                if (par[n] + BP[l_] + BP[r]) % 2:
                    m[n, l_, r] = 0.0
    for idx, v in pushes:
        m[idx] += v
    return m


def _oriented(m, orient):
    if orient == "h":
        return torch.from_numpy(m[:, None, :, None, :].copy()), (TRIV, BP, TRIV, BP)
    return torch.from_numpy(m[:, :, None, :, None].copy()), (BP, TRIV, BP, TRIV)


@pytest.mark.parametrize("orient", ["h", "v"])
def test_stacked_chain_anchors(orient):
    """Spinless and spinful sites on decoupled uniform chains: every term
    kind, both bond sign rules, inside the converged environment."""
    m = _chain_site(3, 2, [((0, 0, 0), 1.0), ((1, 0, 1), 0.8)])
    want_e, want_n = kitaev_chain(m, BP, 1.0, 0.4, 0.6)
    a, pars = _oriented(m, orient)
    got_e, got_n = tfi.fipeps_energy(a, pars, chi=8, t=1.0, mu=0.4, delta=0.6, iters=40)
    assert abs(got_e - want_e) < 1e-9 and abs(got_n - want_n) < 1e-9
    m4 = _chain_site(11, 4, [((0, 0, 0), 1.0), ((1, 0, 1), 0.6), ((2, 0, 1), 0.5),
                             ((3, 0, 0), 0.4)])
    want = hubbard_chain(m4, BP, 1.0, 3.0, 0.4, 0.5)
    a4, pars = _oriented(m4, orient)
    got_e, obs = tfs.hubbard_ipeps_energy(a4, pars, chi=8, t=1.0, u=3.0, mu=0.4, delta=0.5,
                                          iters=40)
    assert abs(got_e - want[0]) < 1e-9
    assert abs(obs["n_up"] - want[1]) < 1e-9 and abs(obs["docc"] - want[3]) < 1e-9


def test_row_correlator_on_stacked_chains():
    """<c^d_0 c_r> through the row-string rule == the chain transfer value
    with explicit Jordan-Wigner parity insertions."""
    m = _chain_site(3, 2, [((0, 0, 0), 1.0), ((1, 0, 1), 0.8)])
    z = np.diag([1.0, -1.0])
    mabs = m * ((-1.0) ** (BP[None, :, None] * BP[None, None, :]))

    def tmat(op):
        return np.einsum("nlr,nm,mLR->lLrR", mabs, op, mabs).reshape(4, 4)

    w, vr = np.linalg.eig(tmat(np.eye(2)))
    i = np.argmax(np.abs(w))
    lam, rv = w[i].real, vr[:, i].real
    wl, vl = np.linalg.eig(tmat(np.eye(2)).T)
    lv = vl[:, np.argmax(np.abs(wl))].real
    a, pars = _oriented(m, "h")
    env = tfi.fipeps_env(a, pars, chi=8, iters=40)
    got = tfi.fipeps_correlator(a, pars, env, SP, SM, [1, 3])
    for k, r in enumerate([1, 3]):
        acc = tmat(SP)
        for _ in range(r - 1):
            acc = acc @ tmat(z)
        want = (lv @ (acc @ tmat(SM)) @ rv) / (lam ** (r + 1) * (lv @ rv))
        assert abs(got[k] - want) < 1e-9


def test_cell_measure_on_dimerized_chains():
    """The one-patch-per-bond cell measurement (open legs, summed op4) on
    decoupled two-site-cell chains == the dense transfer-matrix value."""
    rng = np.random.default_rng(23)
    ma = _chain_tensor(rng, BP, [((0, 0, 0), 1.0), ((1, 0, 1), 0.6), ((2, 0, 1), 0.5),
                                 ((3, 0, 0), 0.4)])
    mb = _chain_tensor(rng, BP, [((0, 0, 0), 1.0), ((2, 0, 1), 0.7), ((3, 0, 0), 0.3)])
    want = _dimer_chain_reference(ma, mb, BP, 1.0, 3.0, 0.4, 0.5)
    a, pars = _oriented(ma, "h")
    b, _ = _oriented(mb, "h")
    got, obs = tfs.hubbard_cell_energy(((a, a), (b, b)), pars, chi=8, t=1.0, u=3.0, mu=0.4,
                                       delta=0.5, iters=40)
    assert abs(got - want) < 1e-9
    assert abs(obs["n_up"][0][0] - obs["n_up"][1][0]) > 1e-4


@pytest.mark.parametrize("cell", [False, True])
def test_hubbard_loss_gradients_match_differences(cell):
    """One value and gradient of each Hubbard loss, fully differentiated
    (no untaped refresh; svd_safe through one CTMRG iteration), against
    central differences."""
    rng = np.random.default_rng(5)
    mask = tfi.parity_mask_site(PARS, d=4, phys_par=tfs.PHYS_PAR, device=CPU)
    draw = lambda: torch.from_numpy(rng.normal(size=(4,) + (2,) * 4)) * mask  # noqa: E731
    if cell:
        params = [draw(), draw()]
        loss = tfs.make_hubbard_cell_loss(PARS, 4, u=8.0, mu=4.0, refresh_iters=0,
                                          grad_iters=1)
        env = tfs.hubbard_cell_env(((params[0], params[1]), (params[1], params[0])), PARS,
                                   4, iters=3)
    else:
        params = [draw()]
        loss = tfs.make_hubbard_loss(PARS, 4, u=4.0, mu=1.0, delta=0.3, refresh_iters=0,
                                     grad_iters=1)
        env = tfi.ctmrg_cell(((tfi.fdouble(params[0], PARS),),), 4, iters=3)
    arg = (lambda ps: ps) if cell else (lambda ps: ps[0])
    leaves = [p.clone().requires_grad_(True) for p in params]
    e, _ = loss(arg(leaves), env)
    grads = torch.autograd.grad(e, leaves)
    dirs = [torch.from_numpy(rng.normal(size=p.shape)) * mask for p in params]
    h = 1e-5
    with torch.no_grad():
        fd = (float(loss(arg([p + h * d for p, d in zip(params, dirs)]), env)[0])
              - float(loss(arg([p - h * d for p, d in zip(params, dirs)]), env)[0])) / (2 * h)
    dd = sum(float((g * d).sum()) for g, d in zip(grads, dirs))
    assert abs(dd - fd) < 1e-6 * max(1.0, abs(fd))


def test_hubbard_cell_correlator_matches_jax():
    """The checkerboard row correlators of the spinful fermionic cell (the
    staggered ``<Sz_0 Sz_r>`` of ``examples/hubbard_ipeps.py``), on shared
    random parity-masked sites: the environments are held through the
    gauge-invariant correlators, connected and not, at 1e-10."""
    rng = np.random.default_rng(29)
    mask = tfi.parity_mask_site(PARS, d=4, phys_par=tfs.PHYS_PAR, device=CPU).numpy()
    a, b = (rng.normal(size=(4,) + (2,) * 4) * mask for _ in range(2))
    sz = np.asarray(jfs.SZ)
    assert np.array_equal(np.asarray(tfs.SZ), sz)
    jsites = ((a, b), (b, a))
    tsites = tuple(tuple(torch.from_numpy(s) for s in col) for col in jsites)
    jenv = jfs.hubbard_cell_env(jsites, PARS, 4, iters=12)
    tenv = tfs.hubbard_cell_env(tsites, PARS, 4, iters=12)
    for connected in (True, False):
        want = jfs.hubbard_cell_correlator(jsites, PARS, jenv, sz, sz, [1, 2, 3],
                                           connected=connected)
        got = tfs.hubbard_cell_correlator(tsites, PARS, tenv, sz, sz, [1, 2, 3],
                                          connected=connected)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-12)

