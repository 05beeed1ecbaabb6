"""MERA: multiscale entanglement renormalization (ternary, scale-invariant).

Counterpart of ``contractn_tpu/models/mera.py``.  The ternary MERA
(Evenbly-Vidal) coarse-grains an infinite critical chain by alternating
layers of disentanglers ``u`` (unitaries on the block-boundary pairs) and
isometries ``w`` (three fine sites -> one coarse).  A per-site two-site
Hamiltonian term ascends through a layer as a sum of three two-site
diagrams ``A(h) = A_L(h) + A_C(h) + A_R(h)``, and ``A(I) = 3 I`` exactly.
A stack of transitional layers lifts the physical dimension to ``chi``;
above them one scale-invariant ``(u, w)`` pair repeats forever, and its
fixed-point density matrix ``rho*`` closes the energy
``e = Tr(rho* A_{L-1}(...A_0(h))) / 3^L``.

* **The descending superoperator is never written.**  It is the adjoint of
  the ascending one: :func:`_descend` is ``torch.func.vjp`` of
  :func:`_ascend` with respect to its input, which for this linear map is
  its exact transpose (the JAX package's ``jax.linear_transpose``).  One set
  of diagrams, and ``Tr(D(rho) h) == Tr(rho A(h)) / 3`` by construction.
* **Environments are never derived by hand.**  The Evenbly-Vidal
  linearized update needs the environment of each tensor with the rest
  frozen: ``torch.autograd.grad`` of the layer energy with the density
  matrix and the ascended Hamiltonian detached.
* A sweep (ascend tower, warm fixed-point power iteration, descend tower,
  polar updates for every tensor) runs on the device with static shapes;
  the host only counts sweeps.  The scale-invariant layer's superoperator
  is formed once a sweep as a matrix, the same diagrams applied to the whole
  basis at once (:func:`_ascend_matrix`), so its 20 power-iteration steps
  (its transpose) and the Hamiltonian tower are small matrix products.  Real tensors only (the JAX module's
  contract: real symmetric ``h2``).

Departure: :func:`mera_ground_state` and :func:`expand_mera` draw their
random isometries from ``generator=`` (a ``torch.Generator`` on the
Hamiltonian's device) where the JAX package takes a key.
"""

import numpy as np
import torch

from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, resolve_device


# --------------------------------------------------------------------- #
# Superoperators
# --------------------------------------------------------------------- #


def _ascend(h4, u, w):
    """One-layer ascent of a per-site two-site term.

    ``h4 (m,m,m,m)`` as ``[out1, out2, in1, in2]``; ``u (m,m,m,m)`` as
    ``[pre1, pre2, post1, post2]``; ``w (M, m, m, m)`` maps the coarse index
    to the block's three fine slots.  Returns the coarse ``(M,M,M,M)``
    term; an ``h4`` with a leading batch axis ascends every member at once.
    """
    b = "Z" if h4.ndim == 5 else ""
    a_l = path_einsum(f"cxyp,dqmn,pqrs,{b}tesm,PQrt,CxyP,DQen->{b}CDcd",
                      w, w, u, h4, u, w, w)
    a_c = path_einsum(f"cqyk,dlzw,klrs,{b}RSrs,KLRS,CqyK,DLzw->{b}CDcd",
                      w, w, u, h4, u, w, w)
    a_r = path_einsum(f"cqmk,dlzw,klrs,{b}MRmr,KLRs,CqMK,DLzw->{b}CDcd",
                      w, w, u, h4, u, w, w)
    return a_l + a_c + a_r


def _descend(rho4, u, w):
    """Average two-site density one layer down: ``(1/3) A^T(rho)``, the
    vector-Jacobian product of the (linear) :func:`_ascend` in its first
    argument."""
    m = u.shape[0]
    example = torch.zeros((m, m, m, m), dtype=rho4.dtype, device=rho4.device)
    _, pullback = torch.func.vjp(lambda h: _ascend(h, u, w), example)
    (out,) = pullback(rho4)
    return out / 3.0


def _ascend_matrix(u, w):
    """The ascending superoperator of one layer as a matrix ``J (M^4,
    m^4)``, ``A(h) = J h``: :func:`_ascend` of the whole basis of ``h`` in
    one batched contraction of the same diagrams.  Its transpose is the
    descent (``D(rho) = J^T rho / 3``, what :func:`_descend` computes as a
    vector-Jacobian product).

    A power iteration applies the scale-invariant layer's descent 20 times a
    sweep; with ``J`` each application is one small matrix product instead
    of a backward pass through the three diagrams (the sweep is
    launch-bound on the card)."""
    m = u.shape[0]
    basis = torch.eye(m ** 4, dtype=w.dtype, device=w.device).reshape(
        m ** 4, m, m, m, m)
    return _ascend(basis, u, w).reshape(m ** 4, -1).T


def _descend_normalized(rho, jmat):
    """One power-iteration step of the scale-invariant descent (``jmat``
    from :func:`_ascend_matrix`): symmetrized and trace-normalized."""
    chi = rho.shape[0]
    mat = (rho.reshape(-1) @ jmat).reshape(chi * chi, chi * chi) / 3.0
    rho = (0.5 * (mat + mat.T)).reshape(chi, chi, chi, chi)
    return rho / peinsum("abab->", rho)


def _fixed_density(u, w, iters):
    """Fixed point of the scale-invariant descent (power iteration)."""
    chi = w.shape[0]
    # [o1,o2,i1,i2]: reshaped identity is already delta_oi delta_oi.
    rho = torch.eye(chi * chi, dtype=w.dtype, device=w.device).reshape(
        chi, chi, chi, chi) / (chi * chi)
    jmat = _ascend_matrix(u, w)
    for _ in range(int(iters)):
        rho = _descend_normalized(rho, jmat)
    return rho


def _trace_pair(rho4, h4):
    """``Tr(rho h)`` for two-site operators in ``[o1,o2,i1,i2]``."""
    return peinsum("abcd,cdab->", rho4, h4)


# --------------------------------------------------------------------- #
# Energy
# --------------------------------------------------------------------- #


def _split4(mat, m):
    return mat.reshape(m, m, m, m)


def mera_energy(params, h2, rho_iters=80):
    """Variational energy per site of ``H = sum_i h2_{i,i+1}`` (a host
    float)."""
    w_s = params["w_s"]
    h2 = as_tensor(h2, w_s.device, w_s.dtype)
    h = _split4(h2, int(np.sqrt(h2.shape[0])))
    for u, w in zip(params["u"], params["w"]):
        h = _ascend(h, u, w)
    rho = _fixed_density(params["u_s"], w_s, rho_iters)
    return float(_trace_pair(rho, h)) / 3 ** len(params["u"])


# --------------------------------------------------------------------- #
# Evenbly-Vidal optimization
# --------------------------------------------------------------------- #


def _polar_update(env, out_rows):
    """Minimizer of ``Tr(X Env)`` over isometries with orthonormal rows in
    the ``(out_rows, -1)`` matricization: ``X = -U V^T``."""
    uu, _, vv = torch.linalg.svd(env.reshape(out_rows, -1), full_matrices=False)
    return -(uu @ vv).reshape(env.shape)


def _env(fn, x):
    """Gradient of the scalar ``fn(x)`` at ``x``: the environment of ``x``
    with everything else frozen."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x), x)
    return g


def _update_layer(u, w, rho_up, h_dn):
    """One Evenbly-Vidal update of ``(u, w)`` against fixed ``rho`` above
    and ``h`` below (environments by autodiff, both detached)."""
    rho_up, h_dn = rho_up.detach(), h_dn.detach()
    m = u.shape[0]
    u = _polar_update(_env(lambda x: _trace_pair(rho_up, _ascend(h_dn, x, w)), u),
                      m * m)
    w = _polar_update(_env(lambda x: _trace_pair(rho_up, _ascend(h_dn, u, x)), w),
                      w.shape[0])
    return u, w


def _si_hamiltonian(h, jmat, k_acc):
    """Scale-invariant accumulated Hamiltonian ``sum_k A_s^k(h) / 3^k``
    (``jmat`` from :func:`_ascend_matrix`)."""
    out = h
    term = h
    for _ in range(k_acc):
        term = (jmat @ term.reshape(-1)).reshape(h.shape) / 3.0
        out = out + term
    return out


def _sweep(params, h0, rho, k_acc, rho_warm):
    """One optimization sweep; returns ``(params, rho, energy)`` with the
    energy a 0-d tensor on the device."""
    n_layers = len(params["u"])
    # Up: ascended Hamiltonians under each transitional layer.
    hs = [h0]
    for u, w in zip(params["u"], params["w"]):
        hs.append(_ascend(hs[-1], u, w))
    # Warm fixed point at the top.
    jmat = _ascend_matrix(params["u_s"], params["w_s"])
    for _ in range(rho_warm):
        rho = _descend_normalized(rho, jmat)
    # Scale-invariant update against the accumulated Hamiltonian.
    h_acc = _si_hamiltonian(hs[-1], jmat, k_acc)
    u_s, w_s = _update_layer(params["u_s"], params["w_s"], rho, h_acc)
    # Down: densities for each transitional layer, updating as we go.
    new_u, new_w = list(params["u"]), list(params["w"])
    rho_l = rho
    for layer in range(n_layers - 1, -1, -1):
        new_u[layer], new_w[layer] = _update_layer(new_u[layer], new_w[layer],
                                                   rho_l, hs[layer])
        rho_l = _descend(rho_l, new_u[layer], new_w[layer])
    out = {"u": new_u, "w": new_w, "u_s": u_s, "w_s": w_s}
    return out, rho, _trace_pair(rho, hs[-1]) / 3 ** n_layers


def _random_isometry(out_dim, in_dim, dtype, device, generator):
    mat = torch.randn((in_dim, out_dim), dtype=dtype, device=device,
                      generator=generator)
    q, _ = torch.linalg.qr(mat)
    return q.T  # (out, in) with orthonormal rows


def _eye4(m, dtype, device):
    return torch.eye(m * m, dtype=dtype, device=device).reshape(m, m, m, m)


def mera_ground_state(h2, chi, d=2, sweeps=800, rho_iters=20, k_acc=8,
                      dtype=torch.float64, generator=None, init=None):
    """Optimize a scale-invariant ternary MERA for the infinite chain.

    Args:
        h2: real symmetric two-site term ``(d^2, d^2)`` (e.g.
            :func:`~.itebd.tfim_h2`); a torch ``h2`` sets the device, a
            numpy one goes to ``cuda``.
        chi: bond dimension of the scale-invariant layer.  Two transitional
            layers lift ``d -> min(d^3, chi) -> chi``.
        sweeps: Evenbly-Vidal sweeps (each updates every tensor once).
        rho_iters: warm power-iteration steps per sweep for ``rho*``.
        k_acc: terms kept in the scale-invariant Hamiltonian tower.
        generator: ``torch.Generator`` on the device for the random
            isometries (default: a fresh one seeded with 0).
        init: warm-start params (e.g. from :func:`expand_mera` for a chi
            ramp); must already have this ``chi``.

    Returns:
        ``(params, energy)``; ``params`` holds transitional ``u``/``w``
        lists plus the scale-invariant ``u_s``/``w_s``; ``energy`` is a host
        float.
    """
    device = resolve_device(None, (h2,))
    h2 = as_tensor(h2, device, torch.float64)
    # Negative-definite shift: polar updates minimize only when the
    # ascended Hamiltonian is <= 0; the shift is added back at the end.
    h_host = h2.cpu().numpy()
    lam = float(np.linalg.eigvalsh(h_host)[-1])
    h0 = _split4(torch.from_numpy(h_host - lam * np.eye(h_host.shape[0])).to(
        device, dtype), d)

    chi1 = min(d ** 3, chi)
    if chi > chi1 ** 3:
        raise ValueError(f"chi {chi} unreachable from d {d} in two layers")
    if init is not None:
        if init["w_s"].shape[0] != chi:
            raise ValueError("init params have chi "
                             f"{init['w_s'].shape[0]}, expected {chi}")
        params = init
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params = {
            "u": [_eye4(d, dtype, device), _eye4(chi1, dtype, device)],
            "w": [_random_isometry(chi1, d ** 3, dtype, device, generator
                                   ).reshape(chi1, d, d, d),
                  _random_isometry(chi, chi1 ** 3, dtype, device, generator
                                   ).reshape(chi, chi1, chi1, chi1)],
            "u_s": _eye4(chi, dtype, device),
            "w_s": _random_isometry(chi, chi ** 3, dtype, device, generator
                                    ).reshape(chi, chi, chi, chi),
        }
    rho = _fixed_density(params["u_s"], params["w_s"], 100)
    energy = None
    for _ in range(int(sweeps)):
        params, rho, energy = _sweep(params, h0, rho, k_acc, rho_iters)
    return params, float(energy) + lam


def _ascend_site_central(o, w):
    """One-site ascent through the CENTER slot of ``w`` (the slot no
    disentangler touches) — the one-site scaling superoperator."""
    return path_einsum("axiy,ij,bxjy->ab", w, o, w)


def _rho_one_site(rho4):
    """Average one-site density from the two-site one."""
    return 0.5 * (peinsum("abcb->ac", rho4) + peinsum("abad->bd", rho4))


def _site_operator(params, op, rho_iters):
    w_s = params["w_s"]
    op = as_tensor(op, w_s.device, w_s.dtype)
    for w in params["w"]:
        op = _ascend_site_central(op, w)
    rho = _fixed_density(params["u_s"], w_s, rho_iters)
    return op, rho, _rho_one_site(rho)


def mera_site_expectation(params, op, rho_iters=80):
    """One-site expectation ``<op>`` in the MERA state (a host float)."""
    op, _, rho1 = _site_operator(params, op, rho_iters)
    return float(peinsum("ab,ba->", rho1, op))


def mera_correlator(params, op, kmax=6, rho_iters=80):
    """Two-point correlators ``<op(x) op(x + 3^k)>`` for ``k >= L``.

    Sites central in their block at every level ascend through the one-site
    scaling superoperator alone; two such sites ``3^k`` apart land on
    ADJACENT coarse sites after ``k`` layers, where the scale-invariant
    two-site density evaluates them.  Returns ``(distances, values)`` as
    numpy arrays for ``k = L .. kmax``.
    """
    op, rho, rho1 = _site_operator(params, op, rho_iters)
    n_layers = len(params["u"])

    def connected(o):
        # Project out the identity channel (lambda = 1).
        return o - peinsum("ab,ba->", rho1, o) * torch.eye(
            o.shape[0], dtype=o.dtype, device=o.device)

    op = connected(op)
    dists, vals = [], []
    for k in range(n_layers, kmax + 1):
        if k > n_layers:
            op = connected(_ascend_site_central(op, params["w_s"]))
        dists.append(3 ** k)
        vals.append(float(path_einsum("abcd,ca,db->", rho, op, op)))
    return np.asarray(dists), np.asarray(vals)


def _embed_unitary(u, m_new):
    """Embed a unitary ``(m,m,m,m)`` into ``(m',m',m',m')``: the old block
    acts on the old product subspace, identity on its complement."""
    m = u.shape[0]
    if m == m_new:
        return u
    big = _eye4(m_new, u.dtype, u.device).clone()
    big[:m, :m, :m, :m] = u
    return big


def _embed_isometry(w, out_new, in_new_dims, generator):
    """Embed an isometry ``(out, i1, i2, i3)`` into larger fine/coarse
    dimensions: old rows zero-pad (still orthonormal); new coarse rows are
    random vectors orthonormalized against them."""
    out_old = w.shape[0]
    in_new = int(np.prod(in_new_dims))
    old = torch.zeros((out_old, *in_new_dims), dtype=w.dtype, device=w.device)
    old[:, :w.shape[1], :w.shape[2], :w.shape[3]] = w
    old = old.reshape(out_old, in_new)
    if out_new == out_old:
        return old.reshape(out_old, *in_new_dims)
    extra = torch.randn((out_new - out_old, in_new), dtype=w.dtype,
                        device=w.device, generator=generator)
    # Project out the old rows, then orthonormalize the remainder.
    extra = extra - (extra @ old.T) @ old
    q, _ = torch.linalg.qr(extra.T)
    return torch.cat([old, q.T], dim=0).reshape(out_new, *in_new_dims)


def expand_mera(params, chi, d=2, generator=None):
    """Warm-start a larger-``chi`` MERA from a converged smaller one (the
    embedding is exact: the enlarged MERA represents the same state).
    ``generator``: ``torch.Generator`` on the params' device (default: a
    fresh one seeded with 17)."""
    device = params["w_s"].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(17)
    chi1 = min(d ** 3, chi)
    return {
        "u": [params["u"][0], _embed_unitary(params["u"][1], chi1)],
        "w": [_embed_isometry(params["w"][0], chi1, (d, d, d), generator),
              _embed_isometry(params["w"][1], chi, (chi1, chi1, chi1),
                              generator)],
        "u_s": _embed_unitary(params["u_s"], chi),
        "w_s": _embed_isometry(params["w_s"], chi, (chi, chi, chi), generator),
    }


def scaling_dimensions(params, n=8):
    """Scaling dimensions from the scale-invariant isometry (host numpy):
    ``-log_3`` of the leading eigenvalues of the one-site scaling
    superoperator ``S[(a,b),(c,d)] = sum_{x,y} w[a,x,c,y] w[b,x,d,y]``."""
    w = params["w_s"].detach().cpu().numpy()
    s = np.einsum("axcy,bxdy->abcd", w, w)
    chi = w.shape[0]
    vals = np.linalg.eigvals(s.reshape(chi * chi, chi * chi))
    vals = np.sort(np.abs(vals))[::-1][:n]
    return -np.log(np.maximum(vals, 1e-300)) / np.log(3.0)
