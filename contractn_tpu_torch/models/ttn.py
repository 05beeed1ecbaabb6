"""Binary tree tensor networks (TTN): ground states and observables.

Counterpart of ``contractn_tpu/models/ttn.py``.  A balanced binary tree of
isometries over ``n = 2^L`` sites, held as one stacked tensor per level
(every block on a level has the same shape), so a level's renormalization is
one batched einsum and a whole evaluation is ``L`` of them.  TTNs contract
exactly (no loops).

Any MPO flows UP the tree as a block operator ``E[w_l, w_r, a, a']`` (open
operator-bond indices at the block edges, renormalized bra/ket indices):
leaves absorb two MPO cores, internal levels contract the shared middle
operator bond of their children, the root closes with the MPO boundary
vectors.  Norm blocks flow the same way, so the energy is a Rayleigh
quotient that never assumes isometric gauge, and the gradient ground state
(:func:`ttn_ground_state`) is a plain unconstrained Adam descent.  The
sweeped alternative (:func:`ttn_dmrg`) keeps every tensor isometric toward
the orthogonality center and walks the center along the tree in a
depth-first Euler tour, replacing each tensor by the Lanczos ground state of
its effective Hamiltonian.

Departures: :func:`random_ttn`, :func:`ttn_ground_state` and :func:`ttn_dmrg`
take ``generator=`` (a ``torch.Generator``) where the JAX functions take a
key; without one they draw from a fresh generator seeded 0, so a call
without a generator is reproducible.  :func:`random_ttn` and
:func:`product_mpo` take ``device=`` (default ``cuda``; ``random_ttn``
defaults to the generator's device when one is given).  The descent runs
optax's ``adam(cosine_decay_schedule(lr, steps, alpha=0.01))`` written out
(:class:`~..ops.optim.Adam`, the schedule evaluated at the update count
before increment) on torch's gradient, which for complex parameters already
is the conjugate of JAX's.
"""

import math

import numpy as np
import torch

from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .mpo import MPO


def _level_dims(n_sites, d, chi):
    """Per-level output bond dims: saturate at ``chi``."""
    n_levels = int(np.log2(n_sites))
    if 2 ** n_levels != n_sites or n_levels < 2:
        raise ValueError("TTN needs n_sites a power of two, >= 4")
    dims = []
    cur = d
    for _ in range(n_levels - 1):
        out = min(cur * cur, chi)
        dims.append(out)
        cur = out
    return dims  # len L-1; top joins two `dims[-1]` bonds


def _generator(generator, device):
    """``generator``, or a fresh one seeded 0 on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _normal(shape, dtype, generator):
    """Standard-normal draw on the generator's device (the one random source
    of :func:`random_ttn`)."""
    return torch.randn(shape, dtype=dtype, device=generator.device, generator=generator)


def random_ttn(n_sites, d, chi, dtype=torch.float64, generator=None, device=None):
    """Random isometric TTN: ``{"levels": [w_l], "top": t}`` with ``w_l``
    stacked ``(blocks, in, in, out)`` isometries and ``t`` the ``(c, c)``
    root matrix (normalized)."""
    dtype = torch_dtype(dtype)
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    generator = _generator(generator, device)
    dims = _level_dims(n_sites, d, chi)
    levels = []
    cur = d
    blocks = n_sites // 2
    for out in dims:
        q, _ = torch.linalg.qr(_normal((blocks, cur * cur, out), dtype, generator).to(device))
        levels.append(q.reshape(blocks, cur, cur, out))
        cur = out
        blocks //= 2
    top = _normal((cur, cur), dtype, generator).to(device)
    return {"levels": levels, "top": top / torch.linalg.norm(top)}


def _pairs(x):
    """A level's stack ``(2 B, ...)`` as its ``(B, ...)`` left and right
    children."""
    x = x.reshape(x.shape[0] // 2, 2, *x.shape[1:])
    return x[:, 0], x[:, 1]


def _mpo_blocks(params, mpo):
    """Flow the MPO up the tree; returns the root's two children ``(e_left,
    e_right)`` of shape ``(W, W, c, c)`` each."""
    c1, c2 = _pairs(mpo.cores)
    w = params["levels"][0]
    e = path_einsum("nsta,nsSpq,ntTqr,nSTb->nprab", w.conj(), c1, c2, w)
    for w in params["levels"][1:]:
        el, er = _pairs(e)
        e = path_einsum("nxya,npqxX,nqryY,nXYb->nprab", w.conj(), el, er, w)
    return e[0], e[1]


def _norm_blocks(params):
    w = params["levels"][0]
    n = peinsum("nsta,nstb->nab", w.conj(), w)
    for w in params["levels"][1:]:
        nl, nr = _pairs(n)
        n = path_einsum("nxya,nxX,nyY,nXYb->nab", w.conj(), nl, nr, w)
    return n[0], n[1]


def ttn_expectation(params, mpo):
    """``<psi| MPO |psi> / <psi|psi>`` by the log-depth block flow (no
    isometric-gauge assumption); a 0-d tensor."""
    el, er = _mpo_blocks(params, mpo)
    top = params["top"]
    num = path_einsum("p,r,xy,pqxX,qryY,XY->", mpo.left, mpo.right, top.conj(), el, er, top)
    nl, nr = _norm_blocks(params)
    den = path_einsum("xy,xX,yY,XY->", top.conj(), nl, nr, top)
    return num / den


def ttn_energy(params, h_mpo):
    """Rayleigh-quotient energy (real part; Hermitian MPOs only)."""
    return torch.real(ttn_expectation(params, h_mpo))


def product_mpo(n, site_ops, d=2, dtype=torch.complex128, device=None):
    """Product of one-site operators (identity elsewhere) as a bond-1 MPO —
    the observable container for :func:`ttn_expectation`; on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    eye = np.eye(d)
    cores = np.broadcast_to(eye[None, :, :, None, None], (n, d, d, 1, 1)).copy()
    for site, op in site_ops:
        if isinstance(op, torch.Tensor):
            op = op.detach().cpu().numpy()
        cores[site, :, :, 0, 0] = np.asarray(op)
    one = torch.ones((1,), dtype=dtype, device=device)
    return MPO(as_tensor(cores, device, dtype), one, one)


def _cosine_decay(lr, steps, count, alpha=0.01):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``count``."""
    count = min(count, steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / steps)) + alpha)


def _optimize(params, h_mpo, steps, lr):
    from ..ops.optim import Adam, descend

    leaves = [p.detach().clone().requires_grad_(True)
              for p in params["levels"] + [params["top"]]]
    opt = Adam(leaves, lr=lr)
    energies = []
    for k in range(steps):
        e = ttn_energy({"levels": leaves[:-1], "top": leaves[-1]}, h_mpo)
        opt.param_groups[0]["lr"] = _cosine_decay(lr, steps, k)
        descend(opt, leaves, torch.autograd.grad(e, leaves))
        energies.append(e.detach())
    out = {"levels": [t.detach() for t in leaves[:-1]], "top": leaves[-1].detach()}
    return out, torch.stack(energies)


def ttn_ground_state(h_mpo, chi, generator=None, steps=3000, lr=0.02, d=None):
    """Variational TTN ground state of an MPO Hamiltonian: ``steps`` Adam
    steps on the Rayleigh quotient with a cosine learning-rate decay; the
    tree is not gauge-constrained during descent (the quotient is
    scale-free).

    Returns ``(params, energies)`` with ``energies`` the per-step values, a
    tensor on the device (read once, by the caller).
    """
    cores = h_mpo.cores
    n = cores.shape[0]
    if d is None:
        d = cores.shape[1]
    generator = _generator(generator, cores.device)
    params = random_ttn(n, d, chi, dtype=cores.dtype, generator=generator,
                        device=cores.device)
    return _optimize(params, h_mpo, int(steps), float(lr))


# -- sweeped eigensolves (TTN-DMRG) ------------------------------------ #

def _leaf_block(w, c1, c2):
    return path_einsum("sta,sSpq,tTqr,STb->prab", w.conj(), c1, c2, w)


def _node_block(w, el, er):
    return path_einsum("xya,pqxX,qryY,XYb->prab", w.conj(), el, er, w)


def _node_matvec(el, er, up, theta):
    """``H_eff theta`` for an internal/leaf tensor ``(x, y, o)``: children
    blocks on the first two legs, up-environment on the third.  For leaves,
    ``el``/``er`` are the two MPO cores in the ``(p, m, x, X)`` block
    layout."""
    t = peinsum("pmxX,XYO->pmxYO", el, theta)
    t = peinsum("mqyY,pmxYO->pqxyO", er, t)
    return peinsum("pqoO,pqxyO->xyo", up, t)


def _core_as_block(c):
    """MPO core ``(d_out, d_in, p, q)`` -> block layout ``(p, q, x, X)``
    (bra index = output leg)."""
    return c.permute(2, 3, 0, 1)


def _lq_rows(mat):
    """``mat = L Q`` with orthonormal ROWS of ``Q``."""
    q, r = torch.linalg.qr(mat.conj().T)
    return r.conj().T, q.conj().T


def _child_upenv(up, sib_block, w, side):
    """Up-environment of a child given the parent's up-env, the sibling's
    block, and the (already isometrized) parent tensor."""
    t = peinsum("pqoO,XYO->pqXYo", up, w)
    if side == "left":
        t = peinsum("mqyY,pqXYo->pmXyo", sib_block, t)
        return peinsum("xyo,pmXyo->pmxX", w.conj(), t)
    t = peinsum("pmxX,pqXYo->mqxYo", sib_block, t)
    return peinsum("xyo,mqxYo->mqyY", w.conj(), t)


def ttn_dmrg(h_mpo, chi, generator=None, sweeps=4, lanczos_iters=24, d=None):
    """Ground state by sweeped local eigensolves (TTN-DMRG).

    Returns ``(params, energies)`` with one energy per sweep (the root
    solve's eigenvalue — variational, non-increasing), host floats.
    """
    from ..ops.krylov import lanczos_ground

    cores = h_mpo.cores
    n = cores.shape[0]
    if d is None:
        d = cores.shape[1]
    generator = _generator(generator, cores.device)
    params = random_ttn(n, d, chi, dtype=cores.dtype, generator=generator,
                        device=cores.device)
    levels = [list(lv.unbind(0)) for lv in params["levels"]]
    top = params["top"]
    n_lv = len(levels)
    lvec = h_mpo.left.to(cores.dtype)
    rvec = h_mpo.right.to(cores.dtype)
    pair = cores.reshape(n // 2, 2, *cores.shape[1:])

    def block_at(lv, b):
        if lv == 0:
            return _leaf_block(levels[0][b], pair[b, 0], pair[b, 1])
        return _node_block(levels[lv][b], blocks[lv - 1][2 * b], blocks[lv - 1][2 * b + 1])

    blocks = [[None] * len(levels[lv]) for lv in range(n_lv)]
    for lv in range(n_lv):
        for b in range(len(levels[lv])):
            blocks[lv][b] = block_at(lv, b)

    def children_blocks(lv, b):
        if lv == 0:
            return _core_as_block(pair[b, 0]), _core_as_block(pair[b, 1])
        return blocks[lv - 1][2 * b], blocks[lv - 1][2 * b + 1]

    def descend(lv, b, up):
        """Center at node (lv, b): optimize, recurse, exit with the node
        isometric toward its parent, returning the R factor."""
        el, er = children_blocks(lv, b)
        _, theta = lanczos_ground(lambda t: _node_matvec(el, er, up, t), levels[lv][b],
                                  lanczos_iters)
        levels[lv][b] = theta
        if lv > 0:
            # left child: isometrize this node w.r.t. (y, o)
            x_dim, y_dim, o_dim = theta.shape
            lmat, q = _lq_rows(theta.reshape(x_dim, y_dim * o_dim))
            levels[lv][b] = q.reshape(x_dim, y_dim, o_dim)
            levels[lv - 1][2 * b] = peinsum("xyo,ok->xyk", levels[lv - 1][2 * b], lmat)
            up_l = _child_upenv(up, blocks[lv - 1][2 * b + 1], levels[lv][b], "left")
            r = descend(lv - 1, 2 * b, up_l)
            blocks[lv - 1][2 * b] = block_at(lv - 1, 2 * b)
            levels[lv][b] = peinsum("kx,xyo->kyo", r, levels[lv][b])
            # right child: isometrize w.r.t. (x, o)
            theta = levels[lv][b]
            lmat, q = _lq_rows(theta.permute(1, 0, 2).reshape(theta.shape[1], -1))
            levels[lv][b] = q.reshape(theta.shape[1], theta.shape[0],
                                      theta.shape[2]).permute(1, 0, 2)
            levels[lv - 1][2 * b + 1] = peinsum("xyo,ok->xyk", levels[lv - 1][2 * b + 1],
                                                lmat)
            up_r = _child_upenv(up, blocks[lv - 1][2 * b], levels[lv][b], "right")
            r = descend(lv - 1, 2 * b + 1, up_r)
            blocks[lv - 1][2 * b + 1] = block_at(lv - 1, 2 * b + 1)
            levels[lv][b] = peinsum("ky,xyo->xko", r, levels[lv][b])
        # exit: QR toward the parent
        theta = levels[lv][b]
        q, r = torch.linalg.qr(theta.reshape(-1, theta.shape[2]))
        levels[lv][b] = q.reshape(theta.shape[0], theta.shape[1], -1)
        blocks[lv][b] = block_at(lv, b)
        return r  # (k, o_old): the caller contracts Sum_o R[k, o]

    energies = []
    for _ in range(sweeps):
        elc = peinsum("p,pqxX->qxX", lvec, blocks[-1][0])
        erc = peinsum("qryY,r->qyY", blocks[-1][1], rvec)

        def top_matvec(t, elc=elc, erc=erc):
            return peinsum("qyY,qxY->xy", erc, peinsum("qxX,XY->qxY", elc, t))

        energy, top = lanczos_ground(top_matvec, top, lanczos_iters)
        energies.append(float(np.real(energy)))
        # left subtree
        lmat, top = _lq_rows(top)
        levels[-1][0] = peinsum("xyo,ok->xyk", levels[-1][0], lmat)
        m = path_einsum("qryY,r,xy,XY->qxX", blocks[-1][1], rvec, top.conj(), top)
        r = descend(n_lv - 1, 0, peinsum("p,qxX->pqxX", lvec, m))
        blocks[-1][0] = block_at(n_lv - 1, 0)
        top = peinsum("kx,xy->ky", r, top)
        # right subtree
        top, r2 = torch.linalg.qr(top)
        levels[-1][1] = peinsum("xyo,ok->xyk", levels[-1][1], r2.T)
        m2 = path_einsum("p,pqxX,xy,XY->qyY", lvec, blocks[-1][0], top.conj(), top)
        r = descend(n_lv - 1, 1, peinsum("qyY,r->qryY", m2, rvec))
        blocks[-1][1] = block_at(n_lv - 1, 1)
        top = peinsum("ky,xy->xk", r, top)
        top = top / torch.linalg.norm(top)
    return {"levels": [torch.stack(lv) for lv in levels], "top": top}, energies


def ttn_inner(pa, pb):
    """Overlap ``<psi_a|psi_b>`` of two same-shape TTNs by the log-depth mixed
    block flow (no gauge assumption on either tree); a 0-d tensor."""
    m = peinsum("nsta,nstb->nab", pa["levels"][0].conj(), pb["levels"][0])
    for wa, wb in zip(pa["levels"][1:], pb["levels"][1:]):
        ml, mr = _pairs(m)
        m = path_einsum("nxya,nxX,nyY,nXYb->nab", wa.conj(), ml, mr, wb)
    return path_einsum("xy,xX,yY,XY->", pa["top"].conj(), m[0], m[1], pb["top"])


def ttn_to_dense(params, d=None):
    """Dense state vector (little lattices only) — the oracle for the
    block-flow machinery in tests.  ``d`` is accepted as in the JAX package
    and not needed."""
    # expand downward from the root matrix, replacing each bond by the two
    # child bonds of the isometry below it
    state = params["top"]
    for w in reversed(params["levels"]):
        dtype = torch.promote_types(state.dtype, w.dtype)
        state, w = state.to(dtype), w.to(dtype)
        for b in reversed(range(w.shape[0])):
            state = torch.tensordot(state, w[b], dims=([b], [2]))
            # the contracted axis appends (in, in) at the end; move it home
            state = torch.movedim(state, (-2, -1), (b, b + 1))
    return state.reshape(-1)
