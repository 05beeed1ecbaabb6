"""TDVP time evolution on binary tree tensor networks.

Counterpart of ``contractn_tpu/models/ttn_tdvp.py``.  The projector-splitting
TDVP integrator generalized from chains to trees (the recursive tree
integrator of Ceruti, Lubich & Walach, SIAM J. Numer. Anal. 59, 2021, in its
sweep formulation, Bauernfeind & Aichhorn, SciPost Phys. 8, 024).  One half
sweep evolves, per subtree and bottom-up,

    gauge down -> recurse into the child subtree -> QR the child up
    -> evolve the bond matrix BACKWARD -> absorb into the parent,

then the node tensor FORWARD: every node forward once, every bond backward
once, the chain-TDVP1 bookkeeping at log depth.  The second half sweep
applies the adjoint ordering (node first, children in reverse), giving the
palindromic second-order integrator.  On the saturated manifold (``chi`` =
full Hilbert space) one step is exact; at truncated ``chi`` real time
conserves norm and energy to integrator order.

Every local operation (Krylov exponentials through
:func:`~.tdvp._krylov_expm_apply`, QR/LQ gauge moves, block recomputations)
runs on the tree's device; the tree walk is host Python over the static
structure, as in :func:`~.ttn.ttn_dmrg`.  Effective Hamiltonians are never
materialized (matvec closures over the block / up-environment tensors).
"""

import torch

from ..ops.stabilize import path_einsum, peinsum
from .tdvp import _krylov_expm_apply
from .ttn import (
    _child_upenv,
    _core_as_block,
    _leaf_block,
    _lq_rows,
    _node_block,
    _node_matvec,
    ttn_energy,
)


def _evolve_node(iters, el, er, up, theta, coef):
    """``exp(coef * H_eff) theta`` for a tree node ``(x, y, o)``."""
    return _krylov_expm_apply(lambda t: _node_matvec(el, er, up, t), theta, coef, iters)


def _evolve_bond(iters, block, up, r, coef):
    """``exp(coef * K) r`` for a bond matrix ``r (child_bond, parent_leg)``:
    ``K(r)[k, o] = block[p, q, k, K] up[p, q, o, O] r[K, O]``, the child's
    renormalized MPO block closed against the child's up-environment."""
    def mv(x):
        return peinsum("pqkK,pqoK->ko", block, peinsum("pqoO,KO->pqoK", up, x))

    return _krylov_expm_apply(mv, r, coef, iters)


def _evolve_top(iters, elc, erc, top, coef):
    """``exp(coef * H_eff) top`` for the root matrix ``(x, y)``."""
    def mv(t):
        return peinsum("qyY,qxY->xy", erc, peinsum("qxX,XY->qxY", elc, t))

    return _krylov_expm_apply(mv, top, coef, iters)


class _Sweeper:
    """Mutable sweep state: per-node tensors and cached MPO blocks.  Every
    method keeps "center on entry == center on exit"."""

    def __init__(self, params, h_mpo, iters):
        cores = h_mpo.cores
        self.n = cores.shape[0]
        self.pair = cores.reshape(self.n // 2, 2, *cores.shape[1:])
        self.lvec = h_mpo.left.to(cores.dtype)
        self.rvec = h_mpo.right.to(cores.dtype)
        self.levels = [list(lv.unbind(0)) for lv in params["levels"]]
        self.top = params["top"]
        self.n_lv = len(self.levels)
        self.iters = iters
        self.blocks = [[None] * len(self.levels[lv]) for lv in range(self.n_lv)]
        for lv in range(self.n_lv):
            for b in range(len(self.levels[lv])):
                self.blocks[lv][b] = self._block_at(lv, b)

    # -- block bookkeeping ------------------------------------------- #

    def _block_at(self, lv, b):
        if lv == 0:
            return _leaf_block(self.levels[0][b], self.pair[b, 0], self.pair[b, 1])
        return _node_block(self.levels[lv][b], self.blocks[lv - 1][2 * b],
                           self.blocks[lv - 1][2 * b + 1])

    def _children_blocks(self, lv, b):
        if lv == 0:
            return _core_as_block(self.pair[b, 0]), _core_as_block(self.pair[b, 1])
        return self.blocks[lv - 1][2 * b], self.blocks[lv - 1][2 * b + 1]

    # -- gauge moves (no evolution) ---------------------------------- #

    def _gauge_down(self, lv, b, side):
        """Isometrize node (lv, b) away from the given child; returns
        ``(child, bond, sibling block)`` with ``bond`` the ``(child_bond,
        parent_leg)`` matrix NOT yet absorbed."""
        theta = self.levels[lv][b]
        x, y, o = theta.shape
        if side == "left":
            bond, q = _lq_rows(theta.reshape(x, y * o))
            self.levels[lv][b] = q.reshape(-1, y, o)
            return 2 * b, bond, self.blocks[lv - 1][2 * b + 1]
        bond, q = _lq_rows(theta.permute(1, 0, 2).reshape(y, x * o))
        self.levels[lv][b] = q.reshape(-1, x, o).permute(1, 0, 2)
        return 2 * b + 1, bond, self.blocks[lv - 1][2 * b]

    def _absorb_into_child(self, lv, child, bond):
        self.levels[lv - 1][child] = peinsum("xyo,ok->xyk", self.levels[lv - 1][child], bond)

    def _qr_child_up(self, lv, child):
        """QR the child toward its parent; refreshes the child's block and
        returns the ``(child_bond, parent_leg)`` matrix."""
        theta = self.levels[lv - 1][child]
        q, r = torch.linalg.qr(theta.reshape(-1, theta.shape[2]))
        self.levels[lv - 1][child] = q.reshape(theta.shape[0], theta.shape[1], -1)
        self.blocks[lv - 1][child] = self._block_at(lv - 1, child)
        return r

    def _absorb_into_parent(self, lv, b, side, bond):
        if side == "left":
            self.levels[lv][b] = peinsum("kx,xyo->kyo", bond, self.levels[lv][b])
        else:
            self.levels[lv][b] = peinsum("ky,xyo->xko", bond, self.levels[lv][b])

    # -- half sweeps -------------------------------------------------- #

    def _fwd(self, lv, b, up, coef):
        """Children subtrees (with backward bond moves on the way up), then
        the node forward — the first-order ordering."""
        if lv > 0:
            for side in ("left", "right"):
                child, bond, sib = self._gauge_down(lv, b, side)
                self._absorb_into_child(lv, child, bond)
                up_c = _child_upenv(up, sib, self.levels[lv][b], side)
                self._fwd(lv - 1, child, up_c, coef)
                r = self._qr_child_up(lv, child)
                r = _evolve_bond(self.iters, self.blocks[lv - 1][child], up_c, r, -coef)
                self._absorb_into_parent(lv, b, side, r)
        el, er = self._children_blocks(lv, b)
        self.levels[lv][b] = _evolve_node(self.iters, el, er, up, self.levels[lv][b], coef)

    def _bwd(self, lv, b, up, coef):
        """Adjoint ordering: node forward first, children in reverse with
        backward bond moves on the way DOWN."""
        el, er = self._children_blocks(lv, b)
        self.levels[lv][b] = _evolve_node(self.iters, el, er, up, self.levels[lv][b], coef)
        if lv > 0:
            for side in ("right", "left"):
                child, bond, sib = self._gauge_down(lv, b, side)
                up_c = _child_upenv(up, sib, self.levels[lv][b], side)
                bond = _evolve_bond(self.iters, self.blocks[lv - 1][child], up_c, bond, -coef)
                self._absorb_into_child(lv, child, bond)
                self._bwd(lv - 1, child, up_c, coef)
                r = self._qr_child_up(lv, child)
                self._absorb_into_parent(lv, b, side, r)

    # -- top-level (root matrix) moves -------------------------------- #

    def _top_gauge_down(self, side):
        """Isometrize the root matrix away from the given child; returns
        ``(child, bond (child_bond, parent_leg))``."""
        if side == "left":
            bond, self.top = _lq_rows(self.top)
            return 0, bond
        self.top, r = torch.linalg.qr(self.top)
        return 1, r.T

    def _top_upenv(self, side):
        if side == "left":
            m = path_einsum("qryY,r,xy,XY->qxX", self.blocks[-1][1], self.rvec,
                            self.top.conj(), self.top)
            return peinsum("p,qxX->pqxX", self.lvec, m)
        m = path_einsum("p,pqxX,xy,XY->qyY", self.lvec, self.blocks[-1][0],
                        self.top.conj(), self.top)
        return peinsum("qyY,r->qryY", m, self.rvec)

    def _top_absorb(self, side, bond):
        if side == "left":
            self.top = peinsum("kx,xy->ky", bond, self.top)
        else:
            self.top = peinsum("ky,xy->xk", bond, self.top)

    def _evolve_top_node(self, coef):
        elc = peinsum("p,pqxX->qxX", self.lvec, self.blocks[-1][0])
        erc = peinsum("qryY,r->qyY", self.blocks[-1][1], self.rvec)
        self.top = _evolve_top(self.iters, elc, erc, self.top, coef)

    def half_step_fwd(self, coef):
        for side in ("left", "right"):
            child, bond = self._top_gauge_down(side)
            self._absorb_into_child(self.n_lv, child, bond)
            up_c = self._top_upenv(side)
            self._fwd(self.n_lv - 1, child, up_c, coef)
            r = self._qr_child_up(self.n_lv, child)
            r = _evolve_bond(self.iters, self.blocks[-1][child], up_c, r, -coef)
            self._top_absorb(side, r)
        self._evolve_top_node(coef)

    def half_step_bwd(self, coef):
        self._evolve_top_node(coef)
        for side in ("right", "left"):
            child, bond = self._top_gauge_down(side)
            up_c = self._top_upenv(side)
            bond = _evolve_bond(self.iters, self.blocks[-1][child], up_c, bond, -coef)
            self._absorb_into_child(self.n_lv, child, bond)
            self._bwd(self.n_lv - 1, child, up_c, coef)
            r = self._qr_child_up(self.n_lv, child)
            self._top_absorb(side, r)

    def params(self):
        return {"levels": [torch.stack(lv) for lv in self.levels], "top": self.top}


def ttn_tdvp_step(h_mpo, params, dt, imaginary=False, iters=16):
    """One symmetric second-order TDVP step on a binary TTN.

    ``params`` is the :func:`~.ttn.random_ttn` dict; the tree need not be
    isometric on entry (the first gauge moves canonicalize it), and comes
    back center-at-root with every level isometric.  Real time evolves by
    ``exp(-i dt H)`` (the tree promoted to complex); ``imaginary=True`` by
    ``exp(-dt H)`` with the norm restored at the end of the step.
    """
    coef = (-dt if imaginary else -1j * dt) / 2.0
    if not imaginary:
        def promote(a):
            return a.to(torch.promote_types(a.dtype, torch.complex64))

        params = {"levels": [promote(w) for w in params["levels"]],
                  "top": promote(params["top"])}
    sw = _Sweeper(params, h_mpo, iters)
    sw.half_step_fwd(coef)
    sw.half_step_bwd(coef)
    if imaginary:
        sw.top = sw.top / torch.linalg.norm(sw.top)
    return sw.params()


def ttn_tdvp_evolve(h_mpo, params, dt, n_steps, imaginary=False, iters=16, observe=None):
    """Evolve a TTN by ``n_steps`` TDVP steps of size ``dt``.

    ``observe(params) -> value`` is called after every step (default: the
    :func:`~.ttn.ttn_energy` Rayleigh quotient as a host float).  Returns
    ``(params, values)``.
    """
    if observe is None:
        def observe(p):
            return float(ttn_energy(p, h_mpo))
    values = []
    for _ in range(int(n_steps)):
        params = ttn_tdvp_step(h_mpo, params, dt, imaginary=imaginary, iters=iters)
        values.append(observe(params))
    return params, values
