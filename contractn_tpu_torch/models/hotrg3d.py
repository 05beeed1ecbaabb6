"""HOTRG on the cubic lattice: 3D classical partition functions.

Counterpart of ``contractn_tpu/models/hotrg3d.py``.  Extends :mod:`.hotrg`
to three dimensions (Xie et al., PRB 86, 045139, Sec. IV): one step merges
two site tensors along the current vertical axis, truncates BOTH transverse
pair-bonds (x and y) with isometries from the merged tensor's one-sided
density matrices, then rotates the lattice cyclically (z -> x -> y) so every
axis is coarse-grained in turn.  After ``k`` steps one tensor stands for
``2^k`` sites.

* **Zero-padded static bonds.**  The site tensor is padded to ``(chi,)*6``
  up front and the flow is one loop of static shapes; null eigenvectors of
  the density matrices (zeroed outright by the live mask) keep the padding
  exactly zero.
* **O(chi^11) flops, O(chi^8) peak memory.**  The chi^10 merged tensor is
  never built.  The merge is the JAX package's chain of two-operand GEMMs,
  in its order: the bottom tensor eats the x-isometry and the top tensor the
  y-isometry (chi^7 operands), ONE chi^11 GEMM joins them into a chi^8
  product, which is regrouped and freed before the tail GEMM absorbs the
  two remaining isometries at once.  The peak is the product and its
  regrouped copy, two chi^8 buffers (17 GB each at chi 16 in float32).  No
  multi-operand einsum touches the merge: another order materializes the
  chi^10 tensor.
* **IEEE GEMMs.**  Every product goes through
  :func:`~..ops.stabilize.pmatmul` or :func:`~..ops.stabilize.peinsum`,
  which refuse to run float32 while TF32 is enabled.
* **Split format rides the flow** (``g -> 2 g + log c`` per merge).
* The four candidate density matrices of a step go through ONE batched
  ``eigh`` (:func:`~..ops.linalg_ad.dense_eigh`: on the CPU, MKL's
  eigensolver fails on the zero-padded degenerate spectra the padding
  creates, and numpy's LAPACK takes the matrix); the axis choice is a
  device-side ``torch.where``.

The differentiable flow (:func:`hotrg3d_log_z_diff`) detaches the isometries
(frozen projectors, as in 2D) and differentiates the rest with
``torch.autograd``; the other flows run under ``torch.no_grad()``, so a
caller's ``requires_grad`` tensor does not make autograd keep every chi^8
buffer.  ``jax.lax.optimization_barrier`` (XLA fusion control) has no
counterpart and is dropped.

Axis convention: ``a[u, l, d, r, f, k]`` — ``u/d`` the merge (z) axis,
``l/r`` the x axis, ``f/k`` ("front/back") the y axis.

Departure: the functions that build from host values
(:func:`ising3d_tensor_smooth`, :func:`ising3d_internal_energy_ad`) take
``device=`` (default: ``beta``'s device if it is a tensor, else ``cuda``).
"""

import torch

from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum, pmatmul
from ..utils.device import as_tensor
from .hotrg import _beta_tensor, _isometry, _site


def _site_like(t, a):
    return as_tensor(t, a.device, a.dtype)


def _pad6(a, chi):
    pad = []
    for s in reversed(a.shape):
        pad += [0, chi - s]
    return torch.nn.functional.pad(a, pad)


def _density_pair3(top, bot):
    """x-bond density matrix of the (never-built) vertical pair,
    ``rho[(l1 l2), (l1' l2')]`` summed over every other leg of ``top *_m
    bot``: two chi^8-flop Gram GEMMs glued over ``(m, m')``."""
    chi = top.shape[0]
    # h1[(l m), (L M)] = sum_{u r f k} top[u,l,m,r,f,k] top[u,L,M,r,f,k]
    t2 = top.permute(1, 2, 0, 3, 4, 5).reshape(chi * chi, chi ** 4)
    h1 = pmatmul(t2, t2.T)
    # h2[(l m), (L M)] = sum_{d r f k} bot[m,l,d,r,f,k] bot[M,L,d,r,f,k]
    b2 = bot.permute(1, 0, 2, 3, 4, 5).reshape(chi * chi, chi ** 4)
    h2 = pmatmul(b2, b2.T)
    # glue over (m, M): both halves regrouped to (l L) x (m M)
    h1 = h1.reshape(chi, chi, chi, chi).permute(0, 2, 1, 3)
    h2 = h2.reshape(chi, chi, chi, chi).permute(0, 2, 1, 3)
    rho = pmatmul(h1.reshape(chi * chi, chi * chi), h2.reshape(chi * chi, chi * chi).T)
    # [(l1 L1), (l2 L2)] -> [(l1 l2), (L1 L2)]
    rho = rho.reshape(chi, chi, chi, chi).permute(0, 2, 1, 3)
    return rho.reshape(chi * chi, chi * chi)


def _isometry_batched(rhos, chi):
    """Top-``chi`` eigenbases of a ``(4, n, n)`` PSD stack by one batched
    eigh; returns ``(u3s (4, chi, chi, chi), errs (4,))``.  Kept columns with
    numerically zero eigenvalue are zeroed (see ``hotrg._isometry``)."""
    rhos = 0.5 * (rhos + rhos.transpose(1, 2))
    vals, vecs = dense_eigh(rhos)
    keep = torch.argsort(-vals, dim=1, stable=True)[:, :chi]
    kept = torch.gather(vals, 1, keep)
    errs = vals.abs().sum(dim=1) - kept.abs().sum(dim=1)
    u = torch.gather(vecs, 2, keep[:, None, :].expand(-1, vecs.shape[1], -1))
    live = kept > 1e-13 * torch.clamp(vals.abs().amax(dim=1, keepdim=True), min=1e-300)
    u = u * live[:, None, :].to(u.dtype)
    return u.reshape(4, chi, chi, chi), errs


def _swap_lr(a):
    return a.permute(0, 3, 2, 1, 4, 5)


def _to_y(a):
    """Bring the y pair (f, k) into the (l, r) slots: (u,f,d,k,l,r)."""
    return a.permute(0, 4, 2, 5, 1, 3)


def _apply_pair3(top, bot, u3x, u3y):
    """Truncated vertical merge ``U_x^T U_y^T (top *_m bot) U_x U_y``;
    ``u3x[a, b, l]`` eats (top x-leg ``a``, bot x-leg ``b``)."""
    return _apply_pair3_gen(top, bot, u3x, u3x, u3y, u3y)


def _apply_pair3_gen(top, bot, u3x_l, u3x_r, u3y_f, u3y_k):
    """The merge with per-slot isometries (four distinct bond classes on a
    checkerboard lattice; the uniform flow passes the same one twice per
    axis), as the JAX package's chain of 2-D GEMMs in its order."""
    chi = top.shape[0]
    # q1: bot's x-leg b eats the x-isometry -> (a l) x (m f2 d r2 k2)
    botp = bot.permute(1, 0, 4, 2, 3, 5)  # b, m, f2, d, r2, k2
    xal = u3x_l.permute(0, 2, 1).reshape(chi * chi, chi)
    q1 = pmatmul(xal, botp.reshape(chi, chi ** 5))
    # regroup -> (f2 a m) x (l d r2 k2)
    qg = q1.reshape(chi, chi, chi, chi, chi ** 3).permute(3, 0, 2, 1, 4)
    qg = qg.reshape(chi ** 3, chi ** 4)
    del q1
    # top's y-leg c eats the y-isometry -> (u r1 k1 a m) x (f2 y)
    topp = top.permute(0, 3, 5, 1, 2, 4)  # u, r1, k1, a, m, c
    topy = pmatmul(topp.reshape(chi ** 5, chi), u3y_f.reshape(chi, chi * chi))
    # regroup -> (u r1 k1 y) x (f2 a m)
    tg = topy.reshape(chi ** 3, chi * chi, chi, chi).permute(0, 3, 2, 1)
    tg = tg.reshape(chi ** 4, chi ** 3)
    del topy
    # the chi^11 GEMM: (chi^4, chi^3) @ (chi^3, chi^4)
    rm = pmatmul(tg, qg)  # (u r1 k1 y) x (l d r2 k2)
    del tg, qg
    # regroup (u y l d) x (r1 k1 r2 k2) and free the product before the tail:
    # the peak stays at two chi^8 buffers
    rg = rm.reshape(chi, chi * chi, chi, chi * chi, chi * chi).permute(0, 2, 3, 1, 4)
    rg = rg.reshape(chi ** 4, chi ** 4)
    del rm
    # both tail isometries at once against W[(r1 k1 r2 k2), (n p)]
    w = peinsum("rwn,kxp->rkwxnp", u3x_r, u3y_k)
    out = pmatmul(rg, w.reshape(chi ** 4, chi * chi))
    del rg
    out = out.reshape((chi,) * 6)  # u, y, l, d, n (new r), p
    return out.permute(0, 2, 3, 4, 1, 5)  # (u, l, d, r, f, k)


def _rot3(a):
    """Cycle the lattice axes z -> x -> y: new (u,l,d,r,f,k) = old (l, f,
    r, k, u, d)."""
    return a.permute(1, 4, 3, 5, 0, 2)


def _merge_step3(a, imp, chi, frozen_proj=False):
    """One vertical merge + axis rotation; the impurity position-averaged.
    The four candidate density matrices share one batched eigh."""
    am = _swap_lr(a)
    ay = _to_y(a)
    aym = _swap_lr(ay)
    rhos = torch.stack([_density_pair3(a, a), _density_pair3(am, am),
                        _density_pair3(ay, ay), _density_pair3(aym, aym)])
    u3s, errs = _isometry_batched(rhos, chi)
    u3x = torch.where(errs[0] <= errs[1], u3s[0], u3s[1])
    u3y = torch.where(errs[2] <= errs[3], u3s[2], u3s[3])
    if frozen_proj:
        u3x, u3y = u3x.detach(), u3y.detach()
    a_new = _apply_pair3(a, a, u3x, u3y)
    imp_new = 0.5 * (_apply_pair3(imp, a, u3x, u3y) + _apply_pair3(a, imp, u3x, u3y))
    c = torch.clamp(a_new.abs().mean(), min=1e-300)
    err = torch.minimum(errs[0], errs[1]) + torch.minimum(errs[2], errs[3])
    return _rot3(a_new / c), _rot3(imp_new / c), torch.log(c), err


def _closure3(a):
    """Periodic one-tensor closure ``sum a[u, l, u, l, f, f]``."""
    return peinsum("ululff->", a)


def _hotrg3_flow(a0, imp0, chi, steps, frozen_proj=False):
    c0 = torch.clamp(a0.abs().mean(), min=1e-300)
    a, imp, g = a0 / c0, imp0 / c0, torch.log(c0)
    errs = []
    for _ in range(int(steps)):
        a, imp, log_c, err = _merge_step3(a, imp, chi, frozen_proj)
        g = 2.0 * g + log_c
        errs.append(err)
    tr_a = _closure3(a)
    log_z = (g + torch.log(tr_a.abs())) / (2.0 ** steps)
    return log_z, _closure3(imp) / tr_a, errs


def hotrg3d_log_z(a, chi, steps=25):
    """``log(partition function per site)`` of the infinite cubic lattice
    built from site tensor ``a`` with legs ``(u,l,d,r,f,k)``; a host float."""
    a0 = _pad6(_site(a), chi)
    with torch.no_grad():
        log_z, _, _ = _hotrg3_flow(a0, a0, chi, int(steps))
    return float(log_z)


def hotrg3d_expectation(a, impurity, chi, steps=25):
    """One-site impurity average ``<impurity>`` on the infinite cubic lattice
    (position-averaged impurity flow sharing the pure tensor's isometries
    and normalization)."""
    a = _site(a)
    impurity = _site_like(impurity, a)
    with torch.no_grad():
        _, ratio, _ = _hotrg3_flow(_pad6(a, chi), _pad6(impurity, chi), chi, int(steps))
    return float(ratio)


def hotrg3d_bond_expectation(a, imp_top, imp_bot, chi, steps=25):
    """Nearest-neighbor pair expectation ``<O_i O_j>`` on a vertical (z-axis)
    bond: the first merge contracts the two impure tensors into ONE coarse
    impurity (pinned pair, no position averaging) sharing the pure tensor's
    isometries and normalization; it then flows as a one-site impurity."""
    a = _site(a)
    chi = int(chi)
    a0 = _pad6(a, chi)
    t0 = _pad6(_site_like(imp_top, a), chi)
    b0 = _pad6(_site_like(imp_bot, a), chi)
    with torch.no_grad():
        c0 = torch.clamp(a0.abs().mean(), min=1e-300)
        a0, t0, b0 = a0 / c0, t0 / c0, b0 / c0
        am = _swap_lr(a0)
        u3x = _min_iso(_density_pair3(a0, a0), _density_pair3(am, am), chi)
        ay = _to_y(a0)
        aym = _swap_lr(ay)
        u3y = _min_iso(_density_pair3(ay, ay), _density_pair3(aym, aym), chi)
        a1 = _apply_pair3(a0, a0, u3x, u3y)
        i1 = _apply_pair3(t0, b0, u3x, u3y)
        c = torch.clamp(a1.abs().mean(), min=1e-300)
        _, ratio, _ = _hotrg3_flow(_rot3(a1 / c), _rot3(i1 / c), chi, int(steps) - 1)
    return float(ratio)


# -- checkerboard (two-sublattice) lattices ----------------------------- #

def _min_iso(rho1, rho2, chi):
    """Shared bond isometry: the side with smaller discarded weight."""
    u1, e1 = _isometry(rho1, chi)
    u2, e2 = _isometry(rho2, chi)
    return torch.where(e1 <= e2, u1, u2)


def _norm(t):
    c = torch.clamp(t.abs().mean(), min=1e-300)
    return t / c, torch.log(c)


def _seed_checkerboard(a, b, chi, imp_a=None, imp_b=None):
    """Three two-species merges collapsing the NaCl checkerboard onto a
    uniform cubic lattice (A at even ``i+j+k``).

    Merge 1 (z) pairs ``bot = z`` even with ``top = z`` odd: supersites S
    (bot A, top B) and S' (bot B, top A) on an xy-checkerboard, whose four
    transverse bond slots carry four distinct isometries.  Merge 2 (old x)
    pairs S/S' into T/T' alternating along y; merge 3 (old y) yields ONE
    uniform tensor.  After two rotations the frame's "down" leg is the
    original minus-y leg, so in merge 3 the TOP tensor is the odd
    sublattice T' and the impurity rides the BOT slot.  Optional impurities
    replace the A (bot) and/or B (top) of one z-pair and ride the S -> T ->
    U chain pinned, sharing the pure tensors' isometries and norms.

    Returns ``(u, imp_u, g_u)``: the uniform tensor (mean |u| = 1), the
    impurity at the same scale, and the log-scale of one 8-site supersite.
    """
    if imp_a is None:
        imp_a = a
    if imp_b is None:
        imp_b = b
    dp, sw, ty = _density_pair3, _swap_lr, _to_y

    # merge 1: along z; S = (top b | bot a), S' = (top a | bot b)
    u3x1 = _min_iso(dp(a, b), dp(sw(b), sw(a)), chi)
    u3x2 = _min_iso(dp(b, a), dp(sw(a), sw(b)), chi)
    u3y1 = _min_iso(dp(sw(ty(a)), sw(ty(b))), dp(ty(b), ty(a)), chi)
    u3y2 = _min_iso(dp(ty(a), ty(b)), dp(sw(ty(b)), sw(ty(a))), chi)
    s = _apply_pair3_gen(b, a, u3x2, u3x1, u3y1, u3y2)
    sp = _apply_pair3_gen(a, b, u3x1, u3x2, u3y2, u3y1)
    s_imp = _apply_pair3_gen(imp_b, imp_a, u3x2, u3x1, u3y1, u3y2)
    s, gs = _norm(s)
    sp, gsp = _norm(sp)
    s_imp = s_imp * torch.exp(-gs)
    s, sp, s_imp = _rot3(s), _rot3(sp), _rot3(s_imp)

    # merge 2: along old x; T = (top s | bot sp) at even old-y
    xt1 = _min_iso(dp(sp, s), dp(sw(s), sw(sp)), chi)
    xt2 = _min_iso(dp(s, sp), dp(sw(sp), sw(s)), chi)
    yt = _min_iso(dp(ty(s), ty(sp)), dp(sw(ty(s)), sw(ty(sp))), chi)
    ytp = _min_iso(dp(ty(sp), ty(s)), dp(sw(ty(sp)), sw(ty(s))), chi)
    t = _apply_pair3_gen(s, sp, xt2, xt1, yt, yt)
    tp = _apply_pair3_gen(sp, s, xt1, xt2, ytp, ytp)
    t_imp = _apply_pair3_gen(s_imp, sp, xt2, xt1, yt, yt)
    t, gt = _norm(t)
    tp, gtp = _norm(tp)
    t_imp = t_imp * torch.exp(-gt)
    t, tp, t_imp = _rot3(t), _rot3(tp), _rot3(t_imp)

    # merge 3: along old y; U = (top tp | bot t), the impurity in the bot slot
    u3x = _min_iso(dp(tp, t), dp(sw(tp), sw(t)), chi)
    u3y = _min_iso(dp(ty(tp), ty(t)), dp(sw(ty(tp)), sw(ty(t))), chi)
    uu = _apply_pair3_gen(tp, t, u3x, u3x, u3y, u3y)
    u_imp = _apply_pair3_gen(tp, t_imp, u3x, u3x, u3y, u3y)
    uu, gu = _norm(uu)
    u_imp = u_imp * torch.exp(-gu)
    g_total = 2.0 * (gs + gsp) + gt + gtp + gu
    return _rot3(uu), _rot3(u_imp), g_total


def _hotrg3_ab(a, b, imp_a, imp_b, chi, steps):
    uu, imp_u, g_seed = _seed_checkerboard(a, b, chi, imp_a, imp_b)
    log_z_u, ratio, errs = _hotrg3_flow(uu, imp_u, chi, steps)
    # the flow's per-input-site log z plus the seed scale, per 8 sites
    return (g_seed + log_z_u) / 8.0, ratio, errs


def hotrg3d_ab_log_z(a, b, chi, steps=22):
    """``log Z`` per site of the two-sublattice (NaCl checkerboard) cubic
    lattice with alternating site tensors ``a`` / ``b``.  With ``a == b``
    this reproduces :func:`hotrg3d_log_z`."""
    a = _site(a)
    b = _site_like(b, a)
    with torch.no_grad():
        lz, _, _ = _hotrg3_ab(_pad6(a, chi), _pad6(b, chi), None, None, chi, int(steps))
    return float(lz)


def hotrg3d_ab_expectation(a, b, imp_a=None, imp_b=None, chi=6, steps=22):
    """Impurity expectation on the checkerboard lattice: ``imp_a`` replaces
    one A-sublattice tensor, ``imp_b`` the B tensor directly above it — one
    for a sublattice-resolved one-site observable, both for a z-bond pair
    observable."""
    a = _site(a)
    b = _site_like(b, a)
    imp_a = None if imp_a is None else _pad6(_site_like(imp_a, a), chi)
    imp_b = None if imp_b is None else _pad6(_site_like(imp_b, a), chi)
    with torch.no_grad():
        _, ratio, _ = _hotrg3_ab(_pad6(a, chi), _pad6(b, chi), imp_a, imp_b, chi,
                                 int(steps))
    return float(ratio)


def hotrg3d_log_z_diff(a, chi, steps=20):
    """Traced ``log Z`` per site (a 0-d tensor), differentiable with
    ``torch.autograd`` through the whole 3D flow with FROZEN projectors (the
    truncation boundary cuts degenerate multiplets, where any eigh gradient
    diverges; the frozen-projector gradient equals the impurity-flow
    insertion)."""
    a0 = _pad6(_site(a), chi)
    log_z, _, _ = _hotrg3_flow(a0, a0, chi, int(steps), frozen_proj=True)
    return log_z


def ising3d_tensor_smooth(beta, h_field=0.0, beta_z=None, device=None):
    """Cubic-lattice Ising site tensor, smooth in ``beta`` for autodiff.

    Bond Boltzmann factor split as ``W = [[sqrt(cosh b), sqrt(sinh b)],
    [sqrt(cosh b), -sqrt(sinh b)]]`` per axis.  ``beta_z`` optionally
    decouples the z axis (``beta_z=0`` gives exactly stacked independent 2D
    layers).  Legs ``(u, l, d, r, f, k)`` with u/d the z axis.
    """
    beta = _beta_tensor(beta, device)
    beta_z = beta if beta_z is None else torch.as_tensor(beta_z, dtype=beta.dtype,
                                                         device=beta.device)

    def w_of(b):
        ch = torch.sqrt(torch.cosh(b))
        sh = torch.sqrt(torch.sinh(b))
        return torch.stack([torch.stack([ch, sh]), torch.stack([ch, -sh])])

    w = w_of(beta)
    wz = w_of(beta_z)
    spins = torch.tensor([1.0, -1.0], dtype=beta.dtype, device=beta.device)
    weight = torch.exp(h_field * spins)
    return peinsum("s,su,sl,sd,sr,sf,sk->uldrfk", weight, wz, w, wz, w, w, w)


def ising3d_internal_energy_ad(beta, chi, steps=20, h_field=0.0, device=None):
    """Internal energy per site ``u = -d log Z / d beta`` of the 3D Ising
    model by one reverse pass over the frozen-projector flow (on ``device``,
    default ``cuda``); a host float."""
    b = _beta_tensor(float(beta), device).requires_grad_(True)
    log_z = hotrg3d_log_z_diff(ising3d_tensor_smooth(b, h_field), chi, steps)
    (grad,) = torch.autograd.grad(log_z, b)
    return float(-grad)
