"""Real-space parallel DMRG: one chain, segments swept in parallel.

Counterpart of ``contractn_tpu/parallel/rs_dmrg.py``: the Stoudenmire-White
real-space decomposition [PRB 87, 155137 (2013)] over a mesh axis.  Each
outer iteration:

1. **Mixed-canonical precompute** (replicated, two QR scans): the
   left-canonical stack ``A``, right-canonical stack ``B``, and per-bond
   center matrices ``C_i = R_i c_i``, so the state at every bond ``i`` reads
   ``A_0..A_i C_i B_{i+1}..``: every window's local problem has exact
   ``N = I`` at once.
2. **Parallel window sweeps** over ``sp``: rank ``p`` seeds its window with
   ``A C`` at its start bond and runs a left-to-right two-site Lanczos sweep
   over its ``k - 1`` interior bonds against frozen exterior environments
   (left from ``A``, right from ``B``).  Windows touch disjoint site ranges;
   the merged update is one psum of masked deltas, the energy a pmax.
3. **Boundary reconciliation**: interior ranks QR off the residual center at
   their window's end so the glue with the right neighbour's center-absorbed
   seed does not double-count cut weights.

Cut bonds between windows are covered by alternating the window offset
between 0 and half a segment each iteration (a Python int here).  State and
environments are replicated: this axis parallelizes work; compose with
``tp`` to shard memory.

Accuracy contract (the JAX package's measurements, TFIM n=16 D=8): the QR
stitch leaves the center's orthogonal factor in the glue, so the parallel
iterations alone plateau about 1e-3..1e-6 above the serial optimum;
``final_sweeps=1`` (the default) runs the serial
:func:`~contractn_tpu_torch.models.ensemble.dmrg_uniform` polish, the
serial/parallel split the S-W paper uses.
"""

import torch

from ..models.dmrg import _heff_matvec, _split_theta, _update_left, _update_right
from ..models.ensemble import _boundary_env, _pad_boundary_sites, dmrg_uniform
from ..models.mps import MPS
from ..ops.krylov import lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype
from ._collectives import pmax, psum
from .mesh import axis_group, axis_index, mesh_shape


def _left_qr(sites):
    """Left-canonical stack ``A`` and per-bond remainders ``R_i`` (the carry
    after absorbing site i, normalized)."""
    _, d, bond, _ = sites.shape
    c = torch.eye(bond, dtype=sites.dtype, device=sites.device)
    a_stack, r_stack = [], []
    for s in sites:
        t = peinsum("ab,dbc->dac", c, s)
        q, r = torch.linalg.qr(t.permute(1, 0, 2).reshape(bond * d, bond))
        c = r / torch.clamp(r.abs().max(), min=1e-300)
        a_stack.append(q.reshape(bond, d, bond).permute(1, 0, 2))
        r_stack.append(c)
    return torch.stack(a_stack), torch.stack(r_stack)


def _right_qr(sites):
    """Right-canonical stack ``B`` and per-bond carries ``c_i`` (after
    absorbing site i+1 going leftward; ``c_i`` sits at bond i, normalized)."""
    n, d, bond, _ = sites.shape
    c = torch.eye(bond, dtype=sites.dtype, device=sites.device)
    b_stack, c_stack = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        t = peinsum("dab,bc->dac", sites[i], c)
        # RQ via QR of the transpose: rows = right modes
        m = t.permute(1, 0, 2).reshape(bond, d * bond).T  # (dD, D)
        q, r = torch.linalg.qr(m)
        b_stack[i] = q.T.reshape(bond, d, bond).permute(1, 0, 2)
        c = r.T / torch.clamp(r.abs().max(), min=1e-300)
        c_stack[i] = c
    return torch.stack(b_stack), torch.stack(c_stack)


def _env_stacks(a_stack, b_stack, ws, l0, rn):
    """(n+1) environments: ``envs_l[i]`` absorbs A sites ``0..i-1``;
    ``envs_r[i]`` absorbs B sites ``i..n-1``."""
    n = a_stack.shape[0]
    envs_l = [l0]
    for i in range(n):
        envs_l.append(_update_left(envs_l[-1], a_stack[i], ws[i]))
    envs_r = [rn]
    for i in range(n - 1, -1, -1):
        envs_r.append(_update_right(envs_r[-1], b_stack[i], ws[i]))
    return envs_l, envs_r[::-1]


def _window_sweep(a_stack, b_stack, c_stack, envs_l, envs_r, ws, offset, n, seg,
                  iters, bond, sp_axis):
    """One rank's window: seed ``A C`` at the start bond, sweep its
    ``seg - 1`` interior bonds left to right, stitch.  Returns the merged
    site stack (replicated by a psum) and the pmax of the windows' last local
    energies."""
    p = axis_index(sp_axis)
    start = offset + p * seg  # first bond of the window
    start_c = min(max(start, 0), n - 2)
    n_valid = min(max(n - 1 - start, 0), seg - 1)  # bonds in range

    sites = b_stack.clone()
    sites[start_c] = peinsum("dij,jk->dik", a_stack[start_c], c_stack[start_c])
    envl = envs_l[start_c]
    energy = 0.0
    for j in range(n_valid):
        i = start_c + j
        theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
        e, theta = lanczos_ground(
            lambda t: _heff_matvec(envl, ws[i], ws[i + 1], envs_r[i + 2], t),
            theta0, iters)
        t1, t2 = _split_theta(theta, bond, True)
        sites[i], sites[i + 1] = t1, t2
        envl = _update_left(envl, t1, ws[i])
        energy = e

    # Stitch: the window's last touched site holds the residual center
    # (right bond = input B-basis); QR it off so the glue with the right
    # neighbour's center-absorbed seed does not double-count cut weights.
    # The Q-factor keeps the center's orthogonal factor in the glue, so cut
    # bonds carry an O(iteration-gap) inconsistency -- the standard S-W
    # tradeoff, cleaned by `final_sweeps`.  Two "exact" alternatives were
    # MEASURED WORSE (by the JAX package, on TFIM n=16/seg=4) and must not be
    # re-attempted blindly: M pinv(C) amplifies weak-Schmidt junk (O(0.1-1)
    # energy error at every rcond), and the inversion-free Q_M Q_C'
    # rotation scrambles the transient (0.56 vs 5e-4 after 24 iterations).
    last = min(start_c + n_valid, n - 1)
    if n_valid > 0 and last < n - 1:
        t = sites[last]
        qm, _ = torch.linalg.qr(t.permute(1, 0, 2).reshape(-1, bond))
        sites[last] = qm.reshape(bond, t.shape[0], bond).permute(1, 0, 2)

    delta = torch.zeros_like(sites)
    if n_valid > 0:
        touched = slice(start, start_c + n_valid + 1)
        delta[touched] = sites[touched] - b_stack[touched]
    # untouched sites: left of the first window (offset parity) the mixed
    # form puts LEFT-canonical tensors (window 0 seeds A C at bond
    # `offset`, so A's sit below it); right of a window, the B stack
    base = torch.cat([a_stack[:offset], b_stack[offset:]])
    merged = base + psum(delta, sp_axis)
    energy = torch.tensor(energy, dtype=real_dtype(sites.dtype), device=sites.device)
    return merged, pmax(energy, sp_axis)


def _rs_iteration(sites, mpo_cores, offset, iters, seg, sp_axis, l_vec, r_vec):
    n, _, bond, _ = sites.shape
    a_stack, r_stack = _left_qr(sites)
    b_stack, c_full = _right_qr(sites)
    # C_i = R_i c_i, normalized (bond i between sites i and i+1): c_full has
    # c_i at index i+1 (the carry after absorbing site i+1 sits at bond i)
    c_bond = peinsum("nab,nbc->nac", r_stack[:-1], c_full[1:])
    scale = c_bond.abs().amax(dim=(1, 2), keepdim=True)
    c_bond = c_bond / torch.clamp(scale, min=1e-300)
    l0 = _boundary_env(l_vec, bond, sites.dtype)
    rn = _boundary_env(r_vec, bond, sites.dtype)
    envs_l, envs_r = _env_stacks(a_stack, b_stack, mpo_cores, l0, rn)
    return _window_sweep(a_stack, b_stack, c_bond, envs_l, envs_r, mpo_cores,
                         offset, n, seg, iters, bond, sp_axis)


def dmrg_realspace(mesh, mpo, mps0, outer_iters=8, lanczos_iters=40, sp_axis="sp",
                   final_sweeps=1):
    """Ground-state DMRG with real-space parallel window sweeps.

    Args:
        mesh: a mesh with an ``sp_axis``; the chain splits into
            ``P = size(sp_axis)`` windows (``n_sites`` must divide by ``P``
            with ``>= 2`` sites a window).
        mpo: Hermitian Hamiltonian (uniform ``W``).
        mps0: initial state; its bond dimension is the optimization bond.
        outer_iters: canonicalize + parallel-sweep iterations; window offsets
            alternate 0 / half a segment so cut bonds are optimized on
            alternating iterations.
        lanczos_iters: Krylov depth per local solve.
        final_sweeps: serial polish sweeps after the parallel phase (see the
            module docstring's accuracy contract); 0 returns the raw
            stitched state.

    Returns:
        ``(ground_mps, energy, energies)``, the same on every rank:
        ``energies`` is the per-parallel-iteration trace of the last local
        solve (pmax over windows); ``energy`` the final (post-polish) value.
    """
    if mps0.n_sites < 2:
        raise ValueError("dmrg_realspace needs at least 2 sites")
    n_sp = mesh_shape(mesh)[sp_axis]
    n = mps0.n_sites
    if n % n_sp:
        raise ValueError(
            f"n_sites={n} must divide by the '{sp_axis}' mesh axis "
            f"(size {n_sp})")
    seg = n // n_sp
    if seg < 2:
        raise ValueError("need >= 2 sites per window")

    sp = axis_group(mesh, sp_axis)
    sites = _pad_boundary_sites(mps0)
    dt = torch.promote_types(sites.dtype, mpo.cores.dtype)
    sites = sites.to(dt)
    ws = mpo.cores.to(dt)
    l_vec = as_tensor(mpo.left, sites.device).to(dt)
    r_vec = as_tensor(mpo.right, sites.device).to(dt)
    energies = []
    for it in range(int(outer_iters)):
        sites, e = _rs_iteration(sites, ws, (it % 2) * (seg // 2), int(lanczos_iters),
                                 seg, sp, l_vec, r_vec)
        energies.append(e)
    bond = sites.shape[-1]
    e0 = torch.zeros((bond,), dtype=dt, device=sites.device)
    e0[0] = 1.0
    out = MPS(sites, e0, e0.clone())
    energies = torch.stack(energies)
    energy = energies[-1]
    if final_sweeps:
        # serial polish, S-W convention: the parallel iterations do the heavy
        # lifting (to ~1e-3..1e-6 of the optimum, stitch-limited); one or two
        # serial sweeps deliver the last variational digits
        out, energy, _ = dmrg_uniform(mpo, out, sweeps=int(final_sweeps),
                                      lanczos_iters=int(lanczos_iters))
    return out, energy, energies
