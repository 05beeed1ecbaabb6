"""MPO time evolution (W^II propagators) for arbitrary — in particular
long-range — Hamiltonians.

Counterpart of ``contractn_tpu/models/mpo_evolution.py``, finite chains.
The W^II construction (Zaletel-Mong-Karrasch-Moore-Pollmann, PRB 91,
165112) compiles ``exp(delta H)`` into an MPO of the virtual dimension of
``H``'s automaton interior, exact through ``O(delta^2)`` per step.  Blocks
are read off the triangular automaton (``D = W[0, last]``, ``C_a = W[0,
a]``, ``A_ba = W[b, a]``, ``B_b = W[b, last]``), and each propagator entry
is extracted exactly by one ``expm`` per ``(b, a)`` pair over the nilpotent
algebra ``C[x, y]/(x^2, y^2)`` (a ``4d x 4d`` block matrix).  The
propagator cores are built on the host (scipy ``expm``) and go to the
Hamiltonian's device; each step is an exact MPO-MPS product plus SVD
compression there.

Infinite chains (:func:`umps_mpo_evolve`) apply the uniform propagator core
to a uniform MPS core and truncate in the Schmidt basis of
:func:`~.vumps.mixed_gauge`, on the core's device.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .boundary import apply_mpo_to_mps
from .canonical import compress
from .mpo import MPO

# Left-multiplication operators of (1, x, y, xy) in C[x,y]/(x^2,y^2)
_LX = np.zeros((4, 4))
_LX[1, 0] = _LX[3, 2] = 1.0
_LY = np.zeros((4, 4))
_LY[2, 0] = _LY[3, 1] = 1.0
_LXY = np.zeros((4, 4))
_LXY[3, 0] = 1.0
_I4 = np.eye(4)


def wii_core(w, delta):
    """W^II propagator core ``(d, d, W-1, W-1)`` (complex numpy) from one
    triangular bulk core ``w (d, d, W, W)`` (start channel 0, done channel
    last, identity corners)."""
    import scipy.linalg as sla

    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w)
    d = w.shape[0]
    wdim = w.shape[2]
    last = wdim - 1
    r = wdim - 2
    root = np.sqrt(complex(delta))
    out = np.zeros((d, d, r + 1, r + 1), complex)
    dblk = w[:, :, 0, last]
    if r == 0:
        out[:, :, 0, 0] = sla.expm(complex(delta) * dblk)
        return out
    base = complex(delta) * np.kron(_I4, dblk)
    for b in range(1, r + 1):
        for a in range(1, r + 1):
            m = (base
                 + root * np.kron(_LX, w[:, :, b, last])
                 + root * np.kron(_LY, w[:, :, 0, a])
                 + np.kron(_LXY, w[:, :, b, a]))
            g = sla.expm(m)
            if b == 1 and a == 1:
                out[:, :, 0, 0] = g[0:d, 0:d]
            if a == 1:
                out[:, :, b, 0] = g[d:2 * d, 0:d]
            if b == 1:
                out[:, :, 0, a] = g[2 * d:3 * d, 0:d]
            out[:, :, b, a] = g[3 * d:4 * d, 0:d]
    return out


def wii_mpo(h_mpo, delta):
    """Compile ``exp(delta H)`` into the complex128 W^II propagator MPO
    (virtual dimension ``W - 1``) on ``h_mpo``'s device.  ``h_mpo`` must be
    in triangular automaton form (boundary vectors ``e_0`` / ``e_last``);
    ``delta`` is ``-1j * dt`` for real time, ``-dbeta`` for imaginary time,
    or any complex value."""
    cores = h_mpo.cores.detach().cpu().numpy()
    n, d, _, wdim, _ = cores.shape
    left = h_mpo.left.detach().cpu().numpy()
    right = h_mpo.right.detach().cpu().numpy()
    if wdim < 2 or abs(left[0] - 1.0) > 1e-12 or np.any(left[1:] != 0):
        raise ValueError("wii_mpo needs the triangular automaton form "
                         "(left boundary = e_0)")
    if abs(right[-1] - 1.0) > 1e-12 or np.any(right[:-1] != 0):
        raise ValueError("wii_mpo needs the triangular automaton form "
                         "(right boundary = e_last)")
    r = wdim - 2
    out = np.stack([wii_core(cores[i], delta) for i in range(n)])
    one = np.zeros((r + 1,), complex)
    one[0] = 1.0
    device = h_mpo.cores.device
    return MPO(*(torch.from_numpy(a).to(device) for a in (out, one, one.copy())))


def _props(h_mpo, delta, order):
    """The W^II propagators of one step: the conjugate pair ``delta (1 +-
    i)/2`` (``order=2``, second global order) or the plain step."""
    if order == 2:
        return [wii_mpo(h_mpo, delta * (1 + 1j) / 2),
                wii_mpo(h_mpo, delta * (1 - 1j) / 2)]
    if order == 1:
        return [wii_mpo(h_mpo, delta)]
    raise ValueError("order must be 1 or 2")


def mpo_evolve(mps, h_mpo, t, n_steps, max_bond=32, imag=False, order=2,
               callback=None):
    """Evolve ``|psi(t)> = exp(-i H t)|psi>`` (or ``exp(-H t)`` with
    ``imag=True``) by repeated W^II application + SVD compression, on the
    state's device.  ``order=2`` composes each step from the conjugate pair
    ``delta (1 +- i)/2`` (second global order).  The state is renormalized
    every step; returns the final normalized MPS.  ``callback(k, mps)`` runs
    after every step."""
    dt = t / n_steps
    delta = -dt if imag else -1j * dt
    props = _props(h_mpo, delta, order)
    for k in range(n_steps):
        for u2 in props:
            mps, _, _ = compress(apply_mpo_to_mps(u2, mps), max_bond=max_bond)
        if callback is not None:
            callback(k, mps)
    return mps


def exp_decay_ising_mpo(n_sites, j=1.0, lam=0.5, h=1.0, dtype=torch.complex128,
                        device=None):
    """Long-range Ising chain ``H = j sum_{i<k} lam^{k-i} Z_i Z_k + h sum_i
    X_i`` as a 3-channel MPO (interior block ``A = lam * I``), on ``device``
    (default ``cuda``)."""
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    z = np.array([[1.0, 0.0], [0.0, -1.0]])
    w = np.zeros((2, 2, 3, 3))
    w[:, :, 0, 0] = np.eye(2)
    w[:, :, 2, 2] = np.eye(2)
    w[:, :, 0, 2] = h * x
    w[:, :, 0, 1] = j * lam * z
    w[:, :, 1, 1] = lam * np.eye(2)
    w[:, :, 1, 2] = z
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    cores = torch.from_numpy(np.broadcast_to(w, (n_sites, 2, 2, 3, 3)).copy())
    left = torch.zeros((3,), dtype=dtype, device=device)
    left[0] = 1.0
    right = torch.zeros((3,), dtype=dtype, device=device)
    right[2] = 1.0
    return MPO(cores.to(device, dtype), left, right)


def umps_apply(core, op_core, bond_dim):
    """Apply a uniform MPO core to a uniform MPS core and truncate.

    The fused ``(d, W*D, W*D)`` core is brought to mixed canonical gauge
    (:func:`~.vumps.mixed_gauge` fixes the bond to the Schmidt basis,
    singular values sorted), so truncation to ``bond_dim`` is a slice of
    ``AL`` (Zaletel et al., PRB 91, 165112, section V), on the core's
    device.

    Returns ``(new_core, trunc_err)``: the sliced left-isometric core and the
    discarded Schmidt weight (a 0-d tensor).
    """
    from .vumps import mixed_gauge

    device = resolve_device(None, (core,))
    core = as_tensor(core, device)
    op_core = as_tensor(op_core, device)
    dt = torch.promote_types(core.dtype, op_core.dtype)
    core, op_core = core.to(dt), op_core.to(dt)
    d, dd, _ = core.shape
    w = op_core.shape[2]
    k = min(int(bond_dim), w * dd)
    big = peinsum("stwv,tij->swivj", op_core, core).reshape(d, w * dd, w * dd)
    al, _, c = mixed_gauge(big)
    s = torch.real(torch.diagonal(c))
    err = 1.0 - (s[:k] ** 2).sum() / (s ** 2).sum()
    return al[:, :k, :k], err


def _wii_pair(h_core, delta, order):
    if order == 2:
        return [wii_core(h_core, delta * (1 + 1j) / 2),
                wii_core(h_core, delta * (1 - 1j) / 2)]
    if order == 1:
        return [wii_core(h_core, delta)]
    raise ValueError("order must be 1 or 2")


def _start_core(core0, device):
    device = resolve_device(device, (core0,))
    return as_tensor(core0, device, torch.complex128)


def umps_mpo_evolve(core0, h_core, t, n_steps, bond_dim, imag=False, order=2,
                    callback=None, device=None):
    """Evolve an INFINITE chain: ``exp(-i H t)`` (or ``exp(-H t)``) applied to
    a uniform MPS by repeated uniform-W^II application (long-range
    Hamiltonians directly in the thermodynamic limit).  ``h_core`` is a
    triangular bulk core; ``order=2`` composes the conjugate pair ``delta (1
    +- i)/2`` per step.  ``device``: where to compute (default: ``core0``'s
    device, else ``cuda``).

    Returns the final ``(d, D, D)`` complex128 uniform core (for the
    :mod:`.umps` observables).  ``callback(k, core)`` runs after each step.
    """
    dt_step = t / n_steps
    delta = -dt_step if imag else -1j * dt_step
    core = _start_core(core0, device)
    props = [torch.from_numpy(p).to(core.device)
             for p in _wii_pair(h_core, delta, order)]
    for k in range(int(n_steps)):
        for p in props:
            core, _ = umps_apply(core, p, bond_dim)
        if callback is not None:
            callback(k, core)
    return core


def umps_mpo_evolve_driven(core0, h_core_fn, t, n_steps, bond_dim, order=2,
                           callback=None, device=None):
    """Time-DEPENDENT evolution of an infinite chain, ``T exp(-i int H(s)
    ds)``, by the midpoint rule: each step propagates with the W^II cores of
    ``h_core_fn(t_k + dt/2)`` (rebuilt per step on the host).  Returns the
    final ``(d, D, D)`` uniform core, as :func:`umps_mpo_evolve`."""
    dt_step = t / n_steps
    core = _start_core(core0, device)
    for k in range(int(n_steps)):
        for p in _wii_pair(h_core_fn((k + 0.5) * dt_step), -1j * dt_step,
                           order):
            core, _ = umps_apply(core, torch.from_numpy(p).to(core.device),
                                 bond_dim)
        if callback is not None:
            callback(k, core)
    return core
