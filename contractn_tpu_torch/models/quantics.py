"""Quantics tensor trains: functions on 2^n grids as MPS, calculus as MPOs,
and the quantics Fourier transform.

Counterpart of ``contractn_tpu/models/quantics.py``.  A function sampled on
the dyadic grid ``x_j = a + j (b-a)/2^n`` is an ``n``-site, phys-dim-2 MPS
over the binary digits of ``j`` (site 0 = most significant bit, the
row-major order of :meth:`MPS.from_dense`).  Grid calculus is exact MPO
algebra (carry automata for shifts, :func:`~.mpo.mpo_sum` combinations for
differences), and the quantics Fourier transform is the textbook circuit run
through :class:`~.circuits.CircuitState`.

:func:`quantics_to_dense` evaluates a quantics MPS on every grid point
through :meth:`MPS.evaluate`: it builds the ``(2^n, n, 2)`` one-hot weights
on the MPS's device in the MPS's dtype, so float32 cores on the card take
the hand-written chain kernel (#1).  MPO builders take ``device`` (default
``cuda``); functions of an MPS follow its device.
"""

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .circuits import CircuitState
from .mpo import MPO, mpo_sum
from .mps import MPS


def grid(n_bits, domain=(0.0, 1.0)):
    """The dyadic sample points ``x_j = a + j (b-a)/2^n`` (numpy; endpoint
    excluded, the periodic convention)."""
    a, b = float(domain[0]), float(domain[1])
    n = 2 ** n_bits
    return a + (b - a) * np.arange(n) / n


def function_mps(f, n_bits, domain=(0.0, 1.0), max_bond=None, cutoff=1e-14,
                 device=None):
    """Quantics MPS of ``f`` (a vectorized numpy callable, or the explicit
    ``2**n_bits`` samples) on the grid, on ``device`` (default ``cuda``).
    Exact unless ``max_bond``/``cutoff`` truncate."""
    vals = np.asarray(f(grid(n_bits, domain)) if callable(f) else f)
    if vals.size != 2 ** n_bits:
        raise ValueError(f"need 2**{n_bits} samples, got {vals.size}")
    return MPS.from_dense(vals, 2, max_bond=max_bond, cutoff=cutoff,
                          device=resolve_device(device))


def _one_hot_bits(n, dtype, device):
    """``(2^n, n, 2)`` one-hot site weights of every grid index, built on
    ``device`` (MSB first)."""
    idx = torch.arange(2 ** n, device=device)[:, None]
    shifts = (n - 1 - torch.arange(n, device=device))[None, :]
    bits = (idx >> shifts) & 1
    return torch.nn.functional.one_hot(bits, 2).to(dtype)


def quantics_to_dense(mps):
    """Dense sample vector ``(2^n,)`` of a quantics MPS (small grids), on
    the MPS's device: one batched :meth:`MPS.evaluate` over every grid
    point (kernel #1 for float32 cores on the card, without autograd)."""
    n = mps.cores.shape[0]
    weights = _one_hot_bits(n, mps.cores.dtype, mps.cores.device)
    vals, logs = mps.evaluate(weights)
    return vals * torch.exp(logs).to(vals.dtype)


def _mpo(cores, left, right, dtype, device):
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    return MPO(*(torch.from_numpy(np.asarray(a, np.float64)).to(device, dtype)
                 for a in (cores, left, right)))


def adder_mpo(n_bits, k, boundary="periodic", dtype=torch.float64, device=None):
    """The basis map ``A_k |y> = |y + k>`` as a bond-2 carry automaton
    (``"periodic"`` wraps mod ``2**n_bits``; ``"open"`` annihilates
    out-of-range results)."""
    n = int(n_bits)
    k_int = int(k)
    k_eff = k_int % (2 ** n)
    cores = np.zeros((n, 2, 2, 2, 2))
    for i in range(n):
        b = (k_eff >> (n - 1 - i)) & 1
        for s in (0, 1):
            for cr in (0, 1):
                out = s ^ b ^ cr
                cl = 1 if (s + b + cr) >= 2 else 0
                cores[i, out, s, cl, cr] = 1.0
    right = np.array([1.0, 0.0])  # no carry into the LSB
    if boundary == "periodic":
        left = np.array([1.0, 1.0])
    elif boundary == "open":
        # in-range iff the overflow bit matches the sign of k
        left = np.array([0.0, 1.0]) if k_int < 0 else np.array([1.0, 0.0])
        if k_eff == 0:
            left = np.array([1.0, 0.0])
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    return _mpo(cores, left, right, dtype, device)


def shift_mpo(n_bits, k, boundary="periodic", dtype=torch.float64, device=None):
    """The sample shift ``(T_k f)(x_j) = f(x_{j+k})``: ``T_k = A_{-k}``."""
    return adder_mpo(n_bits, -k, boundary=boundary, dtype=dtype, device=device)


def _scaled(mpo, c):
    return MPO(mpo.cores, c * mpo.left, mpo.right)


def derivative_mpo(n_bits, domain=(0.0, 1.0), boundary="periodic",
                   dtype=torch.float64, device=None):
    """Central difference ``(f(x+h) - f(x-h)) / 2h`` as a bond-4 MPO."""
    h = (float(domain[1]) - float(domain[0])) / 2 ** n_bits
    tp = shift_mpo(n_bits, +1, boundary=boundary, dtype=dtype, device=device)
    tm = shift_mpo(n_bits, -1, boundary=boundary, dtype=dtype, device=device)
    return mpo_sum(_scaled(tp, 1.0 / (2 * h)), _scaled(tm, -1.0 / (2 * h)))


def laplacian_mpo(n_bits, domain=(0.0, 1.0), boundary="periodic",
                  dtype=torch.float64, device=None):
    """``(f(x+h) - 2 f(x) + f(x-h)) / h^2`` as a bond-5 MPO."""
    h = (float(domain[1]) - float(domain[0])) / 2 ** n_bits
    tp = shift_mpo(n_bits, +1, boundary=boundary, dtype=dtype, device=device)
    tm = shift_mpo(n_bits, -1, boundary=boundary, dtype=dtype, device=device)
    ident = MPO.identity(int(n_bits), 2, dtype=torch_dtype(dtype),
                         device=tp.cores.device)
    s = mpo_sum(tp, tm)
    return mpo_sum(_scaled(s, 1.0 / h ** 2), _scaled(ident, -2.0 / h ** 2))


def position_mpo(n_bits, domain=(0.0, 1.0), dtype=torch.float64, device=None):
    """The diagonal multiply-by-``x`` operator (bond 2): the binary
    expansion of ``x`` as a triangular accumulator automaton."""
    n = int(n_bits)
    a, b = float(domain[0]), float(domain[1])
    cores = np.zeros((n, 2, 2, 2, 2))
    eye = np.eye(2)
    p1 = np.diag([0.0, 1.0])
    for i in range(n):
        c = (b - a) * 2.0 ** (-(i + 1))
        cores[i, :, :, 0, 0] = eye
        cores[i, :, :, 1, 1] = eye
        cores[i, :, :, 0, 1] = c * p1 + (a / n) * eye
    return _mpo(cores, np.array([1.0, 0.0]), np.array([0.0, 1.0]), dtype, device)


def _ones_inner(mps):
    """``sum_j f(x_j)`` as a host complex: the split-format overlap with the
    all-ones product bra, its log combined in float64 (40-bit grids stay
    finite)."""
    n = mps.cores.shape[0]
    ones = MPS.constant(n, 2, 1, fill=1.0, dtype=mps.cores.dtype,
                        device=mps.cores.device)
    v, log = ones.inner(mps, conjugate=True)
    return complex(v) * float(np.exp(float(log)))


def quantics_integral(mps, domain=(0.0, 1.0)):
    """Riemann sum ``sum_j f(x_j) dx`` (host complex)."""
    n = mps.cores.shape[0]
    dx = (float(domain[1]) - float(domain[0])) / 2 ** n
    return _ones_inner(mps) * dx


def register_mpo(mpo, n_total, offset, dtype=None):
    """Embed an ``n``-site MPO on the window ``[offset, offset+n)`` of an
    ``n_total``-site lattice (identities elsewhere; boundary vectors folded
    into the edge cores), on the MPO's device."""
    cores = mpo.cores.detach().cpu().numpy()
    n, d, _, w, _ = cores.shape
    if offset < 0 or offset + n > n_total:
        raise ValueError("window does not fit the lattice")
    dt = cores.dtype if dtype is None else torch.empty(
        (), dtype=torch_dtype(dtype)).numpy().dtype
    left = mpo.left.detach().cpu().numpy()
    right = mpo.right.detach().cpu().numpy()
    first = np.einsum("l,sSlr->sSr", left, cores[0])
    last = np.einsum("sSlr,r->sSl", cores[-1], right)
    out = np.zeros((n_total, d, d, w, w), dt)
    eye = np.eye(d)
    for i in range(n_total):
        if i < offset or i >= offset + n:
            out[i, :, :, 0, 0] = eye
        elif i == offset:
            if n == 1:  # both boundary vectors fold into the one core
                out[i, :, :, 0, 0] = np.einsum("sSr,r->sS", first, right)
            else:
                out[i, :, :, 0, :] = first
        elif i == offset + n - 1:
            out[i, :, :, :, 0] = last
        else:
            out[i] = cores[i - offset]
    e0 = np.zeros(w, dt)
    e0[0] = 1.0
    device = mpo.cores.device
    return MPO(*(torch.from_numpy(a).to(device) for a in (out, e0, e0.copy())))


def function_mps_2d(f, n_bits, domains=((0.0, 1.0), (0.0, 1.0)), max_bond=None,
                    cutoff=1e-14, device=None):
    """Quantics MPS of a 2D function on the ``2^n x 2^n`` grid, stacked
    register ordering (x bits first), on ``device``."""
    if callable(f):
        gx = grid(n_bits, domains[0])
        gy = grid(n_bits, domains[1])
        vals = np.asarray(f(gx[:, None], gy[None, :]))
    else:
        vals = np.asarray(f)
    if vals.shape != (2 ** n_bits, 2 ** n_bits):
        raise ValueError(f"need a (2**{n_bits}, 2**{n_bits}) sample grid")
    return MPS.from_dense(vals.reshape(-1), 2, max_bond=max_bond, cutoff=cutoff,
                          device=resolve_device(device))


def quantics_integral_2d(mps, domains=((0.0, 1.0), (0.0, 1.0))):
    """Riemann sum ``sum_jk f(x_j, y_k) dx dy`` of a stacked 2D quantics
    MPS (host complex)."""
    n = mps.cores.shape[0] // 2
    dx = (float(domains[0][1]) - float(domains[0][0])) / 2 ** n
    dy = (float(domains[1][1]) - float(domains[1][0])) / 2 ** n
    return _ones_inner(mps) * dx * dy


def quantics_to_dense_2d(mps):
    """Dense ``(2^n, 2^n)`` sample grid of a stacked 2D quantics MPS."""
    flat = quantics_to_dense(mps)
    side = int(round(flat.numel() ** 0.5))
    return flat.reshape(side, side)


def reverse_mps(mps):
    """Exact site reversal: cores reversed with their virtual legs swapped."""
    cores = torch.flip(mps.cores.transpose(2, 3), dims=(0,))
    return MPS(cores, mps.right, mps.left)


_SWAP = np.eye(4)[[0, 2, 1, 3]]


def _cphase(theta):
    return np.diag([1.0, 1.0, 1.0, np.exp(1j * theta)])


def _apply_longrange(state, u, i, j):
    """Two-site gate between non-adjacent ``i < j`` via adjacent swap
    chains (exact)."""
    for k in range(j - 1, i, -1):
        state.apply_gate2(_SWAP, k)
    state.apply_gate2(u, i)
    for k in range(i + 1, j):
        state.apply_gate2(_SWAP, k)


def qft_mps(mps, inverse=False, max_bond=None):
    """Quantics Fourier transform ``(QFT f)[k] = 2^{-n/2} sum_x e^{+2 pi i x
    k / 2^n} f[x]`` (``= sqrt(N) ifft``; ``inverse=True`` gives the fft
    convention): the H + controlled-phase circuit through
    :class:`~.circuits.CircuitState` in complex128, long-range phases
    routed by swap chains, the output bit reversal an exact core
    reversal."""
    c128 = torch.complex128
    state = CircuitState(MPS(mps.cores.to(c128), mps.left.to(c128),
                             mps.right.to(c128)), max_bond=max_bond)
    n = state.n_sites
    sign = -1.0 if inverse else 1.0
    hada = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    for i in range(n):
        state.apply_gate(hada, i)
        for j in range(i + 1, n):
            theta = sign * np.pi / 2 ** (j - i)
            if j == i + 1:
                state.apply_gate2(_cphase(theta), i)
            else:
                _apply_longrange(state, _cphase(theta), i, j)
    out = state.finalize()
    scale = float(np.exp(state.log_norm))
    return reverse_mps(MPS(out.cores, scale * out.left, out.right))

