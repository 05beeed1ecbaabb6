"""MPS -> quantum circuit compilation (staircase state preparation).

Counterpart of ``contractn_tpu/models/circuit_compile.py``.  A
bond-dimension-2 qubit MPS is exactly a staircase of two-qubit unitaries:
in right-canonical form each site tensor defines an isometry whose
orthonormal completion is a 4x4 unitary ``G_k``; applying ``G_0, G_1, ..``
down the chain on ``|0..0>`` rebuilds the state.  Higher bonds compile
iteratively (Ran 2020): extract the chi=2 staircase of the residual, apply
its exact inverse (bond headroom 2x, no local-gauge truncation), repeat.

The canonical sweep and the unitary completions are host numpy (small
matrices with live ranks); the gates run through
:class:`~.circuits.CircuitState` on the state's device.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from .canonical import compress
from .circuits import CircuitState

__all__ = [
    "mps_fidelity",
    "mps_to_circuit",
    "circuit_mps",
    "staircase_layer",
]


def _ragged_right_canonical(mps):
    """Host-side exact right canonicalization with LIVE ranks.

    Returns ``[A_0, .., A_{n-1}]`` with ``A_k`` shaped ``(d, Dl_k,
    Dr_k)`` (``Dr_{n-1} = 1``, ``Dl_0 = 1``), each a right isometry
    (``sum_s A A+ = I``) on its live rank, plus the state's norm.  A
    plain padded-uniform QR would leave junk in dead rows (the u1
    lesson); the SVD sweep zeroes them outright.
    """
    cores, left, right = (t.detach().cpu().numpy()
                          for t in (mps.cores, mps.left, mps.right))
    n = cores.shape[0]
    sites = [cores[i] for i in range(n)]
    sites[0] = np.einsum("l,slr->sr", left, sites[0])[:, None, :]
    sites[-1] = np.einsum("slr,r->sl", sites[-1], right)[:, :, None]
    for k in range(n - 1, 0, -1):
        a = sites[k]
        d_, dl, dr = a.shape
        mat = a.transpose(1, 0, 2).reshape(dl, d_ * dr)
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        live = max(1, int(np.sum(s > 1e-13 * max(s[0], 1e-300))))
        u, s, vh = u[:, :live], s[:live], vh[:live]
        sites[k] = vh.reshape(live, d_, dr).transpose(1, 0, 2)
        sites[k - 1] = np.einsum("slr,rm->slm", sites[k - 1],
                                 u * s[None, :])
    norm = float(np.linalg.norm(sites[0]))
    sites[0] = sites[0] / norm
    return sites, norm


def _complete_columns(cols, dim):
    """Unitary ``(dim, dim)`` whose column ``2l`` is ``cols[:, l]``;
    the remaining columns are an orthonormal completion."""
    m = cols.shape[1]
    u, _, _ = np.linalg.svd(cols, full_matrices=True)
    # project out the specified span, keep an orthonormal complement
    comp = u[:, m:]
    out = np.zeros((dim, dim), dtype=np.result_type(cols, 1.0))
    for lcol in range(m):
        out[:, 2 * lcol] = cols[:, lcol]
    free = [j for j in range(dim) if j % 2 == 1 or j // 2 >= m]
    for j, v in zip(free, comp.T):
        out[:, j] = v
    return out


def staircase_layer(mps):
    """Exact two-qubit staircase for a bond<=2 MPS (d = 2).

    Returns ``(gates, last)``: ``gates[k]`` is the 4x4 unitary applied
    to qubits ``(k, k+1)`` in ascending order starting from
    ``|0..0>``; ``last`` is the closing 2x2 on the final qubit.  The
    input is chi=2-truncated first if needed, so this is the chi=2
    skeleton of an arbitrary state.
    """
    n = int(mps.cores.shape[0])
    if int(mps.cores.shape[1]) != 2:
        raise ValueError("staircase compilation needs qubits (d = 2)")
    if n < 2:
        raise ValueError("need at least 2 sites")
    if mps.bond_dim > 2:
        mps, _, _ = compress(mps, max_bond=2)
    sites, _ = _ragged_right_canonical(mps)
    gates = []
    for k in range(n - 1):
        a = sites[k]
        d_, dl, dr = a.shape
        cols = np.zeros((4, dl), dtype=np.result_type(a, 1.0))
        for lcol in range(dl):
            for s in range(2):
                for r in range(dr):
                    cols[2 * s + r, lcol] = a[s, lcol, r]
        gates.append(_complete_columns(cols, 4))
    a = sites[-1]  # (2, Dl, 1)
    dl = a.shape[1]
    cols = a[:, :, 0]
    u, _, _ = np.linalg.svd(cols, full_matrices=True)
    last = np.zeros((2, 2), dtype=np.result_type(a, 1.0))
    last[:, :dl] = cols
    if dl < 2:
        last[:, dl:] = u[:, dl:]
    return gates, last


def _apply_staircase(state, layer):
    gates, last = layer
    for k, g in enumerate(gates):
        state.apply_gate2(g, k)
    state.apply_gate(last, len(gates))
    return state


def _apply_staircase_inverse(state, layer):
    gates, last = layer
    state.apply_gate(np.asarray(last).conj().T, len(gates))
    for k in range(len(gates) - 1, -1, -1):
        state.apply_gate2(np.asarray(gates[k]).conj().T, k)
    return state


def mps_to_circuit(mps, n_layers=1, cutoff=1e-12):
    """Compile an arbitrary qubit MPS into staircase layers.

    Iterative disentangling: each round extracts the chi=2 staircase
    of the current residual state and applies its inverse EXACTLY —
    a staircase crosses each bond once, so the inverse grows the bond
    by at most 2x and truncating below that (especially in the local
    gauge) silently corrupts later layers; the residual is then
    rank-compressed by ``cutoff`` only.  Returns the layer list in
    APPLICATION order — feed it to :func:`circuit_mps` (or a device)
    as-is.
    """
    psi, _, _ = compress(mps, max_bond=int(mps.bond_dim))
    layers = []
    for _ in range(n_layers):
        layer = staircase_layer(psi)
        layers.append(layer)
        st = CircuitState(psi, max_bond=2 * int(psi.bond_dim))
        _apply_staircase_inverse(st, layer)
        psi = st.finalize()
        # rank-reveal only: disentangled residuals COMPRESS, and the
        # cutoff keeps the exactness of the inverse application
        psi, _, _ = compress(psi, max_bond=2 * int(psi.bond_dim),
                             cutoff=cutoff)
    return layers[::-1]


def circuit_mps(layers, n_sites, max_bond=None, device=None):
    """Run staircase ``layers`` (application order) on ``|0..0>`` on
    ``device`` (default ``cuda``); returns the resulting normalized
    :class:`MPS`."""
    up = np.zeros(2)
    up[0] = 1.0
    bond = max_bond or 2 ** len(layers)
    st = CircuitState.product(n_sites, up, max_bond=bond,
                              device=resolve_device(device))
    for layer in layers:
        _apply_staircase(st, layer)
    out = st.finalize()
    out, _, _ = compress(out, max_bond=bond)
    return out


def mps_fidelity(a, b):
    """``|<a|b>|^2 / (<a|a> <b|b>)`` in split format."""
    v, log = a.inner(b)
    na, la = a.norm_squared()
    nb, lb = b.norm_squared()
    return float(
        abs(complex(v)) ** 2
        * np.exp(2.0 * float(log) - float(la) - float(lb))
        / (float(torch.real(na)) * float(torch.real(nb)))
    )
