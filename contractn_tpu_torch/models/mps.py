"""Matrix product states (MPS), the flagship model family.

Counterpart of ``contractn_tpu/models/mps.py``.  Cores live as ONE stacked
``(N, d, D, D)`` tensor; the hot path — batched amplitude evaluation — runs
through the hand-written CUDA chain kernel (:mod:`..ops.cuda_mps`) on the
GPU, and through the plain torch loops of :mod:`..ops.scan` elsewhere.
"""

from dataclasses import dataclass

import torch

from ..ops.cuda_mps import cuda_mps_evaluate
from ..ops.scan import (
    _stab_step,
    mps_evaluate,
    mps_evaluate_auto,
    mps_evaluate_fused,
    mps_norm,
)
from ..ops.stabilize import destabilize, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device
from ..utils.errors import TNError, records_grad

_KERNELS = ("auto", "scan", "cuda")


@dataclass
class MPS:
    """Open-boundary MPS with uniform bond dimension.

    Attributes:
        cores: ``(N, d, D, D)`` site tensors (one stacked tensor).
        left: ``(D,)`` left boundary vector.
        right: ``(D,)`` right boundary vector.
    """

    cores: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor

    # -- constructors --------------------------------------------------- #

    @classmethod
    def random(cls, n_sites, phys_dim, bond_dim, dtype=torch.float32,
               scale=None, generator=None, device=None):
        """Random MPS with cores scaled for O(1) per-site transfer norm.

        Draws on ``device`` (default ``cuda``; raises without a GPU unless
        ``device="cpu"``) from ``generator`` (a ``torch.Generator`` on that
        device, or the global one).
        """
        device = resolve_device(device)
        if scale is None:
            # E[|A x|^2] ~ D * scale^2 per contraction; keep products tame
            scale = 1.0 / (bond_dim * phys_dim) ** 0.5

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=dtype)

        cores = scale * normal(n_sites, phys_dim, bond_dim, bond_dim)
        return cls(cores, normal(bond_dim), normal(bond_dim))

    @classmethod
    def from_dense(cls, vector, phys_dim, max_bond=None, cutoff=0.0,
                   device=None):
        """Encode a dense ``(phys_dim**n,)`` state as an MPS (exact unless
        truncated by ``max_bond``/``cutoff``).

        Sequential left-to-right SVD (the standard tensor-train
        decomposition) with ``torch.linalg.svd``; returns the MPS in the
        uniform stacked form.  Bond dimensions grow at most as
        ``min(d^k, d^(n-k))``.  A torch ``vector`` keeps its device; a numpy
        one goes to ``device`` (default ``cuda``).
        """
        device = resolve_device(device, (vector,))
        vector = as_tensor(vector, device)
        n = 0
        size = vector.numel()
        while phys_dim ** n < size:
            n += 1
        if phys_dim ** n != size:
            raise ValueError(
                f"Vector of size {size} is not phys_dim**n for "
                f"phys_dim={phys_dim}"
            )
        from .dmrg import _rebuild_uniform

        tensors = []
        rest = vector.reshape(1, -1)
        r_prev = 1
        for _ in range(n - 1):
            mat = rest.reshape(r_prev * phys_dim, -1)
            u, s, vh = torch.linalg.svd(mat, full_matrices=False)
            k = s.shape[0]
            if max_bond is not None:
                k = min(k, max_bond)
            if cutoff > 0:
                above = int((s > cutoff * s[0]).sum())
                k = min(k, max(above, 1))
            u, s, vh = u[:, :k], s[:k], vh[:k]
            tensors.append(u.reshape(r_prev, phys_dim, k).permute(1, 0, 2))
            rest = s[:, None] * vh
            r_prev = k
        tensors.append(rest.reshape(r_prev, phys_dim, 1).permute(1, 0, 2))
        return _rebuild_uniform(tensors, vector.dtype)

    @classmethod
    def constant(cls, n_sites, phys_dim, bond_dim, fill=1.0,
                 dtype=torch.float64, device=None):
        device = resolve_device(device)
        cores = torch.full((n_sites, phys_dim, bond_dim, bond_dim), fill,
                           dtype=dtype, device=device)
        boundary = torch.ones((bond_dim,), dtype=dtype, device=device)
        return cls(cores, boundary, boundary)

    # -- properties ----------------------------------------------------- #

    @property
    def n_sites(self):
        return self.cores.shape[0]

    @property
    def phys_dim(self):
        return self.cores.shape[1]

    @property
    def bond_dim(self):
        return self.cores.shape[2]

    # -- contraction API ------------------------------------------------ #

    def _kernel_eligible(self, x, stabilize_every, remat_segments,
                         sites_per_step):
        """Whether the chain kernel takes this call's device, dtypes and
        options (whether a gradient is needed is :meth:`_path`'s question).
        Every bond and batch qualifies: above bond 128 the kernel's streamed
        path ran faster than ``mps_evaluate_auto`` at every shape timed
        (bond 256 with d 2 at 16-4096 samples, d 16 at 16 and 4096; PERF.md,
        section 6)."""
        return (
            self.cores.is_cuda
            and self.cores.dtype in (torch.float32, torch.bfloat16)
            and not x.is_complex()
            and stabilize_every == 1
            and not remat_segments
            and sites_per_step == 1
        )

    def _path(self, x, kernel, stabilize_every, remat_segments,
              sites_per_step):
        """The evaluator a call of :meth:`evaluate` runs: ``"cuda"``,
        ``"fused"``, ``"auto"`` or ``"scan"``.

        ``"auto"`` takes the kernel only where it applies and autograd will
        not record through it (the kernel has no backward); otherwise the
        differentiable loop the JAX package's ``"auto"`` runs.
        """
        if kernel not in _KERNELS:
            raise TNError(f"Unknown kernel {kernel!r}; options: {_KERNELS}")
        if kernel == "cuda":
            return "cuda"
        if (kernel == "auto"
                and self._kernel_eligible(x, stabilize_every, remat_segments,
                                          sites_per_step)
                and not records_grad(self.cores, self.left, self.right, x)):
            return "cuda"
        if sites_per_step > 1:
            return "fused"
        if kernel == "auto" and not remat_segments:
            return "auto"
        return "scan"

    def evaluate(self, x, split_format=True, stabilize_every=1,
                 kernel="auto", remat_segments=None, sites_per_step=1):
        """Amplitudes ``psi(x_b)`` for a batch of inputs ``x: (B, N, d)``.

        Args:
            x: ``(B, N, d)`` input weights per site (a tensor on the cores'
                device).
            split_format: return ``(mantissa, log_scale)`` (default) or the
                dense amplitudes.
            stabilize_every: rescale cadence.
            kernel: ``"auto"`` — on a CUDA device the hand-written chain
                kernel when it applies (real float32/bfloat16 cores,
                ``stabilize_every == 1``, no ``remat_segments``,
                ``sites_per_step == 1``; any bond) and autograd will not
                record through it (grad mode off, or no operand requires
                grad), else the differentiable loops; ``"scan"`` — the plain
                per-site torch loop (needed for ``remat_segments``);
                ``"cuda"`` — the chain kernel (its plain version for CPU
                tensors), the counterpart of the JAX package's ``"pallas"``,
                at every bond: up to 128 on its on-chip tensor-core path,
                above on its streamed path (the carry in device memory
                between sites); it has no backward and raises ``TNError``
                where autograd would record through it.  The kernel keeps
                an fp32 carry and returns fp32 amplitudes for bfloat16
                cores.
            remat_segments: checkpointed-segment count for sqrt(N)
                backward-pass memory on long chains (forces ``"scan"``).
            sites_per_step: fuse this many sites per step
                (:func:`~contractn_tpu_torch.ops.scan.mps_evaluate_fused`).
        """
        path = self._path(x, kernel, stabilize_every, remat_segments,
                          sites_per_step)
        if path == "cuda":
            amp, log = cuda_mps_evaluate(self.cores, self.left, self.right, x)
        elif path == "fused":
            amp, log = mps_evaluate_fused(
                self.cores, self.left, self.right, x,
                sites_per_step=sites_per_step,
                stabilize_every=stabilize_every,
            )
        elif path == "auto":
            amp, log = mps_evaluate_auto(
                self.cores, self.left, self.right, x,
                stabilize_every=stabilize_every,
            )
        else:
            amp, log = mps_evaluate(
                self.cores, self.left, self.right, x,
                stabilize_every=stabilize_every,
                remat_segments=remat_segments,
            )
        return (amp, log) if split_format else destabilize(amp, log)

    def log_abs_amplitude(self, x):
        """``log |psi(x_b)|`` — the overflow-safe quantity for training."""
        amp, log = self.evaluate(x, split_format=True)
        return torch.log(amp.abs()) + log

    def norm_squared(self, split_format=True):
        """``<psi|psi>`` via the density-matrix transfer loop."""
        val, log = mps_norm(self.cores, self.left, self.right)
        return (val, log) if split_format else destabilize(val, log)

    def log_norm(self):
        """``log <psi|psi>`` (always finite in split arithmetic)."""
        val, log = self.norm_squared()
        return torch.log(val.abs()) + log

    def inner(self, other, split_format=True, conjugate=True):
        """Stabilized overlap ``<self|other>`` of two MPS with equal ``N, d``.

        The mixed transfer operator ``rho' = sum_d conj(A[d])^T rho B[d]``
        is applied as two GEMMs per site.

        Args:
            conjugate: take ``self`` as a bra (default).  With ``False`` the
                plain bilinear pairing is computed (no conjugation).
        """
        cj = torch.conj if conjugate else (lambda t: t)
        dtype = torch.promote_types(self.cores.dtype, other.cores.dtype)
        a_cores, b_cores = self.cores.to(dtype), other.cores.to(dtype)
        rho = torch.outer(cj(self.left.to(dtype)), other.left.to(dtype))
        log = torch.zeros((), dtype=real_dtype(dtype), device=rho.device)
        for a, b in zip(a_cores, b_cores):
            xm = torch.einsum("ij,djk->dik", rho, b)
            rho = torch.einsum("dji,djk->ik", cj(a), xm)
            rho, log = _stab_step(rho, log, 0)
        val = torch.einsum("i,ij,j->", cj(self.right.to(dtype)), rho,
                           other.right.to(dtype))
        val, log = _stab_step(val, log, 0)
        return (val, log) if split_format else destabilize(val, log)

    def site_expectations(self, op):
        """``<psi| O_i |psi> / <psi|psi>`` at EVERY site.

        Left and right density environments come from two loops over the
        sites (each environment renormalized by its largest entry per step;
        the factors cancel in the per-site ratio, so thousand-site chains
        never overflow), then all ``n`` one-site sandwiches evaluate as one
        batched einsum.  ``op (d, d)``; returns ``(n,)``.
        """
        cores = self.cores
        op = as_tensor(op, cores.device)

        def renorm(t):
            return t / torch.clamp(t.abs().max(), min=1e-300)

        rho = torch.outer(self.left.conj(), self.left)
        ls = []
        for a in cores:  # emit the env BEFORE absorbing site i
            ls.append(rho)
            rho = renorm(peinsum("ab,dax,dby->xy", rho, a.conj(), a))
        rho = torch.outer(self.right.conj(), self.right)
        rs = []
        for a in reversed(cores):
            rs.append(rho)
            rho = renorm(peinsum("xy,dax,dby->ab", rho, a.conj(), a))
        ls, rs = torch.stack(ls), torch.stack(rs[::-1])
        # mixed dtypes promote inside peinsum (never narrowed)
        num = peinsum("nab,nsax,st,ntby,nxy->n", ls, cores.conj(), op, cores, rs)
        den = peinsum("nab,nsax,nsby,nxy->n", ls, cores.conj(), cores, rs)
        return num / den

    # -- interop with the graph layer ----------------------------------- #

    def to_tn(self):
        """This MPS as a TN graph (the bare state with open physical modes;
        node tensors stay on the MPS's device)."""
        from ..network import TN

        tn = TN()
        n = self.n_sites
        if n == 1:
            only = torch.einsum("i,dij,j->d", self.left, self.cores[0], self.right)
            tn.add_dense_node(only)
            return tn
        first = torch.einsum("i,dij->dj", self.left, self.cores[0])
        last = torch.einsum("dij,j->di", self.cores[-1], self.right)
        nodes = [tn.add_dense_node(first)]
        for i in range(1, n - 1):
            nodes.append(tn.add_dense_node(self.cores[i]))
        nodes.append(tn.add_dense_node(last))
        for i in range(n - 1):
            tn.connect_nodes(nodes[i], nodes[i + 1], -1, -2 if i != n - 2 else -1)
        return tn
