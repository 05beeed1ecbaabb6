"""Exact autoregressive sampling from MPS Born machines.

Counterpart of ``contractn_tpu/models/sampling.py``.  An MPS defines
``p(x) = |psi(x)|^2 / <psi|psi>``.  In right-canonical form the chain of
conditionals collapses to one left-to-right loop: with carry ``v`` (the
normalized prefix environment), ``p(x_n = d | prefix) = ||v A_d||^2 /
sum_d' ||v A_d'||^2``, and the right-isometry property makes those
conditionals exact marginals.  Per site one ``(B, D) x (D, d*D)`` GEMM plus a
categorical draw, batched over samples.

The draws take an explicit ``torch.Generator`` (on the MPS's device, or the
global one) where the JAX package takes a key: each site's categorical draw
is the Gumbel-max of the log-weights, as ``jax.random.categorical`` draws.
The streams of the two packages differ, so their samples do; the reported
``log_prob`` of a sample does not.
"""

import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype
from .canonical import right_canonicalize


def _categorical(logits, generator):
    """One draw per row of ``logits`` (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def sample_canonical(mps_rc, num_samples, generator=None):
    """Draw samples from a RIGHT-CANONICAL MPS (see :func:`sample`).

    Returns ``(samples, log_prob)``: ``(B, N)`` int64 configurations and
    their exact log-probabilities ``log p(x)``.
    """
    cores = mps_rc.cores  # (N, d, D, D)
    n_sites, phys_dim, bond, _ = cores.shape
    v = mps_rc.left.to(cores.dtype).expand(num_samples, bond)
    logp = torch.zeros((num_samples,), dtype=torch.float64
                       if cores.dtype == torch.float64 else torch.float32,
                       device=cores.device)
    rows = torch.arange(num_samples, device=cores.device)
    samples = []
    for core in cores:
        mat = core.permute(1, 0, 2).reshape(bond, phys_dim * bond)
        u = peinsum("bi,ik->bk", v, mat).reshape(num_samples, phys_dim, bond)
        weight = torch.sum(u.abs() ** 2, dim=2)  # (B, d)
        total = torch.sum(weight, dim=1)
        choice = _categorical(torch.log(weight + 1e-300), generator)
        picked = weight[rows, choice]
        v = u[rows, choice] / torch.clamp(torch.sqrt(picked), min=1e-300)[:, None]
        logp = logp + (torch.log(picked) - torch.log(total))
        samples.append(choice)
    return torch.stack(samples, dim=1), logp


def sample(mps, num_samples, generator=None):
    """Draw exact samples from ``|psi|^2 / <psi|psi>``.

    Right-canonicalizes first (a QR sweep); for repeated sampling from the
    same state, canonicalize once with
    :func:`~.canonical.right_canonicalize` and call :func:`sample_canonical`.
    """
    mps_rc, _ = right_canonicalize(mps)
    return sample_canonical(mps_rc, num_samples, generator)


def sample_conditional(mps, num_samples, observed, generator=None):
    """Exact conditional sampling (inpainting): draw the FREE sites of
    ``observed`` (``(N,)`` ints, ``-1`` = free) from ``p(x_free | x_obs)``.

    Clamping the observed sites inside the plain autoregressive sweep would
    be WRONG — each free conditional must also condition on the
    observations yet to come.  The right environments are built with the
    observed sites PROJECTED onto their values and free sites traced, via
    per-site physical weight vectors ``w_s`` (ones when free, one-hot when
    observed): one sample-independent right-environment sweep, one batched
    forward draw.

    Returns ``(samples, log_prob)``: full ``(B, N)`` configurations
    (observed sites copied in) and the exact CONDITIONAL
    ``log p(x_free | x_obs)`` (only free sites accumulate).
    """
    cores = mps.cores  # (N, d, D, D)
    n_sites, phys_dim, bond, _ = cores.shape
    device = cores.device
    observed = as_tensor(observed, device, torch.int64)
    onehot = torch.nn.functional.one_hot(observed.clamp(min=0), phys_dim)
    w = torch.where((observed >= 0)[:, None], onehot.to(cores.dtype),
                    torch.ones((n_sites, phys_dim), dtype=cores.dtype,
                               device=device))  # (N, d)

    # right marginal/projected environments, rescaled each step;
    # renvs[i] = environment strictly right of site i (scaled)
    r = torch.outer(mps.right, mps.right.conj()).to(cores.dtype)
    renvs = []
    for core, ws in zip(reversed(cores), reversed(w)):
        renvs.append(r)
        nxt = peinsum("s,sij,jk,slk->il", ws, core, r, core.conj())
        r = nxt / torch.clamp(nxt.abs().max(), min=1e-300)
    renvs = renvs[::-1]

    v = mps.left.to(cores.dtype).expand(num_samples, bond)
    rdt = real_dtype(cores.dtype)
    logp = torch.zeros((num_samples,), dtype=rdt, device=device)
    rows = torch.arange(num_samples, device=device)
    samples = []
    for core, renv, obs, ws in zip(cores, renvs, observed, w):
        u = peinsum("bi,sij->bsj", v, core)  # (B, d, D)
        weight = torch.real(peinsum("bsj,jk,bsk->bs", u, renv, u.conj()))
        weight = torch.clamp(weight, min=0.0) * torch.real(ws)[None, :]
        total = torch.sum(weight, dim=1)
        drawn = _categorical(torch.log(weight + 1e-300), generator)
        choice = torch.where(obs >= 0, obs, drawn)
        v = u[rows, choice]
        nrm = torch.sqrt(torch.sum(v.abs() ** 2, dim=1, keepdim=True))
        v = v / torch.clamp(nrm, min=1e-300)
        p = weight[rows, choice] / total
        logp = logp + torch.where(obs >= 0, torch.zeros_like(p),
                                  torch.log(p + 1e-300)).to(rdt)
        samples.append(choice)
    return torch.stack(samples, dim=1), logp
