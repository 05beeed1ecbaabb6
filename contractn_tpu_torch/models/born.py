"""MPS Born machines: exact-likelihood generative modeling.

Counterpart of ``contractn_tpu/models/born.py``.  An MPS over discrete
variables defines ``p(x) = |psi(x)|^2 / <psi|psi>`` (a "Born machine"),
whose log-likelihood is EXACT because both the amplitude and the partition
function are chain contractions.

``mps_log_prob`` is one loop over sites: per site one ``(B, D) x (D, d*D)``
GEMM, the column block of each sample's value picked out, and a per-sample
split-format rescale carried in log space, so 1000-site amplitudes neither
under- nor overflow.  (The JAX package gathers each sample's ``(D, D)`` core
and runs a batched GEMV instead; the sums are the same.)  ``fit_born_machine``
runs Adam (``torch.optim.Adam`` with optax's defaults: betas ``(0.9,
0.999)``, eps ``1e-8``, bias-corrected) over the exact NLL; the JAX
``lax.scan`` over steps is a Python loop here, and the minibatch draw takes
an explicit ``torch.Generator``.  Sampling from the trained model is
:mod:`.sampling`.

Gradients flow through both terms of ``log p = log|psi(x)|^2 - log Z`` by
plain autograd; the ``log Z`` term is exact (from
:func:`~contractn_tpu_torch.ops.scan.mps_norm`, not sampled).  No hand
kernel runs here: the JAX package has no Pallas kernel on this path.
"""

import torch

from ..ops.scan import mps_norm
from ..utils.device import as_tensor, real_dtype
from .mps import MPS


def mps_log_amp2(mps, samples):
    """``log |psi(x)|^2`` (unnormalized), stabilized, for ``(B, N)`` integer
    configurations.  One loop over sites; per-sample rescale carried in log
    space."""
    cores = mps.cores  # (N, d, D, D)
    n, d, bond, _ = cores.shape
    samples = as_tensor(samples, cores.device, torch.int64)
    b = samples.shape[0]
    v = mps.left.to(cores.dtype).expand(b, bond)
    log = torch.zeros((b,), dtype=real_dtype(cores.dtype), device=cores.device)
    tiny = torch.finfo(real_dtype(cores.dtype)).tiny
    for site in range(n):
        mat = cores[site].permute(1, 0, 2).reshape(bond, d * bond)
        u = torch.matmul(v, mat).reshape(b, d, bond)
        # each sample's block; gather's backward is a scatter-add (advanced
        # indexing's is a sorted index_put)
        v = torch.gather(u, 1, samples[:, site, None, None].expand(b, 1, bond))[:, 0]
        s = v.abs().mean(dim=1)
        s_safe = torch.where(s > tiny, s, torch.ones_like(s))
        v = v / s_safe[:, None]
        log = log + torch.log(s_safe)
    amp = torch.matmul(v, mps.right.to(cores.dtype))
    return 2.0 * (log + torch.log(amp.abs() + tiny))


def mps_log_prob(mps, samples):
    """Exact ``(B,)`` log-probabilities ``log p(x)`` of integer
    configurations under the Born distribution of ``mps``."""
    m, ls = mps_norm(mps.cores, mps.left, mps.right)
    log_z = torch.log(torch.real(m)) + ls
    return mps_log_amp2(mps, samples) - log_z


def born_nll(mps, samples):
    """Mean negative log-likelihood (nats) of the batch — the exact
    training loss."""
    return -torch.mean(mps_log_prob(mps, samples))


def fit_born_machine(mps, data, steps=1000, batch=None, lr=0.01,
                     generator=None):
    """Train an MPS Born machine on ``(n_data, N)`` integer samples by exact
    maximum likelihood.

    ``batch=None`` uses the full dataset each step (exact gradient); an
    integer draws a random minibatch per step from ``generator`` (a
    ``torch.Generator`` on the MPS's device, or the global one).  Returns
    ``(mps, losses)``: a new MPS (the argument is left as it was) and the
    ``(steps,)`` per-step NLLs in nats, each taken before its update (at
    the optimum: the empirical entropy of the data distribution).
    """
    device = mps.cores.device
    data = as_tensor(data, device, torch.int64)
    params = [t.detach().clone().requires_grad_(True)
              for t in (mps.cores, mps.left, mps.right)]
    opt = torch.optim.Adam(params, lr=float(lr), betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(int(steps)):
        if batch is None:
            mb = data
        else:
            idx = torch.randint(0, data.shape[0], (batch,), generator=generator,
                                device=device)
            mb = data[idx]
        opt.zero_grad(set_to_none=True)
        loss = born_nll(MPS(*params), mb)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    out = MPS(*(p.detach() for p in params))
    return out, torch.stack(losses)


def born_machine(n_sites, phys_dim=2, bond_dim=8, dtype=torch.float64,
                 generator=None, device=None):
    """Fresh random Born machine (an :class:`MPS` with training-friendly
    init — positive boundary vectors keep early log-amplitudes finite on
    every configuration).  Draws from ``generator`` on ``device`` (default
    ``cuda``) as :meth:`MPS.random` does."""
    m = MPS.random(n_sites, phys_dim, bond_dim, dtype=dtype,
                   generator=generator, device=device)
    return MPS(m.cores, m.left.abs() + 0.1, m.right.abs() + 0.1)
