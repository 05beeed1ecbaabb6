"""Differentiable BP: variational energies on arbitrary graph states.

Counterpart of ``contractn_tpu/compiler/bp_variational.py``.
:mod:`.bp_measure` evaluates observables at the Bethe fixed point; this
module provides the differentiable counterpart: a FIXED number of
synchronous message sweeps (the batched sweep of :class:`~.bp.BPGraph`,
differentiated by autograd), energy terms assembled from the resulting
messages, and a gradient-descent ground-state optimizer.  As the sweep count
grows the unrolled gradient converges to the exact implicit-function
gradient of the Bethe energy (Tindall & Fishman, SciPost Phys. 15, 222).

Exact on trees: the energy is the true Rayleigh quotient, so
``bp_ground_state`` on a chain is gradient-based DMRG.  On loopy graphs the
energy is the Bethe estimate (not variational).

Two departures in form, not in result:

* torch's ``.grad`` of a real loss of complex parameters already is
  ``dE/dRe + i dE/dIm``, the direction the JAX package gets by conjugating
  JAX's gradient; it is used as it is.
* Adam is the optax update written out (:class:`~..ops.optim.Adam`: the
  second moment from ``|g|^2`` per complex element): for complex tensors
  ``torch.optim.Adam`` forms the second moment per real component, whose
  trajectory differs.
"""

import torch

from ..ops.optim import Adam, descend
from .bp import BPGraph
from .bp_gauge import _rebuild
from .bp_measure import term_batches


def make_bp_energy(tn, bond_terms=(), local_terms=(), n_sweeps=30,
                   damping=0.0, device=None):
    """Build a differentiable ``energy(tensors) -> real scalar``.

    ``tensors`` is the tuple of node tensors in ``tn.nodes()`` order
    (the template's values are only used for shapes/static structure).
    The energy is the sum of all term expectations at the ``n_sweeps``
    BP point — exact Rayleigh-quotient terms on trees.  Terms of one
    structure are closed as one batch (:class:`~.bp_measure.TermBatch`).
    Returns ``(energy, tensors0)`` with ``tensors0`` the network's own
    tensors on the device of the computation.
    """
    graph = BPGraph(tn, doubled=True, device=device)
    tensors0 = tuple(graph.node_tensors())
    batches, _ = term_batches(graph, [t.shape for t in tensors0],
                              local_terms, bond_terms)

    def energy(ts):
        msgs = graph.sweeps(graph.stacks(ts), n_sweeps, damping)
        total = 0.0
        for batch in batches:
            total = total + torch.real(batch.values(ts, msgs)).sum()
        return total

    energy.bonds = graph.bonds
    return energy, tensors0


def bp_energy(tn, bond_terms=(), local_terms=(), n_sweeps=30,
              damping=0.0, device=None):
    """One-shot BP energy of the network's current tensors."""
    fn, ts = make_bp_energy(tn, bond_terms, local_terms, n_sweeps,
                            damping, device)
    with torch.no_grad():
        return float(fn(ts))


def bp_ground_state(tn, bond_terms=(), local_terms=(), steps=400,
                    lr=0.02, n_sweeps=30, damping=0.0, device=None):
    """Gradient-descent ground state of a graph Hamiltonian with BP
    environments.

    The Hamiltonian is given as ``bond_terms`` ``(name_a, name_b, h2)``
    on adjacent node pairs plus optional ``local_terms`` ``(name, h1)``
    (each ``h`` on the fused physical space, Hermitian).  Each step runs
    the BP sweeps, the term assembly and their backward, then one Adam
    update.  Returns ``(optimized_tn, energies)``: ``energies[k]`` is the
    energy before the k-th update.

    On trees this is exact variational optimization (gradient DMRG);
    on loopy graphs it descends the Bethe energy estimate.
    """
    energy_fn, ts = make_bp_energy(tn, bond_terms, local_terms, n_sweeps,
                                   damping, device)
    params = [t.detach().clone().requires_grad_(True) for t in ts]
    opt = Adam(params, lr=float(lr))
    energies = []
    for _ in range(int(steps)):
        e = energy_fn(params)
        descend(opt, params, torch.autograd.grad(e, params))
        energies.append(e.detach())
    params = [p.detach() for p in params]
    energies = torch.stack(energies) if energies else torch.zeros(0)
    return _rebuild(tn, params, energy_fn.bonds), energies
