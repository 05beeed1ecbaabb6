"""Gradient training of ARBITRARY tensor networks.

Counterpart of ``contractn_tpu/parallel/fit.py``.  Any TN — any topology,
with copy tensors, clones and input nodes — contracts through
:meth:`TN.make_contract_fun` as eager torch, so its dense-node parameters
train under autograd with any torch optimizer: clones receive the SUM of
their slots' gradients, input nodes carry the data batch, and the
split-format log register keeps losses finite for arbitrarily deep networks.
Gradients land on the parameters' device.

``fit_tn`` runs the loop and writes the trained parameters back into the
TN's nodes at the end, so the graph object stays the source of truth.
"""

from ..utils.device import as_tensor, resolve_device
from .training import load_params, optimizer_step


def make_tn_train_step(tn, optimizer, loss_fn, optimize="auto", **kwargs):
    """Training step over a TN's parameter tuple.

    Args:
        tn: the network; its dense-node tensors are the trainables.
        optimizer: a factory ``params -> torch.optim.Optimizer``, the
            counterpart of the JAX package's optax ``GradientTransformation``.
        loss_fn: ``loss_fn(output, *batch) -> scalar`` applied to the
            SPLIT-FORMAT contraction output ``(mantissa, log_scale)`` plus
            whatever batch tensors the caller passes to the step.
        optimize / kwargs: forwarded to ``make_contract_fun`` (e.g.
            ``device="cpu"``).

    Returns:
        ``(step, init)``: ``init(params)`` builds the optimizer over copies
        of the parameter tensors; ``step(params, opt_state, inputs, *batch)
        -> (params, opt_state, loss)`` loads ``params`` into it and takes
        one step.  ``inputs`` is the tuple for the TN's input nodes (``()``
        if none).
    """
    cfun = tn.make_contract_fun(split_format=True, optimize=optimize, **kwargs)

    def init(params):
        return optimizer([p.detach().clone().requires_grad_(True) for p in params])

    def step(params, opt_state, inputs, *batch):
        leaves = load_params(opt_state, params)
        value = optimizer_step(
            opt_state, leaves, lambda p: loss_fn(cfun(tuple(p), inputs), *batch)
        )
        return tuple(p.detach().clone() for p in leaves), opt_state, value

    return step, init


def fit_tn(tn, optimizer, loss_fn, steps, inputs=(), batch=(),
           optimize="auto", **kwargs):
    """Train a TN's parameters in place; returns the loss trace (floats).

    Parameters held as numpy arrays start on ``kwargs["device"]`` (default
    ``cuda``); torch parameters keep their device.  The trained tensors are
    written back into the TN's dense nodes when the loop finishes (node
    identity and topology are untouched).
    """
    device = resolve_device(kwargs.get("device"), tn.params)
    step, init = make_tn_train_step(tn, optimizer, loss_fn,
                                    optimize=optimize, **kwargs)
    params = tuple(as_tensor(p, device) for p in tn.params)
    opt_state = init(params)
    trace = []
    for _ in range(int(steps)):
        params, opt_state, loss = step(params, opt_state, tuple(inputs), *batch)
        trace.append(float(loss))
    dense_nodes = [n for n in tn.nodes(as_iter=True) if n.node_type == "dense"]
    for node, p in zip(dense_nodes, params):
        node.tensor = p
    return trace
