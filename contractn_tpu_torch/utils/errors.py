"""Error types and validation helpers.

Counterpart of ``contractn_tpu/utils/errors.py``: every user-facing failure
raises a real exception with an actionable message.
"""

import torch


class TNError(ValueError):
    """Base class for tensor-network construction/contraction errors."""


_FULL_NODE_NAMES = {
    "dense": "dense",
    "clone": "duplicate",
    "hyper": "copy",
    "input": "input",
    "dangler": "dangling",
}


def attribute_error_for(node_type: str, attr_name: str, node_name, actual_type):
    """Error for accessing a node-type-specific attribute on the wrong type."""
    full = _FULL_NODE_NAMES.get(node_type, node_type)
    return TNError(
        f"Only {full} nodes have {attr_name} attributes "
        f"(node '{node_name}' has node type '{actual_type}')"
    )


def check_valid_tensor(tensor) -> None:
    """Duck-typed tensor check: torch tensors, numpy arrays and anything
    else with ``.ndim`` and ``.shape`` are accepted as node tensors."""
    if not (hasattr(tensor, "ndim") and hasattr(tensor, "shape")):
        raise TypeError(
            "Core tensors must expose .ndim and .shape attributes "
            f"(got object of type {type(tensor).__name__})"
        )


def records_grad(*tensors):
    """Whether autograd would record an operation on ``tensors``: grad mode
    is on and one of them (``None`` entries aside) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def check_no_autograd(entry, *tensors):
    """Raise :class:`TNError` where autograd would record through ``entry``.

    The hand kernels write into fresh outputs and have no backward, so a
    gradient through them would be silently lost; the check runs on every
    device, so the CPU (where the wrappers run their plain versions) refuses
    what the GPU would.
    """
    if records_grad(*tensors):
        raise TNError(
            f"{entry} runs a hand kernel without a backward, and autograd is "
            "recording through its operands: call it under torch.no_grad(), or "
            "use the differentiable path (MPS.evaluate with kernel='auto' or "
            "'scan', MPO.expectation)"
        )
