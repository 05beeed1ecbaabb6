"""contractn_tpu_torch — the PyTorch/CUDA port of contractn_tpu.

Tensor networks are defined as graphs of typed nodes (dense cores,
weight-sharing clones, copy-tensor hyperedges, runtime inputs) and contracted
as stabilized einsum contractions in split format, eagerly in PyTorch, or
approximately by belief propagation (``bp_*``).  The MPS/MPO model layer
runs its batched chains through hand-written CUDA kernels for Hopper
(``csrc/``).  Entry points compute on the GPU unless the
caller asks for the CPU (``device="cpu"``).

The JAX package ``contractn_tpu`` beside this one is the reference the port
is held against; this package imports nothing of it.
"""

from .compiler.bp import bp_contract, bp_environment
from .compiler.bp_gauge import bp_gauge, bp_norm, bp_truncate
from .compiler.bp_measure import bp_measure
from .compiler.bp_update import bp_apply_gates, gate_from_term
from .compiler.bp_variational import (
    bp_energy,
    bp_ground_state,
    make_bp_energy,
)
from .compiler.engine import contract
from .compiler.expression import contract_expression
from .edges import Edge
from .network import TN
from .nodes import Node
from .ops.stabilize import destabilize, stabilize
from .utils.errors import TNError

__version__ = "0.1.0"

__all__ = [
    "TN",
    "Node",
    "Edge",
    "contract",
    "contract_expression",
    "bp_contract",
    "bp_environment",
    "bp_apply_gates",
    "bp_gauge",
    "bp_energy",
    "bp_ground_state",
    "bp_measure",
    "make_bp_energy",
    "bp_norm",
    "bp_truncate",
    "gate_from_term",
    "stabilize",
    "destabilize",
    "TNError",
    "__version__",
]
