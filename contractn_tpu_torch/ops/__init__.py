from .chain import (
    stabilized_chain_product,
    stabilized_hadamard_product,
    stabilized_ring_product,
    tree_chain_product,
)
from .cuda_epilogue import epilogue_chain, mps_evaluate_epilogue
from .cuda_mpo import make_mpo_cuda_fn, mpo_env, mpo_expectation_cuda
from .cuda_mps import cuda_mps_evaluate
from .krylov import lanczos_basis, lanczos_ground, masked_tridiagonal
from .scan import (
    mps_evaluate,
    mps_evaluate_auto,
    mps_evaluate_fused,
    mps_evaluate_perphys,
    mps_evaluate_premix,
    mps_norm,
    scan_matrix_chain,
)
from .stabilize import MIN_NORM, destabilize, dot_precision, stabilize, stabilize_batched

__all__ = [
    "MIN_NORM",
    "cuda_mps_evaluate",
    "destabilize",
    "dot_precision",
    "epilogue_chain",
    "lanczos_basis",
    "lanczos_ground",
    "masked_tridiagonal",
    "make_mpo_cuda_fn",
    "mpo_env",
    "mpo_expectation_cuda",
    "mps_evaluate",
    "mps_evaluate_auto",
    "mps_evaluate_epilogue",
    "mps_evaluate_fused",
    "mps_evaluate_perphys",
    "mps_evaluate_premix",
    "mps_norm",
    "scan_matrix_chain",
    "stabilize",
    "stabilize_batched",
    "stabilized_chain_product",
    "stabilized_hadamard_product",
    "stabilized_ring_product",
    "tree_chain_product",
]
