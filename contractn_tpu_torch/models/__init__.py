from .born import born_machine, born_nll, fit_born_machine, mps_log_prob
from .boundary import (
    apply_mpo_to_mps,
    boundary_contract,
    peps_expectation,
    peps_norm,
)
from .canonical import (
    compress,
    compress_fixed,
    compress_mpo,
    entanglement_entropy,
    imaginary_time_step,
    left_canonicalize,
    mps_add,
    right_canonicalize,
    schmidt_spectra,
    truncate_safe,
)
from .decompositions import cp_tn, mps_tn, tensor_ring_tn, tucker_tn
from .dmrg import heisenberg_mpo, tfim_mpo
from .features import fourier_features, one_hot, trig_features
from .mpo import MPO, mpo_from_bond_term, rayleigh
from .mps import MPS
from .peps import peps_tn
from .sampling import sample, sample_canonical, sample_conditional

__all__ = [
    "MPO",
    "MPS",
    "apply_mpo_to_mps",
    "born_machine",
    "born_nll",
    "boundary_contract",
    "compress",
    "compress_fixed",
    "compress_mpo",
    "cp_tn",
    "entanglement_entropy",
    "fit_born_machine",
    "fourier_features",
    "heisenberg_mpo",
    "imaginary_time_step",
    "left_canonicalize",
    "mpo_from_bond_term",
    "mps_add",
    "mps_tn",
    "mps_log_prob",
    "one_hot",
    "peps_expectation",
    "peps_norm",
    "peps_tn",
    "rayleigh",
    "right_canonicalize",
    "sample",
    "sample_canonical",
    "sample_conditional",
    "schmidt_spectra",
    "tensor_ring_tn",
    "tfim_mpo",
    "trig_features",
    "truncate_safe",
    "tucker_tn",
]
