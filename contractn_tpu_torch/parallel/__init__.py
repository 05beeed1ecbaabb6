from .dryrun import dryrun_multichip
from .ensembles import dmrg_ensemble_sharded, ipeps_cell_scan_sharded
from .fit import fit_tn, make_tn_train_step
from .generative import fit_born_machine_sharded, make_sharded_born_loss
from .mesh import make_mesh
from .pipeline import make_pipeline_train_step, pipeline_mps_forward
from .rs_dmrg import dmrg_realspace
from .sharded import segment_mps_forward, sharded_mps_forward
from .spectra import cv_greens_function_sharded, cv_spectral_function_sharded
from .tp import make_tp_train_step, segment_mps_forward_3d
from .tp_dmrg import dmrg_uniform_tp, heff_matvec_tp
from .training import (
    loss_fn,
    make_optax_train_step,
    make_sharded_train_step,
    make_train_step,
    sgd_init,
)

__all__ = [
    "make_mesh",
    "dmrg_ensemble_sharded",
    "ipeps_cell_scan_sharded",
    "cv_greens_function_sharded",
    "cv_spectral_function_sharded",
    "dmrg_realspace",
    "dmrg_uniform_tp",
    "heff_matvec_tp",
    "fit_born_machine_sharded",
    "fit_tn",
    "make_sharded_born_loss",
    "make_tn_train_step",
    "make_pipeline_train_step",
    "pipeline_mps_forward",
    "sharded_mps_forward",
    "segment_mps_forward",
    "segment_mps_forward_3d",
    "make_train_step",
    "make_optax_train_step",
    "make_sharded_train_step",
    "make_tp_train_step",
    "sgd_init",
    "loss_fn",
]
