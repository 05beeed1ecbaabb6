from .fit import fit_tn, make_tn_train_step
from .training import loss_fn, make_optax_train_step, make_train_step, sgd_init

__all__ = [
    "fit_tn",
    "loss_fn",
    "make_optax_train_step",
    "make_tn_train_step",
    "make_train_step",
    "sgd_init",
]
