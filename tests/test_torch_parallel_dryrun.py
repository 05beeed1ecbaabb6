"""The port's multi-process dry run on the CPU.

``contractn_tpu_torch.parallel.dryrun_multichip(8)`` spawns its own world of
8 gloo ranks and runs the 3-axis ``dp x sp x tp`` training step and the
sharded model layer (ensemble, tensor-parallel and real-space DMRG, the
sharded Born machine and spectra) on tiny shapes, as the JAX package's
``__graft_entry__.dryrun_multichip`` does; every value must be finite.  A
failing rank is reported with its traceback.
"""

import pytest

from contractn_tpu_torch.parallel import dryrun_multichip
from contractn_tpu_torch.parallel.dryrun import run_cpu_world


def test_dryrun_multichip_runs_every_sharded_path(capsys):
    dryrun_multichip(8)
    assert "dryrun_multichip(8) OK" in capsys.readouterr().out


def _fails_on_rank_one(rank, world_size):
    if rank == 1:
        raise ValueError("rank one fails")


def test_a_failing_rank_is_reported_with_its_error():
    with pytest.raises(RuntimeError, match="(?s)rank 1 ---.*rank one fails"):
        run_cpu_world(_fails_on_rank_one, 2)
