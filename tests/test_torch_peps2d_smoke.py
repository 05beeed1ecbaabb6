"""``chip_smoke.py``'s phase 12 rehearsed on the CPU at ``PEPS2D_TINY`` (the
"card" is the CPU here): every path runs through the user entry points with
its checks, and none may launch a hand kernel."""

import torch

import chip_smoke

torch.set_num_threads(1)


def test_chip_smoke_peps2d_rehearsal():
    runs = chip_smoke.peps2d_paths(torch.device("cpu"), "CPU", chip_smoke.PEPS2D_TINY)
    assert set(runs) == {"cell_ctmrg", "cell_su", "scan", "full_update", "variational",
                         "thermal2d", "fermions", "sampling"}
    assert all(not any(counts.values()) for counts, _ in runs.values())
