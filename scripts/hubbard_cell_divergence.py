"""How far the checkerboard Hubbard optimizer parts from itself and from
the JAX package's under a tiny nudge to its start, on the CPU in float64.

    JAX_PLATFORMS=cpu python scripts/hubbard_cell_divergence.py \
        [--package jax|port|both] [--steps 500] [--nudge 0 1e-15 ...] \
        [--noise-seed 1] [--watch-cut] [--save runs.npz] [--against runs.npz]

Runs ``hubbard_cell_ground_state`` of ``examples/hubbard_ipeps.py``'s third
part (U 8, D 2, chi 12, Adam at 1e-2 from the Neel-dimer start) for STEPS
steps, once for each nudge: the start ``(a0, b0)`` becomes
``a0 * (1 + nudge * noise)`` with ``noise`` standard normal from
``--noise-seed``.  For each run it prints the final energy, the staggered
densities and the connected ``<Sz_0 Sz_r>`` (r = 1..4), and every ten
steps the gap between its energy trace and the first run's.  With
``--package both`` the first run is the JAX package's un-nudged one, and
the port runs after it.  ``--save`` writes each run's energy trace and
correlators; ``--against`` takes the first trace of such a file as the
reference for the gaps instead (another process, another thread count).

``--watch-cut`` (port only) records, at every step, the projector SVDs of
the cell CTMRG: the smallest ratio ``s[chi] / s[chi - 1]`` across the cut
(1 is a degenerate cut, where the truncation could keep either of two
vectors), the smallest relative gap between two kept singular values, and
the number of kept values that fall below the inverse-square-root cutoff,
then for each window of steps how many came within 1e-4 of a degenerate
cut and how many raised the energy.
"""

import argparse
import importlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KW = dict(bond_parities=(0, 1), chi=12, t=1.0, u=8.0, lr=1e-2, seed=0)


class CutWatch:
    """Wraps the port's ``ctmrg_cell._left_move`` and keeps, per step, the
    nearest approach of the SVD spectrum to a degenerate cut."""

    def __init__(self):
        self.mod = importlib.import_module("contractn_tpu_torch.models.ctmrg_cell")
        self.orig = self.mod._left_move
        self.steps = []
        self.new_step()

    def new_step(self):
        self.cur = {"cut": 0.0, "kept_gap": np.inf, "below_tol": 0}
        self.steps.append(self.cur)

    def __enter__(self):
        def left_move(a, env, x, chi, svd_fn=self.mod.small_svd):
            def svd(f):
                out = svd_fn(f)
                s = out[1].detach().cpu().numpy()
                k = min(chi, f.shape[1], f.shape[2])
                if s.shape[-1] > k:
                    ratio = s[:, k] / np.maximum(s[:, k - 1], 1e-300)
                    self.cur["cut"] = max(self.cur["cut"], float(ratio.max()))
                kept = s[:, :k]
                gaps = (kept[:, :-1] - kept[:, 1:]) / np.maximum(kept[:, :1], 1e-300)
                self.cur["kept_gap"] = min(self.cur["kept_gap"], float(gaps.min()))
                self.cur["below_tol"] = max(self.cur["below_tol"], int(
                    (kept <= self.mod._SVD_TOL * kept[:, :1]).sum(axis=1).max()))
                return out

            return self.orig(a, env, x, chi, svd_fn=svd)

        self.mod._left_move = left_move
        return self

    def __exit__(self, *exc):
        self.mod._left_move = self.orig


def start(nudge, noise_seed):
    from contractn_tpu_torch.models.fipeps_spin import neel_dimer_init

    a0, b0 = neel_dimer_init(KW["bond_parities"], seed=KW["seed"])
    rng = np.random.default_rng(noise_seed)
    return tuple(x * (1 + nudge * rng.standard_normal(x.shape)) for x in (a0, b0))


def run(package, steps, init, watch=None):
    """One optimization; returns ``(trace, energy, obs, <Sz_0 Sz_r>)``."""
    if package == "jax":
        import jax

        jax.config.update("jax_enable_x64", True)
        mod = importlib.import_module("contractn_tpu.models.fipeps_spin")

        extra = {}
    else:
        mod = importlib.import_module("contractn_tpu_torch.models.fipeps_spin")

        extra = {"device": "cpu"}
    if watch is not None:
        fipeps = importlib.import_module("contractn_tpu_torch.models.fipeps")
        orig_descent = fipeps._masked_descent

        def descent(loss, params, mask, env, steps, lr):
            def counted(p, env):
                watch.new_step()
                return loss(p, env)

            return orig_descent(counted, params, mask, env, steps, lr)

        fipeps._masked_descent = descent
        mod._masked_descent = descent
    try:
        a, b, e, obs, trace = mod.hubbard_cell_ground_state(steps=steps, init=init, **KW,
                                                            **extra)
    finally:
        if watch is not None:
            fipeps._masked_descent = orig_descent
            mod._masked_descent = orig_descent
    bp = (np.asarray(KW["bond_parities"]),) * 4
    sites = ((a, b), (b, a))
    sc = mod.hubbard_cell_correlator(sites, bp, mod.hubbard_cell_env(sites, bp, chi=KW["chi"]),
                                     mod.SZ, mod.SZ, [1, 2, 3, 4])
    return np.asarray(trace), e, obs, [float(v) for v in sc]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--nudge", type=float, nargs="+", default=[0.0])
    ap.add_argument("--noise-seed", type=int, default=1)
    ap.add_argument("--watch-cut", action="store_true")
    ap.add_argument("--save", help="write every run's energy trace and <Sz_0 Sz_r> to this .npz")
    ap.add_argument("--against", help="an .npz of --save whose first trace the gaps are taken to")
    args = ap.parse_args()
    runs = [(p, n) for p in (("jax", "port") if args.package == "both" else (args.package,))
            for n in args.nudge]
    first, saved = None, {}
    if args.against:
        ref = np.load(args.against)
        name = next(k for k in ref.files if k.endswith("_trace"))
        first = (f"{args.against}: {name[:-len('_trace')]}", None, ref[name])
    for package, nudge in runs:
        watch = None
        if args.watch_cut and package == "port":
            watch = CutWatch()
        if watch is not None:
            with watch:
                trace, e, obs, sc = run(package, args.steps, start(nudge, args.noise_seed),
                                        watch)
        else:
            trace, e, obs, sc = run(package, args.steps, start(nudge, args.noise_seed))
        print(f"{package} nudge {nudge:g} (noise seed {args.noise_seed}): "
              f"E + U/2 = {e + KW['u'] / 2:.10f}, n_up {obs['n_up'][0][0]:.6f} / "
              f"{obs['n_up'][1][0]:.6f}, docc {obs['docc'][0][0]:.6f}, <Sz_0 Sz_r> "
              + " ".join(f"{v:+.3e}" for v in sc), flush=True)
        saved[f"{package}_{nudge:g}_trace"] = trace
        saved[f"{package}_{nudge:g}_sz"] = np.asarray(sc)
        if args.save:
            np.savez(args.save, **saved)
        if first is None:
            first = (package, nudge, trace)
        else:
            n = min(len(trace), len(first[2]))
            gap = np.abs(trace[:n] - first[2][:n])
            print(f"  |E - E({first[0]}{'' if first[1] is None else f', nudge {first[1]:g}'})|"
                  " every 10 steps: "
                  + " ".join(f"{k}:{gap[k]:.1e}" for k in range(0, n, 10)),
                  flush=True)
        if watch is not None:
            # watch.steps[0] is the set-up before the first step
            for k, st in enumerate(watch.steps[1:]):
                print(f"  step {k:4d}: E {trace[k]:+.12f}  cut s[chi]/s[chi-1] "
                      f"{st['cut']:.6f}  min kept gap {st['kept_gap']:.2e}  "
                      f"kept below tol {st['below_tol']}")
            cuts = np.asarray([st["cut"] for st in watch.steps[1:]])
            rises = np.diff(trace) > 0
            for lo, hi in ((0, 100), (100, 169), (169, 190), (190, 300), (300, len(trace))):
                if lo < len(trace):
                    w = cuts[lo:hi]
                    print(f"  steps {lo}-{min(hi, len(trace)) - 1}: cut within 1e-4 of "
                          f"degenerate at {int((w > 0.9999).sum())} (largest ratio "
                          f"{w.max():.6f} at step {lo + int(w.argmax())}), energy rose at "
                          f"{int(rises[lo:hi - 1].sum())}")


if __name__ == "__main__":
    main()
