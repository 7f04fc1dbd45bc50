"""Example 7 on the PyTorch port — converged polish and population
Nelder-Mead.

``examples/example_7.py`` on ``gpyrn_tpu_torch``, on ``device`` (the card
unless ``--device cpu`` is given):

1. ``refine_sweeps = 'converge'`` — the mixed-precision fit's float64
   polish driven to TRUE stationarity by the Anderson-accelerated
   fixed-point solver (``ops/fixedpoint.py``).  The coordinate-ascent
   sweep map converges linearly with spectral radius → 1 as N grows, and
   the reference's rel-std stopping rule halts far short of the fixed
   point; Anderson mixing reaches it in a few dozen sweeps.
2. ``multistart_optimize(method='nm')`` — a population of
   scipy-trajectory Nelder-Mead simplexes in lockstep (one batched fit of
   every simplex's candidates per iteration), on one process here; with a
   mesh (see ``torch_example_3.py``) the restarts split over its ranks.

    python3 examples/torch_example_7.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc
from gpyrn_tpu_torch.parallel import multistart_optimize


def main(device="cuda"):
    """Run the example on ``device``; return the three ELBOs, the
    converged polish's iteration count and the population's result."""
    rng = np.random.default_rng(7)
    N = 60
    time = np.sort(rng.uniform(0, 90, N))
    y = (2.5 * np.sin(2 * np.pi * time / 23)
         + 0.3 * rng.standard_normal(N))
    yerr = np.full(N, 0.3)

    gprn = inference(1, time, y, yerr, device=device)
    gprn.set_components(covfunc.QuasiPeriodic(2.0, 40.0, 21.0, 0.8),
                        covfunc.SquaredExponential(1.0, 35.0),
                        [None], [0.3])

    # -- 1. how much ELBO does the reference stopping rule leave behind?
    e_ref, *_ = gprn.ELBOcalc()                 # reference rel-std(3) rule
    e_3sweep, *_ = gprn.ELBOcalc(precision='mixed', mu='init', var='init')
    gprn.refine_sweeps = 'converge'             # Anderson fixed-point polish
    gprn.refine_tol = 1e-9
    e_conv, _, _, n_sweeps = gprn.ELBOcalc(precision='mixed',
                                           mu='init', var='init')
    print(f"ELBO: reference rule {e_ref:.6f} | mixed +3 sweeps "
          f"{e_3sweep:.6f} | converged fixed point {e_conv:.6f} "
          f"({n_sweeps} total iterations)")

    # -- 2. population Nelder-Mead from perturbed restarts --------------
    gprn.refine_sweeps = 3
    out = multistart_optimize(gprn, n_restarts=4, n_steps=80, n_sweeps=15,
                              method='nm', seed=1)
    print(f"population NM: restart ELBOs "
          f"{np.round(out['restart_elbos'], 3)}"
          f" -> winner {out['winner']} at ELBO {out['elbo']:.4f}")
    return {"e_ref": e_ref, "e_3sweep": e_3sweep, "e_conv": e_conv,
            "n_sweeps": n_sweeps, "restart_elbos": out["restart_elbos"],
            "winner": out["winner"], "elbo": out["elbo"],
            "theta": out["theta"], "nit": out["nit"]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
