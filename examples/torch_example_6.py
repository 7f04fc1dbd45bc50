"""Example 6 on the PyTorch port — on-device optimization and cached
predictive variances.

``examples/example_6.py`` on ``gpyrn_tpu_torch``, on ``device`` (the card
unless ``--device cpu`` is given):

1. ``optimize_device()`` — scipy-trajectory Nelder-Mead with the simplex
   on the device: every iteration's candidate points (reflection,
   expansion, contractions, shrink rows) are fitted in ONE batched call,
   and several restarts run in lockstep as one population.
2. ``build_love()`` — LOVE-style cached predictive variances: after a
   one-off Lanczos build, every predictive variance is one product
   (O(rank·N) per test point, no solves).  The build's products are the
   fused kernel-matrix product on the card.
3. ``run_hmc(..., mass_matrix='dense')`` — NUTS with a full
   warmup-adapted covariance mass matrix, every chain on the device,
   drawing its random numbers from a generator on that device (so its
   chain is the JAX package's only in distribution).

``love.predict`` and ``predict`` return tensors on the device; the
comparison brings them to the host with ``.cpu().numpy()``.

    python3 examples/torch_example_6.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc
from gpyrn_tpu_torch.inference import priors as pr
from gpyrn_tpu_torch.inference.hmc import run_hmc
from gpyrn_tpu_torch.models.iterative import build_love


def main(device="cuda"):
    """Run the example on ``device``; return the optimizer's result, the
    LOVE-vs-dense gaps and the NUTS chain's summary."""
    rng = np.random.default_rng(6)
    N = 40
    time = np.sort(rng.uniform(0, 80, N))
    y = 3 * np.sin(2 * np.pi * time / 21) + 0.3 * rng.standard_normal(N)
    yerr = np.full(N, 0.3)

    gprn = inference(1, time, y, yerr, device=device)
    gprn.set_components(covfunc.Periodic(2.0, 19.0, 0.8),
                        covfunc.SquaredExponential(1.0, 40.0),
                        [None], [0.3])

    # -- 1. hyperparameter search without the host in the loop ----------
    elbo0, *_ = gprn.ELBOcalc(max_iter=200)
    out = gprn.optimize_device(n_sweeps=20, max_iter=120, n_restarts=2,
                               spread=0.05)
    print(f"ELBO {elbo0:.4f} -> {out['elbo']:.4f} after {out['nit']} "
          f"on-device Nelder-Mead iterations "
          f"({out['nfev']} scipy-equivalent evals)")

    # -- 2. constant-time predictive variances from the LOVE cache ------
    love = build_love(gprn, rank=min(64, N))
    tstar = np.linspace(time.min() - 5, time.max() + 5, 200)
    _, mean_l, std_l, _ = love.predict(tstar=tstar)
    _, mean_d, std_d, _ = gprn.predict(tstar=tstar)
    dmean = float(np.max(np.abs(mean_l.cpu().numpy()
                                - mean_d.cpu().numpy())))
    dstd = float(np.max(np.abs(std_l.cpu().numpy() - std_d.cpu().numpy())))
    print(f"LOVE vs dense predict: max|Δmean| = {dmean:.2e}, "
          f"max|Δstd| = {dstd:.2e}")

    # -- 3. dense-mass NUTS over the two most correlated hyperparameters
    gprn._apply_vars_selection(['node1.P', 'jitter1'])
    res = run_hmc(gprn, {'node1.P': pr.Normal(out['x'][1], 1.0),
                         'jitter1': pr.LogNormal(np.log(0.3), 0.3)},
                  n_samples=40, n_warmup=60, n_chains=4, n_sweeps=10,
                  algorithm='nuts', max_depth=4, mass_matrix='dense',
                  p0=gprn.get_parameters(), seed=0)
    gprn.thaw_all_parameters()
    flat = res.get_chain(discard=10, flat=True)
    print(f"dense-mass NUTS: P = {flat[:, 0].mean():.2f} "
          f"± {flat[:, 0].std():.2f} "
          f"(acceptance {res.acceptance:.2f})")
    return {"elbo0": elbo0, "elbo": out["elbo"], "fun": out["fun"],
            "x": out["x"], "nit": out["nit"], "nfev": out["nfev"],
            "love_dmean": dmean, "love_dstd": dstd,
            "mean_love": mean_l.cpu().numpy()[::10, 0],
            "std_love": std_l.cpu().numpy()[::10, 0],
            "chain_shape": flat.shape, "chain_mean": flat.mean(axis=0),
            "chain_std": flat.std(axis=0),
            "acceptance": float(res.acceptance)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
