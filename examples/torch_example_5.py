"""Example 5 on the PyTorch port — precision modes, NUTS, and the
matrix-free path.

``examples/example_5.py`` on ``gpyrn_tpu_torch``, on ``device`` (the card
unless ``--device cpu`` is given):

1. ``ELBOcalc(precision='mixed')`` — float32 coordinate ascent with the
   exact reference nugget, polished by float64 sweeps and the float64
   ELBO.  The H100 has float64 units, so the polish runs in native
   float64 on the same card (``refine_method`` 'auto' or 'f64'); the JAX
   package's double-single emulation for float32-only hardware,
   ``refine_method='df64'``, has no counterpart here and raises.
2. ``mcmc(sampler='hmc', algorithm='nuts')`` — the multinomial no-U-turn
   sampler with dual-averaging warmup and a diagonal mass matrix, every
   chain on the device, drawing its random numbers from a generator on
   that device (so its chain is the JAX package's only in distribution).
3. ``predict_iterative`` — the GPRN posterior predictive through
   matrix-free conjugate-gradient solves (the kernel matrices never
   stored: on the card every product is the fused kernel-matrix product):
   the N ≫ 20k path.  Its tensors are brought to the host with
   ``.cpu().numpy()``.

    python3 examples/torch_example_5.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc
from gpyrn_tpu_torch.inference import priors as pr
from gpyrn_tpu_torch.models.iterative import predict_iterative


def main(device="cuda"):
    """Run the example on ``device``; return the two ELBOs, the NUTS
    chain's summary, the CG-vs-dense gap and every 10th point of the CG
    predictive."""
    rng = np.random.default_rng(5)
    N = 40
    time = np.sort(rng.uniform(0, 80, N))
    y = 3 * np.sin(2 * np.pi * time / 21) + 0.3 * rng.standard_normal(N)
    yerr = np.full(N, 0.3)

    gprn = inference(1, time, y, yerr, device=device)
    gprn.set_components(covfunc.Periodic(3.0, 21.0, 0.8),
                        covfunc.SquaredExponential(1.0, 40.0),
                        [None], [0.3])

    # -- 1. mixed-precision fit with the float64 polish -----------------
    elbo_mixed, mu, var, it = gprn.ELBOcalc(precision='mixed')
    print(f"mixed-precision ELBO = {elbo_mixed:.4f}  "
          f"({it} iterations; polish: {gprn.refine_method!r})")

    # plain fit (reference stopping rule) for comparison
    elbo_plain, *_ = gprn.ELBOcalc()
    print(f"reference-rule ELBO  = {elbo_plain:.4f} "
          "(stops earlier; mixed converges the state fully)")

    # -- 2. NUTS over the period and jitter -----------------------------
    gprn._apply_vars_selection(['node1.P', 'jitter1'])
    priors = {'node1.P': pr.Normal(21.0, 1.0),
              'jitter1': pr.LogNormal(np.log(0.3), 0.4)}
    res = gprn.mcmc(priors, p0=gprn.get_parameters(), sampler='hmc',
                    algorithm='nuts', niter=60, n_warmup=60, n_chains=2,
                    n_sweeps=8, max_depth=5, seed=1)
    chain = res.get_chain(discard=20, flat=True)
    print(f"NUTS period posterior: {chain[:, 0].mean():.3f} "
          f"± {chain[:, 0].std():.3f} (truth 21)")
    gprn.thaw_all_parameters()

    # -- 3. matrix-free prediction --------------------------------------
    tstar = np.linspace(0, 80, 200)
    _, mean_cg, std_cg, _ = predict_iterative(gprn, tstar=tstar, tol=1e-9)
    _, mean_dense, std_dense, _ = gprn.predict(tstar=tstar)
    mean_cg = mean_cg.cpu().numpy()                      # device → host
    gap = np.max(np.abs(mean_cg - mean_dense.cpu().numpy()))
    print(f"CG vs dense predictive mean: max |Δ| = {gap:.2e} "
          "(same math, no dense kernel matrices)")
    return {"elbo_mixed": elbo_mixed, "iterations": it,
            "elbo_plain": elbo_plain, "chain_shape": chain.shape,
            "chain_mean": chain.mean(axis=0), "chain_std": chain.std(axis=0),
            "acceptance": float(res.acceptance), "gap": float(gap),
            "mean_cg": mean_cg[::10, 0],
            "std_cg": std_cg.cpu().numpy()[::10, 0]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
