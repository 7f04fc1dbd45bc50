"""Example 4 on the PyTorch port — MCMC over hyperparameters + evidence
estimation.

``examples/example_4.py`` on ``gpyrn_tpu_torch``: the native ensemble
sampler batches every walker's ELBO fit into one call on ``device`` (the
card unless ``--device cpu`` is given), and the chain feeds the Perrakis
evidence estimator.  The priors are scipy's, so the chain runs the host
loop (the walkers' moves drawn by numpy, the fits on the device): the
same chain as the JAX package's for the same seeds.  Two draws that the
JAX example leaves unseeded are seeded here, so that a run can be
repeated: the initial walkers, which the priors' ``rvs()`` draw from
numpy's global generator (``np.random.seed``), and the estimator's
reshuffle (``rng=``).

    python3 examples/torch_example_4.py [--device cpu]
"""
import argparse

import numpy as np
import scipy.stats as st

from gpyrn_tpu_torch import inference, covfunc
from gpyrn_tpu_torch.inference import evidence as ev

WALKER_SEED = 0
PERRAKIS_SEED = 0


def main(device="cuda"):
    """Run the example on ``device``; return the chain's summary and the
    evidence estimate.  Writes the checkpoint ``gprn_chain.npz``."""
    rng = np.random.default_rng(2)
    N = 30
    time = np.sort(rng.uniform(0, 60, N))
    y = 4 * np.sin(2 * np.pi * time / 17) + 0.3 * rng.standard_normal(N)
    yerr = np.full(N, 0.3)

    gprn = inference(1, time, y, yerr, device=device)
    gprn.set_components(covfunc.Periodic(4.0, 17.0, 0.7),
                        covfunc.SquaredExponential(1.0, 40.0),
                        None, 0.3)
    gprn.ELBOcalc()

    priors = {
        'node1.theta': st.lognorm(s=0.5, scale=4.0),
        'node1.P': st.norm(17.0, 1.0),
        'node1.ell': st.lognorm(s=0.5, scale=0.7),
        'weight1.theta': st.lognorm(s=0.5, scale=1.0),
        'weight1.ell': st.lognorm(s=0.5, scale=40.0),
        'jitter1': st.lognorm(s=0.5, scale=0.3),
    }

    np.random.seed(WALKER_SEED)   # the initial walkers' prior draws
    result = gprn.mcmc(priors, niter=200, elbo_max_iter=60, seed=0,
                       checkpoint='gprn_chain.npz', progress=True)
    print('converged:', result.converged, ' acceptance:', result.acceptance)

    chain = result.get_chain(discard=result.iteration // 4, flat=True)
    names = list(result.parameter_names)
    for k, name in enumerate(names):
        print(f'{name:16s} = {chain[:, k].mean():.3f} '
              f'+- {chain[:, k].std():.3f}')

    # Bayesian evidence from the posterior samples (ELBO surrogate
    # likelihood); batch_elbo fits the rows on the device and returns numpy
    def lnlike(thetas):
        return ev.batch_elbo(gprn, thetas, max_iter=60)

    def lnprior(thetas):
        thetas = np.atleast_2d(thetas)
        return sum(priors[n].logpdf(thetas[:, k])
                   for k, n in enumerate(names))

    logz = ev.compute_perrakis_estimate(
        chain[-500:], lnlike, lnprior, nsamples=300,
        rng=np.random.default_rng(PERRAKIS_SEED))
    print('Perrakis log-evidence:', logz)
    return {"converged": bool(result.converged),
            "acceptance": float(np.mean(result.acceptance)),
            "iteration": int(result.iteration), "names": names,
            "chain_mean": chain.mean(axis=0), "chain_std": chain.std(axis=0),
            "logz": float(logz)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
