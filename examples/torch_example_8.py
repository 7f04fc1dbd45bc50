"""Example 8 on the PyTorch port — production serving of a fitted GPRN.

``examples/example_8.py`` on ``gpyrn_tpu_torch``: the fitted posterior
predictive becomes a self-contained artifact (``gpyrn_tpu_torch.serving``,
built on ``torch.export``):

1. fit on ``device`` (the card unless ``--device cpu`` is given),
2. ``export_predict`` → a ``torch.export`` program with the training
   inputs and variational state baked in (a symbolic request size: one
   artifact answers any number of prediction points),
3. the serving side loads it with ``serving.load_predict`` and no model
   object.  It needs torch and this package's operator module (the
   kernel-matrix operator the program calls); on the card that operator
   launches the B1 kernel, which ``nvcc`` builds at its first use.  An
   artifact serves on the device it was exported on, and returns tensors
   there (brought to the host here with ``.cpu().numpy()``).

    python3 examples/torch_example_8.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc, meanfunc, serving


def main(device="cuda"):
    """Run the example on ``device``; return the fit, the served ranges
    and the served-vs-in-process deviation.  Writes the artifact
    ``gprn_predict.pt2``."""
    rng = np.random.default_rng(8)
    N = 50
    time = np.sort(rng.uniform(0, 80, N))
    y = 1.8 * np.sin(2 * np.pi * time / 17) + 0.2 * rng.standard_normal(N)
    yerr = np.full(N, 0.2)

    gprn = inference(1, time, y, yerr, device=device)
    gprn.set_components(covfunc.Periodic(1.5, 17.0, 0.6),
                        covfunc.SquaredExponential(1.0, 40.0),
                        meanfunc.Constant(0.0), 0.2)

    # -- 1. fit ----------------------------------------------------------
    elbo, mu, var, it = gprn.ELBOcalc(max_iter=500)
    print(f"fit: ELBO = {elbo:.4f} in {it} iterations")

    # -- 2. export the fitted predictive ---------------------------------
    nbytes = gprn.export_predict("gprn_predict.pt2")
    print(f"artifact: {nbytes} bytes on disk")

    # -- 3. 'serving box': torch, the operator module and the artifact ---
    serve = serving.load_predict("gprn_predict.pt2")
    served = {}
    for n_req in (25, 400):                 # one artifact, any request size
        tstar = np.linspace(-5.0, 85.0, n_req)
        mean, varr = (x.cpu().numpy() for x in serve(tstar)[:2])
        served[n_req] = (mean.min(), mean.max(), np.sqrt(varr).max())
        print(f"served {n_req:4d} points: mean range "
              f"[{mean.min():+.3f}, {mean.max():+.3f}], "
              f"max std {np.sqrt(varr).max():.3f}")

    # the served program IS the research-path predict
    tstar = np.linspace(0.0, 80.0, 60)
    mean_serve = serve(tstar)[0].cpu().numpy()
    mean_research = gprn._Prediction(tstar=tstar)[0].cpu().numpy()
    dev = float(np.max(np.abs(mean_serve - mean_research)))
    print(f"served vs in-process predict: max |dev| = {dev:.3e}")
    assert dev < 1e-10
    return {"elbo": elbo, "iterations": it, "nbytes": nbytes,
            "served_25": np.array(served[25]),
            "served_400": np.array(served[400]), "dev": dev,
            "mean_serve": mean_serve[::3, 0]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
