"""Example 2 on the PyTorch port — two outputs, one node, on the bundled
solar dataset.

``examples/example_2.py`` on ``gpyrn_tpu_torch``: the bundled
Solar_observations.txt (RV + FWHM), 100 of its points, and 100 adam
steps on the unrolled ELBO gradient (``torch.optim.Adam`` with optax's
defaults, so the trajectory is the JAX package's), on ``device`` (the
card unless ``--device cpu`` is given).

    python3 examples/torch_example_2.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc, meanfunc
from gpyrn_tpu_torch.datasets import load_solar


def main(device="cuda"):
    """Run the example on ``device``; return the ELBOs, adam's best loss
    and the optimized parameters."""
    time, data = load_solar(("RV", "FWHM"))
    # subsample for a quick demo
    keep = slice(0, 200, 2)
    time = time[keep]
    data = [d[keep] for d in data]

    gprn = inference(1, time, *data, device=device)
    gprn.set_components(
        covfunc.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
        [covfunc.SquaredExponential(np.std(data[0]), 30.0),
         covfunc.SquaredExponential(np.std(data[2]), 30.0)],
        [meanfunc.Constant(0.0), meanfunc.Constant(0.0)],
        [np.std(data[0]) / 2, np.std(data[2]) / 2])

    initial = gprn.ELBO
    print('initial ELBO =', initial)

    res = gprn.optimize_adam(n_steps=100, learning_rate=2e-2)
    print('optimized ELBO =', res["elbo"])
    params = gprn.parameters_dict
    for name, val in params.items():
        print(f'  {name:18s} = {val:.4f}')

    try:
        import matplotlib.pyplot as plt
        fig, _ = gprn.plot_prediction(nn=500)
        fig.savefig('solar_prediction.png', bbox_inches='tight')
        plt.close(fig)
        print('saved solar_prediction.png')
    except ImportError:
        pass
    return {"initial_elbo": initial, "elbo": res["elbo"],
            "fun": res["fun"],
            "theta": np.array([float(v) for v in params.values()])}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
