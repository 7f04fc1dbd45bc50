"""Example 1 on the PyTorch port — one dataset, one node.

``examples/example_1.py`` on ``gpyrn_tpu_torch``: fit a 1-node × 1-output
GPRN to a noisy sinusoid, compare two weight length-scales, and plot the
posterior predictive.  The fit runs on ``device`` (the card unless
``--device cpu`` is given); ``predict`` returns tensors on that device,
brought to the host with ``.cpu().numpy()`` for the plot.

    python3 examples/torch_example_1.py [--device cpu]
"""
import argparse

import numpy as np

from gpyrn_tpu_torch import inference, covfunc, meanfunc


def main(device="cuda"):
    """Run the example on ``device``; return what it prints, and every
    50th point of the predictive."""
    time = np.linspace(0, 100, 25)
    y1 = 20 * np.sin(2 * np.pi * time / 31)
    y1err = np.random.default_rng(0).random(25)

    gprn = inference(1, time, y1, y1err, device=device)

    # short weight length-scale
    gprn.set_components([covfunc.Periodic(15, 31, 0.5)],
                        [covfunc.SquaredExponential(1, 1)],
                        [meanfunc.Constant(0)], [0.5])
    elbo_short, m, v, _ = gprn.ELBOcalc()
    print('ELBO (ell_w = 1)   =', elbo_short)

    # long weight length-scale — better ELBO: the weight should be
    # ~constant
    gprn.set_components([covfunc.Periodic(15, 31, 0.5)],
                        [covfunc.SquaredExponential(1, 100)],
                        [meanfunc.Constant(0)], [0.5])
    elbo_long, m, v, _ = gprn.ELBOcalc()
    print('ELBO (ell_w = 100) =', elbo_long)

    tstar, mean, std, _ = gprn.predict(nn=1000)
    mean, std = mean.cpu().numpy(), std.cpu().numpy()   # device → host

    try:
        import matplotlib.pyplot as plt
        plt.figure(figsize=(8, 4))
        plt.errorbar(time, y1, y1err, fmt='ob', markersize=7, label='data')
        plt.plot(tstar, mean[:, 0], '--k', linewidth=2, label='predictive')
        plt.fill_between(tstar, mean[:, 0] - std[:, 0],
                         mean[:, 0] + std[:, 0], alpha=0.2)
        plt.xlabel('Time (days)')
        plt.ylabel('Measurements')
        plt.legend(loc='upper right')
        plt.grid(which='major', alpha=0.5)
        plt.savefig('dataAndPrediction.png', bbox_inches='tight')
        plt.close()
        print('saved dataAndPrediction.png')
    except ImportError:
        pass
    return {"elbo_short": elbo_short, "elbo_long": elbo_long,
            "tstar": tstar[::50], "mean": mean[::50, 0],
            "std": std[::50, 0]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
