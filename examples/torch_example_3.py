"""Example 3 on the PyTorch port — two nodes, two outputs, mixed kernels.

``examples/example_3.py`` on ``gpyrn_tpu_torch``: a 2-node (Periodic +
Matern-5/2) × 2-output GPRN, with the multi-start optimizer exploring the
multi-modal ELBO surface from several restarts, split over a device mesh.

The port's multi-device layer runs one process per rank on
``torch.distributed``, so the mesh lives inside the ranks: the per-rank
work is the module-level function :func:`restarts`, started on every card
by ``gpyrn_tpu_torch.parallel.mesh.spawn`` (NCCL, one rank per card; with
``--device cpu``, one gloo rank).  Each rank builds the model, calls
``make_mesh()`` and ``multistart_optimize(..., mesh=mesh)``, and every
rank ends with the same result; rank 0's is printed.  ``spawn`` starts the
ranks with the ``spawn`` start method, so :func:`restarts` is imported by
the children from this module: run the file as a script or import it by
module name.

    python3 examples/torch_example_3.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from gpyrn_tpu_torch import inference, covfunc
from gpyrn_tpu_torch.parallel import make_mesh, multistart_optimize, use_mesh
from gpyrn_tpu_torch.parallel.mesh import spawn


def model(device):
    """The example's data and GPRN on ``device``."""
    rng = np.random.default_rng(1)
    N = 40
    time = np.sort(rng.uniform(0, 80, N))
    activity = np.sin(2 * np.pi * time / 25)
    trend = 0.02 * (time - 40)
    y1 = 5 * activity + 2 * trend + 0.3 * rng.standard_normal(N)
    y2 = -3 * activity + trend + 0.3 * rng.standard_normal(N)
    e1 = e2 = np.full(N, 0.3)

    gprn = inference(2, time, y1, e1, y2, e2, device=device)
    gprn.set_components(
        [covfunc.Periodic(3.0, 25.0, 0.8), covfunc.Matern52(1.0, 30.0)],
        [covfunc.SquaredExponential(2.0, 40.0) for _ in range(4)],
        [None, None], [0.3, 0.3])
    return gprn


def restarts(device):
    """One rank's part: the multi-start population over the mesh of all
    ranks (every rank on ``dp``).  Returns the result as numpy values."""
    gprn = model(device)
    mesh = make_mesh(device_type=torch.device(device).type)
    with use_mesh(mesh):
        out = multistart_optimize(gprn, n_restarts=max(4, mesh.size()),
                                  n_steps=60, n_sweeps=20, mesh=mesh,
                                  seed=0)
    return {k: np.asarray(v) for k, v in out.items()}


def main(device="cuda"):
    """Run the example on ``device``; return the initial ELBO and rank 0's
    multi-start result."""
    gprn = model(device)
    initial = gprn.ELBO
    print('initial ELBO =', initial)

    if torch.device(device).type == "cuda":
        world, backend = torch.cuda.device_count(), "nccl"
    else:
        world, backend = 1, "gloo"
    out = spawn(restarts, world, backend, torch.device(device).type,
                device)[0]
    print('best ELBO     =', float(out["elbo"]),
          f'(restart {int(out["winner"])})')
    print('restart ELBOs =', np.round(out["restart_elbos"], 2))
    return {"initial_elbo": initial, "world": world,
            "elbo": float(out["elbo"]), "winner": int(out["winner"]),
            "restart_elbos": out["restart_elbos"], "theta": out["theta"]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
