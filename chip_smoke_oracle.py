#!/usr/bin/env python3
"""Write chip_smoke_oracle.json: the JAX package's float64 results that
``chip_smoke.py`` holds the port's on the card against
(``chip_smoke.py`` itself never imports jax), all at N=1000:

* the 10-sweep ``ELBOcalc`` of the headline and flagship models;
* ``engine.elbo_value_and_grad`` from the heuristic start, 30 sweeps for
  the headline model and 10 for the flagship;
* five ``optimize_adam`` steps of the headline model (30 sweeps each).

    JAX_PLATFORMS=cpu python3 chip_smoke_oracle.py

Runs on the CPU in a few minutes.
"""
from __future__ import annotations

import json
import os

import numpy as np

import chip_smoke

COMMAND = "JAX_PLATFORMS=cpu python3 chip_smoke_oracle.py"
STRIDE = 97


def main():
    import gpyrn_tpu
    import jax
    out = {"_note": ("cached oracle: values computed by the JAX package "
                     "(gpyrn_tpu, float64, CPU), not measured by "
                     "chip_smoke.py"),
           "_command": COMMAND,
           "_jax": jax.__version__}
    for name, make in chip_smoke.PROBLEMS.items():
        g = make(gpyrn_tpu)
        elbo, mu, var, n_iter = g.ELBOcalc(max_iter=chip_smoke.FIT_SWEEPS)
        out[name] = {"N": chip_smoke.N_MAIN,
                     "max_iter": chip_smoke.FIT_SWEEPS,
                     "elbo": float(elbo), "n_iter": int(n_iter),
                     "stride": STRIDE,
                     **chip_smoke.state_summary(np.asarray(mu),
                                                np.asarray(var), STRIDE)}
        print(name, out[name]["elbo"], out[name]["n_iter"], flush=True)
    out["grad"] = {}
    for name, n_sweeps in chip_smoke.GRAD_SWEEPS.items():
        g = chip_smoke.PROBLEMS[name](gpyrn_tpu)
        eng = g.engine
        theta = g._theta()
        mu0, var0 = eng.init_mu_var(theta, g.y)
        value, grad = eng.elbo_value_and_grad(
            theta, np.asarray(g.time, dtype=float), g.y, g.yerr2, mu0, var0,
            n_sweeps)
        out["grad"][name] = {"n_sweeps": n_sweeps, "value": float(value),
                             "grad": np.asarray(grad).tolist()}
        print(name, "grad", float(value), flush=True)
    g = chip_smoke.headline_problem(gpyrn_tpu)
    res = g.optimize_adam(n_steps=chip_smoke.ADAM_STEPS,
                          n_sweeps=chip_smoke.GRAD_SWEEPS["headline"])
    out["adam"] = {"n_steps": chip_smoke.ADAM_STEPS,
                   "n_sweeps": chip_smoke.GRAD_SWEEPS["headline"],
                   "x": np.asarray(res["x"]).tolist(),
                   "fun": float(res["fun"]), "elbo": float(res["elbo"])}
    print("adam", out["adam"]["fun"], out["adam"]["elbo"], flush=True)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke_oracle.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
