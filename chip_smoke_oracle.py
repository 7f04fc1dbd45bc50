#!/usr/bin/env python3
"""Write chip_smoke_oracle.json: the JAX package's 10-sweep float64
``ELBOcalc`` of the headline and flagship models at N=1000, the cached
oracle that ``chip_smoke.py`` holds the port's value on the card against
(``chip_smoke.py`` itself never imports jax).

    JAX_PLATFORMS=cpu python3 chip_smoke_oracle.py

Runs on the CPU in about a minute.
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
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke_oracle.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
