#!/usr/bin/env python3
"""Write chip_smoke_oracle.json: the JAX package's float64 results that
``chip_smoke.py`` holds the port's on the card against
(``chip_smoke.py`` itself never imports jax), all at N=1000:

* the 10-sweep ``ELBOcalc`` of the headline and flagship models;
* ``engine.elbo_value_and_grad`` from the heuristic start, 30 sweeps for
  the headline model and 10 for the flagship;
* five ``optimize_adam`` steps of the headline model (30 sweeps each);
* the headline model's ``ELBOcalc(precision='mixed')`` with the default
  settings and with ``refine_sweeps='converge'`` (the polish settings of
  ``chip_smoke.CONVERGE``);
* its ``elbo_grad(method='implicit')`` from the heuristic start, with the
  residuals of that call;
* three ``optimize_adam(grad='implicit')`` steps (the adjoint solve cut
  as ``chip_smoke.ADAM_IMPLICIT`` says);
* the batched paths: ``vmap(elbo_fit)`` over the 13 rows of
  ``chip_smoke.BATCH``, ``optimize_device`` with ``chip_smoke.OPT`` and
  with ``chip_smoke.OPT_RESTARTS`` restarts (cut to
  ``OPT_RESTART_ORACLE_ITERS`` iterations), the ensemble sampler's host
  loop with scipy priors (cut to ``MCMC_ORACLE_STEPS`` steps) and
  ``evidence.batch_elbo`` over the rows of ``chip_smoke.EVIDENCE``.

    JAX_PLATFORMS=cpu python3 chip_smoke_oracle.py [--all]

A section that the file already holds is kept as it is unless ``--all``
is given, so a new section is added without touching the others.  Runs on
the CPU in some minutes.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

import chip_smoke

COMMAND = "JAX_PLATFORMS=cpu python3 chip_smoke_oracle.py"
STRIDE = 97


def fit_sections(gpyrn_tpu):
    """The 10-sweep fits, one section per model."""
    for name, make in chip_smoke.PROBLEMS.items():
        def section(make=make):
            g = make(gpyrn_tpu)
            elbo, mu, var, n_iter = g.ELBOcalc(max_iter=chip_smoke.FIT_SWEEPS)
            return {"N": chip_smoke.N_MAIN,
                    "max_iter": chip_smoke.FIT_SWEEPS,
                    "elbo": float(elbo), "n_iter": int(n_iter),
                    "stride": STRIDE,
                    **chip_smoke.state_summary(np.asarray(mu),
                                               np.asarray(var), STRIDE)}
        yield name, section


def grad_section(gpyrn_tpu):
    out = {}
    for name, n_sweeps in chip_smoke.GRAD_SWEEPS.items():
        g = chip_smoke.PROBLEMS[name](gpyrn_tpu)
        eng = g.engine
        theta = g._theta()
        mu0, var0 = eng.init_mu_var(theta, g.y)
        value, grad = eng.elbo_value_and_grad(
            theta, np.asarray(g.time, dtype=float), g.y, g.yerr2, mu0, var0,
            n_sweeps)
        out[name] = {"n_sweeps": n_sweeps, "value": float(value),
                     "grad": np.asarray(grad).tolist()}
    return out


def adam_section(gpyrn_tpu):
    g = chip_smoke.headline_problem(gpyrn_tpu)
    res = g.optimize_adam(n_steps=chip_smoke.ADAM_STEPS,
                          n_sweeps=chip_smoke.GRAD_SWEEPS["headline"])
    return {"n_steps": chip_smoke.ADAM_STEPS,
            "n_sweeps": chip_smoke.GRAD_SWEEPS["headline"],
            "x": np.asarray(res["x"]).tolist(),
            "fun": float(res["fun"]), "elbo": float(res["elbo"])}


def mixed_section(gpyrn_tpu):
    """The mixed fit of the headline model: the float32 bulk differs from
    runtime to runtime, so only ``converge`` (polished to the float64
    fixed point) is a value to hold the port to tightly."""
    out = {"N": chip_smoke.N_MAIN}
    g = chip_smoke.headline_problem(gpyrn_tpu)
    elbo, _, _, n_iter = g.ELBOcalc(precision='mixed')
    out["default"] = {"elbo": float(elbo), "n_iter": int(n_iter)}
    g = chip_smoke.headline_problem(gpyrn_tpu)
    g.refine_sweeps = 'converge'
    for key, value in chip_smoke.CONVERGE.items():
        setattr(g, key, value)
    elbo, mu, var, n_iter = g.ELBOcalc(precision='mixed')
    out["converge"] = {**chip_smoke.CONVERGE, "elbo": float(elbo),
                       "n_iter": int(n_iter), "stride": STRIDE,
                       **chip_smoke.state_summary(np.asarray(mu),
                                                  np.asarray(var), STRIDE)}
    return out


def implicit_section(gpyrn_tpu):
    from gpyrn_tpu.models.implicit import implicit_value_and_grad_for
    g = chip_smoke.headline_problem(gpyrn_tpu)
    value, grad = g.elbo_grad(method='implicit', **chip_smoke.IMPLICIT)
    res = implicit_value_and_grad_for(g.engine)(
        g._theta(), np.asarray(g.time, dtype=float), g.y, g.yerr2, g._mu,
        g._var)
    return {"N": chip_smoke.N_MAIN, **chip_smoke.IMPLICIT,
            "value": float(value), "grad": np.asarray(grad).tolist(),
            "adjoint_residual": float(res.adjoint_residual),
            "state_residual": float(res.state_residual)}


def adam_implicit_section(gpyrn_tpu):
    g = chip_smoke.headline_problem(gpyrn_tpu)
    res = g.optimize_adam(n_steps=chip_smoke.ADAM_IMPLICIT_STEPS,
                          grad='implicit', **chip_smoke.ADAM_IMPLICIT)
    return {"n_steps": chip_smoke.ADAM_IMPLICIT_STEPS,
            **chip_smoke.ADAM_IMPLICIT,
            "x": np.asarray(res["x"]).tolist(),
            "fun": float(res["fun"]), "elbo": float(res["elbo"])}


def batch_section(gpyrn_tpu):
    import jax
    import jax.numpy as jnp
    g = chip_smoke.headline_problem(gpyrn_tpu)
    eng = g.engine
    cfg = chip_smoke.BATCH
    thetas = chip_smoke.batch_thetas(g.get_parameters(include_frozen=True),
                                     cfg["rows"], cfg["spread"], cfg["seed"])
    t = np.asarray(g.time, dtype=float)

    def one(th):
        mu0, var0 = eng.init_mu_var(th, g.y)
        return eng.elbo_fit(th, t, g.y, g.yerr2, mu0, var0,
                            cfg["max_iter"])

    elbo, mu, var, n_iter, conv, _ = jax.jit(jax.vmap(one))(
        jnp.asarray(thetas))
    rows = [chip_smoke.state_summary(np.asarray(m), np.asarray(v), STRIDE)
            for m, v in zip(mu, var)]
    return {"N": chip_smoke.N_MAIN, **cfg, "stride": STRIDE,
            "elbo": np.asarray(elbo).tolist(),
            "n_iter": np.asarray(n_iter).tolist(),
            "converged": np.asarray(conv).tolist(),
            "mu": [r["mu"] for r in rows], "var": [r["var"] for r in rows]}


def _opt_result(res):
    return {"x": np.asarray(res["x"]).tolist(), "fun": float(res["fun"]),
            "nit": int(res["nit"]), "nfev": int(res["nfev"]),
            "success": bool(res["success"]), "elbo": float(res["elbo"])}


def optimize_device_section(gpyrn_tpu):
    g = chip_smoke.headline_problem(gpyrn_tpu)
    single = _opt_result(g.optimize_device(**chip_smoke.OPT))
    g = chip_smoke.headline_problem(gpyrn_tpu)
    cut = {**chip_smoke.OPT,
           "max_iter": chip_smoke.OPT_RESTART_ORACLE_ITERS,
           "n_restarts": chip_smoke.OPT_RESTARTS}
    restarts = _opt_result(g.optimize_device(**cut))
    return {"N": chip_smoke.N_MAIN, "single": {**chip_smoke.OPT, **single},
            "restarts": {**cut, **restarts}}


def mcmc_section(gpyrn_tpu):
    from scipy import stats
    g = chip_smoke.headline_problem(gpyrn_tpu)
    priors = chip_smoke.headline_priors(
        g, lambda m, s: stats.lognorm(s=s, scale=np.exp(m)))
    cfg = {**chip_smoke.MCMC, "niter": chip_smoke.MCMC_ORACLE_STEPS}
    res = g.mcmc(priors, p0=g.get_parameters(), **cfg)
    return {"N": chip_smoke.N_MAIN, **cfg,
            "prior_width": chip_smoke.PRIOR_WIDTH,
            "chain": res.chain.tolist(), "log_prob": res.log_prob.tolist(),
            "elbo": res.elbo.tolist(), "acceptance": float(res.acceptance)}


def batch_elbo_section(gpyrn_tpu):
    from gpyrn_tpu.inference.evidence import batch_elbo
    g = chip_smoke.headline_problem(gpyrn_tpu)
    cfg = chip_smoke.EVIDENCE
    thetas = chip_smoke.batch_thetas(g.get_parameters(include_frozen=True),
                                     cfg["rows"], cfg["spread"], cfg["seed"])
    return {"N": chip_smoke.N_MAIN, **cfg,
            "elbo": np.asarray(batch_elbo(g, thetas,
                                          cfg["max_iter"])).tolist()}


def main():
    import gpyrn_tpu
    import jax
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke_oracle.json")
    out = {}
    if os.path.exists(path) and "--all" not in sys.argv[1:]:
        with open(path) as f:
            out = json.load(f)
    out["_note"] = (
        "cached oracle: values computed by the JAX package (gpyrn_tpu, "
        "float64, CPU), not measured by chip_smoke.py: the 10-sweep fits "
        "(headline, flagship), the unrolled value and gradient (grad), "
        "five unrolled Adam steps (adam), the mixed-precision fit with "
        "its default settings and polished to the float64 fixed point "
        "(mixed), the implicit gradient of the converged ELBO (implicit) "
        "and three implicit Adam steps (adam_implicit); the batched paths: "
        "vmap(elbo_fit) over 13 perturbed parameter rows (batch), "
        "optimize_device with 3 sweeps and 30 iterations, and with 4 "
        "restarts cut to 8 iterations (optimize_device), the ensemble "
        "sampler's host loop with 26 walkers and scipy priors cut to 2 "
        "steps of the 10 the card runs (mcmc), and evidence.batch_elbo "
        "over 8 rows (batch_elbo)")
    out["_command"] = COMMAND
    out.setdefault("_jax", jax.__version__)
    sections = list(fit_sections(gpyrn_tpu)) + [
        ("grad", lambda: grad_section(gpyrn_tpu)),
        ("adam", lambda: adam_section(gpyrn_tpu)),
        ("mixed", lambda: mixed_section(gpyrn_tpu)),
        ("implicit", lambda: implicit_section(gpyrn_tpu)),
        ("adam_implicit", lambda: adam_implicit_section(gpyrn_tpu)),
        ("batch", lambda: batch_section(gpyrn_tpu)),
        ("optimize_device", lambda: optimize_device_section(gpyrn_tpu)),
        ("mcmc", lambda: mcmc_section(gpyrn_tpu)),
        ("batch_elbo", lambda: batch_elbo_section(gpyrn_tpu))]
    for name, section in sections:
        if name in out:
            print(name, "kept", flush=True)
            continue
        out[name] = section()
        print(name, json.dumps(out[name])[:200], flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
