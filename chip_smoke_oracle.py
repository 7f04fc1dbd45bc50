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
  ``evidence.batch_elbo`` over the rows of ``chip_smoke.EVIDENCE``;
* the gradient paths over a batch: ``vmap(value_and_grad(elbo_fixed))``
  over the rows of ``chip_smoke.GRAD_BATCH``, ``run_hmc`` with HMC and
  NUTS (``chip_smoke.HMC_ORACLE`` / ``NUTS_ORACLE``) and the draws of its
  key tree (:func:`jax_hmc_draws`), ``multistart_optimize`` with adam
  and ``nm``, and the nonparametric ``ELBOcalc``.
* the large-N stack (section ``lean``): at N=2000 one float64
  ``elbo_refine_lean`` sweep, three float32 ``fit_state_lean`` sweeps and
  the mixed fit with ``fit_method='cg'`` (``chip_smoke.CG_MIXED``); at
  N=1000 the SVI fit (``chip_smoke.SVI_ORACLE``) with the subsets it
  drew.
* the Keplerian RV workflow: ``keplerian_rv`` at the times of
  ``chip_smoke.astro_times`` and its ``jax.grad`` (section ``astro``); the
  solar model (``chip_smoke.solar_problem``, N=497): the converged
  ``ELBOcalc``, ``predict(nn=1000)``, five ``optimize_adam`` steps and
  ``vmap(elbo_fit)`` over 13 rows (section ``solar``); the served
  predictive (section ``serving``): ``gpyrn_tpu.serving``'s artifact of
  the headline model from its converged state (kept whole) at N=1000 and
  from the heuristic state at N=5000, called at ``chip_smoke.SERVE``'s
  request sizes, and its float32 artifact of the headline model.
* the multi-device layer (section ``parallel``): one float64
  ``elbo_refine_lean`` sweep of the headline model at N=4096, which the
  JAX package's tests hold its panel engine equal to.

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


def batched_grad_section(gpyrn_tpu):
    """``vmap(value_and_grad(elbo_fixed))`` over the rows of
    ``chip_smoke.GRAD_BATCH``, each from its heuristic start."""
    import jax
    import jax.numpy as jnp
    g = chip_smoke.headline_problem(gpyrn_tpu)
    eng, cfg = g.engine, chip_smoke.GRAD_BATCH
    t = np.asarray(g.time, dtype=float)
    th = jnp.asarray(chip_smoke.batch_thetas(
        g.get_parameters(include_frozen=True), cfg["rows"], cfg["spread"],
        cfg["seed"]))
    mu, var = jax.vmap(lambda x: eng.init_mu_var(x, g.y))(th)
    vg = jax.value_and_grad(lambda x, m, v: eng.elbo_fixed(
        x, t, g.y, g.yerr2, m, v, cfg["n_sweeps"]))
    value, grad = jax.jit(jax.vmap(vg))(th, mu, var)
    return {"N": chip_smoke.N_MAIN, **cfg,
            "value": np.asarray(value).tolist(),
            "grad": np.asarray(grad).tolist()}


def hmc_section(gpyrn_tpu):
    """``run_hmc`` with ``chip_smoke.HMC`` and the oracle settings of HMC
    and NUTS, with the draws of its key tree."""
    from gpyrn_tpu.inference import priors
    from gpyrn_tpu.inference.hmc import run_hmc
    out = {"N": chip_smoke.N_MAIN, "prior_width": chip_smoke.PRIOR_WIDTH}
    for name, cfg in (("hmc", chip_smoke.HMC_ORACLE),
                      ("nuts", chip_smoke.NUTS_ORACLE)):
        g = chip_smoke.fitted_headline(gpyrn_tpu)
        kw = {**chip_smoke.HMC, **cfg}
        res = run_hmc(g, chip_smoke.headline_priors(g, priors.LogNormal),
                      p0=g.get_parameters(), **kw)
        draws = jax_hmc_draws(kw["seed"], kw["n_chains"],
                              res.chain.shape[-1], kw["n_warmup"],
                              kw["n_samples"], algorithm=kw["algorithm"],
                              max_depth=kw.get("max_depth", 8))
        out[name] = {**kw, "chain": res.chain.tolist(),
                     "log_prob": res.log_prob.tolist(),
                     "acceptance": float(res.acceptance),
                     "step_size": float(res.step_size),
                     "draws": [{k: v.tolist() for k, v in seg.items()}
                               for seg in draws]}
    return out


def multistart_section(gpyrn_tpu):
    from gpyrn_tpu.parallel.multistart import multistart_optimize
    out = {"N": chip_smoke.N_MAIN}
    for name, cfg in (("adam", chip_smoke.MULTISTART),
                      ("nm", chip_smoke.MULTISTART_NM)):
        res = multistart_optimize(chip_smoke.headline_problem(gpyrn_tpu),
                                  **cfg)
        out[name] = {**cfg, **{k: np.asarray(v).tolist()
                               for k, v in res.items()}}
    return out


def npv_section(gpyrn_tpu):
    from gpyrn_tpu.inference import nonparametric
    cfg = chip_smoke.NPV
    g = chip_smoke.headline_problem(gpyrn_tpu)
    npv = chip_smoke.npv_problem(nonparametric, g, cfg)
    elbo, mu, std = npv.ELBOcalc(g.nodes, g.weights, g.means, g.jitters,
                                 iterations=cfg["iterations"],
                                 seed=cfg["seed"])
    return {"N": chip_smoke.N_MAIN, **cfg, "elbo": float(elbo),
            "traj": np.asarray(npv._traj).tolist(), "std": std.tolist(),
            "stride": STRIDE, "mu": np.asarray(mu)[:, ::STRIDE].tolist()}


def lean_section(gpyrn_tpu):
    """The large-N stack: the lean engines at N=2000 (one float64
    ``elbo_refine_lean`` sweep, three float32 ``fit_state_lean`` sweeps
    from the heuristic start), the mixed fit with ``fit_method='cg'``
    there, and the SVI fit at N=1000 with its subsets."""
    import jax
    import jax.numpy as jnp
    from gpyrn_tpu.models.svi import make_svi_fit
    N = chip_smoke.LEAN_CHECK_N
    g = chip_smoke.headline_problem(gpyrn_tpu, N=N)
    eng, theta = g.engine, g._theta()
    t = np.asarray(g.time, dtype=float)
    mu0, var0 = eng.init_mu_var(theta, g.y)
    out = {"N": N, "stride": STRIDE}
    elbo, mu, var = eng.elbo_refine_lean(theta, t, g.y, g.yerr2, mu0, var0,
                                         1)
    out["refine"] = {"elbo": float(elbo), **chip_smoke.state_summary(
        np.asarray(mu), np.asarray(var), STRIDE)}

    def f32(x):
        return jnp.asarray(np.asarray(x), dtype=jnp.float32)

    mu32, var32, _, _ = eng.fit_state_lean(
        f32(theta), f32(t), f32(g.y), f32(g.yerr2), f32(mu0), f32(var0),
        chip_smoke.LEAN_FIT32_SWEEPS, np.float32(0.0))
    out["fit_state32"] = {"sweeps": chip_smoke.LEAN_FIT32_SWEEPS,
                          **chip_smoke.state_summary(
                              np.asarray(mu32, dtype=np.float64),
                              np.asarray(var32, dtype=np.float64), STRIDE)}
    g = chip_smoke.headline_problem(gpyrn_tpu, N=chip_smoke.CG_MIXED["N"])
    g.fit_method = 'cg'
    for key in ("refine_sweeps", *chip_smoke.CONVERGE):
        setattr(g, key, chip_smoke.CG_MIXED[key])
    elbo, _, _, n_iter = g.ELBOcalc(precision='mixed',
                                    max_iter=chip_smoke.CG_MIXED["max_iter"])
    out["cg_mixed"] = {**chip_smoke.CG_MIXED, "elbo": float(elbo),
                       "n_iter": int(n_iter),
                       "cg_achieved_relres": float(g.cg_achieved_relres)}
    cfg = chip_smoke.SVI_ORACLE
    g = chip_smoke.headline_problem(gpyrn_tpu, N=chip_smoke.SVI_N)
    eng, theta = g.engine, g._theta()
    mu0, var0 = eng.init_mu_var(theta, g.y)
    batch_p = max(1, g.p // 4)
    sv = make_svi_fit(eng.spec, batch_p)
    mu, var = sv.fit_state_svi(theta, np.asarray(g.time, dtype=float), g.y,
                               g.yerr2, mu0, var0, cfg["n_steps"],
                               cfg["seed"], cfg["t0"], cfg["kappa"])
    # the subsets fit_state_svi draws (models/svi.py, its step loop)
    base = jax.random.PRNGKey(cfg["seed"])
    subsets = [np.asarray(jax.random.choice(jax.random.fold_in(base, i),
                                            g.p, (batch_p,),
                                            replace=False)).tolist()
               for i in range(cfg["n_steps"])]
    out["svi"] = {"N": chip_smoke.SVI_N, **cfg, "batch_p": batch_p,
                  "subsets": subsets, "stride": STRIDE,
                  **chip_smoke.state_summary(np.asarray(mu),
                                             np.asarray(var), STRIDE)}
    return out


def parallel_section(gpyrn_tpu):
    """The multi-device phase 33's oracle: one float64 sweep of the JAX
    package's single-device ``elbo_refine_lean`` on the headline model at
    ``chip_smoke.PANEL_N`` from the heuristic start, which the JAX
    package's own tests (tests/test_panel.py) hold its panel engine equal
    to."""
    N = chip_smoke.PANEL_N
    g = chip_smoke.headline_problem(gpyrn_tpu, N=N)
    eng, theta = g.engine, g._theta()
    mu0, var0 = eng.init_mu_var(theta, g.y)
    elbo, mu, var = eng.elbo_refine_lean(
        theta, np.asarray(g.time, dtype=float), g.y, g.yerr2, mu0, var0,
        chip_smoke.PANEL_SWEEPS)
    return {"N": N, "sweeps": chip_smoke.PANEL_SWEEPS, "stride": STRIDE,
            "refine": {"elbo": float(elbo), **chip_smoke.state_summary(
                np.asarray(mu), np.asarray(var), STRIDE)}}


def astro_section(gpyrn_tpu):
    import jax
    import jax.numpy as jnp
    from gpyrn_tpu.datasets import load_solar
    from gpyrn_tpu.utils.astro import keplerian_rv
    times = chip_smoke.astro_times(load_solar()[0])
    n_small = min(chip_smoke.ASTRO_NS)
    out = {"params": list(chip_smoke.SOLAR_KEPLERIAN),
           "stride": chip_smoke.ASTRO_STRIDE, "rv": {}, "grad": {}}
    for e in chip_smoke.ASTRO_ECCENTRICITIES:
        pars = chip_smoke.astro_params(e)
        out["rv"][repr(e)] = {
            str(n): np.asarray(keplerian_rv(
                t, P=pars[0], K=pars[1], e=pars[2], w=pars[3], T=pars[4])
            )[::1 if n == n_small else chip_smoke.ASTRO_STRIDE].tolist()
            for n, t in times.items()}
        t = jnp.asarray(times[n_small])
        grad = jax.grad(lambda p: jnp.sum(keplerian_rv(
            t, P=p[0], K=p[1], e=p[2], w=p[3], T=p[4])))(jnp.asarray(pars))
        out["grad"][repr(e)] = np.asarray(grad).tolist()
    return out


def solar_section(gpyrn_tpu):
    import jax
    import jax.numpy as jnp
    stride = chip_smoke.SOLAR_STRIDE
    g = chip_smoke.solar_problem(gpyrn_tpu)
    elbo, mu, var, n_iter = g.ELBOcalc()
    _, mean, std, _ = g.predict(nn=chip_smoke.SOLAR_NN)
    out = {"N": int(g.N), "stride": stride,
           "fit": {"elbo": float(elbo), "n_iter": int(n_iter),
                   **chip_smoke.state_summary(np.asarray(mu),
                                              np.asarray(var), stride)},
           "predict": {"nn": chip_smoke.SOLAR_NN,
                       "mean": np.asarray(mean)[::stride].tolist(),
                       "std": np.asarray(std)[::stride].tolist()}}
    g = chip_smoke.solar_problem(gpyrn_tpu)
    res = g.optimize_adam(n_steps=chip_smoke.ADAM_STEPS,
                          n_sweeps=chip_smoke.GRAD_SWEEPS["headline"])
    out["adam"] = {"n_steps": chip_smoke.ADAM_STEPS,
                   "n_sweeps": chip_smoke.GRAD_SWEEPS["headline"],
                   "x": np.asarray(res["x"]).tolist(),
                   "fun": float(res["fun"]), "elbo": float(res["elbo"])}
    g = chip_smoke.solar_problem(gpyrn_tpu)
    eng, cfg = g.engine, chip_smoke.BATCH
    thetas = chip_smoke.batch_thetas(g.get_parameters(include_frozen=True),
                                     cfg["rows"], cfg["spread"], cfg["seed"])
    t = np.asarray(g.time, dtype=float)

    def one(th):
        mu0, var0 = eng.init_mu_var(th, g.y)
        return eng.elbo_fit(th, t, g.y, g.yerr2, mu0, var0,
                            cfg["max_iter"])

    elbo, mu, var, n_iter, conv, _ = jax.jit(jax.vmap(one))(
        jnp.asarray(thetas))
    rows = [chip_smoke.state_summary(np.asarray(m), np.asarray(v), stride)
            for m, v in zip(mu, var)]
    out["batch"] = {**cfg, "elbo": np.asarray(elbo).tolist(),
                    "n_iter": np.asarray(n_iter).tolist(),
                    "converged": np.asarray(conv).tolist(),
                    "mu": [r["mu"] for r in rows],
                    "var": [r["var"] for r in rows]}
    return out


def serving_section(gpyrn_tpu):
    from gpyrn_tpu import serving
    out = {"stride": chip_smoke.SERVE_STRIDE}
    for key, cfg in chip_smoke.SERVE.items():
        g = chip_smoke.headline_problem(gpyrn_tpu, N=cfg["N"])
        if key == "headline":
            g.ELBOcalc()
        else:
            mu, var = g.engine.init_mu_var(g._theta(), g.y)
            g._mu, g._var = np.asarray(mu), np.asarray(var)
        serve = serving.ServingPredictor(serving.export_predict(g))
        out[key] = {**cfg, "requests": {
            str(n): chip_smoke.serve_summary(
                serve(chip_smoke.serve_times(g.time, n)))
            for n in cfg["ns"]}}
        if key == "headline":
            serve32 = serving.ServingPredictor(
                serving.export_predict(g, dtype=np.float32))
            out[key]["float32"] = chip_smoke.serve_summary(serve32(
                chip_smoke.serve_times(g.time, chip_smoke.SERVE_F32_N)
                .astype(np.float32)))
            out[key]["state"] = {"mu": np.asarray(g._mu).ravel().tolist(),
                                 "var": np.asarray(g._var).ravel().tolist()}
    return out


def jax_hmc_draws(seed, n_chains, ndim, n_warmup, n_samples, chunk=50,
                  mass_matrix="diag", algorithm="hmc", max_depth=8):
    """The draws of ``gpyrn_tpu.inference.hmc.run_hmc`` with these
    settings, from its key tree, as the segments that
    ``gpyrn_tpu_torch.inference.hmc.GivenDraws`` takes: ``PRNGKey(seed)``
    split in 3 (the sampling key, warmup phase 1, phase 2); per segment
    ``split(key, n_steps)``, per step ``split(·, n_chains)``; per HMC step
    ``split(rng)`` (momentum, accept uniform); per NUTS transition
    ``split(rng)`` (momentum, tree), per depth ``split(key, 4)`` (next,
    direction, subtree, across) and per leaf ``split(key)``.  Which
    segments run does not depend on the data."""
    import gpyrn_tpu  # noqa: F401  (float64 in jax)
    import jax
    import jax.numpy as jnp

    def hmc_one(rng):
        k1, k2 = jax.random.split(rng)
        return {"xi": jax.random.normal(k1, (ndim,), dtype=jnp.float64),
                "u": jax.random.uniform(k2, dtype=jnp.float64)}

    def nuts_one(rng):
        k_mom, key = jax.random.split(rng)
        kd, kb = [], []
        ka = jnp.ones((max_depth, 1 << max(max_depth - 1, 0)))
        for depth in range(max_depth):
            key, k_d, ks, k_b = jax.random.split(key, 4)
            kd.append(jax.random.bernoulli(k_d))
            kb.append(jax.random.uniform(k_b))
            for i in range(1 << depth):
                ks, k_a = jax.random.split(ks)
                ka = ka.at[depth, i].set(jax.random.uniform(k_a))
        return {"xi": jax.random.normal(k_mom, (ndim,), dtype=jnp.float64),
                "kd": jnp.stack(kd), "kb": jnp.stack(kb), "ka": ka}

    one = hmc_one if algorithm == "hmc" else nuts_one
    per_step = jax.jit(jax.vmap(lambda k: jax.vmap(one)(
        jax.random.split(k, n_chains))))

    def segment(key, n_steps):
        out = per_step(jax.random.split(key, n_steps))
        # chains last for the per-depth arrays, as GivenDraws reads them
        return {k: np.moveaxis(np.asarray(v), 1, -1) if k != "xi"
                else np.asarray(v) for k, v in out.items()}

    key = jax.random.PRNGKey(seed)
    key, k1, k2 = jax.random.split(key, 3)
    n1 = n_warmup if mass_matrix == "identity" else n_warmup // 2
    segments = []
    if n1 > 0:
        segments.append(segment(k1, n1))
    if n_warmup - n1 > 0:
        segments.append(segment(k2, n_warmup - n1))
    done = 0
    while done < n_samples:
        k = min(chunk, n_samples - done)
        key, sub = jax.random.split(key)
        segments.append(segment(sub, k))
        done += k
    return segments


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
        "over 8 rows (batch_elbo); the gradient paths over a batch: "
        "vmap(value_and_grad(elbo_fixed)) over 4 rows (batched_grad), "
        "run_hmc with HMC and NUTS and the draws of its key tree (hmc), "
        "multistart_optimize with adam and nm (multistart), and "
        "nonparametric ELBOcalc (npv); the large-N stack (lean): one "
        "float64 elbo_refine_lean sweep and three float32 fit_state_lean "
        "sweeps at N=2000, the mixed fit with fit_method='cg' there "
        "polished to the float64 fixed point, and the SVI fit at N=1000 "
        "with the subsets it drew")
    out["_note_rv"] = (
        "cached oracle, as _note says: the Keplerian RV workflow's "
        "keplerian_rv values and jax.grad (astro), the solar model's "
        "converged fit, prediction, adam steps and vmap(elbo_fit) over 13 "
        "rows (solar), and gpyrn_tpu.serving's artifact of the headline "
        "model at N=1000 (its converged state kept whole) and N=5000 "
        "(serving), with the headline's float32 artifact")
    out["_note_parallel"] = (
        "cached oracle, as _note says: one float64 elbo_refine_lean sweep "
        "of the headline model at N=4096 from the heuristic start "
        "(parallel), the single-device value the JAX package's tests hold "
        "its panel engine to")
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
        ("batch_elbo", lambda: batch_elbo_section(gpyrn_tpu)),
        ("batched_grad", lambda: batched_grad_section(gpyrn_tpu)),
        ("hmc", lambda: hmc_section(gpyrn_tpu)),
        ("multistart", lambda: multistart_section(gpyrn_tpu)),
        ("npv", lambda: npv_section(gpyrn_tpu)),
        ("lean", lambda: lean_section(gpyrn_tpu)),
        ("astro", lambda: astro_section(gpyrn_tpu)),
        ("solar", lambda: solar_section(gpyrn_tpu)),
        ("serving", lambda: serving_section(gpyrn_tpu)),
        ("parallel", lambda: parallel_section(gpyrn_tpu))]
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
