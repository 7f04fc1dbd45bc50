"""What the multi-rank tests of gpyrn_tpu_torch.parallel run in their ranks.

``tests/test_torch_panel.py`` and ``tests/test_torch_sharding.py`` each
start one 4-rank gloo job (:func:`gpyrn_tpu_torch.parallel.mesh.spawn`)
that runs one of the ``*_job`` functions below in every rank; a rank
computes all of its file's cases and hands back numpy arrays, which the
tests compare with the JAX package's values and with the port's
unsharded functions.  This module imports torch, numpy and the port only
(every rank imports it), never jax.  :func:`one_rank_mesh` is the
in-process one-rank mesh of the single-process ``mesh=`` tests.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.parallel import mesh as pm

WORLD = 4


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank gloo process group in this process and its (1, 1) CPU
    mesh; the group is destroyed on the way out."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            yield pm.make_mesh(device_type="cpu")
        finally:
            dist.destroy_process_group()


def run(job, *args):
    """``job(*args)`` in every rank of a 4-rank gloo job on the CPU."""
    return pm.spawn(job, WORLD, "gloo", "cpu", *args, timeout=600.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


# ---- models (numpy data; the tests build the JAX twins from the same) ----

def panel_problem(pkg, name, device="cpu"):
    """The inference of the panel case ``name``, in either package:
    ``pkg`` is ``gpyrn_tpu`` or ``gpyrn_tpu_torch`` (on ``device``)."""
    kw = {} if pkg.__name__ == "gpyrn_tpu" else {"device": device}
    cf = pkg.covfunc
    rng = np.random.default_rng({"headline": 0, "q2p2": 5, "composite": 2,
                                 "q3": 9}[name])
    q, p, N = {"headline": (1, 3, 64), "q2p2": (2, 2, 48),
               "composite": (1, 1, 48), "q3": (3, 1, 40)}[name]
    t = np.sort(rng.uniform(0, 100, N))
    args = []
    for i in range(p):
        args += [np.sin(2 * np.pi * t / 31 + i)
                 + 0.05 * rng.standard_normal(N), 0.05 * np.ones(N)]
    g = pkg.inference(q, t, *args, **kw)
    nodes = [cf.QuasiPeriodic(1., 40., 31., .7),
             cf.SquaredExponential(.8, 60.), cf.Matern52(.9, 35.)][:q]
    weights = [cf.SquaredExponential(1. + .1 * a, 50. + 5 * a)
               for a in range(q * p)]
    if name == "composite":
        nodes = [cf.SquaredExponential(1., 40.)
                 + cf.Linear(50.) * cf.Constant(0.02)]
        weights = [cf.Matern52(1., 30.)]
    g.set_components(nodes, weights, [None] * p, [0.05] * p)
    return g


# the panel cases: (model, block, fit_state sweeps, elbo_refine sweeps,
# elbo_fit max_iter or 0)
PANEL_CASES = {"headline": (16, 6, 3, 30), "q2p2": (16, 4, 3, 0),
               "composite": (16, 0, 3, 0), "q3": (8, 0, 3, 0)}
# the raw linear algebra: (N, block)
LINALG_CASES = ((64, 8), (50, 8), (40, 64))


def spd_pair(N, seed):
    """Two SPD matrices, a right-hand side and a positive diagonal."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, N))
    M2 = rng.standard_normal((N, N))
    return (M @ M.T + N * np.eye(N), M2 @ M2.T + N * np.eye(N),
            rng.standard_normal(N), 0.1 + rng.random(N))


def _linalg(ax, N, block):
    from gpyrn_tpu_torch.parallel import panel as pp
    dims = pp.panel_dims(N, ax.size, block)
    A, A2, b, d = spd_pair(N, N)

    def padded(X):
        out = np.eye(dims.Np)
        out[:N, :N] = X
        return torch.tensor(out[ax.rank * dims.Nl:(ax.rank + 1) * dims.Nl])

    bp = pp.pad_vector(torch.tensor(b), dims)
    L = pp.panel_cholesky_local(padded(A), dims, ax)
    G, dKinv = pp.panel_tri_inv_local(L, dims, ax)
    LA = pp.panel_cholesky_local(padded(A2), dims, ax)
    dS, cn = pp.panel_diag_trace_local(L, padded(A), dims, ax)
    return _np({
        "dims": tuple(dims), "L": pp.gather_vector(L, ax),
        "logdet_half": pp.panel_logdet_half_local(L, dims, ax),
        "x": pp.panel_cho_solve_local(L, bp, dims, ax),
        "xf": pp.panel_solve_local(L, bp, dims, ax),
        "xb": pp.panel_solve_t_local(L, bp, dims, ax),
        "Kx": pp.panel_matvec_local(padded(A), bp, dims, ax),
        "dS": dS, "cn": cn, "G": pp.gather_vector(G, ax), "dKinv": dKinv,
        "frob": pp.panel_fro_cross_local(
            LA, G, pp.pad_vector(torch.tensor(d), dims), dims, ax)})


def _panel_fits(mesh, name):
    from gpyrn_tpu_torch.parallel.panel_fit import make_panel_engine
    block, n_fs, n_ref, n_fit = PANEL_CASES[name]
    g = panel_problem(gt, name)
    eng = g.engine
    theta = g._theta()
    t, y, yerr2 = g._data()
    mu0, var0 = eng.init_mu_var(theta, y)
    pe = make_panel_engine(eng.spec, mesh, block=block)
    args = (theta, t, y, yerr2, mu0, var0)
    out = {"dims": tuple(pe.dims),
           "refine": pe.elbo_refine_panel(*args, n_ref)}
    if n_fs:
        out["fit_state"] = pe.fit_state_panel(*args, n_fs, 1e-12)
    if n_fit:
        out["elbo_fit"] = pe.elbo_fit_panel(*args, n_fit)
    return _np(out)


def panel_job():
    """Every case of tests/test_torch_panel.py in this rank: the raw panel
    linear algebra over (1, 4), the panel fits, and the slab launches
    (none here: the CPU takes the plain version)."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(shape=(1, WORLD), device_type="cpu")
    ax = pm.mesh_axis(mesh, pm.LAT_AXIS)
    return {"linalg": {c: _linalg(ax, *c) for c in LINALG_CASES},
            "fits": {name: _panel_fits(mesh, name) for name in PANEL_CASES}}


# ---- the dp and lat axes (tests/test_torch_sharding.py) --------------------

def lattice_problem(pkg):
    """q=2, p=2, N=16: the JAX package's sharding test model."""
    kw = {} if pkg.__name__ == "gpyrn_tpu" else {"device": "cpu"}
    cf = pkg.covfunc
    rng = np.random.default_rng(0)
    N = 16
    t = np.sort(rng.uniform(0, 30, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (8 + 3 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = pkg.inference(2, t, *data, **kw)
    g.set_components([cf.Periodic(1.0, 8.0, 0.6), cf.Matern52(1.0, 4.0)],
                     [cf.SquaredExponential(1.0 + 0.1 * k, 5.0)
                      for k in range(4)], [None] * 2, [0.1] * 2)
    return g


def walker_problem(pkg):
    """q=1, p=1, N=16: the JAX package's sampler-sharding test model."""
    kw = {} if pkg.__name__ == "gpyrn_tpu" else {"device": "cpu"}
    cf = pkg.covfunc
    rng = np.random.default_rng(2)
    N = 16
    t = np.sort(rng.uniform(0, 30, N))
    y = np.sin(2 * np.pi * t / 9) + 0.1 * rng.standard_normal(N)
    g = pkg.inference(1, t, y, np.full(N, 0.1), **kw)
    g.set_components([cf.Periodic(1.0, 9.0, 0.6)],
                     [cf.SquaredExponential(1.0, 5.0)], [None], [0.1])
    return g


def walker_priors(pr):
    return {'node1.P': pr.Normal(9.0, 0.5),
            'node1.theta': pr.LogNormal(0.0, 0.3)}


# the device chain: walkers a multiple of the dp size (4), and an uneven
# count (10: a half-step of 5 does not split, so its fits run whole)
CHAIN = dict(p0=np.array([9.0, 1.0]), vars=['node1.P', 'node1.theta'],
             niter=4, elbo_max_iter=30, seed=5, check_every=2, nwalkers=8)
UNEVEN = dict(CHAIN, niter=2, elbo_max_iter=20, seed=1, nwalkers=10)
MULTISTART = {"adam": dict(n_restarts=4, n_steps=3, n_sweeps=3, seed=1),
              "nm": dict(n_restarts=4, n_steps=4, n_sweeps=2, seed=2,
                         method="nm")}


def batch_thetas(gprn, rows=8):
    theta0 = gprn.get_parameters(include_frozen=True)
    rng = np.random.default_rng(0)
    return theta0[None, :] * np.exp(0.1 * rng.standard_normal(
        (rows, theta0.size)))


def cg_system(pkg, name):
    """(structure, core params, t, b, d_add, keyword arguments) of the
    distributed-CG cases (``tests/test_iterative_sharded.py``'s, at N
    around 64 so that 4 ranks pad)."""
    cf = pkg.covfunc
    N, kernel, seed, kw = {
        "pad": (62, cf.QuasiPeriodic(1.0, 30.0, 20.0, 0.7), 0,
                dict(nugget=1e-2, tol=1e-10, maxiter=400)),
        "periodic": (63, cf.Periodic(1.0, 9.0, 0.7), 1,
                     dict(nugget=1e-2, tol=1e-10, maxiter=500)),
        "single_rhs": (61, cf.SquaredExponential(1.0, 20.0), 0,
                       dict(nugget=1e-2, tol=1e-8)),
        "jacobi_smooth": (61, cf.SquaredExponential(1.0, 30.0), 7,
                          dict(nugget=1e-6, tol=1e-9, maxiter=500)),
        "lowrank": (61, cf.SquaredExponential(1.0, 30.0), 7,
                    dict(nugget=1e-6, tol=1e-9, maxiter=500,
                         precond_rank=20)),
        "refresh": (64, cf.QuasiPeriodic(1.0, 30.0, 20.0, 0.7), 4,
                    dict(nugget=1e-2, tol=1e-10, maxiter=400,
                         refresh_every=7, return_relres=True)),
        "lowrank_no_nugget": (64, cf.QuasiPeriodic(1.0, 3.0, 20.0, 0.7), 11,
                              dict(nugget=0.0, tol=1e-8, maxiter=60,
                                   precond_rank=16)),
    }[name]
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    b = rng.standard_normal((N, 2))
    d = 0.3 + rng.random(N)
    if name == "single_rhs":
        b = b[:, 0]
    if name.startswith("lowrank") or name == "jacobi_smooth":
        d = None
    if name == "lowrank_no_nugget":
        # a right-hand side in K's range: K is singular to rounding
        from gpyrn_tpu_torch.ops.iterative import kernel_matvec
        b = kernel_matvec(kernel.structure, torch.tensor(kernel.core_params()),
                          torch.tensor(t), torch.tensor(
                              rng.standard_normal(N))).numpy()
    return (kernel.structure, np.asarray(kernel.core_params(), dtype=float),
            t, b, d, kw)


CG_CASES = ("pad", "periodic", "single_rhs", "jacobi_smooth", "lowrank",
            "refresh", "lowrank_no_nugget")


def cg_fit_problem(pkg, N):
    """q=1, p=2 at N (32 divides over 4 ranks, 33 does not)."""
    kw = {} if pkg.__name__ == "gpyrn_tpu" else {"device": "cpu"}
    cf = pkg.covfunc
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 60, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (11 + 3 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = pkg.inference(1, t, *data, **kw)
    g.set_components([cf.Periodic(1.0, 11.0, 0.6)],
                     [cf.SquaredExponential(1.0, 8.0),
                      cf.SquaredExponential(0.9, 9.0)], [None] * 2,
                     [0.1] * 2)
    return g


def predict_problem(pkg):
    kw = {} if pkg.__name__ == "gpyrn_tpu" else {"device": "cpu"}
    cf = pkg.covfunc
    rng = np.random.default_rng(2)
    N = 40
    t = np.sort(rng.uniform(0, 60, N))
    y = np.sin(2 * np.pi * t / 13) + 0.1 * rng.standard_normal(N)
    g = pkg.inference(1, t, y, np.full(N, 0.1), **kw)
    g.set_components([cf.Periodic(1.0, 13.0, 0.6)],
                     [cf.SquaredExponential(1.0, 8.0)], [None], [0.1])
    g.ELBOcalc(max_iter=80)
    return g


PREDICT_TSTAR = np.linspace(0, 60, 50)
# fit_state's sweeps and tolerance on the lattice model
LATTICE_FIT = (25, 1e-10)
CG_FIT = dict(rank=32, max_iter=30)


def lattice_results(g, grad_sweeps=3):
    """The lattice-sharded (or not) dense engine's results on the
    lattice model: fit_state, the shell's fit, and the unrolled gradient."""
    eng = g.engine
    theta = g._theta()
    t, y, yerr2 = g._data()
    mu0, var0 = eng.init_mu_var(theta, y)
    return _np({
        "fit_state": eng.fit_state(theta, t, y, yerr2, mu0, var0,
                                   *LATTICE_FIT),
        "grad": eng.elbo_value_and_grad(theta, t, y, yerr2, mu0, var0,
                                        grad_sweeps),
        "elbocalc": g.ELBOcalc(max_iter=60)})


def cg_results(mesh=None):
    """Every distributed-CG case through ``cg_solve_sharded`` (with
    ``mesh``) or the single-device ``cg_solve`` on the same system."""
    from gpyrn_tpu_torch.ops.iterative import cg_solve, kernel_matvec
    from gpyrn_tpu_torch.parallel.iterative_sharded import cg_solve_sharded
    out = {}
    for name in CG_CASES:
        structure, cp, t, b, d, kw = cg_system(gt, name)
        t, b, cp = (torch.tensor(a) for a in (t, b, cp))
        d = None if d is None else torch.tensor(d)
        if mesh is not None:
            out[name] = _np(cg_solve_sharded(structure, cp, t, b, mesh,
                                             d_add=d, **kw))
            continue
        nugget = kw["nugget"]

        def mv(x):
            y = kernel_matvec(structure, cp, t, x, nugget=nugget)
            if d is None:
                return y
            return y + (d[:, None] * x if x.ndim == 2 else d * x)
        out[name] = _np(cg_solve(mv, b, tol=kw["tol"],
                                 maxiter=kw.get("maxiter", 200)))
    return out


def sharding_job():
    """Every case of tests/test_torch_sharding.py in this rank: the lat
    axis of the dense engine and a multistart population over a (2, 2)
    mesh; batch_elbo, the ensemble's device chain, the nm population,
    the distributed CG, predict_iterative and the CG fit over (4, 1)."""
    from gpyrn_tpu_torch.inference import priors as pr
    from gpyrn_tpu_torch.inference.evidence import batch_elbo
    from gpyrn_tpu_torch.models.cg_fit import make_cg_fit
    from gpyrn_tpu_torch.models.iterative import predict_iterative
    from gpyrn_tpu_torch.parallel import multistart_optimize
    torch.set_num_threads(1)
    mesh22 = pm.make_mesh(shape=(2, 2), device_type="cpu")
    mesh41 = pm.make_mesh(shape=(4, 1), device_type="cpu")
    x = torch.arange(24.0).reshape(8, 3)
    mine = pm.shard_along(x, mesh41)
    try:
        pm.make_mesh(shape=(3, 1), device_type="cpu")
        bad = None
    except ValueError as err:
        bad = str(err)
    out = {"mesh": _np({
        "default": [pm.mesh_axis(pm.make_mesh(device_type="cpu"), a).size
                    for a in (pm.DP_AXIS, pm.LAT_AXIS)],
        "mesh22": [pm.mesh_axis(mesh22, a)[1:3]
                   for a in (pm.DP_AXIS, pm.LAT_AXIS)],
        "share": mine, "gathered": pm.gather_along(mine, mesh41),
        "bad_shape": bad})}

    g = lattice_problem(gt)
    g.lattice_axis = pm.LAT_AXIS
    with pm.use_mesh(mesh22):
        out["lattice"] = lattice_results(g)
        out["multistart_adam"] = _np(multistart_optimize(
            g, mesh=mesh22, **MULTISTART["adam"]))
    out["multistart_nm"] = _np(multistart_optimize(
        lattice_problem(gt), mesh=mesh41, **MULTISTART["nm"]))
    g = lattice_problem(gt)
    out["batch_elbo"] = batch_elbo(g, batch_thetas(g), max_iter=30,
                                   mesh=mesh41)

    g = walker_problem(gt)
    res = g.mcmc(walker_priors(pr), mesh=mesh41, **CHAIN)
    out["chain"] = {"chain": res.chain, "log_prob": res.log_prob}
    res = walker_problem(gt).mcmc(walker_priors(pr), mesh=mesh41, **UNEVEN)
    out["uneven"] = {"chain": res.chain, "log_prob": res.log_prob}

    out["cg"] = cg_results(mesh41)
    _, mean, std, _ = predict_iterative(predict_problem(gt),
                                        tstar=PREDICT_TSTAR, tol=1e-10,
                                        mesh=mesh41)
    out["predict"] = _np((mean, std))
    g = cg_fit_problem(gt, 32)
    out["cg_fit"] = _np(cg_fit_results(g, mesh41))
    spec, core_maps = cg_fit_problem(gt, 33)._spec_and_core_maps()
    try:
        make_cg_fit(spec, rank=16, core_maps=core_maps, mesh=mesh41)
        out["indivisible"] = None
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


def cg_fit_results(g, mesh=None):
    from gpyrn_tpu_torch.models.cg_fit import make_cg_fit
    spec, core_maps = g._spec_and_core_maps()
    theta = g._theta()
    t, y, yerr2 = g._data()
    mu0, var0 = g.engine.init_mu_var(theta, y)
    cg = make_cg_fit(spec, rank=CG_FIT["rank"], core_maps=core_maps,
                     mesh=mesh)
    return cg.fit_state_cg(theta, t, y, yerr2, mu0, var0,
                           CG_FIT["max_iter"], 0.0)


def nccl_panel_job(n_sweeps=3, block=16):
    """One NCCL rank on its card: the headline panel case's
    ``elbo_refine_panel`` against ``Engine.elbo_refine_lean`` from the same
    state, and the B1 launches the panel path made (the slab entry's)."""
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    from gpyrn_tpu_torch.parallel.panel_fit import make_panel_engine
    g = panel_problem(gt, "headline", device="cuda")
    eng = g.engine
    theta = g._theta()
    t, y, yerr2 = g._data()
    mu0, var0 = eng.init_mu_var(theta, y)
    lean = eng.elbo_refine_lean(theta, t, y, yerr2, mu0, var0, n_sweeps)
    mesh = pm.make_mesh(shape=(1, 1))
    pe = make_panel_engine(eng.spec, mesh, block=block)
    ck.reset_launch_counts()
    panel = pe.elbo_refine_panel(theta, t, y, yerr2, mu0, var0, n_sweeps)
    return _np({"lean": lean, "panel": panel,
                "launches": ck.LAUNCHES["kernel_matrix"],
                "backend": pm.mesh_axis(mesh, pm.LAT_AXIS).backend})
