"""The panel-sharded N axis of gpyrn_tpu_torch.parallel against the JAX
package, over a 4-rank gloo mesh on the CPU.

One module-scoped job (``torch_parallel_jobs.panel_job``, four processes
through ``parallel.mesh.spawn``) computes every case; the tests read its
results:

* the raw panel linear algebra (Cholesky, log-determinant, the solves,
  the matvec, the Σ-free diag/trace pass, the triangular inverse, the
  q > 1 Frobenius cross term) against dense numpy at the JAX package's
  bars (``tests/test_panel.py``), for N = 64 / block 8, N = 50 (padding
  to 64) and N = 40 with block 64 (the block clamped to the slab);
* the panel fits (``fit_state_panel``, ``elbo_refine_panel``,
  ``elbo_fit_panel``) against the JAX package's single-device engine,
  which the JAX package's own tests hold its panel engine equal to: the
  headline model (q=1, p=3, N=64), q=2 p=2 (N=48), a non-stationary
  composite node (N=48) and q=3 (N=40, all three cross pairs); ELBO
  relative 1e-9, state max |Δ| / (1 + max) 1e-8, equal sweeps and flags;
* B1's slab twin (``cuda_kernels.kernel_matrix_slab_ref``, what the CPU
  runs) against the JAX package's own slab (``panel_fit._slab_kernel``
  inside a 4-device ``shard_map``), every rank's rows;
* every rank returns the same (replicated) results.

The JAX results come from compiled loops and a ``shard_map``, so they are
kept in ``torch_parallel_reference.json`` (written by
``JAX_PLATFORMS=cpu python -m tests.test_torch_panel``); the ``slow``
test ``test_reference_is_the_jax_packages`` recomputes them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.parallel import panel as jpp
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.parallel import panel as tpp

from tests import torch_parallel_jobs as J

torch.set_num_threads(1)

ELBO_RTOL = 1e-9
STATE_TOL = 1e-8
SLAB_RTOL = 1e-13
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_parallel_reference.json")
# B1's slab twin against the JAX package's slab: the node of these models
# (a stationary leaf; a composite with a non-stationary child), N=50 over
# 4 ranks of 16 rows (Np = 64)
SLAB_MODELS = ("headline", "composite")
SLAB_N, SLAB_BLOCK = 50, 16


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


def _slab_inputs(pkg, name):
    """(structure, core params, t) of the slab case ``name``."""
    g = J.panel_problem(pkg, name)
    node = g.nodes[0]
    t = np.sort(np.random.default_rng(3).uniform(0, 100, SLAB_N))
    return node.structure, np.asarray(node.core_params(), dtype=float), t


def _closure_fn(fn, name, seen=None):
    """The function called ``name`` among the closures reachable from
    ``fn`` (the JAX panel engine keeps ``_slab_kernel`` there)."""
    seen = set() if seen is None else seen
    fn = getattr(fn, "__wrapped__", fn)
    if id(fn) in seen or not hasattr(fn, "__code__"):
        return None
    seen.add(id(fn))
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        value = cell.cell_contents
        if var == name:
            return value
        if callable(value):
            found = _closure_fn(value, name, seen)
            if found is not None:
                return found
    return None


def _jax_slab(name):
    """The padded (Np, Np) matrix the JAX panel engine's ``_slab_kernel``
    builds over a 4-device mesh (ELBO mode, no added diagonal)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from gpyrn_tpu.models.gprn import spec_from_components
    from gpyrn_tpu.parallel.panel_fit import make_panel_engine
    structure, cp, t = _slab_inputs(gj, name)
    g = J.panel_problem(gj, name)
    spec = spec_from_components(g.nodes, g.weights, g.means, SLAB_N)
    mesh = Mesh(np.array(jax.devices()[:J.WORLD]), ("lat",))
    pe = make_panel_engine(spec, mesh, block=SLAB_BLOCK)
    slab = _closure_fn(pe.elbo_refine_panel, "_slab_kernel")
    Np = pe.dims.Np
    f = jax.jit(jax.shard_map(
        lambda tp, c: slab(structure, c, tp, jnp.zeros(Np), True),
        mesh=mesh, in_specs=(P(), P()), out_specs=P("lat", None),
        check_vma=False))
    return np.asarray(f(jnp.pad(jnp.asarray(t), (0, Np - SLAB_N)),
                        jnp.asarray(cp)))


def _jax_fits(name):
    """The JAX package's single-device engine on the panel case."""
    block, n_fs, n_ref, n_fit = J.PANEL_CASES[name]
    g = J.panel_problem(gj, name)
    eng = g.engine
    theta = g._theta()
    t = np.asarray(g.time, dtype=float)
    mu0, var0 = eng.init_mu_var(theta, g.y)
    args = (theta, t, g.y, g.yerr2, mu0, var0)
    e, mu, var = eng.elbo_refine(*args, n_ref)
    out = {"refine": {"elbo": float(e), "mu": np.asarray(mu).tolist(),
                      "var": np.asarray(var).tolist()}}
    if n_fs:
        mu, var, it, done = eng.fit_state(*args, n_fs, 1e-12)
        out["fit_state"] = {"mu": np.asarray(mu).tolist(),
                            "var": np.asarray(var).tolist(),
                            "n_iter": int(it), "done": bool(done)}
    if n_fit:
        e, mu, var, it, done, _ = eng.elbo_fit(*args, n_fit)
        out["elbo_fit"] = {"elbo": float(e), "mu": np.asarray(mu).tolist(),
                           "var": np.asarray(var).tolist(),
                           "n_iter": int(it), "done": bool(done)}
    return out


def _jax_reference():
    return {"fits": {n: _jax_fits(n) for n in J.PANEL_CASES},
            "slabs": {n: _jax_slab(n).tolist() for n in SLAB_MODELS}}


def write_reference():
    """Rewrite this file's section of the shared reference file."""
    ref = {}
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            ref = json.load(f)
    ref["panel"] = _jax_reference()
    with open(REFERENCE, "w") as f:
        json.dump(ref, f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)["panel"]


@pytest.fixture(scope="module")
def ranks():
    return J.run(J.panel_job)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_every_rank_returns_the_same(ranks):
    for other in ranks[1:]:
        _equal_trees(other, ranks[0])


@pytest.mark.parametrize("N,block", J.LINALG_CASES)
def test_panel_dims_match_jax(N, block):
    for D in (1, 2, 4, 8):
        assert tuple(tpp.panel_dims(N, D, block)) == \
            tuple(jpp.panel_dims(N, D, block))


@pytest.mark.parametrize("N,block", J.LINALG_CASES)
def test_panel_linalg_matches_dense(ranks, N, block):
    got = ranks[0]["linalg"][(N, block)]
    dims = tpp.PanelDims(*got["dims"])
    A, A2, b, d = J.spd_pair(N, N)
    L = np.linalg.cholesky(A)
    s = np.max(np.abs(L))
    np.testing.assert_allclose(got["L"][:N, :N], L, atol=1e-11 * s)
    assert np.all(np.triu(got["L"], 1) == 0.0)
    assert abs(float(got["logdet_half"]) - np.sum(np.log(np.diag(L)))) \
        < 1e-10
    x = np.linalg.solve(A, b)
    np.testing.assert_allclose(got["x"][:N], x, rtol=1e-9,
                               atol=1e-11 * np.max(np.abs(x)))
    np.testing.assert_allclose(got["xf"][:N], np.linalg.solve(L, b),
                               rtol=1e-9)
    np.testing.assert_allclose(got["xb"][:N], np.linalg.solve(L.T, b),
                               rtol=1e-9)
    np.testing.assert_allclose(got["Kx"][:N], A @ b, rtol=1e-12)
    Bm = np.linalg.solve(L, A)
    np.testing.assert_allclose(got["dS"][:N],
                               np.diag(A) - np.sum(Bm ** 2, axis=0),
                               atol=1e-8 * N)
    np.testing.assert_allclose(got["cn"][:N],
                               np.sum((L.T - Bm) ** 2, axis=0), atol=1e-8)
    G = np.linalg.inv(L)
    np.testing.assert_allclose(got["G"][:N, :N], G, atol=1e-10)
    np.testing.assert_allclose(got["dKinv"][:N], np.diag(np.linalg.inv(A)),
                               rtol=1e-8)
    W = np.linalg.solve(np.linalg.cholesky(A2), np.diag(d) @ G.T)
    assert abs(float(got["frob"]) - np.sum(W ** 2)) < \
        1e-8 * (1 + np.sum(W ** 2))
    if dims.Np > N:           # identity padding stays clean
        assert np.all(got["dS"][N:] == 0.0) and np.all(got["cn"][N:] == 0.0)
        assert np.all(got["dKinv"][N:] == 1.0)


FIT_RUNS = [(name, run) for name, (_, n_fs, _, n_fit) in
            J.PANEL_CASES.items()
            for run, on in (("fit_state", n_fs), ("refine", True),
                            ("elbo_fit", n_fit)) if on]


@pytest.mark.parametrize("name,run", FIT_RUNS,
                         ids=[f"{n}-{r}" for n, r in FIT_RUNS])
def test_panel_fit_matches_jax(ranks, reference, name, run):
    got = ranks[0]["fits"][name][run]
    want = reference["fits"][name][run]
    if run == "fit_state":
        mu, var, it, done = got
    elif run == "refine":
        e, mu, var = got
    else:
        e, mu, var, it, done = got
    if run != "refine":
        assert (it, done) == (want["n_iter"], want["done"])
    if run != "fit_state":
        assert abs(float(e) - want["elbo"]) <= ELBO_RTOL * abs(want["elbo"])
    assert _state_err(mu, want["mu"]) <= STATE_TOL
    assert _state_err(var, want["var"]) <= STATE_TOL


def test_the_fits_take_the_panel_geometry(ranks):
    """Every case runs over the four ranks, with padding where N does not
    fill them (N=48, 40 → Np=64) and the q=3 case at block 8."""
    for name, (block, *_) in J.PANEL_CASES.items():
        dims = tpp.PanelDims(*ranks[0]["fits"][name]["dims"])
        N = J.panel_problem(gt, name).N
        assert dims == tpp.panel_dims(N, J.WORLD, block)
        assert dims.D == J.WORLD and dims.Np == 64


@pytest.mark.parametrize("name", SLAB_MODELS)
def test_slab_twin_matches_jax(reference, name):
    """Each rank's slab from the plain version (the CPU's path) against the
    JAX package's, the trace-scaled float64 jitter (1e-6) on the valid
    diagonal, identity in the padding."""
    structure, cp, t = _slab_inputs(gt, name)
    want = np.asarray(reference["slabs"][name])
    dims = tpp.panel_dims(SLAB_N, J.WORLD, SLAB_BLOCK)
    tt, pp_ = torch.tensor(t), torch.tensor(cp)
    slabs = [ck.kernel_matrix_slab_ref(structure, pp_, tt, dims.Np,
                                       r * dims.Nl, dims.Nl,
                                       torch.tensor(1e-6)).numpy()
             for r in range(J.WORLD)]
    got = np.concatenate(slabs)
    assert got.shape == want.shape == (dims.Np, dims.Np)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SLAB_RTOL * np.max(np.abs(want)))
    np.testing.assert_array_equal(got[SLAB_N:, :], np.eye(dims.Np)[SLAB_N:])


@pytest.mark.slow
def test_reference_is_the_jax_packages(reference):
    fresh = _jax_reference()
    for name, runs in fresh["fits"].items():
        for run, vals in runs.items():
            for key, v in vals.items():
                np.testing.assert_allclose(
                    v, reference["fits"][name][run][key],
                    rtol=REFERENCE_RTOL, err_msg=f"{name} {run} {key}")
    for name, v in fresh["slabs"].items():
        np.testing.assert_allclose(v, reference["slabs"][name],
                                   rtol=REFERENCE_RTOL)


if __name__ == "__main__":
    # the JAX package's meshes need the CPU's virtual devices (as
    # tests/conftest.py sets them up for pytest)
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    write_reference()
