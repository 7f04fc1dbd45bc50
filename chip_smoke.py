#!/usr/bin/env python3
"""Smoke run of gpyrn_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the run
ends non-zero:

1. environment: torch / CUDA / nvcc versions and the card's name and
   power limit (fails without a CUDA device);
2. build: compiles ``gpyrn_tpu_torch/csrc/kernel_matrix.cu`` with nvcc
   into ``gpyrn_tpu_torch/_build/`` and reports the time, what
   ``-Xptxas -v`` says of every kernel instance the two models use
   (registers, stack frame, spills; a spill or an unexplained stack frame
   fails the run) and, where the toolkit has ``cuobjdump``, their FP64
   operation counts in the SASS;
3. the gradient path, headline model (N=1000, q=1, p=3, QuasiPeriodic
   node, SquaredExponential weights): the 30-sweep
   ``elbo_value_and_grad`` in float64 against the JAX package's cached
   value and gradient (``chip_smoke_oracle.json``), the same in float32
   against float64, wall times, peak memory, launches per call;
4. the gradient path, flagship model (N=1000, q=2, p=3, Periodic +
   Matern52 nodes, Linear means): 10 sweeps, float64, against the cached
   JAX value and gradient;
5. a trainer: five ``optimize_adam`` steps of the headline model on the
   card against the JAX package's (optax) result;
6. the fit path, headline model: a 10-sweep ``ELBOcalc`` on the card
   against the same on the CPU and against the JAX package's cached
   value, then a converged ``ELBOcalc`` and ``predict(nn=1000)`` on the
   card, and a traced fit;
7. the fit path, flagship model: the same checks;
8. B1 (the kernel-matrix kernel) vs its plain version on the card: six
   structures, N ∈ {1, 3, 31, 32, 33, 255, 257, 1000, 4096}, float64 and
   float32, jitter multiplier 4 and 0; every output equals its transpose
   exactly;
9. B1′ (its backward, the dK/dθ contraction) vs its plain version
   (autograd): the 18 leaves and the six structures, N ∈ {1, 3, 31, 32,
   33, 257, 1000, 4096}, float64 and float32, a random (non-symmetric)
   adjoint per case; a second call gives the same bits;
10. ``kernel_matrix_stack_cuda`` (the lattice of kernel matrices built
    into one buffer) vs its plain version: values and gradients of a
    QP + 3 × SE list, float64 and float32; ``kernel_matrix_rows_cuda``
    (13 rows of that list, the batched paths' lattice) vs its plain
    version and the one-row stack; the host's time per call of
    ``linalg.kernel_matrix_stack`` against the matrix-by-matrix build with
    ``torch.stack``, and of ``linalg.kernel_matrix_rows`` for 13 and 68
    rows against one ``kernel_matrix_stack`` over the flattened list;
11. the mixed-precision fit, headline model at N=1000:
    ``ELBOcalc(precision='mixed')`` with its defaults (the float32
    merit-stall fit on the exact-nugget matrices, three float64 polish
    sweeps) and with ``refine_sweeps='converge'``, on the card against
    the JAX package's cached values and against the port on the CPU;
    sweeps and wall of the bulk and of the polish, non-finite merits;
12. the mixed fit at full width, the headline model at N=5000 (the JAX
    package's north-star size): B1 in float32 with multiplier 0 against
    its plain version at this N, the stall rule fires before
    ``max_iter``, one further float64 sweep hardly moves the ELBO, and
    the result is not below the float64 reference-rule fit's; ms per
    sweep, peak memory, non-finite factors;
13. the implicit gradient of the converged ELBO, headline model, N=1000,
    float64: ``elbo_grad(method='implicit')`` against the cached JAX
    value and gradient and against the unrolled gradient started at the
    fixed point; residuals, pull-backs, launches, wall and peak memory
    beside the unrolled call's;
14. three ``optimize_adam(grad='implicit')`` steps of the headline model
    against the cached optax result;
15. the flagship model (q=2): ``fit_state`` with a fixed count of sweeps
    and one implicit call from that state, card against CPU;
16. in a fresh process (``chip_smoke.py --profile``): a traced 30-sweep
    gradient call, a traced block of the float32 stall fit and a traced
    implicit call (headline model), then B1's and B1′'s device times
    against their plain versions' and their bounds; in a second one
    (``--profile-batch``) a traced sweep of the 13-row θ batch beside one
    of its rows alone, and the share of ``_prepare`` in a 68-row
    ``optimize_device`` objective call.  After some dozens of profiled runs and ~150k
    traced kernels in one process, torch.profiler was seen to lose records
    (an H100, torch 2.11; the first process sat at that edge once the
    batched traces were in it), so the profiled work gets processes of
    its own;
17. the θ-batched fit, headline model: ``Engine.elbo_fit_batch`` of 13
    perturbed parameter rows against the single-θ ``elbo_fit`` of each
    row on the card and the JAX package's cached ``vmap(elbo_fit)``;
    walker-fits per second against 13 sequential fits, peak memory (the
    sequential fits are the comparison: their launches leave the count);
18. ``optimize_device`` (Nelder-Mead on the device, 3 sweeps per
    objective, 30 iterations), alone and with 4 restarts, against the
    cached JAX results (the restarted call at the oracle's 8 iterations);
    iterations per second;
19. ``mcmc`` with 26 walkers and 10 steps: the host loop with scipy
    priors against the cached JAX host-loop chain, and the device chain
    with the port's priors; ensemble steps per second;
20. ``evidence.batch_elbo`` over 8 parameter rows against the cached JAX
    values.

The launch counts are set to 0 before each path (phases 3–5, phases
6–7, phases 11–12, phases 13–15, phases 17–20) and read after it.  The
last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the arguments of the child processes that run the profiled phase: the
# traced calls and the kernels' times, and the traced batched sweeps
PROFILE_ARG = "--profile"
PROFILE_BATCH_ARG = "--profile-batch"
TRACE_TRIES = 4
ORACLE = os.path.join(HERE, "chip_smoke_oracle.json")
N_MAIN = 1000
FIT_SWEEPS = 10

# parity tolerances of the main path (relative ELBO; max-abs/(1+max) of
# the variational state): the card's cuSOLVER and the CPU's LAPACK round
# differently, and the contraction of the sweep map damps the difference
ELBO_RTOL = 1e-9
STATE_TOL = 1e-7

# the gradient path: unrolled sweeps per model, Adam steps of the trainer
GRAD_SWEEPS = {"headline": 30, "flagship": 10}
ADAM_STEPS = 5
# the converged-state paths: the polish settings of the mixed fit with
# refine_sweeps='converge' (a cap that lets the Anderson polish reach the
# float64 fixed point at N=1000, where the default 80 evaluations may
# not), the implicit gradient's fit, and the implicit trainer's steps
CONVERGE = {"refine_tol": 1e-10, "refine_max_sweeps": 400}
IMPLICIT = {"fit_tol": 1e-12, "fit_max_iter": 2000}
ADAM_IMPLICIT_STEPS = 3
# the implicit trainer's adjoint solve is cut to two GMRES(20) cycles: at
# N=1000 the 1e-10 target lies under the floor float64 leaves, and a solve
# held to it runs all of its 25 cycles in every step
ADAM_IMPLICIT = {"adjoint_maxiter": 2, "adjoint_restart": 20}
# the north-star width of the mixed fit
N_WIDE = 5000
# the flagship's converged-state check: sweeps of fit_state (tol 0), and
# a cut adjoint solve (the state is not a fixed point; card and CPU run
# the same few Arnoldi steps)
FLAGSHIP_STATE_SWEEPS = 20
FLAGSHIP_ADJOINT = {"maxiter": 1, "restart": 8}

# the mixed fit.  With three polish sweeps the float32 bulk decides where
# the fit stops, and float32 trajectories differ between runtimes (an
# H100 stopped after 104 float32 sweeps where the CPU and the JAX package
# took 120, 1.6e-4 apart in the ELBO): the limit is what the JAX
# package's own tests allow between a mixed fit and the float64 fixed
# point.  Polished to convergence, every runtime lands on the same
# float64 fixed point: limits ~100 times the agreement measured on an
# H100 (ELBO 8.6e-13 against jax, 4.9e-12 against the CPU; state, max-abs
# / (1 + max): mu 2.4e-6 and 3.9e-6, var 7.1e-8 and 1.4e-7)
MIXED_POLISH3_RTOL = 1e-3
MIXED_CONVERGE_RTOL = {"jax": 8e-11, "cpu": 4e-10}
MIXED_CONVERGE_STATE_TOL = {"mu": 2e-4, "var": 1e-5}
# at N=5000: one more float64 sweep after the default polish moves the
# ELBO by less than this (relative; measured 5.1e-4: the stall rule stops
# the float32 fit well short of the fixed point at this N), and the mixed
# ELBO is not below the float64 reference-rule fit's by more than this
# (relative; measured 4% above it)
WIDE_NEXT_SWEEP_RTOL = 5e-3
WIDE_BELOW_F64_RTOL = 1e-6
# the implicit gradient against the JAX package's, ~100 times the
# agreement measured on an H100 (value 8.9e-15, gradient 2.3e-12 of
# max |g|; two GMRES, each run to its 1e-10 target).  The residual of
# the solve as computed afterwards stays at 1.7e-10 of |v| on the card and
# 1.9e-10 in the JAX package: the floor float64 leaves at N=1000, where
# |w| is some thousand times |v|
IMPLICIT_VALUE_RTOL = 5e-13
IMPLICIT_GRAD_TOL = 2e-10
IMPLICIT_ADJOINT_TOL = 1e-8
# ... and against the 30-sweep unrolled gradient started at the same
# state (measured 1.6e-13 of max |g|: the slow modes of the sweep map
# hardly reach the hyperparameters' gradient)
IMPLICIT_UNROLL_TOL = 1e-11
# the fit tolerance of the call that times the gradient alone from the
# cached state: 1e-12 lies under the floor the float64 state reaches at
# N=1000 (1.1e-11), so that every call at it runs all its 2,000 sweeps
IMPLICIT_WARM_FIT_TOL = 1e-10
ADAM_IMPLICIT_X_RTOL = 1e-6
# its tolerances against the JAX package's float64 values on the CPU:
# relative value; gradient max |Δg| / max |g| and the Adam parameters
# (relative), each ~100 times the agreement measured on an H100 (7e-12
# headline, 1.1e-10 flagship; 8e-11): cuSOLVER vs LAPACK rounding, carried
# back through the unrolled sweeps
GRAD_VALUE_RTOL = 1e-9
GRAD_TOL = 1e-8
ADAM_X_RTOL = 1e-8
# float32 against float64 on the card, max |Δg| / max |g| (measured
# 1.6e-2): the float32 jitter 4·eps·N·k(0) changes the model itself, not
# just its rounding
F32_GRAD_TOL = 0.1

# B1′ against autograd of the plain version, per parameter, as a share of
# Σ |G| |∂k/∂θ|: the two take the derivatives by other operations and
# sum in other orders (per-thread, per-block tree, then the rows), so
# they differ by rounding of the order eps·log(N²)
GRAD_KERNEL_TOL = {"float64": 1e-12, "float32": 1e-4}
GRAD_NS = (1, 3, 31, 32, 33, 257, 1000, 4096)
# the stacked function's gradients against autograd of its plain version,
# max |Δg| / max |g| per parameter tensor: B1′'s rounding plus the jitter's
# trace(G), summed in another order
STACK_GRAD_TOL = {"float64": 1e-11, "float32": 1e-3}

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s in float32 and 34 TFLOP/s in float64
# outside the tensor cores.  The kernels do no matrix products.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# operations per lag of the timed structure (QP), from the kernels'
# source, each add, multiply, divide, abs and each exp / sin / cos counted
# once (a transcendental costs the card many more: a lower bound).  Both
# kernels compute each lag once: N (N + 1) / 2 lags.
OPS_PER_LAG = {"kernel_matrix": 17, "kernel_matrix_grad": 33}
# the single-leaf kernel instances the two models run (op codes of
# ``cuda_kernels.OPCODES``)
MAIN_PATH_LEAVES = ("QP", "SE", "P", "M52")
# B1 must round as the plain version does, so it calls the CUDA math
# library's sinf / cosf, whose large-argument reduction (never taken at
# these lags) keeps a small array on the stack in float32; nothing else
# may have a stack frame
SINF_FRAME_BYTES = 32
PERIODIC_LEAVES = ("QP", "P")


def headline_problem(pkg, N=N_MAIN, **kw):
    """The benchmark's headline model: 3 outputs, 1 QuasiPeriodic node,
    SquaredExponential weights, zero means, data from default_rng(0)."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, N))
    data = []
    for i in range(3):
        data += [np.sin(2 * np.pi * t / (20 + 5 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = pkg.inference(1, t, *data, **kw)
    g.set_components(
        [pkg.covfunc.QuasiPeriodic(1.0, 30.0, 20.0, 0.7)],
        [pkg.covfunc.SquaredExponential(1.0 + 0.05 * k, 30.0)
         for k in range(3)],
        [None] * 3, [0.1] * 3)
    return g


def flagship_problem(pkg, N=N_MAIN, seed=0, **kw):
    """The flagship model: 3 outputs, 2 nodes (Periodic + Matern52), SE
    weights, linear means, per-output jitters."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 60, N))
    data = []
    for i in range(3):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = pkg.inference(2, t, *data, **kw)
    nodes = [pkg.covfunc.Periodic(1.0, 9.0, 0.6),
             pkg.covfunc.Matern52(1.0, 5.0)]
    weights = [pkg.covfunc.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
               for k in range(6)]
    means = [pkg.meanfunc.Linear(0.01, 0.0) for _ in range(3)]
    g.set_components(nodes, weights, means, [0.1, 0.12, 0.14])
    return g


PROBLEMS = {"headline": headline_problem, "flagship": flagship_problem}

# the batched paths (phases 17-20), all on the headline model at N=1000
# (13 hyperparameters): the θ batch of one ensemble half-step, 13 rows of
# log-normally perturbed parameters (row 0 unperturbed), fitted under the
# reference rule; optimize_device's settings (3 sweeps per objective, 17
# candidates per iteration; with restarts a population of 4 simplexes,
# 68 candidates); the sampler (26 walkers, 2·ndim) with log-normal priors
# of width 0.3 around the starting values; the evidence batch
BATCH = {"rows": 13, "spread": 0.1, "seed": 7, "max_iter": 10000}
OPT = {"n_sweeps": 3, "max_iter": 30}
OPT_RESTARTS = 4
MCMC = {"nwalkers": 26, "niter": 10, "elbo_max_iter": 100, "seed": 0}
PRIOR_WIDTH = 0.3
EVIDENCE = {"rows": 8, "spread": 0.1, "seed": 11, "max_iter": 100}
# the cached JAX values of the costlier two are cut to regenerate on a
# CPU in minutes: the restarted simplex runs OPT_RESTART_ORACLE_ITERS
# iterations (the card runs the same cut call beside the full one), and
# the JAX host loop MCMC_ORACLE_STEPS steps (the host loop's first steps
# do not depend on how many follow, so the card's chain is held to them)
OPT_RESTART_ORACLE_ITERS = 8
MCMC_ORACLE_STEPS = 2


def batch_thetas(theta0, rows, spread, seed):
    """``rows`` copies of the parameter vector ``theta0``, each entry
    times exp(spread·N(0, 1)) from default_rng(seed); row 0 unperturbed."""
    theta0 = np.asarray(theta0, dtype=float)
    rng = np.random.default_rng(seed)
    out = theta0[None, :] * np.exp(
        spread * rng.standard_normal((rows, theta0.size)))
    out[0] = theta0
    return out


def headline_priors(g, lognormal):
    """Per free parameter of ``g``, ``lognormal(log value, PRIOR_WIDTH)``:
    a scipy or a port prior, as the caller makes it."""
    return {name: lognormal(np.log(value), PRIOR_WIDTH)
            for name, value in g.parameters_dict.items()}

# structures and parameters of the kernel-vs-plain phase
KERNEL_CASES = [
    (("SE",), (1.2, 8.0)),
    (("QP",), (1.1, 20.0, 13.0, 0.6)),
    (("M52",), (1.2, 5.0)),
    (("P",), (1.1, 9.0, 0.7)),
    (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)),
    (("*", ("QP",), ("C",)), (1.1, 20.0, 13.0, 0.6, 0.8)),
]
KERNEL_NS = (1, 3, 31, 32, 33, 255, 257, 1000, 4096)
TIMED_NS = (1000, 4096)
# one parameter set per stationary leaf the kernels take
LEAF_CASES = [((tag,), pars) for tag, pars in (
    ("C", (0.8,)), ("SE", (1.2, 8.0)), ("P", (1.1, 9.0, 0.7)),
    ("QP", (1.1, 20.0, 13.0, 0.6)), ("RQ", (0.9, 1.5, 6.0)),
    ("RQP", (1.0, 1.2, 15.0, 9.0, 0.8)), ("COS", (1.1, 7.0)),
    ("EXP", (0.8, 4.0)), ("M32", (1.05, 3.0)), ("M52", (1.2, 5.0)),
    ("GammaExp", (1.1, 1.4, 6.0)), ("PW", (12.0,)),
    ("PAC", (1.0, 3.0, 7.0)), ("NP", (1.0, 1.3, 9.0, 0.9)),
    ("QNP", (1.0, 1.3, 15.0, 9.0, 0.9)),
    ("NRQP", (1.0, 1.1, 1.3, 15.0, 9.0, 0.9)), ("CP", (1.0, 9.0, 1.5)),
    ("QCP", (1.0, 15.0, 9.0, 1.5)))]


def state_summary(mu, var, stride=97):
    """Strided samples of the variational state (what the cached oracle
    keeps of it)."""
    mu = np.asarray(mu, dtype=float).ravel()
    var = np.asarray(var, dtype=float).ravel()
    return {"mu": mu[::stride].tolist(), "var": var[::stride].tolist()}


def _rel_state_err(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _bound(n_bytes, n_ops, dtype):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / PEAK_FLOPS[_dtype_name(dtype)]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _time_ms(torch, fn, reps):
    """Median of per-call CUDA-event times (ms), after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _trace_kernels(torch, fn, reps=1, name=None):
    """(wall ms, [(kernel name, device ms)]) of one torch.profiler trace
    of ``reps`` calls of ``fn``: every CUDA kernel the trace holds, or,
    when ``name`` is given, those whose name holds it.  The profiler
    now and then hands back a trace without these device records; such a
    trace is taken again, up to ``TRACE_TRIES`` times in all, and then
    the result is None."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        device = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [(k, ms) for k, ms in device if name is None or name in k]
        if kernels:
            return wall, kernels
        print(f"trace {attempt} of {TRACE_TRIES}: {len(device)} device "
              f"records, none of them {name or 'a kernel'} (names: "
              f"{sorted({k[:60] for k, _ in device})[:4]})", file=sys.stderr,
              flush=True)
    return None


def _traced(torch, fn):
    """One traced call: (wall ms, [(kernel name, device ms)] of every CUDA
    kernel the trace holds)."""
    traced = _trace_kernels(torch, fn)
    if traced is None:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{TRACE_TRIES} traces")
    return traced


def _device_ms(torch, fn, reps, name=None):
    """Device time per call (ms) from a torch.profiler trace of ``reps``
    calls of ``fn``: the summed durations of all its CUDA kernels over
    ``reps``; or, when ``name`` is given, of the kernels whose name holds
    it, each launched once per call: the mean duration of each such
    kernel, summed over their names (unmoved if the trace lost some
    records).  Where no trace holds them, the time per call between two
    CUDA events around the ``reps`` calls, which bounds it from above."""
    for _ in range(3):
        fn()
    traced = _trace_kernels(torch, fn, reps, name)
    if traced is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        print(f"device time of {name or 'all kernels'} from CUDA events: "
              f"{ms:.5f} ms per call", file=sys.stderr, flush=True)
        return ms
    durations = {}
    for k, ms in traced[1]:
        durations.setdefault(k, []).append(ms)
    if name is None:
        return sum(map(sum, durations.values())) / reps
    return sum(sum(d) / len(d) for d in durations.values())


_INSTANCE = re.compile(
    r"_Z\d+(kernel_matrix_kernel|kernel_matrix_grad_kernel)I([df])Li(\d+)E")
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def _sass_counts(cuobjdump, library, entry):
    """(all SASS operations, FP64 arithmetic, MUFU) in the SASS of one
    kernel: a static count, slow paths included."""
    text = _run([cuobjdump, "-sass", "-fun", entry, str(library)])
    ops = _SASS_OPCODE.findall(text)
    fp64 = sum(op.split(".")[0] in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
               for op in ops)
    return len(ops), fp64, sum(op.startswith("MUFU") for op in ops)


def phase_build(_build, ck):
    """Builds the library; prints the build time and the resources of the
    kernel instances the two models run, and fails on a spill or a stack
    frame that is not the CUDA math library's."""
    t0 = time.perf_counter()
    path = _build.build("kernel_matrix")
    print(f"built {os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    usage = _build.resource_usage(_build.build_log("kernel_matrix"))
    names = {code: tag for tag, code in ck.OPCODES.items()}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("cuobjdump not found: no SASS counts", flush=True)
    found = 0
    others = []
    for entry, use in sorted(usage.items()):
        m = _INSTANCE.match(entry)
        if not m or names[int(m[3])] not in MAIN_PATH_LEAVES:
            if use["stack_frame"] or use["spill_stores"] or \
                    use["spill_loads"]:
                others.append(f"{entry[4:].split('EvPK')[0]} "
                              f"{use['registers']}r/{use['stack_frame']}/"
                              f"{use['spill_stores']}/{use['spill_loads']}")
            continue
        found += 1
        kernel, dtype, leaf = m[1], {"d": "float64", "f": "float32"}[m[2]], \
            names[int(m[3])]
        line = (f"ptxas {kernel}<{dtype}, {leaf}>: {use['registers']} "
                f"registers, {use['stack_frame']} bytes stack frame, "
                f"{use['spill_stores']} / {use['spill_loads']} bytes spill "
                f"stores / loads")
        if os.path.exists(cuobjdump):
            total, fp64, mufu = _sass_counts(cuobjdump, path, entry)
            line += (f"; SASS {total} operations, {fp64} FP64 arithmetic, "
                     f"{mufu} MUFU (static; a thread computes 4 lags)")
        print(line, flush=True)
        allowed = SINF_FRAME_BYTES if (
            kernel == "kernel_matrix_kernel" and dtype == "float32"
            and leaf in PERIODIC_LEAVES) else 0
        if use["spill_stores"] or use["spill_loads"] or \
                use["stack_frame"] > allowed:
            raise AssertionError(f"{kernel}<{dtype}, {leaf}> spills or has a "
                                 f"stack frame over {allowed} bytes: {use}")
    print(f"ptxas, the other {len(usage) - found} instances: "
          f"{len(others)} with a stack frame or spills (mangled: Id / If the "
          f"type, Li<op code>E, n1 the pair, n2 the interpreter; then "
          f"registers/frame/spill stores/spill loads in bytes): "
          f"{', '.join(others)}", flush=True)
    expected = 2 * 2 * len(MAIN_PATH_LEAVES)
    if found != expected:
        raise AssertionError(f"the build log names {found} of the "
                             f"{expected} kernel instances of the main path")


def phase_stack(torch, ck, lin):
    """``kernel_matrix_stack_cuda`` vs its plain version: values (B1's
    tolerances) and gradients of the headline model's list, one QP and
    three SE."""
    structures = [("QP",)] + [("SE",)] * 3
    pars = [(1.0, 30.0, 20.0, 0.7)] + [(1.0 + 0.05 * k, 30.0)
                                       for k in range(3)]
    B = len(structures)
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-14),
                              (torch.float32, 2e-6, 1e-6)):
        tol = STACK_GRAD_TOL[_dtype_name(dtype)]
        worst = 0.0
        for N in (33, N_MAIN):
            rng = np.random.default_rng(N)
            t = torch.tensor(np.sort(rng.uniform(0, 100, N)), dtype=dtype,
                             device="cuda")
            G = torch.tensor(rng.standard_normal((B, N, N)), dtype=dtype,
                             device="cuda")
            out = {}
            for name, fn in (("cuda", ck.kernel_matrix_stack_cuda),
                             ("plain", ck.kernel_matrix_stack_ref)):
                params = [torch.tensor(q, dtype=dtype, device="cuda",
                                       requires_grad=True) for q in pars]
                before = dict(ck.LAUNCHES)
                K = fn(structures, params, t, lin.TRAIN_NUGGET,
                       lin.F32_JITTER_MULT)
                grads = torch.autograd.grad(K, params, grad_outputs=G)
                torch.cuda.synchronize()
                launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
                want = B if name == "cuda" else 0
                if launched != {"kernel_matrix": want,
                                "kernel_matrix_grad": want}:
                    raise AssertionError(f"stack ({name}) launched "
                                         f"{launched}, expected {want} each")
                out[name] = (K.detach(), grads)
            (K, g), (R, g_ref) = out["cuda"], out["plain"]
            if tuple(K.shape) != (B, N, N) or not K.is_contiguous():
                raise AssertionError(f"stack: shape {tuple(K.shape)}")
            if not bool(((K - R).abs() <= atol * R.abs().amax()
                         + rtol * R.abs()).all()):
                raise AssertionError(
                    f"stack N={N} {dtype}: values differ by "
                    f"{float((K - R).abs().max()):.3e}")
            for a, b in zip(g, g_ref):
                err = float((a - b).abs().max() / b.abs().max())
                worst = max(worst, err)
                if not np.isfinite(err) or err > tol:
                    raise AssertionError(
                        f"stack N={N} {dtype}: gradient {a.tolist()} vs "
                        f"plain {b.tolist()}: {err:.3e} exceeds {tol}")
        print(f"kernel_matrix_stack {_dtype_name(dtype)}: QP + 3 x SE, "
              f"N=(33, {N_MAIN}), values agree (max "
              f"{float((K - R).abs().max()):.3e} at N={N_MAIN}), gradients "
              f"worst max|Δg|/max|g| = {worst:.3e} (limit {tol}), "
              f"{B} launches of each kernel per call", flush=True)
        phase_rows(torch, ck, lin, structures, pars, dtype, rtol, atol)


def _row_params(torch, pars, W, dtype, seed):
    """W rows of each parameter tuple of ``pars``, log-normally perturbed
    (spread 0.1, default_rng(seed)), as (W, n) tensors on the card."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(np.asarray(q) * np.exp(
        0.1 * rng.standard_normal((W, len(q)))), dtype=dtype, device="cuda")
        for q in pars]


def phase_rows(torch, ck, lin, structures, pars, dtype, rtol, atol):
    """``kernel_matrix_rows_cuda`` at the batched fit's shapes (13 rows of
    the headline lattice, N=1000) vs its plain version and, row by row, the
    one-row stack to the bit; its gradients vs the plain version's at 3
    rows, N=33."""
    W, B = BATCH["rows"], len(structures)
    t = torch.tensor(np.sort(np.random.default_rng(W).uniform(0, 100,
                                                               N_MAIN)),
                     dtype=dtype, device="cuda")
    rows = _row_params(torch, pars, W, dtype, W)
    before = ck.LAUNCHES["kernel_matrix"]
    K = ck.kernel_matrix_rows_cuda(structures, rows, t, lin.TRAIN_NUGGET,
                                   lin.F32_JITTER_MULT)
    torch.cuda.synchronize()
    launched = ck.LAUNCHES["kernel_matrix"] - before
    R = ck.kernel_matrix_rows_ref(structures, rows, t, lin.TRAIN_NUGGET,
                                  lin.F32_JITTER_MULT)
    err = float((K - R).abs().max())
    one_row = all(torch.equal(K[w], ck.kernel_matrix_stack_cuda(
        structures, [r[w] for r in rows], t, lin.TRAIN_NUGGET,
        lin.F32_JITTER_MULT)) for w in range(W))
    tol = STACK_GRAD_TOL[_dtype_name(dtype)]
    tg = torch.tensor(np.sort(np.random.default_rng(3).uniform(0, 100, 33)),
                      dtype=dtype, device="cuda")
    G = torch.tensor(np.random.default_rng(4).standard_normal((3, B, 33, 33)),
                     dtype=dtype, device="cuda")
    grads = []
    for fn in (ck.kernel_matrix_rows_cuda, ck.kernel_matrix_rows_ref):
        ps = [r[:3].clone().requires_grad_(True) for r in rows]
        grads.append(torch.autograd.grad(
            fn(structures, ps, tg, lin.TRAIN_NUGGET, lin.F32_JITTER_MULT),
            ps, grad_outputs=G))
    g_err = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(*grads))
    _check(f"kernel_matrix_rows {_dtype_name(dtype)}", [
        ("shape", tuple(K.shape) == (W, B, N_MAIN, N_MAIN)
         and K.is_contiguous(), f"{tuple(K.shape)}"),
        ("values vs plain", bool(((K - R).abs() <= atol * R.abs().amax()
                                  + rtol * R.abs()).all()),
         f"max |Δ| {err:.3e}"),
        ("each row equals the one-row stack", one_row, f"{W} rows"),
        ("launches, one per matrix", launched == W * B,
         f"{launched} vs {W * B}"),
        ("gradients vs plain", np.isfinite(g_err) and g_err <= tol,
         f"max|Δg|/max|g| {g_err:.3e} (limit {tol})"),
    ])


def _host_ms(torch, fn, reps):
    """(ms the host takes to enqueue one call of ``fn``, ms per call until
    the card has finished), over ``reps`` calls after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    return 1e3 * enqueued / reps, 1e3 * done / reps


def host_cost_stack(torch, lin):
    """What the host pays per lattice of the headline model (QP + 3 × SE,
    N=1000, float64, parameters that require grad): one call of
    ``linalg.kernel_matrix_stack`` against ``linalg.kernel_matrix`` per
    matrix and ``torch.stack``; forward alone, and forward with backward.
    Order: stack, per matrix, per matrix, stack."""
    structures = [("QP",)] + [("SE",)] * 3
    pars = [(1.0, 30.0, 20.0, 0.7)] + [(1.0 + 0.05 * k, 30.0)
                                       for k in range(3)]
    rng = np.random.default_rng(N_MAIN)
    t = torch.tensor(np.sort(rng.uniform(0, 100, N_MAIN)),
                     dtype=torch.float64, device="cuda")
    G = torch.tensor(rng.standard_normal((len(pars), N_MAIN, N_MAIN)),
                     dtype=torch.float64, device="cuda")
    params = [torch.tensor(q, dtype=torch.float64, device="cuda",
                           requires_grad=True) for q in pars]

    def stacked():
        return lin.kernel_matrix_stack(structures, params, t)

    def per_matrix():
        return torch.stack([lin.kernel_matrix(s, q, t)
                            for s, q in zip(structures, params)])

    for what, wrap in (
            ("forward", lambda build: build),
            ("forward and backward", lambda build: lambda: torch.autograd.grad(
                build(), params, grad_outputs=G))):
        runs = [_host_ms(torch, wrap(build), 300)
                for build in (stacked, per_matrix, per_matrix, stacked)]
        (s_a, p_a, p_b, s_b) = runs
        print(f"host cost of the lattice, {what}, QP + 3 x SE, N={N_MAIN}, "
              f"float64, 300 calls, ms per call enqueued (until the card is "
              f"done): kernel_matrix_stack {s_a[0]:.4f} ({s_a[1]:.4f}) and "
              f"{s_b[0]:.4f} ({s_b[1]:.4f}); per matrix and torch.stack "
              f"{p_a[0]:.4f} ({p_a[1]:.4f}) and {p_b[0]:.4f} ({p_b[1]:.4f})",
              flush=True)
    # the batched paths' lattice: W rows in one kernel_matrix_rows call
    # (each structure checked and its jitters computed once) against one
    # kernel_matrix_stack call over the W·4 matrices' flattened list
    for W in (BATCH["rows"], OPT_RESTARTS * 17):
        rows = _row_params(torch, pars, W, torch.float64, W)
        flat = [r[w] for w in range(W) for r in rows]

        def by_rows():
            return lin.kernel_matrix_rows(structures, rows, t)

        def flattened():
            return lin.kernel_matrix_stack(structures * W, flat, t)

        runs = [_host_ms(torch, build, 30)
                for build in (by_rows, flattened, flattened, by_rows)]
        (r_a, f_a, f_b, r_b) = runs
        print(f"host cost of the lattice, {W} rows, forward, QP + 3 x SE, "
              f"N={N_MAIN}, float64, 30 calls, ms per call enqueued (until "
              f"the card is done): kernel_matrix_rows {r_a[0]:.4f} "
              f"({r_a[1]:.4f}) and {r_b[0]:.4f} ({r_b[1]:.4f}); one "
              f"kernel_matrix_stack over the flattened list {f_a[0]:.4f} "
              f"({f_a[1]:.4f}) and {f_b[0]:.4f} ({f_b[1]:.4f})", flush=True)


def phase_kernels(torch, ck, lin):
    """B1 vs its plain version on the card."""
    from gpyrn_tpu_torch.ops import kernels
    worst = 0.0
    before = ck.LAUNCHES["kernel_matrix"]
    n_cases = 0
    for dtype, rtol, atol_rel in ((torch.float64, 1e-12, 1e-14),
                                  (torch.float32, 2e-6, 1e-6)):
        for structure, pars in KERNEL_CASES:
            for N in KERNEL_NS:
                rng = np.random.default_rng(N)
                t = torch.tensor(np.sort(rng.uniform(0, 100, N)),
                                 dtype=dtype, device="cuda")
                params = torch.tensor(pars, dtype=dtype, device="cuda")
                k0 = abs(float(kernels.evaluate(
                    structure, params,
                    r=torch.zeros((), dtype=dtype, device="cuda"))))
                for mult in (lin.F32_JITTER_MULT, 0.0):
                    K = ck.kernel_matrix_cuda(structure, params, t,
                                              lin.TRAIN_NUGGET, mult)
                    R = ck.kernel_matrix_ref(structure, params, t,
                                             lin.TRAIN_NUGGET, mult)
                    torch.cuda.synchronize()
                    n_cases += 1
                    err = (K - R).abs()
                    bound = atol_rel * k0 + rtol * R.abs()
                    if not bool(torch.isfinite(K).all()) or \
                            not bool((err <= bound).all()):
                        raise AssertionError(
                            f"kernel_matrix {structure} N={N} {dtype} "
                            f"mult={mult}: max abs err "
                            f"{float(err.max()):.3e} exceeds rtol={rtol}, "
                            f"atol={atol_rel}*k(0)")
                    if not torch.equal(K, K.T):
                        raise AssertionError(
                            f"kernel_matrix {structure} N={N} {dtype} "
                            f"mult={mult}: the output is not equal to its "
                            f"transpose")
                    worst = max(worst, float(err.max()) / max(k0, 1e-300))
            print(f"kernel_matrix {structure} {str(dtype)[6:]}: "
                  f"N={list(KERNEL_NS)} mult=(4, 0) agree", flush=True)
    launched = ck.LAUNCHES["kernel_matrix"] - before
    if launched != n_cases:
        raise AssertionError(f"launch counter moved by {launched}, "
                             f"expected {n_cases}")
    print(f"kernel vs plain: {n_cases} cases agree and equal their "
          f"transposes exactly, worst max-abs-err / k(0) = {worst:.3e}",
          flush=True)


def time_kernel(torch, ck, lin):
    """B1's and its plain version's times on the card; returns the record
    of the headline node's structure at N=1000 in float64."""
    record = None
    for dtype in (torch.float64, torch.float32):
        for structure, pars in KERNEL_CASES[:2]:
            for N in TIMED_NS:
                rng = np.random.default_rng(N)
                t = torch.tensor(np.sort(rng.uniform(0, 100, N)),
                                 dtype=dtype, device="cuda")
                params = torch.tensor(pars, dtype=dtype, device="cuda")
                args = (structure, params, t, lin.TRAIN_NUGGET,
                        lin.F32_JITTER_MULT)
                reps = 50 if N <= 1000 else 20

                def kern():
                    return ck.kernel_matrix_cuda(*args)

                def plain():
                    return ck.kernel_matrix_ref(*args)

                # kernel, plain, plain, kernel: compare within one call
                dev_a = _device_ms(torch, kern, reps, "kernel_matrix_kernel")
                pdev_a = _device_ms(torch, plain, reps)
                pdev_b = _device_ms(torch, plain, reps)
                dev_b = _device_ms(torch, kern, reps, "kernel_matrix_kernel")
                wrap_dev = _device_ms(torch, kern, reps)
                call_ms = _time_ms(torch, kern, reps)
                plain_call_ms = _time_ms(torch, plain, reps)
                ms, plain_ms = min(dev_a, dev_b), min(pdev_a, pdev_b)
                err = float((kern() - plain()).abs().max())
                print(f"time kernel_matrix {structure} N={N} "
                      f"{str(dtype)[6:]}: device kernel {ms:.5f} ms "
                      f"({dev_a:.5f}/{dev_b:.5f}), wrapper with its jitter "
                      f"ops {wrap_dev:.5f} ms, plain {plain_ms:.5f} ms "
                      f"({pdev_a:.5f}/{pdev_b:.5f}); per call as the "
                      f"device sees it: wrapper {call_ms:.4f} ms, plain "
                      f"{plain_call_ms:.4f} ms", flush=True)
                # reads t and the parameters, writes K once
                item = t.element_size()
                bound_ms, bound_by = _bound(
                    item * (N + params.shape[0] + 1 + N * N),
                    OPS_PER_LAG["kernel_matrix"] * N * (N + 1) // 2, dtype)
                if structure == ("QP",):
                    print(f"bound kernel_matrix QP N={N} "
                          f"{_dtype_name(dtype)}: {bound_ms:.5f} ms "
                          f"({bound_by}); kernel at "
                          f"{bound_ms / ms:.3f} of it", flush=True)
                if (dtype == torch.float64 and structure == ("QP",)
                        and N == N_MAIN):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None,
                              "call_ms": call_ms,
                              "plain_call_ms": plain_call_ms}
    return record


def _abs_contraction(torch, structure, params, t, G):
    """Σ |G| |∂k/∂θ_m| per parameter (forward-mode derivatives of the
    plain formula), the scale of B1′'s tolerance."""
    from gpyrn_tpu_torch.ops import kernels
    r = t[:, None] - t[None, :]
    out = []
    for m in range(params.shape[0]):
        e = torch.zeros_like(params)
        e[m] = 1.0
        _, dk = torch.func.jvp(
            lambda p: kernels.evaluate(structure, p, r=r), (params,), (e,))
        out.append((G.abs() * dk.abs()).sum())
    return torch.stack(out)


def _grad_inputs(torch, N, dtype, cache):
    """The times and a random adjoint G of B1′'s cases, from numpy seeded
    by N (``cache`` keeps the numpy draws per N)."""
    if N not in cache:
        rng = np.random.default_rng(N)
        times = np.sort(rng.uniform(0, 100, N))
        if N > 5:
            times[5] = times[4]            # r = 0 off the diagonal too
        cache[N] = (times, rng.standard_normal((N, N)))
    times, G = cache[N]
    return (torch.tensor(times, dtype=dtype, device="cuda"),
            torch.tensor(G, dtype=dtype, device="cuda"))


def phase_grad_kernel(torch, ck):
    """B1′ vs its plain version (autograd) on the card."""
    cache = {}
    before = ck.LAUNCHES["kernel_matrix_grad"]
    n_cases = 0
    for dtype in (torch.float64, torch.float32):
        tol = GRAD_KERNEL_TOL[_dtype_name(dtype)]
        worst = 0.0
        for structure, pars in LEAF_CASES + KERNEL_CASES:
            for N in GRAD_NS:
                t, G = _grad_inputs(torch, N, dtype, cache)
                params = torch.tensor(pars, dtype=dtype, device="cuda")
                got = ck.kernel_matrix_grad_cuda(structure, params, t, G)
                again = ck.kernel_matrix_grad_cuda(structure, params, t, G)
                ref = ck.kernel_matrix_grad_ref(structure, params, t, G)
                scale = _abs_contraction(torch, structure, params, t, G)
                torch.cuda.synchronize()
                n_cases += 2
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"kernel_matrix_grad {structure} N={N} {dtype}: two "
                        f"calls on the same input differ: {got.tolist()} "
                        f"vs {again.tolist()}")
                share = float(((got - ref).abs() / scale).max())
                if not bool(torch.isfinite(got).all()) or share > tol:
                    raise AssertionError(
                        f"kernel_matrix_grad {structure} N={N} {dtype}: "
                        f"max |Δg| / Σ|G ∂k/∂θ| = {share:.3e} exceeds {tol} "
                        f"(kernel {got.tolist()}, plain {ref.tolist()})")
                worst = max(worst, share)
        print(f"kernel_matrix_grad {_dtype_name(dtype)}: 18 leaves + "
              f"{len(KERNEL_CASES)} structures, N={list(GRAD_NS)} agree, "
              f"and a second call gives the same bits; "
              f"worst max |Δg| / Σ|G ∂k/∂θ| = {worst:.3e} (limit {tol})",
              flush=True)
    launched = ck.LAUNCHES["kernel_matrix_grad"] - before
    if launched != n_cases:
        raise AssertionError(f"grad launch counter moved by {launched}, "
                             f"expected {n_cases}")


def time_grad_kernel(torch, ck):
    """B1′'s and its plain version's times on the card; returns the record
    of the headline node's structure at N=1000 in float64."""
    cache = {}
    record = None
    for dtype in (torch.float64, torch.float32):
        for structure, pars in KERNEL_CASES[:2]:
            for N in TIMED_NS:
                t, G = _grad_inputs(torch, N, dtype, cache)
                params = torch.tensor(pars, dtype=dtype, device="cuda")
                args = (structure, params, t, G)
                reps = 50 if N <= 1000 else 20

                def kern():
                    return ck.kernel_matrix_grad_cuda(*args)

                def plain():
                    return ck.kernel_matrix_grad_ref(*args)

                dev_a = _device_ms(torch, kern, reps, "kernel_matrix_grad")
                pdev_a = _device_ms(torch, plain, reps)
                pdev_b = _device_ms(torch, plain, reps)
                dev_b = _device_ms(torch, kern, reps, "kernel_matrix_grad")
                call_ms = _time_ms(torch, kern, reps)
                plain_call_ms = _time_ms(torch, plain, reps)
                ms, plain_ms = min(dev_a, dev_b), min(pdev_a, pdev_b)
                err = float((kern() - plain()).abs().max())
                # reads t, the parameters and G once, writes g once
                item = t.element_size()
                n_par = params.shape[0]
                bound_ms, bound_by = _bound(
                    item * (N + 2 * n_par + N * N),
                    OPS_PER_LAG["kernel_matrix_grad"] * N * (N + 1) // 2,
                    dtype)
                print(f"time kernel_matrix_grad {structure} N={N} "
                      f"{_dtype_name(dtype)}: device kernels {ms:.5f} ms "
                      f"({dev_a:.5f}/{dev_b:.5f}), plain {plain_ms:.5f} ms "
                      f"({pdev_a:.5f}/{pdev_b:.5f}); per call as the device "
                      f"sees it: wrapper {call_ms:.4f} ms, plain "
                      f"{plain_call_ms:.4f} ms; bound {bound_ms:.5f} ms "
                      f"({bound_by}), kernel at {bound_ms / ms:.3f} of it",
                      flush=True)
                if (dtype == torch.float64 and structure == ("QP",)
                        and N == N_MAIN):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None,
                              "call_ms": call_ms,
                              "plain_call_ms": plain_call_ms}
    return record


def phase_main(torch, pkg, name, oracle, ck):
    """10-sweep fit on the card vs the CPU and the cached JAX value,
    then a converged fit and a prediction on the card."""
    make = PROBLEMS[name]
    g_gpu = make(pkg, device="cuda")
    q, p = g_gpu.q, g_gpu.p
    n_k = q + q * p

    before = ck.LAUNCHES["kernel_matrix"]
    t0 = time.perf_counter()
    e_gpu, mu_gpu, var_gpu, it_gpu = g_gpu.ELBOcalc(max_iter=FIT_SWEEPS)
    torch.cuda.synchronize()
    dt_gpu = time.perf_counter() - t0
    launched = ck.LAUNCHES["kernel_matrix"] - before
    if launched != n_k:
        raise AssertionError(f"{name}: ELBOcalc launched the kernel "
                             f"{launched} times, expected q + q·p = {n_k}")
    g_cpu = make(pkg, device="cpu")
    t0 = time.perf_counter()
    e_cpu, mu_cpu, var_cpu, it_cpu = g_cpu.ELBOcalc(max_iter=FIT_SWEEPS)
    dt_cpu = time.perf_counter() - t0
    mu_gpu, var_gpu = mu_gpu.cpu().numpy(), var_gpu.cpu().numpy()
    print(f"{name}: {FIT_SWEEPS}-sweep ELBOcalc cuda {e_gpu!r} "
          f"({it_gpu} sweeps, {dt_gpu:.3f} s), cpu {e_cpu!r} "
          f"({it_cpu} sweeps, {dt_cpu:.3f} s), kernel launches {launched}",
          flush=True)
    checks = [
        ("n_iter cuda vs cpu", it_gpu == it_cpu, f"{it_gpu} vs {it_cpu}"),
        ("ELBO cuda vs cpu", abs(e_gpu - e_cpu) <= ELBO_RTOL * abs(e_cpu),
         f"rel {abs(e_gpu - e_cpu) / abs(e_cpu):.3e}"),
        ("mu cuda vs cpu",
         _rel_state_err(mu_gpu, mu_cpu.numpy()) <= STATE_TOL,
         f"{_rel_state_err(mu_gpu, mu_cpu.numpy()):.3e}"),
        ("var cuda vs cpu",
         _rel_state_err(var_gpu, var_cpu.numpy()) <= STATE_TOL,
         f"{_rel_state_err(var_gpu, var_cpu.numpy()):.3e}"),
        ("n_iter cuda vs jax", it_gpu == oracle["n_iter"],
         f"{it_gpu} vs {oracle['n_iter']}"),
        ("ELBO cuda vs jax",
         abs(e_gpu - oracle["elbo"]) <= ELBO_RTOL * abs(oracle["elbo"]),
         f"rel {abs(e_gpu - oracle['elbo']) / abs(oracle['elbo']):.3e}"),
    ]
    summary = state_summary(mu_gpu, var_gpu, oracle["stride"])
    for key in ("mu", "var"):
        err = _rel_state_err(summary[key], oracle[key])
        checks.append((f"{key} cuda vs jax", err <= STATE_TOL, f"{err:.3e}"))
    for what, ok, detail in checks:
        print(f"{name}: {what}: {detail} {'ok' if ok else 'FAILED'}",
              flush=True)
    failed = [what for what, ok, _ in checks if not ok]
    if failed:
        raise AssertionError(f"{name}: parity failed: {failed}")

    t0 = time.perf_counter()
    elbo, mu, var, n_iter = g_gpu.ELBOcalc()
    torch.cuda.synchronize()
    dt_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    tstar, mean, std, _ = g_gpu.predict(nn=1000)
    torch.cuda.synchronize()
    dt_pred = time.perf_counter() - t0
    ok = (np.isfinite(elbo) and mean.shape == (1000, p)
          and std.shape == (1000, p) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(std).all()) and bool((std > 0).all())
          and bool(torch.isfinite(mu).all())
          and bool(torch.isfinite(var).all()))
    print(f"{name}: converged ELBOcalc {elbo!r} in {n_iter} sweeps, "
          f"{dt_fit:.3f} s ({1e3 * dt_fit / max(n_iter, 1):.3f} ms/sweep); "
          f"predict(nn=1000) {dt_pred:.3f} s; finite, shapes "
          f"{tuple(mean.shape)} {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: converged fit or prediction is not "
                             "finite or has the wrong shape")

    # where the device time of a converged fit goes (a second, traced run)
    wall, kernels = _traced(torch, g_gpu.ELBOcalc)
    busy = sum(ms for _, ms in kernels)
    km = sum(ms for k, ms in kernels if "kernel_matrix_kernel" in k)
    print(f"{name}: traced converged ELBOcalc: wall {wall:.3f} ms, "
          f"device kernels {busy:.3f} ms in {len(kernels)} launches "
          f"(idle share {1 - busy / wall:.3f}), kernel_matrix "
          f"{km:.4f} ms ({km / busy:.5f} of device time)", flush=True)


def _grad_error(g, ref):
    g, ref = np.asarray(g, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(g - ref)) / np.max(np.abs(ref)))


def phase_grad_path(torch, pkg, name, oracle, ck):
    """``elbo_value_and_grad`` on the card against the JAX package's cached
    float64 value and gradient; for the headline model also float32, wall
    times and peak memory."""
    n_sweeps = GRAD_SWEEPS[name]
    g = PROBLEMS[name](pkg, device="cuda")
    eng = g.engine
    theta = g._theta()
    data = g._data()
    mu0, var0 = eng.init_mu_var(theta, data[1])
    n_k = g.q + g.q * g.p

    def call(dtype):
        args = [a.to(dtype) for a in (theta, *data, mu0, var0)]
        return eng.elbo_value_and_grad(*args, n_sweeps)

    before = dict(ck.LAUNCHES)
    value, grad = call(torch.float64)
    torch.cuda.synchronize()
    launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
    if launched != {"kernel_matrix": n_k, "kernel_matrix_grad": n_k}:
        raise AssertionError(f"{name}: one gradient call launched "
                             f"{launched}, expected {n_k} of each")
    value, grad = float(value), grad.cpu().numpy()
    ref = oracle["grad"][name]
    v_rel = abs(value - ref["value"]) / abs(ref["value"])
    g_err = _grad_error(grad, ref["grad"])
    ok = (np.isfinite(value) and np.all(np.isfinite(grad))
          and grad.shape == (len(ref["grad"]),)
          and v_rel <= GRAD_VALUE_RTOL and g_err <= GRAD_TOL)
    print(f"{name}: {n_sweeps}-sweep elbo_value_and_grad float64 on the "
          f"card {value!r} vs jax {ref['value']!r}: value rel {v_rel:.3e} "
          f"(limit {GRAD_VALUE_RTOL}), gradient max|Δg|/max|g| "
          f"{g_err:.3e} (limit {GRAD_TOL}); launches per call {launched} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: gradient parity failed")
    if name != "headline":
        return

    v32, g32 = call(torch.float32)
    g32 = g32.cpu().numpy()
    e32 = _grad_error(g32, grad)
    ok = (np.isfinite(float(v32)) and np.all(np.isfinite(g32))
          and e32 <= F32_GRAD_TOL)
    print(f"{name}: float32 on the card {float(v32)!r} (float64 "
          f"{value!r}), gradient max|Δg|/max|g| against float64 "
          f"{e32:.3e} (limit {F32_GRAD_TOL}) {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: float32 gradient off")

    for dtype in (torch.float64, torch.float32):
        call(dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            v, gr = call(dtype)
            float(v), gr.cpu()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name}: elbo_value_and_grad {_dtype_name(dtype)} wall "
              f"median of 5 {1e3 * float(np.median(walls)):.3f} ms "
              f"(min {1e3 * min(walls):.3f}, max {1e3 * max(walls):.3f}); "
              f"peak device memory {peak:.3f} GiB", flush=True)




def _rel(a, b):
    return abs(a - b) / abs(b)


def _check(name, checks):
    """Print each (what, ok, detail) and fail on the first that is not
    ok."""
    for what, ok, detail in checks:
        print(f"{name}: {what}: {detail} {'ok' if ok else 'FAILED'}",
              flush=True)
    failed = [what for what, ok, _ in checks if not ok]
    if failed:
        raise AssertionError(f"{name}: failed: {failed}")


def _timed(torch, fn):
    """(result, seconds) of one call, the card's work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _mixed_stages(torch, g):
    """The two stages of the default mixed fit timed apart: (bulk sweeps,
    bulk seconds, polish sweeps, polish seconds)."""
    theta = g._theta()
    mu0, var0 = g._resolve_mu_var('init', 'init', theta)
    (mu32, var32, n_bulk, _), dt_bulk = _timed(
        torch, lambda: g._bulk_fit32(theta, mu0, var0, 10000))
    (_, _, _, n_polish), dt_polish = _timed(
        torch, lambda: g._polish64(theta, mu32.double(), var32.double()))
    return n_bulk, dt_bulk, n_polish, dt_polish


def phase_mixed(torch, pkg, oracle, ck):
    """The mixed fit of the headline model at N=1000 on the card: the
    defaults, then polished to the float64 fixed point, against the cached
    JAX values and the port on the CPU."""
    ref = oracle["mixed"]
    n_k = 4                                   # q + q·p kernel matrices
    g = headline_problem(pkg, device="cuda")
    g.ELBOcalc(precision='mixed', max_iter=8)            # warm-up
    before = ck.LAUNCHES["kernel_matrix"]
    (elbo, mu, var, n_iter), wall = _timed(
        torch, lambda: g.ELBOcalc(precision='mixed'))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    info = dict(g.mixed_info)
    n_bulk, dt_bulk, n_polish, dt_polish = _mixed_stages(torch, g)
    g_cpu = headline_problem(pkg, device="cpu")
    t0 = time.perf_counter()
    e_cpu, _, _, it_cpu = g_cpu.ELBOcalc(precision='mixed')
    dt_cpu = time.perf_counter() - t0
    print(f"mixed, defaults: ELBO {elbo!r} in {n_iter} sweeps, wall "
          f"{wall:.3f} s; float32 bulk {info}; stages timed apart: bulk "
          f"{n_bulk} sweeps {dt_bulk:.3f} s "
          f"({1e3 * dt_bulk / max(n_bulk, 1):.3f} ms/sweep), polish "
          f"{n_polish} float64 sweeps {dt_polish:.3f} s "
          f"({1e3 * dt_polish / n_polish:.3f} ms/sweep); cpu {e_cpu!r} in "
          f"{it_cpu} sweeps, {dt_cpu:.3f} s; jax {ref['default']['elbo']!r} "
          f"in {ref['default']['n_iter']} sweeps", flush=True)
    # the jittered lattice for the merit's prior factors and the
    # exact-nugget one (multiplier 0) in float32, the jittered one of the
    # float64 polish
    _check("mixed, defaults", [
        ("finite, float64 state",
         np.isfinite(elbo) and mu.dtype == torch.float64
         and bool(torch.isfinite(mu).all()) and bool((var > 0).all()),
         f"{tuple(mu.shape)}"),
        ("B1 launches (float32 with multiplier 4 and 0, float64)",
         launched == 3 * n_k, f"{launched} vs {3 * n_k}"),
        ("the stall rule fired", info["bulk"] == "stall" and info["stalled"]
         and info["bulk_sweeps"] < 10000, f"{info['bulk_sweeps']} sweeps"),
        ("non-finite float32 merits", info["nonfinite_merits"] == 0,
         f"{info['nonfinite_merits']} of {info['blocks']}"),
        ("state cached", g._mu is mu, "the converged state"),
        ("ELBO card vs cpu", _rel(elbo, e_cpu) <= MIXED_POLISH3_RTOL,
         f"rel {_rel(elbo, e_cpu):.3e} (limit {MIXED_POLISH3_RTOL})"),
        ("ELBO card vs jax",
         _rel(elbo, ref["default"]["elbo"]) <= MIXED_POLISH3_RTOL,
         f"rel {_rel(elbo, ref['default']['elbo']):.3e} "
         f"(limit {MIXED_POLISH3_RTOL})"),
    ])

    conv = ref["converge"]
    settings = {k: conv[k] for k in CONVERGE}
    runs = {}
    for device in ("cuda", "cpu"):
        g = headline_problem(pkg, device=device)
        g.refine_sweeps = 'converge'
        for key, value in settings.items():
            setattr(g, key, value)
        before = ck.LAUNCHES["kernel_matrix"]
        t0 = time.perf_counter()
        out = g.ELBOcalc(precision='mixed')
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (*out, time.perf_counter() - t0, dict(g.mixed_info),
                        ck.LAUNCHES["kernel_matrix"] - before)
    e_gpu, mu, var, it_gpu, dt_gpu, info, launched = runs["cuda"]
    e_cpu, mu_c, var_c, it_cpu, dt_cpu, info_c, _ = runs["cpu"]
    print(f"mixed, converge {settings}: card {e_gpu!r} in {it_gpu} sweeps "
          f"({info['bulk_sweeps']} float32 + {info['polish_sweeps']} "
          f"float64), {dt_gpu:.3f} s; cpu {e_cpu!r} in {it_cpu} sweeps "
          f"({info_c['bulk_sweeps']} + {info_c['polish_sweeps']}), "
          f"{dt_cpu:.3f} s; jax {conv['elbo']!r} in {conv['n_iter']}",
          flush=True)
    summary = state_summary(mu.cpu().numpy(), var.cpu().numpy(),
                            conv["stride"])
    checks = [
        ("B1 launches", launched == n_k * (2 + info["polish_sweeps"]),
         f"{launched} vs {n_k} x (2 + {info['polish_sweeps']} polish calls)"),
        ("the polish converged under its cap",
         info["polish_sweeps"] <= settings["refine_max_sweeps"],
         f"{info['polish_sweeps']} sweeps"),
        ("ELBO card vs jax",
         _rel(e_gpu, conv["elbo"]) <= MIXED_CONVERGE_RTOL["jax"],
         f"rel {_rel(e_gpu, conv['elbo']):.3e} (limit "
         f"{MIXED_CONVERGE_RTOL['jax']})"),
        ("ELBO card vs cpu", _rel(e_gpu, e_cpu) <= MIXED_CONVERGE_RTOL["cpu"],
         f"rel {_rel(e_gpu, e_cpu):.3e} (limit "
         f"{MIXED_CONVERGE_RTOL['cpu']})"),
    ]
    for key, got, got_cpu in (("mu", mu, mu_c), ("var", var, var_c)):
        tol = MIXED_CONVERGE_STATE_TOL[key]
        err = _rel_state_err(summary[key], conv[key])
        checks.append((f"{key} card vs jax", err <= tol,
                       f"{err:.3e} (limit {tol})"))
        err = _rel_state_err(got.cpu().numpy(), got_cpu.numpy())
        checks.append((f"{key} card vs cpu", err <= tol,
                       f"{err:.3e} (limit {tol})"))
    _check("mixed, converge", checks)


def phase_mixed_wide(torch, pkg, ck, lin):
    """The default mixed fit of the headline model at N=5000 on the card,
    beside the float64 reference-rule fit at the same N."""
    N = N_WIDE
    n_k = 4
    g = headline_problem(pkg, N=N, device="cuda")
    eng, theta = g.engine, g._theta()

    # B1 in float32 with multiplier 0 at this N, against its plain
    # version: the exact-nugget lattice of the bulk fit
    theta32 = theta.float()
    t32 = g._tensor(g.time, torch.float32)
    before = ck.LAUNCHES["kernel_matrix"]
    Kf, Kw = eng._plain_matrices(theta32, t32)
    launched = ck.LAUNCHES["kernel_matrix"] - before
    structures = list(eng.spec.node_structs) + list(eng.spec.weight_structs)
    from gpyrn_tpu_torch.models.gprn import unpack_parameters
    node_p, weight_p, _, _ = unpack_parameters(eng.spec, theta32)
    worst = 0.0
    for K, s, q in zip(torch.cat([Kf, Kw]), structures, node_p + weight_p):
        R = ck.kernel_matrix_ref(s, q, t32, lin.TRAIN_NUGGET, 0.0)
        k0 = float(R[0, 0])
        err = (K - R).abs()
        if not bool((err <= 1e-6 * k0 + 2e-6 * R.abs()).all()) or \
                not torch.equal(K, K.T):
            raise AssertionError(f"B1 float32 multiplier 0 N={N} {s}: max "
                                 f"abs err {float(err.max()):.3e}")
        if float((torch.diagonal(K) - torch.diagonal(R)).abs().max()) != 0:
            raise AssertionError(f"B1 float32 multiplier 0 N={N} {s}: the "
                                 f"diagonal differs from the plain "
                                 f"version's k(0) + nugget")
        worst = max(worst, float(err.max()) / k0)
        del R, err
    del Kf, Kw
    print(f"wide: B1 float32 with multiplier 0 at N={N}: {launched} "
          f"launches for {n_k} matrices agree with the plain version, "
          f"worst max-abs-err / k(0) = {worst:.3e} (rtol 2e-6, atol "
          f"1e-6·k(0)), diagonals equal", flush=True)
    if launched != n_k:
        raise AssertionError(f"wide: {launched} launches for {n_k} matrices")

    torch.cuda.reset_peak_memory_stats()
    before = ck.LAUNCHES["kernel_matrix"]
    (elbo, mu, var, n_iter), wall = _timed(
        torch, lambda: g.ELBOcalc(precision='mixed'))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    info = dict(g.mixed_info)
    n_bulk, dt_bulk, n_polish, dt_polish = _mixed_stages(torch, g)
    # one further float64 sweep from the returned state
    data = g._data()
    e_next, mu_next, _ = eng.sweep_once(theta, *data, mu, var)
    e_next = float(e_next)
    move = _rel_state_err(mu_next.cpu().numpy(), mu.cpu().numpy())
    # factors of the float32 prior lattice with the scaled jitter, and of
    # the float64 one
    bad = {}
    for name, dtype in (("float32", torch.float32), ("float64", None)):
        args = (theta, g._tensor(g.time), data[1], data[2])
        if dtype is not None:
            args = tuple(a.to(dtype) for a in args)
        L_all = eng._prepare(*args)[2]
        bad[name] = int((~torch.isfinite(L_all).flatten(1).all(1)).sum())
        del L_all
    g64 = headline_problem(pkg, N=N, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    (e64, _, _, it64), wall64 = _timed(torch, g64.ELBOcalc)
    peak64 = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"wide: N={N} mixed ELBOcalc {elbo!r} in {n_iter} sweeps, wall "
          f"{wall:.3f} s, peak device memory {peak:.3f} GiB, B1 launches "
          f"{launched}; float32 bulk {info}; stages timed apart: bulk "
          f"{n_bulk} sweeps {dt_bulk:.3f} s "
          f"({1e3 * dt_bulk / max(n_bulk, 1):.3f} ms/sweep), polish "
          f"{n_polish} float64 sweeps {dt_polish:.3f} s "
          f"({1e3 * dt_polish / n_polish:.3f} ms/sweep); one further "
          f"float64 sweep: ELBO {e_next!r}, max|Δμ|/(1+max|μ|) {move:.3e}; "
          f"non-finite prior factors {bad}; float64 reference-rule "
          f"ELBOcalc {e64!r} in {it64} sweeps, {wall64:.3f} s "
          f"({1e3 * wall64 / it64:.3f} ms/sweep), peak {peak64:.3f} GiB",
          flush=True)
    _check("wide", [
        ("finite", np.isfinite(elbo) and bool(torch.isfinite(mu).all())
         and bool((var > 0).all()), f"{tuple(mu.shape)}"),
        ("B1 launches (float32 with multiplier 4 and 0, float64)",
         launched == 3 * n_k, f"{launched} vs {3 * n_k}"),
        ("the stall rule fired before max_iter",
         info["stalled"] and info["bulk_sweeps"] < 10000,
         f"{info['bulk_sweeps']} sweeps"),
        ("non-finite float32 merits", info["nonfinite_merits"] == 0,
         f"{info['nonfinite_merits']} of {info['blocks']}"),
        ("non-finite prior factors", not any(bad.values()), f"{bad}"),
        ("one further float64 sweep",
         _rel(e_next, elbo) <= WIDE_NEXT_SWEEP_RTOL,
         f"rel {_rel(e_next, elbo):.3e} (limit {WIDE_NEXT_SWEEP_RTOL})"),
        ("not below the float64 reference-rule fit",
         elbo >= e64 - WIDE_BELOW_F64_RTOL * abs(e64),
         f"{elbo!r} vs {e64!r} (allowance {WIDE_BELOW_F64_RTOL} relative)"),
    ])


def phase_implicit(torch, pkg, oracle, ck):
    """``elbo_grad(method='implicit')`` of the headline model on the card
    against the cached JAX value and gradient and against the unrolled
    gradient started at the fixed point."""
    ref = oracle["implicit"]
    n_k = 4
    settings = {k: ref[k] for k in IMPLICIT}
    g = headline_problem(pkg, device="cuda")
    g.elbo_grad(method='implicit', fit_max_iter=2, adjoint_maxiter=1,
                adjoint_restart=2)                        # warm-up
    g._mu = g._var = None
    torch.cuda.reset_peak_memory_stats()
    before = dict(ck.LAUNCHES)
    (value, grad), wall = _timed(
        torch, lambda: g.elbo_grad(method='implicit', **settings))
    launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    info = dict(g.implicit_info)
    # the gradient alone, from the cached state
    (v_warm, g_warm), wall_warm = _timed(
        torch, lambda: g.elbo_grad(method='implicit',
                                   fit_tol=IMPLICIT_WARM_FIT_TOL))
    info_warm = dict(g.implicit_info)
    # the unrolled gradient started at the fixed point
    n_sweeps = GRAD_SWEEPS["headline"]
    g.elbo_grad(n_sweeps=2)
    torch.cuda.reset_peak_memory_stats()
    (v_un, g_un), wall_un = _timed(
        torch, lambda: g.elbo_grad(n_sweeps=n_sweeps))
    peak_un = torch.cuda.max_memory_allocated() / 2 ** 30
    g_err = _grad_error(grad, ref["grad"])
    print(f"implicit: elbo_grad(method='implicit', {settings}) on the card "
          f"{value!r} vs jax {ref['value']!r}; fit {info['fit_sweeps']} "
          f"sweeps (converged {info['fit_converged']}), "
          f"{info['pullbacks']} pull-backs, adjoint residual "
          f"{info['adjoint_residual']:.3e} (jax "
          f"{ref['adjoint_residual']:.3e}), state residual "
          f"{info['state_residual']:.3e} (jax {ref['state_residual']:.3e}); "
          f"wall {wall:.3f} s, peak device memory {peak:.3f} GiB, launches "
          f"{launched}; again from the cached state with fit_tol "
          f"{IMPLICIT_WARM_FIT_TOL}: {wall_warm:.3f} s, fit "
          f"{info_warm['fit_sweeps']} sweeps, {info_warm['pullbacks']} "
          f"pull-backs; unrolled {n_sweeps} sweeps from the fixed point: "
          f"{v_un!r}, {wall_un:.3f} s, peak {peak_un:.3f} GiB", flush=True)
    _check("implicit", [
        ("value vs jax", _rel(value, ref["value"]) <= IMPLICIT_VALUE_RTOL,
         f"rel {_rel(value, ref['value']):.3e} (limit "
         f"{IMPLICIT_VALUE_RTOL})"),
        ("gradient vs jax", np.all(np.isfinite(grad))
         and g_err <= IMPLICIT_GRAD_TOL,
         f"max|Δg|/max|g| {g_err:.3e} (limit {IMPLICIT_GRAD_TOL})"),
        ("adjoint residual",
         info["adjoint_residual"] <= IMPLICIT_ADJOINT_TOL,
         f"{info['adjoint_residual']:.3e} (limit {IMPLICIT_ADJOINT_TOL})"),
        ("B1 launches (fit_state and the linearised sweep)",
         launched["kernel_matrix"] == 2 * n_k,
         f"{launched['kernel_matrix']} vs {2 * n_k}"),
        ("B1' launches (2 pull-backs to theta x 4 matrices)",
         launched["kernel_matrix_grad"] == 2 * n_k,
         f"{launched['kernel_matrix_grad']} vs {2 * n_k} in "
         f"{info['pullbacks']} pull-backs"),
        ("warm call agrees", _grad_error(g_warm, grad) <= IMPLICIT_GRAD_TOL
         and _rel(v_warm, value) <= GRAD_VALUE_RTOL,
         f"max|Δg|/max|g| {_grad_error(g_warm, grad):.3e}"),
        ("value vs unrolled from the fixed point",
         _rel(v_un, value) <= GRAD_VALUE_RTOL,
         f"rel {_rel(v_un, value):.3e} (limit {GRAD_VALUE_RTOL})"),
        ("gradient vs unrolled from the fixed point",
         _grad_error(g_un, grad) <= IMPLICIT_UNROLL_TOL,
         f"max|Δg|/max|g| {_grad_error(g_un, grad):.3e} (limit "
         f"{IMPLICIT_UNROLL_TOL})"),
        ("memory under the unrolled call's", peak < peak_un,
         f"{peak:.3f} vs {peak_un:.3f} GiB"),
    ])


def phase_implicit_trainer(torch, pkg, oracle):
    """Three ``optimize_adam(grad='implicit')`` steps of the headline model
    on the card against the JAX package's (optax) result."""
    ref = oracle["adam_implicit"]
    g = headline_problem(pkg, device="cuda")
    settings = {k: ref[k] for k in ADAM_IMPLICIT}
    res, dt = _timed(torch, lambda: g.optimize_adam(
        n_steps=ref["n_steps"], grad='implicit', **settings))
    x_err = float(np.max(np.abs(res["x"] - np.asarray(ref["x"]))
                         / np.abs(np.asarray(ref["x"]))))
    print(f"implicit trainer: optimize_adam({ref['n_steps']} steps, "
          f"grad='implicit', {settings}) on the card in {dt:.3f} s",
          flush=True)
    _check("implicit trainer", [
        ("x vs jax", x_err <= ADAM_IMPLICIT_X_RTOL,
         f"max rel err {x_err:.3e} (limit {ADAM_IMPLICIT_X_RTOL})"),
        ("best loss vs jax", _rel(res["fun"], ref["fun"]) <= GRAD_VALUE_RTOL,
         f"{res['fun']!r} vs {ref['fun']!r} rel "
         f"{_rel(res['fun'], ref['fun']):.3e} (limit {GRAD_VALUE_RTOL})"),
        ("refit ELBO at the optimum", np.isfinite(res["elbo"]),
         f"{res['elbo']!r} vs jax {ref['elbo']!r} rel "
         f"{_rel(res['elbo'], ref['elbo']):.3e}"),
    ])


def phase_flagship_state(torch, pkg, ck):
    """The flagship model (q=2): a fixed count of ``fit_state`` sweeps and
    one implicit call from that state, card against CPU (a converged q=2
    comparison can land in another permutation basin)."""
    from gpyrn_tpu_torch.models.implicit import implicit_value_and_grad_for
    out = {}
    for device in ("cuda", "cpu"):
        g = flagship_problem(pkg, device=device)
        eng, theta, data = g.engine, g._theta(), g._data()
        mu0, var0 = eng.init_mu_var(theta, data[1])
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        mu, var, n_iter, conv = eng.fit_state(theta, *data, mu0, var0,
                                              FLAGSHIP_STATE_SWEEPS, 0.0)
        res = implicit_value_and_grad_for(eng)(theta, *data, mu, var,
                                               **FLAGSHIP_ADJOINT)
        grad = res.grad.cpu().numpy()
        dt = time.perf_counter() - t0
        launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
        out[device] = (mu.cpu().numpy(), var.cpu().numpy(), n_iter, conv,
                       float(res.elbo), grad, res.pullbacks,
                       float(res.adjoint_residual), dt, launched)
    (mu, var, it, conv, e, grad, pulls, adj, dt, launched) = out["cuda"]
    (mu_c, var_c, it_c, _, e_c, grad_c, pulls_c, adj_c, dt_c, _) = out["cpu"]
    n_k = 8
    print(f"flagship: fit_state({FLAGSHIP_STATE_SWEEPS} sweeps, tol 0) and "
          f"one implicit call ({FLAGSHIP_ADJOINT}) on the card {e!r} in "
          f"{dt:.3f} s, cpu {e_c!r} in {dt_c:.3f} s; {pulls} pull-backs, "
          f"adjoint residual {adj:.3e} (cpu {adj_c:.3e}: the solve is cut "
          f"and the state is not a fixed point); launches {launched}",
          flush=True)
    _check("flagship", [
        ("sweeps", (it, conv, it_c) == (FLAGSHIP_STATE_SWEEPS, False,
                                        FLAGSHIP_STATE_SWEEPS), f"{it}"),
        ("mu card vs cpu", _rel_state_err(mu, mu_c) <= STATE_TOL,
         f"{_rel_state_err(mu, mu_c):.3e} (limit {STATE_TOL})"),
        ("var card vs cpu", _rel_state_err(var, var_c) <= STATE_TOL,
         f"{_rel_state_err(var, var_c):.3e} (limit {STATE_TOL})"),
        ("ELBO card vs cpu", _rel(e, e_c) <= ELBO_RTOL,
         f"rel {_rel(e, e_c):.3e} (limit {ELBO_RTOL})"),
        ("pull-backs card vs cpu", pulls == pulls_c, f"{pulls} vs {pulls_c}"),
        ("gradient card vs cpu", _grad_error(grad, grad_c) <= GRAD_TOL,
         f"max|Δg|/max|g| {_grad_error(grad, grad_c):.3e} (limit "
         f"{GRAD_TOL})"),
        ("launches", launched == {"kernel_matrix": 2 * n_k,
                                  "kernel_matrix_grad": 2 * n_k},
         f"{launched}, expected {2 * n_k} of each"),
    ])


def _batch_inputs(g, cfg):
    """The θ rows of ``cfg`` around ``g``'s parameters, and their heuristic
    starting states, as tensors on ``g``'s device."""
    thetas = g._tensor(batch_thetas(g.get_parameters(include_frozen=True),
                                    cfg["rows"], cfg["spread"], cfg["seed"]))
    return (thetas, *g.engine.init_mu_var(thetas, g._tensor(g.y)))


def phase_batch(torch, pkg, oracle, ck):
    """``elbo_fit_batch`` of the 13 rows of ``BATCH`` on the card, against
    the port's single-θ fit of each row on the card and the JAX package's
    cached ``vmap(elbo_fit)``; walker-fits per second against 13 sequential
    fits, peak memory."""
    ref = oracle["batch"]
    rows, max_iter = BATCH["rows"], BATCH["max_iter"]
    g = headline_problem(pkg, device="cuda")
    eng, data = g.engine, g._data()
    thetas, mu0, var0 = _batch_inputs(g, BATCH)
    eng.elbo_fit_batch(thetas, *data, mu0, var0, 4)              # warm-up
    torch.cuda.reset_peak_memory_stats()
    before = ck.LAUNCHES["kernel_matrix"]
    (elbo, mu, var, n_iter, conv), wall = _timed(
        torch, lambda: eng.elbo_fit_batch(thetas, *data, mu0, var0,
                                          max_iter))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted = dict(ck.LAUNCHES)
    singles, wall_seq = _timed(torch, lambda: [
        eng.elbo_fit(thetas[w], *data, mu0[w], var0[w], max_iter)
        for w in range(rows)])
    # the sequential fits are the comparison, not the batched path
    ck.LAUNCHES.update(counted)
    elbo, mu, var = (a.cpu().numpy() for a in (elbo, mu, var))
    n_iter, conv = n_iter.cpu().tolist(), conv.cpu().tolist()
    e1 = np.array([float(s[0]) for s in singles])
    it1 = [s[3] for s in singles]
    mu_err = max(_rel_state_err(mu[w], singles[w][1].cpu().numpy())
                 for w in range(rows))
    var_err = max(_rel_state_err(var[w], singles[w][2].cpu().numpy())
                  for w in range(rows))
    e_single = float(np.max(np.abs(elbo - e1) / np.abs(e1)))
    e_jax = float(np.max(np.abs(elbo - ref["elbo"]) /
                         np.abs(ref["elbo"])))
    jax_state = max(
        _rel_state_err(state_summary(mu[w], var[w], ref["stride"])[key],
                       ref[key][w])
        for w in range(rows) for key in ("mu", "var"))
    sweeps = max(n_iter)
    print(f"batch: elbo_fit_batch of {rows} rows, N={N_MAIN}: {wall:.3f} s, "
          f"{sweeps} batched sweeps ({1e3 * wall / sweeps:.3f} ms each; rows "
          f"stop at {n_iter}), peak device memory {peak:.3f} GiB, B1 "
          f"launches {launched}; {rows} sequential elbo_fit calls "
          f"{wall_seq:.3f} s ({sum(it1)} sweeps, "
          f"{1e3 * wall_seq / sum(it1):.3f} ms each): walker-fits per second "
          f"{rows / wall:.3f} batched against {rows / wall_seq:.3f} "
          f"sequential ({wall_seq / wall:.3f}x)", flush=True)
    _check("batch", [
        ("n_iter per row, batch vs single", n_iter == it1,
         f"{n_iter} vs {it1}"),
        ("ELBO batch vs single", e_single <= ELBO_RTOL,
         f"max rel {e_single:.3e} (limit {ELBO_RTOL})"),
        ("state batch vs single", max(mu_err, var_err) <= STATE_TOL,
         f"mu {mu_err:.3e}, var {var_err:.3e} (limit {STATE_TOL})"),
        ("n_iter and converged vs jax",
         n_iter == ref["n_iter"] and conv == ref["converged"],
         f"{n_iter} vs {ref['n_iter']}"),
        ("ELBO vs jax", e_jax <= ELBO_RTOL,
         f"max rel {e_jax:.3e} (limit {ELBO_RTOL})"),
        ("state vs jax", jax_state <= STATE_TOL,
         f"{jax_state:.3e} (limit {STATE_TOL})"),
        ("B1 launches (one per matrix of every row)", launched == 4 * rows,
         f"{launched} vs {4 * rows}"),
    ])


def _x_rel(x, ref):
    ref = np.asarray(ref, dtype=float)
    return float(np.max(np.abs(np.asarray(x) - ref) / np.abs(ref)))


def phase_optimize_device(torch, pkg, oracle, ck):
    """``optimize_device`` of the headline model on the card: ``OPT``
    alone, and with ``OPT_RESTARTS`` restarts (the cut call against the
    cached JAX result, the full one timed)."""
    ref = oracle["optimize_device"]
    n_free = 13
    out = {}
    for name, kw in (
            ("single", OPT),
            ("restarts, cut", {**OPT, "max_iter": OPT_RESTART_ORACLE_ITERS,
                               "n_restarts": OPT_RESTARTS}),
            ("restarts", {**OPT, "n_restarts": OPT_RESTARTS})):
        g = headline_problem(pkg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        before = ck.LAUNCHES["kernel_matrix"]
        res, wall = _timed(torch, lambda: g.optimize_device(**kw))
        launched = ck.LAUNCHES["kernel_matrix"] - before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = (res, wall, launched)
        print(f"optimize_device {name} {kw}: {wall:.3f} s, nit "
              f"{res['nit']}, nfev {res['nfev']}, success {res['success']}, "
              f"fun {res['fun']!r}, ELBO at the optimum {res['elbo']!r}; "
              f"{res['nit'] / wall:.3f} iterations per second (the final "
              f"ELBOcalc included), peak device memory {peak:.3f} GiB, B1 "
              f"launches {launched}", flush=True)
    checks = []
    for name, key in (("single", "single"), ("restarts, cut", "restarts")):
        res, r = out[name][0], ref[key]
        checks += [
            (f"{name}: x vs jax", _x_rel(res["x"], r["x"]) <= ADAM_X_RTOL,
             f"max rel {_x_rel(res['x'], r['x']):.3e} (limit "
             f"{ADAM_X_RTOL})"),
            (f"{name}: nit, nfev, success vs jax",
             (res["nit"], res["nfev"], res["success"]) ==
             (r["nit"], r["nfev"], r["success"]),
             f"{res['nit']}, {res['nfev']} vs {r['nit']}, {r['nfev']}"),
            (f"{name}: fun vs jax", _rel(res["fun"], r["fun"]) <= ELBO_RTOL,
             f"rel {_rel(res['fun'], r['fun']):.3e}")]
    res, _, launched = out["single"]
    # 14 vertices, then 17 candidates per iteration, 4 matrices each, and
    # the final fit's 4
    expect = 4 * ((n_free + 1) + (n_free + 4) * (res["nit"] - 1)) + 4
    checks.append(("single: B1 launches", launched == expect,
                   f"{launched} vs {expect}"))
    res = out["restarts"][0]
    checks.append(("restarts: finite", np.isfinite(res["fun"])
                   and np.all(np.isfinite(res["x"])), f"{res['fun']!r}"))
    _check("optimize_device", checks)


def phase_mcmc(torch, pkg, oracle, ck):
    """``mcmc`` of the headline model on the card, 26 walkers: the host
    loop with scipy priors against the cached JAX host-loop chain (the
    cut run in full, the first steps of the full run), and the device
    chain with the port's priors."""
    from scipy import stats

    from gpyrn_tpu_torch.inference import priors as port_priors
    ref = oracle["mcmc"]
    k = ref["niter"]
    runs = {}
    for name, niter, scipy_priors in (("host loop, cut", k, True),
                                      ("host loop", MCMC["niter"], True),
                                      ("device chain", MCMC["niter"], False)):
        g = headline_problem(pkg, device="cuda")
        priors = headline_priors(
            g, (lambda m, s: stats.lognorm(s=s, scale=np.exp(m)))
            if scipy_priors else port_priors.LogNormal)
        torch.cuda.reset_peak_memory_stats()
        before = ck.LAUNCHES["kernel_matrix"]
        res, wall = _timed(torch, lambda: g.mcmc(
            priors, p0=g.get_parameters(), **{**MCMC, "niter": niter}))
        launched = ck.LAUNCHES["kernel_matrix"] - before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = res
        print(f"mcmc {name}: {res.chain.shape[0]} steps of "
              f"{res.chain.shape[1]} walkers in {wall:.3f} s "
              f"({res.chain.shape[0] / wall:.3f} ensemble steps per second, "
              f"the initial fit of every walker included), acceptance "
              f"{res.acceptance:.4f}, max log-prob "
              f"{float(np.max(res.log_prob)):.4f}, peak device memory "
              f"{peak:.3f} GiB, B1 launches {launched}", flush=True)
    cut, full, dev = (runs[n] for n in ("host loop, cut", "host loop",
                                        "device chain"))
    chain_ref = np.asarray(ref["chain"])
    lp_ref = np.asarray(ref["log_prob"])
    chain_err = _rel_state_err(cut.chain, chain_ref)
    lp_err = float(np.max(np.abs(cut.log_prob - lp_ref) / np.abs(lp_ref)))
    _check("mcmc", [
        ("host loop chain vs jax", chain_err <= STATE_TOL,
         f"{chain_err:.3e} (limit {STATE_TOL})"),
        ("host loop log-prob vs jax", lp_err <= ELBO_RTOL,
         f"max rel {lp_err:.3e} (limit {ELBO_RTOL})"),
        ("host loop acceptance vs jax", cut.acceptance == ref["acceptance"],
         f"{cut.acceptance!r} vs {ref['acceptance']!r}"),
        ("the full run's first steps are the cut run's",
         np.array_equal(full.chain[:k], cut.chain)
         and np.array_equal(full.log_prob[:k], cut.log_prob),
         f"{k} steps"),
        ("device chain: finite log-probs",
         bool(np.all(np.isfinite(dev.log_prob))), f"{dev.log_prob.shape}"),
        ("device chain: acceptance in (0, 1)", 0 < dev.acceptance < 1,
         f"{dev.acceptance:.4f}"),
    ])


def phase_batch_elbo(torch, pkg, oracle):
    """``evidence.batch_elbo`` over the 8 rows of ``EVIDENCE`` on the card
    against the cached JAX values."""
    from gpyrn_tpu_torch.inference.evidence import batch_elbo
    ref = oracle["batch_elbo"]
    g = headline_problem(pkg, device="cuda")
    thetas = batch_thetas(g.get_parameters(include_frozen=True),
                          EVIDENCE["rows"], EVIDENCE["spread"],
                          EVIDENCE["seed"])
    elbo, wall = _timed(torch, lambda: batch_elbo(g, thetas,
                                                  EVIDENCE["max_iter"]))
    err = float(np.max(np.abs(elbo - ref["elbo"]) / np.abs(ref["elbo"])))
    print(f"batch_elbo: {EVIDENCE['rows']} rows in {wall:.3f} s", flush=True)
    _check("batch_elbo", [
        ("ELBO vs jax", err <= ELBO_RTOL,
         f"max rel {err:.3e} (limit {ELBO_RTOL})")])


def trace_batched_sweep(torch, pkg):
    """One traced sweep of the 13-row batch and one of its first row alone
    (headline model, N=1000, float64, the state from the heuristic start):
    wall, device time, launches, idle share."""
    g = headline_problem(pkg, device="cuda")
    eng, data = g.engine, g._data()
    thetas, mu0, var0 = _batch_inputs(g, BATCH)
    for what, th, mu, var in (
            (f"batched sweep ({BATCH['rows']} rows)", thetas, mu0, var0),
            ("single-row sweep", thetas[0], mu0[0], var0[0])):
        prepared = eng._prepare(th, *data)
        (muF, muW), (varF, varW) = eng._u_split(mu), eng._u_split(var)

        def sweep():
            return eng._sweep(*prepared, muF, varF, muW, varW)

        sweep()
        wall, kernels = _traced(torch, sweep)
        _trace_summary(what, wall, kernels, {})
    # a 68-row objective call of optimize_device with 4 restarts (the
    # population's candidates of one iteration, 3 sweeps): the host's and
    # the card's ms of its _prepare against those of the whole call
    W = OPT_RESTARTS * 17
    th = g._tensor(batch_thetas(g.get_parameters(include_frozen=True), W,
                                BATCH["spread"], BATCH["seed"]))
    mu, var = eng.init_mu_var(th, g._tensor(g.y))
    prep = _host_ms(torch, lambda: eng._prepare(th, *data), 20)
    call = _host_ms(torch, lambda: eng.elbo_fixed_batch(
        th, *data, mu, var, OPT["n_sweeps"]), 20)
    print(f"objective call of {W} rows ({OPT['n_sweeps']} sweeps, N={N_MAIN}, "
          f"float64), ms per call enqueued (until the card is done): "
          f"_prepare {prep[0]:.4f} ({prep[1]:.4f}), the whole call "
          f"{call[0]:.4f} ({call[1]:.4f}); _prepare's share "
          f"{prep[1] / call[1]:.4f}", flush=True)


def trace_grad_path(torch, pkg):
    """One traced float64 30-sweep ``elbo_value_and_grad`` of the headline
    model (after a warm-up call): device time, idle share, the shares of
    B1 and B1′, and the leading kernels."""
    g = headline_problem(pkg, device="cuda")
    eng = g.engine
    theta = g._theta()
    data = g._data()
    mu0, var0 = eng.init_mu_var(theta, data[1])
    n_k = g.q + g.q * g.p

    def call():
        return eng.elbo_value_and_grad(theta, *data, mu0, var0,
                                       GRAD_SWEEPS["headline"])

    call()
    wall, kernels = _traced(torch, call)
    busy = sum(ms for _, ms in kernels)

    def part(key):
        mine = [ms for k, ms in kernels if key in k]
        return sum(mine), len(mine)

    (b1, n_b1), (b1g, n_b1g) = part("kernel_matrix_kernel"), \
        part("kernel_matrix_grad")
    # each B1 launch is one kernel, each B1′ launch two
    print(f"headline: traced float64 elbo_value_and_grad: wall {wall:.3f} "
          f"ms, device kernels {busy:.3f} ms in {len(kernels)} launches "
          f"(idle share {1 - busy / wall:.3f}); kernel_matrix {b1:.4f} ms "
          f"({b1 / busy:.5f} of device time), kernel_matrix_grad "
          f"{b1g:.4f} ms ({b1g / busy:.5f}); the trace holds {n_b1} of "
          f"{n_k} B1 and {n_b1g} of {2 * n_k} B1' kernels", flush=True)
    by_name = {}
    for k, ms in kernels:
        by_name[k] = by_name.get(k, 0.0) + ms
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"headline:   {v:9.3f} ms  {v / busy:.3f}  {k[:90]}",
              flush=True)


def _trace_summary(what, wall, kernels, expect):
    """One line on a traced call: wall, device time, launches, idle share
    and the kernels of this repo it holds (``expect``: kernel-name part →
    the count the trace should hold)."""
    busy = sum(ms for _, ms in kernels)
    parts = []
    for key, n in expect.items():
        mine = [ms for k, ms in kernels if key in k]
        parts.append(f"{key} {sum(mine):.4f} ms ({sum(mine) / busy:.5f} of "
                     f"device time, {len(mine)} of {n} kernels)")
    print(f"headline: traced {what}: wall {wall:.3f} ms, device kernels "
          f"{busy:.3f} ms in {len(kernels)} launches (idle share "
          f"{1 - busy / wall:.3f}); {'; '.join(parts)}", flush=True)
    by_name = {}
    for k, ms in kernels:
        by_name[k] = by_name.get(k, 0.0) + ms
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"headline:   {v:9.3f} ms  {v / busy:.3f}  {k[:90]}",
              flush=True)


def trace_state_paths(torch, pkg):
    """A traced block of the float32 stall fit (8 sweeps, the last with
    the merit) and a traced implicit call at the converged state, headline
    model, N=1000."""
    from gpyrn_tpu_torch.models.implicit import implicit_value_and_grad_for
    g = headline_problem(pkg, device="cuda")
    eng, theta, data = g.engine, g._theta(), g._data()
    mu0, var0 = eng.init_mu_var(theta, data[1])
    args32 = tuple(a.float() for a in (theta, *data, mu0, var0))

    def block():
        return eng.fit_state_stall(*args32, g.stall_block, 0.0,
                                   g.stall_block, 0.0, 10)

    block()
    wall, kernels = _traced(torch, block)
    _trace_summary(f"float32 stall block ({g.stall_block} sweeps, both "
                   f"lattices built)", wall, kernels,
                   {"kernel_matrix_kernel": 8})

    mu, var, n_fit, conv = eng.fit_state(theta, *data, mu0, var0,
                                         IMPLICIT["fit_max_iter"],
                                         IMPLICIT_WARM_FIT_TOL)
    ivag = implicit_value_and_grad_for(eng)

    def implicit():
        return ivag(theta, *data, mu, var)

    res = implicit()
    wall, kernels = _traced(torch, implicit)
    _trace_summary(f"implicit call at the fixed point ({n_fit} fit sweeps "
                   f"before it, converged {conv}; {res.pullbacks} "
                   f"pull-backs)", wall, kernels,
                   {"kernel_matrix_kernel": 4, "kernel_matrix_grad": 16})


def profile_main(torch, pkg, ck, lin):
    """Everything timed by torch.profiler, run in a fresh process: the
    traced gradient call, the traced stall block and implicit call, then
    B1's and B1′'s times.  Its last line is the JSON of the two kernels'
    records."""
    trace_grad_path(torch, pkg)
    trace_state_paths(torch, pkg)
    records = {"kernel_matrix": time_kernel(torch, ck, lin),
               "kernel_matrix_grad": time_grad_kernel(torch, ck)}
    print(json.dumps({"records": records}), flush=True)


def phase_trainer(torch, pkg, oracle):
    """``optimize_adam`` of the headline model on the card against the JAX
    package's (optax) result for the same steps."""
    ref = oracle["adam"]
    g = headline_problem(pkg, device="cuda")
    t0 = time.perf_counter()
    res = g.optimize_adam(n_steps=ADAM_STEPS, n_sweeps=GRAD_SWEEPS["headline"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    x_err = float(np.max(np.abs(res["x"] - np.asarray(ref["x"]))
                         / np.abs(np.asarray(ref["x"]))))
    f_rel = abs(res["fun"] - ref["fun"]) / abs(ref["fun"])
    e_rel = abs(res["elbo"] - ref["elbo"]) / abs(ref["elbo"])
    ok = (x_err <= ADAM_X_RTOL and f_rel <= GRAD_VALUE_RTOL
          and np.isfinite(res["elbo"]))
    print(f"trainer: optimize_adam({ADAM_STEPS} steps, "
          f"{GRAD_SWEEPS['headline']} sweeps) on the card in {dt:.3f} s: "
          f"x max rel err {x_err:.3e} (limit {ADAM_X_RTOL}), best loss "
          f"{res['fun']!r} vs jax {ref['fun']!r} rel {f_rel:.3e} (limit "
          f"{GRAD_VALUE_RTOL}); converged ELBO at the optimum "
          f"{res['elbo']!r} vs jax {ref['elbo']!r} rel {e_rel:.3e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("trainer: optimize_adam disagrees with jax")


def _child(arg):
    """The output lines of this script run with ``arg`` in a fresh
    process; its failure fails the run."""
    child = subprocess.run([sys.executable, os.path.abspath(__file__), arg],
                           capture_output=True, text=True)
    sys.stderr.write(child.stderr)
    if child.returncode != 0:
        sys.stdout.write(child.stdout)
        raise AssertionError(f"the profiling process ({arg}) failed with "
                             f"exit code {child.returncode}")
    return child.stdout.strip().splitlines()


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import gpyrn_tpu_torch as pkg
    from gpyrn_tpu_torch.ops import _build
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    from gpyrn_tpu_torch.ops import linalg as lin
    if sys.argv[1:] == [PROFILE_ARG]:
        profile_main(torch, pkg, ck, lin)
        return
    if sys.argv[1:] == [PROFILE_BATCH_ARG]:
        trace_batched_sweep(torch, pkg)
        return

    print("== phase 1: environment", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device count "
          f"{torch.cuda.device_count()}", flush=True)
    print(_run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {smi}", flush=True)

    print("== phase 2: build", flush=True)
    phase_build(_build, ck)

    with open(ORACLE) as f:
        oracle = json.load(f)
    # the gradient path and the trainer: every launch from here to their
    # end is the port's own
    ck.reset_launch_counts()
    for i, name in enumerate(("headline", "flagship"), start=3):
        print(f"== phase {i}: gradient path, {name} model", flush=True)
        phase_grad_path(torch, pkg, name, oracle, ck)
    print("== phase 5: trainer, headline model", flush=True)
    phase_trainer(torch, pkg, oracle)
    grad_launches = dict(ck.LAUNCHES)
    print(f"gradient path launches: {grad_launches}", flush=True)
    if min(grad_launches.values()) == 0:
        raise AssertionError("the gradient path never launched "
                             f"one of its kernels: {grad_launches}")

    # the fit path
    ck.reset_launch_counts()
    for i, name in enumerate(("headline", "flagship"), start=6):
        print(f"== phase {i}: fit path, {name} model", flush=True)
        phase_main(torch, pkg, name, oracle[name], ck)
    fit_launches = dict(ck.LAUNCHES)
    print(f"fit path launches: {fit_launches}", flush=True)
    if fit_launches["kernel_matrix"] == 0:
        raise AssertionError("the fit path never launched kernel_matrix")

    print("== phase 8: B1 kernel vs plain version on the card", flush=True)
    phase_kernels(torch, ck, lin)
    print("== phase 9: B1' (backward) vs plain version on the card",
          flush=True)
    phase_grad_kernel(torch, ck)

    print("== phase 10: the stacked kernel matrices vs the plain version",
          flush=True)
    phase_stack(torch, ck, lin)
    host_cost_stack(torch, lin)

    # the mixed fit: the float32 bulk on the exact-nugget lattice
    ck.reset_launch_counts()
    print("== phase 11: mixed-precision fit, headline model, N=1000",
          flush=True)
    phase_mixed(torch, pkg, oracle, ck)
    print(f"== phase 12: mixed-precision fit at full width, headline "
          f"model, N={N_WIDE}", flush=True)
    phase_mixed_wide(torch, pkg, ck, lin)
    mixed_launches = dict(ck.LAUNCHES)
    print(f"mixed path launches: {mixed_launches}", flush=True)
    if mixed_launches["kernel_matrix"] == 0:
        raise AssertionError("the mixed path never launched kernel_matrix")

    # the implicit gradient of the converged ELBO
    ck.reset_launch_counts()
    print("== phase 13: implicit gradient, headline model", flush=True)
    phase_implicit(torch, pkg, oracle, ck)
    print("== phase 14: implicit trainer, headline model", flush=True)
    phase_implicit_trainer(torch, pkg, oracle)
    print("== phase 15: converged-state paths, flagship model", flush=True)
    phase_flagship_state(torch, pkg, ck)
    implicit_launches = dict(ck.LAUNCHES)
    print(f"implicit path launches: {implicit_launches}", flush=True)
    if min(implicit_launches.values()) == 0:
        raise AssertionError("the implicit path never launched one of its "
                             f"kernels: {implicit_launches}")

    print("== phase 16: traced calls and the kernels' times, in fresh "
          "processes", flush=True)
    lines = _child(PROFILE_ARG)
    print("\n".join(lines[:-1]), flush=True)
    records = json.loads(lines[-1])["records"]
    print("\n".join(_child(PROFILE_BATCH_ARG)), flush=True)
    record, grad_record = records["kernel_matrix"], \
        records["kernel_matrix_grad"]

    # the batched paths: the θ-batched fit, Nelder-Mead on the device, the
    # ensemble sampler and the evidence batch
    ck.reset_launch_counts()
    print("== phase 17: batched fit, headline model, 13 rows", flush=True)
    phase_batch(torch, pkg, oracle, ck)
    print("== phase 18: optimize_device, headline model", flush=True)
    phase_optimize_device(torch, pkg, oracle, ck)
    print("== phase 19: mcmc (ensemble sampler), headline model, 26 "
          "walkers", flush=True)
    phase_mcmc(torch, pkg, oracle, ck)
    print("== phase 20: evidence.batch_elbo, headline model", flush=True)
    phase_batch_elbo(torch, pkg, oracle)
    batch_launches = dict(ck.LAUNCHES)
    print(f"batched path launches: {batch_launches}", flush=True)
    if batch_launches["kernel_matrix"] == 0:
        raise AssertionError("the batched path never launched "
                             "kernel_matrix")

    kernels = []
    for kname, rec in (("kernel_matrix", record),
                       ("kernel_matrix_grad", grad_record)):
        by_path = {"fit": fit_launches[kname], "grad": grad_launches[kname],
                   "mixed": mixed_launches[kname],
                   "implicit": implicit_launches[kname],
                   "batch": batch_launches[kname]}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "gpyrn_tpu_torch/csrc/kernel_matrix.cu",
            "replaces": "gpyrn_tpu/ops/pallas_kernels.py:122",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
