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
   operation counts in the SASS; the same for the QP instances of B1's
   slab and product entries, and the FP-pipe instructions per element of
   the QP instances (``pipe_per_element``), which every kernel's FP-pipe
   bound below is counted from; the resources of the product entry's
   tiled instances of the models' leaves, the spills of all its
   instances (one that a path launches fails the run after the paths),
   and its register path's SASS issue count: every instruction of the
   inner loop per element (``issue_per_element``);
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
    of its rows alone, a traced 4-row batched gradient call (phase 21's),
    and the share of ``_prepare`` in a 68-row ``optimize_device``
    objective call.  After some dozens of profiled runs and ~150k
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
    values;
21. the θ-batched gradient: ``elbo_fixed_batch`` of 4 rows (5 sweeps)
    under ``torch.autograd.grad`` against each row's single-θ gradient on
    the card and the cached JAX ``vmap(value_and_grad)``; B1′ launches
    (4 per row), wall, peak memory, and the host's ms to enqueue the
    backward of a 4-row lattice (one B1′ launch per row and structure);
22. HMC (``inference.hmc``, 4 leapfrog steps, 5 sweeps, log-normal
    priors, from the converged fit): 2 chains fed the JAX key tree's
    draws against the cached JAX chain, then the user's
    ``mcmc(sampler='hmc')`` with 4 chains, 10 warmup steps and 10 samples
    drawing on the card; steps and leapfrog steps per second, launches,
    peak memory;
23. NUTS: the same with ``algorithm='nuts'`` (max depth 3 against JAX;
    the user's call 5 transitions at the initial step, max depth 4),
    leapfrog steps per transition;
24. ``parallel.multistart.multistart_optimize`` (4 restarts, adam and
    ``nm``) and the nonparametric ``ELBOcalc`` (k=2, 20 steps) against the
    cached JAX results; wall times and launches.

25–28. the large-N stack, in a fresh process (``chip_smoke.py --large``):
    25(a) the lean engines at N=2000 (one float64 ``elbo_refine_lean``
    sweep, three float32 ``fit_state_lean`` sweeps) against the cached
    JAX values and the card's dense engine; 25(b) one float64 sweep of the
    dense and of the lean engine from one state at N=5000 and 10,000,
    headline and flagship (s/sweep, peak; the reading ``LEAN_N`` is set
    from; at N=5000 also the dense sweep on MAGMA's batched solves);
    25(c) at N=20,000 ``fit_state_lean``, ``elbo_fit_lean``,
    ``elbo_refine_lean`` and ``ELBOcalc`` (the lean route, by its B1
    launches), and B1 against its plain version on a 256-row slab and
    timed against its bound; 26 the matrix-free solve at N=50,000
    (``kernel_matvec``, B1's product entry, against a float64 slab and
    timed; the entry against its plain version and timed at m = 1, 8,
    16, 64 and 1000 in float32 and float64 beside its bounds (each
    element of K evaluated once; above MATVEC_CAP the product on the FP64
    tensor cores or the FP32 pipe; as diagnostics the tiled path's own
    count of evaluations and the register path's SASS issue time), its
    plain version and B1's slab
    entry plus ``torch.matmul``; the plain version's row
    chunks; plain CG, the pivoted-Cholesky split preconditioner,
    ``cg_refined`` with a float64 residual); 27 the CG fit at N=50,000
    (5 float32 sweeps, the matvecs' share), CG against lean at N=10,000
    and the shell's
    ``fit_method='cg'`` against the cached JAX value; 28
    ``predict_iterative`` against the dense ``predict`` at N=5000 and
    timed at 20,000, LOVE at 20,000, ``sample_iterative`` at 50,000, SVI
    (the full-batch identity, the cached JAX subsets, 20 default steps).
    B1's product entry launches on each of phases 26, 27 and 28.

29. astro: ``utils.astro.keplerian_rv`` on the card at N=497 (the solar
    data's times) and 50,000, for e ∈ {0, 0.3, 0.9}, against the CPU and
    the cached JAX values, and its gradient with respect to (P, K, e, w,
    Tp) against the cached ``jax.grad``;
30. the RV workflow: the solar model (``solar_problem``: all 497
    observations of RV and FWHM from the port's ``datasets.load_solar``,
    a QuasiPeriodic node, a Keplerian on RV): a converged ``ELBOcalc``,
    ``predict(nn=1000)``, five ``optimize_adam`` steps and a 13-row
    ``elbo_fit_batch`` against the cached JAX values; the host's ms of
    the 13-row mean values in one pass against row by row;
31. serving: ``export_predict`` on the card of the headline model at
    N=1000 (the JAX package's converged state) and at N=5000 (the
    heuristic state), saved and loaded in a fresh process
    (``chip_smoke.py --serve``) that imports the serving module alone and
    must not load the shell or the engine; its requests against the
    in-process ``predict`` and the cached outputs of the JAX package's
    artifact, B1 launched in every request; the float32 artifact against
    the JAX package's float32 artifact; export and load seconds, artifact bytes, first-call and
    steady latency and peak memory per request size;
32. profiling: ``utils.profiling.trace`` of a served request writes a
    trace that holds B1 among its device records; the ``StageTimer`` of
    phases 29–31.
33. the multi-device layer, four gloo ranks sharing the card
    (``parallel.mesh.spawn``; the JAX package's ``dryrun_multichip``):
    on a (dp=2, lat=2) mesh a 3-step ``multistart_optimize`` with the
    weight lattice split, the lattice-split ``fit_state`` and one ELBO
    sweep; on (4, 1) ``batch_elbo`` and the ensemble's device chain; on
    (1, lat=4) the panel ``elbo_fit_panel`` at N=192 and
    ``elbo_refine_panel`` of the headline model at N=4096, and
    ``cg_solve_sharded``; each against the unsharded call made afterwards
    (and the panel at N=4096 against the cached JAX value); each rank's
    slab of the headline model's four kernel matrices (QP node, three SE
    weights) from B1's slab entry against the plain version and against
    B1's full-matrix rows.  The ranks time-slice the card: agreement only;
34. full width on a one-rank NCCL mesh: ``elbo_refine_panel`` of the
    headline model at N=20,000 (3 sweeps from the state of one lean
    sweep) against ``elbo_refine_lean``, s/sweep, peak GiB, slab
    launches; ``cg_solve_sharded`` at N=50,000 in float32 against
    ``ops.iterative.cg_solve`` (its product entry launches counted, x
    bit-equal), one rank's rows of the product (``slab_matvec``)
    bit for bit against ``kernel_matvec``'s; the whole padded slab
    (20,224 rows, the shape the path launches) of the QP node and of an
    SE weight against the plain version and B1's full-matrix rows; the
    slab entry's time on a 256-row slab at N=4096 and 20,000 and on the
    whole slab at 20,000, against its plain version and its bound.
35. the worked examples, in three fresh processes side by side
    (``chip_smoke.py --examples 5``, ``--examples 6,7,8,1``,
    ``--examples 2,3,4``; ``--examples`` alone runs all eight in one):
    ``examples/torch_example_1.py`` ... ``_8.py``, each imported by
    module name and run once through ``main("cuda")`` in a temporary
    working directory, at the examples' own sizes; what each
    returns against the JAX examples' values cached in
    ``tests/torch_examples_reference.json`` (``example_checks``, the
    bars of ``tests/test_torch_examples.py``), its launches (B1 in every
    example, B1's product entry in examples 5 and 6) and its wall.

The launch counts are set to 0 before each path (phases 3–5, phases
6–7, phases 11–12, phases 13–15, phases 17–20, phases 21–24, phases
25–28, phases 29–30; phase 31's are counted in its serving process,
phase 33's and 34's in their ranks, started by a fresh process,
``chip_smoke.py --parallel``; phase 34's distributed CG alone; phase
35's before each example, in its process) and read after it.  The last
three lines are the kernels' JSON record (B1, B1′ and B1's product entry
``kernel_matvec``; each with its launches per path and per example), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
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
# the multistart winner's parameters against the JAX package's
THETA_RTOL = 1e-7
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
# outside the tensor cores; 67 TFLOP/s in float64 on the tensor cores,
# where the product entry's tiled path multiplies in float64 (mma.sync).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TENSOR_FP64_FLOPS = 67e12
# operations per lag of the timed structure (QP), from the kernels'
# source, each add, multiply, divide, abs and each exp / sin / cos counted
# once (a transcendental costs the card many more: a lower bound).  Both
# kernels compute each lag once: N (N + 1) / 2 lags.
OPS_PER_LAG = {"kernel_matrix": 17, "kernel_matrix_grad": 33}
# The honest count: FP-pipe instructions (DADD / DMUL / DFMA / DSETP /
# DMNMX in float64, their F* forms in float32) per element of the QP
# instances, read from the built library's SASS (``pipe_per_element``),
# over the pipe's instruction rate: half the peak FLOP/s, an FMA being one
# instruction and two operations.  Each transcendental and division is
# then counted as the instructions the card runs for it.
PIPE_OPS = {"float64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
            "float32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX")}
PIPE_INSTR_PER_S = {k: v / 2 for k, v in PEAK_FLOPS.items()}
# An SM issues 4 warp-instructions a clock, 128 lanes: the FP32 pipe's
# width, so every SASS instruction (integer, load, branch, MUFU as much as
# FP) takes an issue slot at the FP32 pipe's rate
ISSUE_PER_S = PIPE_INSTR_PER_S["float32"]
# the elements a thread of B1, B1' and the slab entry computes (16 bytes of
# neighbouring columns in each of its rows): the copies of the element's
# code in the instance
ELEMENTS_PER_THREAD = 4
# B1 and B1', the kernels every engine path launches (B1's product entry
# runs on the matrix-free paths only)
B1_KERNELS = ("kernel_matrix", "kernel_matrix_grad")
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

# the gradient paths over a batch (phases 21-24, headline model, N=1000):
# the θ-batched gradient of 4 rows (log-normal perturbations of 0.1, each
# row from its heuristic start), the samplers on it (log-normal priors of
# width PRIOR_WIDTH, p0 = the model's parameters after a converged fit;
# the oracle runs are fed the JAX key tree's draws, the user's calls
# draw on the card), the multistart population and nonparametric VI
GRAD_BATCH = {"rows": 4, "spread": 0.1, "seed": 13, "n_sweeps": 5}
HMC = {"n_leapfrog": 4, "n_sweeps": 5, "seed": 0, "initial_step": 0.005}
HMC_ORACLE = {"algorithm": "hmc", "n_chains": 2, "n_warmup": 0,
              "n_samples": 3}
NUTS_ORACLE = {"algorithm": "nuts", "n_chains": 2, "n_warmup": 0,
               "n_samples": 2, "max_depth": 3}
HMC_RUN = {"algorithm": "hmc", "niter": 10, "n_warmup": 10, "n_chains": 4}
NUTS_RUN = {"algorithm": "nuts", "niter": 5, "n_warmup": 0, "n_chains": 4,
            "max_depth": 4}
MULTISTART = {"n_restarts": 4, "n_steps": 5, "n_sweeps": 5}
MULTISTART_NM = {"n_restarts": 4, "n_steps": 10, "n_sweeps": 5,
                 "method": "nm"}
NPV = {"k": 2, "iterations": 20, "seed": 0}

# the large-N stack (phases 25-28), run in a process of its own
# (``chip_smoke.py --large``) so that its peaks are its own.  25(a): the
# lean engines at N=2000 against the cached JAX values and the card's
# dense engine; 25(b): one float64 sweep of the dense and the lean engine
# from one state, headline and flagship, the reading LEAN_N is set from;
# 25(c): the lean engines at BASELINE config 5's upper end (bench.py:
# 413-442) and B1 there
LARGE_ARG = "--large"
MAGMA_ARG = "--magma-batched-solve"
LEAN_CHECK_N = 2000
LEAN_FIT32_SWEEPS = 3
LEAN_COMPARE_NS = (5000, 10000)
# the largest N at which torch's batched cholesky_solve (MAGMA) ran on an
# H100 (batches of 3; it failed from 7000 on)
MAGMA_BATCHED_SOLVE_MAX_N = 6000
LEAN_WIDE_N = 20000
LEAN_WIDE = {"fit32_sweeps": 3, "elbo_fit_iters": 3, "refine_sweeps": 2}
SLAB_ROWS = 256
# 26: the matrix-free solve of bench.py:446-518 (QP(1, 300, 200, 0.7), t
# uniform on [0, 1000] from default_rng(1), float32)
SOLVE_N = 50000
SOLVE_PARS = (1.0, 300.0, 200.0, 0.7)
SOLVE_NUGGET = 1e-2
PLAIN_CG = {"tol": 1e-4, "maxiter": 200}
PRE_CG = {"rank": 128, "tol": 2e-3, "maxiter": 60, "refresh_every": 4}
REFINED = {"n_refine": 3, "tol": 1e-6, "inner_tol": 1e-3, "maxiter": 60}
# 27: the CG fit (bench.py:524-554, :586-644): the headline model at
# N=50,000, 5 float32 sweeps at cg_tol 1e-5; CG against lean, one float64
# sweep each at N=10,000 (the JAX package's bar 1e-4); the shell's mixed
# fit with fit_method='cg'
CG_FIT_N = 50000
CG_FIT = {"sweeps": 5, "cg_tol": 1e-5}
CG_LEAN_N = 10000
CG_LEAN_TOL = 1e-4
CG_MIXED = {"N": 2000, "max_iter": 30, "refine_sweeps": "converge",
            **CONVERGE}
# 28: prediction checked from the heuristic starting state (from a state
# 10 sweeps into the fit, the small posterior variances leave A = K +
# diag(v) so ill-conditioned that the node GP's Jacobi-preconditioned CG
# runs to its 2,000 iterations, which the phase also shows), its
# variances one batched solve per GP; LOVE; prior samples; SVI (one
# output of three per step, the default p // 4 at least 1) fed the cached
# JAX subsets, the full-batch identity, and the default steps timed
PREDICT_N = 5000
PREDICT_WIDE_N = 20000
PREDICT_RHS_CHUNK = 1000
LOVE_RANK = 100
SAMPLE_N = 50000
SVI_N = 1000
SVI_ORACLE = {"n_steps": 10, "seed": 0, "t0": 5.0, "kappa": 0.6}
SVI_TIMED = {"N": 5000, "n_steps": 20}

# the Keplerian RV workflow and the served predictive (phases 29-32).  29:
# keplerian_rv at the solar data's N and at 50,000 times uniform on its
# span (default_rng(ASTRO_SEED)), the solar model's orbit with three
# eccentricities; the gradient of the curve's sum at N=497.  30: the solar
# model (examples/example_2.py without its subsample, a Keplerian on RV);
# its θ batch as phase 17's.  31: the headline model served from the
# JAX package's converged state (N=1000) and from the heuristic state
# (N=5000, above BATCHED_SOLVE_MAX_N), loaded in a fresh process
# (``chip_smoke.py --serve``), at request sizes SERVE[...]["ns"]
SOLAR_KEPLERIAN = (100.0, 1.0, 0.1, 0.5, 0.0)        # P, K, e, w, Tp
ASTRO_ECCENTRICITIES = (0.0, 0.3, 0.9)
ASTRO_NS = (497, 50000)
ASTRO_SEED = 5
ASTRO_STRIDE = 97
# keplerian_rv on the card against the CPU (the same operations; sin, cos,
# tan and atan round differently in the two math libraries), against the
# JAX package's values, and its gradient against jax.grad (of max |g|):
# measured 3.7e-14 against JAX at e=0.9 on a CPU, where 100 Newton steps
# carry the last bits of the first ones
ASTRO_CPU_RTOL = 1e-12
ASTRO_JAX_RTOL = 1e-10
ASTRO_GRAD_TOL = 1e-9
SOLAR_STRIDE = 7
SOLAR_NN = 1000
SERVE_ARG = "--serve"
SERVE = {"headline": {"N": N_MAIN, "ns": (1, 7, 1000, 10000)},
         "wide": {"N": N_WIDE, "ns": (1, 1000)}}
SERVE_STRIDE = 97
SERVE_STEADY_REPS = 5
SERVE_F32_N = 1000
# served outputs against the in-process predict (the same operations) and
# against the JAX package's artifact (cuSOLVER against LAPACK); the float32
# artifact against the JAX package's float32 artifact, at the bar of
# tests/test_serving.py::test_f32_export_dtype (5e-4).  Each is max |Δ| /
# max |ref| per output.  The float32 artifact is not held to the float64
# one: at N=1000 from the converged state both packages' float32 programs
# lie 0.0125 (mean) and 0.045 (var) of max |ref| from float64 on a CPU, the
# float32 trace-scaled jitter (4·eps·tr K) changing the model itself; the
# port's lay 5.1e-5 from the JAX package's there
SERVE_RTOL = {"predict": 1e-12, "jax": 1e-9, "float32": 5e-4}
# the served program's B1 operator (gpyrn_torch::kernel_matrix_stack) on
# the served models' own structures and parameters against the plain
# version, at B1's tolerances of phase 8 (rtol, atol of max |ref|)
STACK_OP_TOL = {"float64": (1e-12, 1e-14), "float32": (2e-6, 1e-6)}

# the multi-device layer (phases 33-34).  33: four gloo ranks sharing the
# card (``parallel.mesh.spawn``), the port's version of the JAX package's
# dryrun_multichip (__graft_entry__.py): on a (dp=2, lat=2) mesh a 3-step
# multistart population of the flagship model at N=256 with its weight
# lattice split over lat, the lattice-split fit_state (60 sweeps, tol
# 1e-10) and one ELBO sweep from its state, batch_elbo over 8 rows and the
# ensemble's device chain (8 walkers, two free parameters, 8 steps) on a
# (4, 1) mesh; on a (1, lat=4) mesh the panel elbo_fit_panel at N=192
# (block 16; the dryrun's QuasiPeriodic node and SE weight, q=1 p=1,
# default_rng(11)), elbo_refine_panel of the headline model at N=4096
# (block 256, one sweep) against the single-device lean engine and the
# cached JAX value, and cg_solve_sharded at N=192 against cg_solve.
# Ranks that share one card time-slice it: this phase checks agreement
# and prints its wall only.  34: one NCCL rank on the card, the headline
# model at N=20,000 (Np = 20,224): elbo_refine_panel for 3 sweeps from
# the state of one elbo_refine_lean sweep, against elbo_refine_lean from
# that state; then cg_solve_sharded on phase 26's float32 system at
# N=50,000 against ops.iterative.cg_solve with the same Jacobi
# preconditioner
PARALLEL_ARG = "--parallel"
PARALLEL_RANKS = 4
PARALLEL_TIMEOUT = 600.0
LATTICE = {"N": 256, "max_iter": 60, "tol": 1e-10}
MULTISTART_MESH = {"n_restarts": 2, "n_steps": 3, "n_sweeps": 3}
EVIDENCE_MESH_ROWS = 8
CHAIN_MESH = {"nwalkers": 8, "niter": 8, "elbo_max_iter": 30, "seed": 5,
              "check_every": 4}
PANEL_FIT = {"N": 192, "block": 16, "max_iter": 100}
PANEL_N, PANEL_BLOCK, PANEL_SWEEPS = 4096, 256, 1
CG_MESH = {"N": 192, "nugget": 1e-2, "tol": 1e-10, "maxiter": 400}
PANEL_WIDE = {"N": 20000, "block": 256, "sweeps": 3}
CG_WIDE = {"tol": 1e-4, "maxiter": 50, "chunk": 2048}
# bars: lat-split against unsharded (the JAX package's dryrun: state atol
# 1e-10, ELBO relative 1e-10, equal sweeps); dp-split against unsharded
# (tests/test_sharding.py, test_sharding_samplers.py: batch_elbo relative
# 1e-8, chain rtol 1e-6 / atol 1e-7, log-probs 1e-6); the panel fits
# (the dryrun: relative 1e-8 at N=192; tests/test_panel.py at N=4096:
# ELBO relative 1e-8, state 1e-7·(1 + max)); at N=20,000 against the
# lean engine, ELBO relative 1e-9 and state 1e-8·(1 + max); CG
# (tests/test_iterative_sharded.py: rtol 1e-5, atol 1e-8)
LATTICE_ATOL, LATTICE_ELBO_RTOL = 1e-10, 1e-10
EVIDENCE_MESH_RTOL = 1e-8
CHAIN_MESH_TOL = {"chain": (1e-6, 1e-7), "log_prob": (1e-6, 1e-6)}
PANEL_FIT_RTOL = 1e-8
PANEL_RTOL = {"elbo": 1e-8, "state": 1e-7}
PANEL_WIDE_RTOL = {"elbo": 1e-9, "state": 1e-8}
CG_MESH_TOL = (1e-5, 1e-8)

# phase 35: the worked examples (examples/torch_example_1.py ... _8.py),
# each one main("cuda") in a fresh process (chip_smoke.py --examples),
# against the JAX examples' values cached by tests/test_torch_examples.py
EXAMPLES_ARG = "--examples"
EXAMPLES_DIR = os.path.join(HERE, "examples")
EXAMPLES_REFERENCE = os.path.join(HERE, "tests",
                                  "torch_examples_reference.json")
EXAMPLE_NUMBERS = tuple(range(1, 9))
# the examples are launch-bound at their sizes (N <= 100: the host's
# launches, not the card, set their walls): on an NVIDIA H100 80GB HBM3
# at 700 W, side by side in these groups, example 5's NUTS took 201 s,
# examples 6, 7, 8, 1 168 s and 2, 3, 4 126 s (chip_smoke.py --examples;
# the eight walls sum to 495 s), so phase 35 runs them in three processes
# side by side
EXAMPLE_GROUPS = ((5,), (6, 7, 8, 1), (2, 3, 4))
# the examples that run B1's product entry (predict_iterative, build_love)
EXAMPLES_WITH_MATVEC = (5, 6)
# the bars of example_checks, each against the JAX example's value:
# float64 fits from the heuristic state relative 1e-9 (ELBO_RTOL) and
# their predictives 1e-9 of the largest value; optimizer trajectories of
# 60-120 steps (adam, Nelder-Mead) relative 1e-7 (THETA_RTOL, parameters
# entry by entry, an entry near 0 against the largest); a fit from a
# float32 bulk with three float64 polish sweeps MIXED_POLISH3_RTOL, and
# with the polish to its fixed point (refine_tol 1e-9) relative 1e-7,
# tests/test_torch_mixed.py's bars; the matrix-free predictives
# EXAMPLE_ITERATIVE_TOL; the port's own NUTS chains:
# finite, of the JAX chain's shape, acceptance in (0, 1] and each
# posterior mean within NUTS_SIGMAS posterior standard deviations of the
# JAX chain's
EXAMPLE_PREDICT_TOL = 1e-9
EXAMPLE_CONVERGE_RTOL = 1e-7
NUTS_SIGMAS = 4.0
# the matrix-free predictives (CG solves at tol 1e-9, LOVE's Lanczos
# cache with its CG solve at 1e-8) agree with another runtime's only to
# the solves' accuracy, not to rounding (an H100 against the JAX
# package: CG std 1.0e-8 of the largest value): their values, and their
# gaps to the dense predictive, are held to this share of the largest
# predictive value
EXAMPLE_ITERATIVE_TOL = 1e-7
# the example's own bar for the served mean against the in-process one
SERVE_DEV_TOL = 1e-10


def solar_problem(pkg, **kw):
    """The solar RV workflow's model: RV and FWHM of the bundled solar
    data (all 497 observations), one QuasiPeriodic node, SquaredExponential
    weights of the outputs' std, a Keplerian on RV and a zero constant on
    FWHM, jitters of half the std (examples/example_2.py's model, with the
    planet)."""
    import importlib
    datasets = importlib.import_module(pkg.__name__ + ".datasets")
    time, data = datasets.load_solar(("RV", "FWHM"))
    g = pkg.inference(1, time, *data, **kw)
    s_rv, s_fwhm = np.std(data[0]), np.std(data[2])
    g.set_components(
        pkg.covfunc.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
        [pkg.covfunc.SquaredExponential(s_rv, 30.0),
         pkg.covfunc.SquaredExponential(s_fwhm, 30.0)],
        [pkg.meanfunc.Keplerian(*SOLAR_KEPLERIAN),
         pkg.meanfunc.Constant(0.0)],
        [s_rv / 2, s_fwhm / 2])
    return g


def astro_times(solar_time):
    """The times of phase 29, one array per ``ASTRO_NS``: the solar data's
    own, then uniform draws on its span."""
    rng = np.random.default_rng(ASTRO_SEED)
    span = float(np.max(solar_time))
    return {n: (np.asarray(solar_time, dtype=float) if n == solar_time.size
                else np.sort(rng.uniform(0.0, span, n))) for n in ASTRO_NS}


def astro_params(e):
    """(P, K, e, w, Tp) of the solar model's orbit with eccentricity e."""
    P, K, _, w, Tp = SOLAR_KEPLERIAN
    return (P, K, e, w, Tp)


def serve_times(time, n):
    """A request of n prediction times over the data's span widened by a
    fifth on each side (``predict``'s default grid)."""
    lo, hi = float(np.min(time)), float(np.max(time))
    span = hi - lo
    return np.linspace(lo - 0.2 * span, hi + 0.2 * span, n)


def serve_summary(outputs):
    """Each of predict's four outputs flattened row by row, whole up to
    1000 values, else every ``SERVE_STRIDE``-th (what the cached oracle
    keeps of them)."""
    flat = [np.asarray(o, dtype=float).ravel() for o in outputs]
    return [(f if f.size <= 1000 else f[::SERVE_STRIDE]).tolist()
            for f in flat]


def batch_thetas(theta0, rows, spread, seed):
    """``rows`` copies of the parameter vector ``theta0``, each entry
    times exp(spread·N(0, 1)) from default_rng(seed); row 0 unperturbed."""
    theta0 = np.asarray(theta0, dtype=float)
    rng = np.random.default_rng(seed)
    out = theta0[None, :] * np.exp(
        spread * rng.standard_normal((rows, theta0.size)))
    out[0] = theta0
    return out


def fitted_headline(pkg, **kw):
    """The headline model after a converged ``ELBOcalc``: the samplers'
    warm start."""
    g = headline_problem(pkg, **kw)
    g.ELBOcalc()
    return g


def npv_problem(npv_module, g, cfg):
    """A nonparametric inference of ``npv_module`` (either package's) on
    the data of the mean-field ``g``, with ``cfg['k']`` components."""
    data = []
    for y, yerr in zip(np.asarray(g.y), np.asarray(g.yerr)):
        data += [y, yerr]
    kw = {"device": g.device} if hasattr(g, "device") else {}
    return npv_module.inference(g.q, np.asarray(g.time, dtype=float),
                                cfg["k"], *data, **kw)


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
# the QP instances whose SASS gives the instructions per element, and the
# product entry's (register path with 1 and MV_CAP columns, tiled path)
_QP_INSTANCE = re.compile(
    r"_Z\d+(kernel_matrix_kernel|kernel_matrix_grad_kernel|"
    r"kernel_matrix_slab_kernel|kernel_matvec_kernel|"
    r"kernel_matvec_tiled_kernel)I([df])Li5E(?:Li(\d+)E)?")
# a SASS line: (its predicate, its operation)
_SASS_LINE = re.compile(
    r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)")


def _sass_counts(cuobjdump, library, entry):
    """(all SASS operations, FP64 arithmetic, MUFU) in the SASS of one
    kernel: a static count, slow paths included."""
    text = _run([cuobjdump, "-sass", "-fun", entry, str(library)])
    ops = [op for _, op in _SASS_LINE.findall(text)]
    fp64 = sum(op.split(".")[0] in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
               for op in ops)
    return len(ops), fp64, sum(op.startswith("MUFU") for op in ops)


def _sass_pipe(cuobjdump, library, entry, dtype):
    """(FP-pipe instructions of the whole kernel, of its main line: from
    the entry to the first unpredicated EXIT, which leaves out the math
    library's slow paths placed after it) in the SASS of one kernel."""
    text = _run([cuobjdump, "-sass", "-fun", entry, str(library)])
    ops = PIPE_OPS[dtype]
    total = main = 0
    ended = False
    for pred, op in _SASS_LINE.findall(text):
        hit = op.split(".")[0] in ops
        total += hit
        if not ended:
            main += hit
            ended = op == "EXIT" and not pred
    return total, main


_PIPE_COUNTS = {}


def pipe_per_element(_build):
    """{(kernel, dtype): FP-pipe instructions per element} of the QP
    instances of B1, B1' and the slab entry, from the built library's
    SASS: the main line over ELEMENTS_PER_THREAD (a static count; the code
    of one element runs once per element).  The product entry runs the
    slab's element plus one FMA per column of V.  Empty without
    cuobjdump.  Once per process."""
    if _PIPE_COUNTS:
        return _PIPE_COUNTS
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return _PIPE_COUNTS
    library = _build.build("kernel_matrix")
    for entry in _build.resource_usage(_build.build_log("kernel_matrix")):
        m = _QP_INSTANCE.match(entry)
        if not m or m[1] not in ("kernel_matrix_kernel",
                                 "kernel_matrix_grad_kernel",
                                 "kernel_matrix_slab_kernel"):
            continue
        dtype = {"d": "float64", "f": "float32"}[m[2]]
        _, main = _sass_pipe(cuobjdump, library, entry, dtype)
        _PIPE_COUNTS[(m[1], dtype)] = main / ELEMENTS_PER_THREAD
    return _PIPE_COUNTS


# The registers a thread of the product entry's tiled instances must get
# from ptxas, which csrc MtShape's setmaxnreg split assumes: 65,536 over the
# block's threads, rounded down to 8 (narrow: 128 + 768 threads; wide: 256
# + 512).
TILED_REGISTERS = {"tiled": 65536 // 896 // 8 * 8,
                   "wide": 65536 // 768 // 8 * 8}
# the product entry's instances: (kernel, dtype, op code or n1 / n2 for the
# pair / the interpreter, register width or tiled shape: 0 narrow, 1 wide)
_PRODUCT_INSTANCE = re.compile(
    r"_Z\d+(kernel_matvec_kernel|kernel_matvec_tiled_kernel)I([df])"
    r"Li(n?\d+)E(?:Li(\d+)E)?")
_SASS_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def product_instance_key(entry, ck):
    """The ``ck.MATVEC_INSTANCES`` key of a mangled product-entry
    instance, or None for another kernel."""
    m = _PRODUCT_INSTANCE.match(entry)
    if not m:
        return None
    code = int(m[3].replace("n", "-"))
    names = {c: tag for tag, c in ck.OPCODES.items()}
    mode = {-1: "pair", -2: "any"}.get(code) or names[code]
    if m[1] == "kernel_matvec_tiled_kernel":
        width = "wide" if m[4] == "1" else "tiled"
    else:
        width = f"W={m[4]}"
    dtype = {"d": "float64", "f": "float32"}[m[2]]
    return f"{dtype} {mode} {width}"


def _sass_ops(text):
    """(operations, branches) of one kernel's SASS: each operation's name,
    and (index, target index) of each branch (a target given as a label
    or an address)."""
    ops, where, raw = [], {}, []
    for line in text.splitlines():
        lab = _SASS_LABEL.match(line)
        if lab:
            where[lab[1]] = len(ops)
            continue
        ins = _SASS_INSTR.search(line)
        if not ins:
            continue
        where[int(ins[1], 16)] = len(ops)
        tgt = _SASS_TARGET.search(ins[4])
        if ins[3].startswith("BRA") and tgt:
            raw.append((len(ops), tgt[1] or int(tgt[2], 16)))
        ops.append(ins[3].split(".")[0])
    return ops, [(at, where[t]) for at, t in raw if t in where]


def _sass_inner_loop(cuobjdump, library, entry, dtype):
    """(SASS instructions, FP-pipe instructions) of one pass of a
    kernel's element loop, a static count of its fast path: of each loop
    (a backward branch's target to the branch), the instructions that no
    forward branch inside it skips over a slow path (a skipped stretch
    that holds a loop or a CALL: the math library's large-argument
    reductions and division fallbacks, never taken at these lags); the
    loop taken is the one with the most FP-pipe instructions among those
    whose fast path holds no other loop.  None if there is none."""
    ops, branches = _sass_ops(
        _run([cuobjdump, "-sass", "-fun", entry, str(library)]))
    loops = [(t, at) for at, t in branches if t <= at]
    fp = PIPE_OPS[dtype]
    best = None
    for a, b in loops:
        slow = set()
        for at, t in branches:
            if a <= at < t <= b:
                body = range(at + 1, t)
                if any(ops[i] == "CALL" for i in body) or any(
                        c in body for c, _ in loops if c != at):
                    slow.update(body)
        fast = [i for i in range(a, b + 1) if i not in slow]
        if any(a <= c and d <= b and (c, d) != (a, b) and d not in slow
               for c, d in loops):
            continue
        count = (len(fast), sum(ops[i] in fp for i in fast))
        if best is None or count[1] > best[1]:
            best = count
    return best


_ISSUE_COUNTS = {}


def issue_per_element(_build):
    """{(dtype, width): (SASS instructions, FP-pipe instructions, elements)
    of one pass of the inner loop} of the product entry's register-path
    QP instances: the elements of a pass are the loop's FP-pipe
    instructions over the element's (``pipe_per_element`` of the slab
    entry, plus one fma a column).  Empty without cuobjdump.  Once per
    process."""
    if _ISSUE_COUNTS:
        return _ISSUE_COUNTS
    pipe = pipe_per_element(_build)
    if not pipe:
        return _ISSUE_COUNTS
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    library = _build.build("kernel_matrix")
    for entry in _build.resource_usage(_build.build_log("kernel_matrix")):
        m = _QP_INSTANCE.match(entry)
        if not m or m[1] != "kernel_matvec_kernel":
            continue
        dtype, width = {"d": "float64", "f": "float32"}[m[2]], int(m[3])
        loop = _sass_inner_loop(cuobjdump, library, entry, dtype)
        if loop is None:
            continue
        per = pipe[("kernel_matrix_slab_kernel", dtype)] + width
        _ISSUE_COUNTS[(dtype, width)] = (loop[0], loop[1],
                                         max(1, round(loop[1] / per)))
    return _ISSUE_COUNTS


def _pipe_bound(_build, kernel, dtype, elements, extra=0):
    """(FP-pipe instructions per element, the least ms the pipe needs for
    ``elements`` of them): None where the count is missing.  ``extra``
    instructions per element on top (the product's FMAs)."""
    per = pipe_per_element(_build).get((kernel, _dtype_name(dtype)))
    if per is None:
        return None, None
    per += extra
    return per, 1e3 * elements * per / PIPE_INSTR_PER_S[_dtype_name(dtype)]


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
    # the slab and product entries' QP instances: resources, FP-pipe SASS
    product = 0
    for entry, use in sorted(usage.items()):
        m = _QP_INSTANCE.match(entry)
        if not m or m[1] in ("kernel_matrix_kernel",
                             "kernel_matrix_grad_kernel"):
            continue
        product += m[1].startswith("kernel_matvec")
        dtype = {"d": "float64", "f": "float32"}[m[2]]
        if m[1] == "kernel_matvec_tiled_kernel":
            width = ", wide" if m[3] == "1" else ", narrow"
        else:
            width = f", {m[3]} columns" if m[3] else ""
        line = (f"ptxas {m[1]}<{dtype}, QP{width}>: {use['registers']} "
                f"registers, {use['stack_frame']} bytes stack frame, "
                f"{use['spill_stores']} / {use['spill_loads']} bytes spill "
                f"stores / loads")
        if os.path.exists(cuobjdump):
            total, main = _sass_pipe(cuobjdump, path, entry, dtype)
            line += (f"; SASS {total} FP-pipe instructions, {main} on the "
                     f"main line (static)")
        print(line, flush=True)
    # the register path's one- and MATVEC_CAP-column instances and the
    # tiled path's narrow shape in both types, its wide shape in float32
    if product != 2 * 3 + 1:
        raise AssertionError(f"the build log names {product} of the 7 QP "
                             f"instances of B1's product entry")
    # the tiled instances of the models' leaves
    for entry, use in sorted(usage.items()):
        key = product_instance_key(entry, ck)
        if key is None or key.split()[2] not in ("tiled", "wide") or \
                key.split()[1] not in MAIN_PATH_LEAVES:
            continue
        print(f"ptxas kernel_matvec_tiled_kernel<{key.split()[0]}, "
              f"{key.split()[1]}, {key.split()[2]}>: {use['registers']} "
              f"registers, "
              f"{use['stack_frame']} bytes stack frame, "
              f"{use['spill_stores']} / {use['spill_loads']} bytes spill "
              f"stores / loads", flush=True)
    mv = {product_instance_key(e, ck): u for e, u in usage.items()
          if product_instance_key(e, ck) is not None}
    # setmaxnreg.inc waits for registers freed inside the block's own
    # allocation: an instance given fewer than csrc MtShape assumes would
    # hang the card, so it fails here
    wrong = {k: u["registers"] for k, u in mv.items()
             if k.split()[2] in TILED_REGISTERS
             and u["registers"] != TILED_REGISTERS[k.split()[2]]}
    if wrong:
        raise AssertionError(f"tiled product-entry instances whose "
                             f"registers are not {TILED_REGISTERS}: {wrong}")
    spilled = {k: u for k, u in mv.items()
               if u["spill_stores"] or u["spill_loads"]}
    print(f"ptxas, B1's product entry: {len(mv)} instances, "
          f"{min(u['registers'] for u in mv.values())}-"
          f"{max(u['registers'] for u in mv.values())} registers; "
          f"{len(spilled)} spill (registers/stores/loads in bytes): "
          + ", ".join(f"{k} {u['registers']}r/{u['spill_stores']}/"
                      f"{u['spill_loads']}" for k, u in sorted(
                          spilled.items())), flush=True)
    counts = {f"{k}<{d}>": v
              for (k, d), v in pipe_per_element(_build).items()}
    print(f"FP-pipe instructions per element of the QP instances (the main "
          f"line over {ELEMENTS_PER_THREAD} elements a thread): {counts}",
          flush=True)
    for (dtype, width), (instr, fp, elems) in sorted(
            issue_per_element(_build).items()):
        print(f"SASS inner loop of kernel_matvec_kernel<{dtype}, QP, "
              f"{width}>: {instr} instructions, {fp} FP-pipe, {elems} "
              f"elements a pass: {instr / elems:.2f} instructions an element "
              f"(issue), {fp / elems:.2f} FP-pipe", flush=True)
    return spilled


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
                                "kernel_matrix_grad": want,
                                "kernel_matvec": 0}:
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
    from gpyrn_tpu_torch.ops import _build
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
                per, pipe_ms = _pipe_bound(_build, "kernel_matrix_kernel",
                                           dtype, N * (N + 1) // 2)
                if structure == ("QP",):
                    print(f"bound kernel_matrix QP N={N} "
                          f"{_dtype_name(dtype)}: {bound_ms:.5f} ms "
                          f"({bound_by}); kernel at "
                          f"{bound_ms / ms:.3f} of it; FP-pipe bound "
                          f"{pipe_ms} ms ({per} instructions a lag)",
                          flush=True)
                if (dtype == torch.float64 and structure == ("QP",)
                        and N == N_MAIN):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None,
                              "pipe_bound_ms": pipe_ms,
                              "pipe_instructions_per_lag": per,
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
    from gpyrn_tpu_torch.ops import _build
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
                per, pipe_ms = _pipe_bound(
                    _build, "kernel_matrix_grad_kernel", dtype,
                    N * (N + 1) // 2)
                print(f"time kernel_matrix_grad {structure} N={N} "
                      f"{_dtype_name(dtype)}: device kernels {ms:.5f} ms "
                      f"({dev_a:.5f}/{dev_b:.5f}), plain {plain_ms:.5f} ms "
                      f"({pdev_a:.5f}/{pdev_b:.5f}); per call as the device "
                      f"sees it: wrapper {call_ms:.4f} ms, plain "
                      f"{plain_call_ms:.4f} ms; bound {bound_ms:.5f} ms "
                      f"({bound_by}), kernel at {bound_ms / ms:.3f} of it; "
                      f"FP-pipe bound {pipe_ms} ms ({per} instructions a "
                      f"lag)", flush=True)
                if (dtype == torch.float64 and structure == ("QP",)
                        and N == N_MAIN):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None,
                              "pipe_bound_ms": pipe_ms,
                              "pipe_instructions_per_lag": per,
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
    if launched != {"kernel_matrix": n_k, "kernel_matrix_grad": n_k,
                    "kernel_matvec": 0}:
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
        Linv_all = eng._prepare(*args)[2]      # NaN where a factor failed
        bad[name] = int((~torch.isfinite(Linv_all).flatten(1).all(1)).sum())
        del Linv_all
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
                                  "kernel_matrix_grad": 2 * n_k,
                                  "kernel_matvec": 0},
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
    (headline model, N=1000, float64, the state from the heuristic start),
    and one traced gradient call of the ``GRAD_BATCH`` rows (a leapfrog
    step of 4 chains): wall, device time, launches, idle share."""
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
    rows = g._tensor(batch_thetas(g.get_parameters(include_frozen=True),
                                  GRAD_BATCH["rows"], GRAD_BATCH["spread"],
                                  GRAD_BATCH["seed"]))
    mu, var = eng.init_mu_var(rows, g._tensor(g.y))

    def grad_call():
        T = rows.clone().requires_grad_(True)
        with torch.enable_grad():
            elbo = eng.elbo_fixed_batch(T, *data, mu, var,
                                        GRAD_BATCH["n_sweeps"])
            return torch.autograd.grad(elbo.sum(), T)

    grad_call()
    wall, kernels = _traced(torch, grad_call)
    n_k = 4 * GRAD_BATCH["rows"]
    _trace_summary(f"batched gradient ({GRAD_BATCH['rows']} rows, "
                   f"{GRAD_BATCH['n_sweeps']} sweeps)", wall, kernels,
                   {"kernel_matrix_kernel": n_k,
                    # B1′ is two kernels: the contraction and its sum
                    "kernel_matrix_grad": 2 * n_k})
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


def phase_batched_grad(torch, pkg, oracle, ck, lin):
    """``elbo_fixed_batch`` of the ``GRAD_BATCH`` rows under
    ``torch.autograd.grad`` on the card against each row's single-θ
    ``elbo_value_and_grad`` on the card and the cached JAX
    ``vmap(value_and_grad)``; B1′ launches, wall, peak memory, and the
    host's ms to enqueue the lattice's backward (the per-row,
    per-structure launch loop) against the call's wall.  Returns the
    call's wall (s)."""
    ref, cfg = oracle["batched_grad"], GRAD_BATCH
    rows, n_sweeps = cfg["rows"], cfg["n_sweeps"]
    g = headline_problem(pkg, device="cuda")
    eng, data = g.engine, g._data()
    thetas = g._tensor(batch_thetas(g.get_parameters(include_frozen=True),
                                    rows, cfg["spread"], cfg["seed"]))
    mu0, var0 = eng.init_mu_var(thetas, data[1])

    def call():
        T = thetas.clone().requires_grad_(True)
        with torch.enable_grad():
            elbo = eng.elbo_fixed_batch(T, *data, mu0, var0, n_sweeps)
            (grad,) = torch.autograd.grad(elbo.sum(), T)
        return elbo.detach(), grad

    call()                                                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    before = ck.LAUNCHES["kernel_matrix_grad"]
    (value, grad), wall = _timed(torch, call)
    launched = ck.LAUNCHES["kernel_matrix_grad"] - before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted = dict(ck.LAUNCHES)
    singles = [eng.elbo_value_and_grad(thetas[w], *data, mu0[w], var0[w],
                                       n_sweeps) for w in range(rows)]
    value, grad = value.cpu().numpy(), grad.cpu().numpy()

    # the backward's host loop alone: the (rows, 4, N, N) lattice of the
    # headline structures, its backward enqueued against a fixed adjoint
    structures = [("QP",)] + [("SE",)] * 3
    pars = [(1.0, 30.0, 20.0, 0.7)] + [(1.0 + 0.05 * k, 30.0)
                                       for k in range(3)]
    params = [p.requires_grad_(True) for p in
              _row_params(torch, pars, rows, torch.float64, rows)]
    t = data[0]
    K = lin.kernel_matrix_rows(structures, params, t)
    G = torch.randn(K.shape, dtype=K.dtype, device=K.device,
                    generator=torch.Generator(device=K.device).manual_seed(0))
    host_ms, done_ms = _host_ms(torch, lambda: torch.autograd.grad(
        K, params, grad_outputs=G, retain_graph=True), 50)
    # the comparisons are not the path
    ck.LAUNCHES.update(counted)

    v_single = float(np.max(np.abs(value - [float(s[0]) for s in singles])
                            / np.abs(value)))
    g_single = max(_grad_error(grad[w], singles[w][1].cpu().numpy())
                   for w in range(rows))
    v_jax = float(np.max(np.abs(value - ref["value"]) /
                         np.abs(ref["value"])))
    g_jax = _grad_error(grad, ref["grad"])
    print(f"batched gradient: elbo_fixed_batch of {rows} rows, {n_sweeps} "
          f"sweeps, N={N_MAIN}, float64: {1e3 * wall:.3f} ms per call, peak "
          f"device memory {peak:.3f} GiB, B1' launches {launched}; the "
          f"backward's launch loop over the ({rows}, 4, {N_MAIN}, {N_MAIN}) "
          f"lattice: {host_ms:.4f} ms of host per call ({done_ms:.4f} ms "
          f"until the card is done), {host_ms / (1e3 * wall):.4f} of the "
          f"gradient call", flush=True)
    _check("batched gradient", [
        ("values vs single rows", v_single <= GRAD_VALUE_RTOL,
         f"max rel {v_single:.3e} (limit {GRAD_VALUE_RTOL})"),
        ("gradients vs single rows", g_single <= GRAD_TOL,
         f"max|dg|/max|g| {g_single:.3e} (limit {GRAD_TOL})"),
        ("values vs jax", v_jax <= GRAD_VALUE_RTOL,
         f"max rel {v_jax:.3e} (limit {GRAD_VALUE_RTOL})"),
        ("gradients vs jax", g_jax <= GRAD_TOL,
         f"max|dg|/max|g| {g_jax:.3e} (limit {GRAD_TOL})"),
        ("B1' launches (rows x matrices)", launched == 4 * rows,
         f"{launched} vs {4 * rows}"),
    ])
    return wall


def phase_sampler(torch, pkg, oracle, ck, algorithm, grad_wall):
    """HMC or NUTS of the headline model on the card: (a) the oracle's
    run fed the JAX key tree's draws against the cached JAX chain; (b)
    the user's ``mcmc(sampler='hmc')`` with the card's draws: finite
    log-probabilities, acceptance in [0, 1], a finite positive step size;
    steps and leapfrog steps per second, launches, peak memory."""
    from gpyrn_tpu_torch.inference import priors as port_priors
    from gpyrn_tpu_torch.inference.hmc import GivenDraws, run_hmc
    ref = oracle["hmc"][algorithm]
    name = algorithm.upper()
    g = fitted_headline(pkg, device="cuda")
    priors = headline_priors(g, port_priors.LogNormal)
    kw = {k: v for k, v in ref.items()
          if k not in ("chain", "log_prob", "acceptance", "step_size",
                       "draws")}
    res = run_hmc(g, priors, p0=g.get_parameters(),
                  draws=GivenDraws(ref["draws"]), **kw)
    chain_err = _rel_state_err(res.chain, ref["chain"])
    lp_err = float(np.max(np.abs(res.log_prob - ref["log_prob"])
                          / np.abs(ref["log_prob"])))
    acc_err = abs(res.acceptance - ref["acceptance"])
    # the acceptance statistic is a mean of min(1, exp(-ΔE)), ΔE a
    # difference of log-probabilities of this size: it inherits their
    # error in absolute terms
    acc_tol = 2 * ELBO_RTOL * float(np.max(np.abs(ref["log_prob"])))
    print(f"{name} fed the JAX draws: {kw}: acceptance {res.acceptance!r} "
          f"(jax {ref['acceptance']!r}), log-probs "
          f"{res.log_prob[-1].tolist()}", flush=True)

    cfg = HMC_RUN if algorithm == "hmc" else NUTS_RUN
    run = {**HMC, **cfg}
    g = fitted_headline(pkg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    before = dict(ck.LAUNCHES)
    user, wall = _timed(torch, lambda: g.mcmc(
        priors, p0=g.get_parameters(), sampler="hmc", **run))
    launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = run["n_warmup"] + run["niter"]
    chains = run["n_chains"]
    # one gradient call per leapfrog step, and per step one more (HMC:
    # the trajectory's first gradient; NUTS: the tree's start)
    row_grads = launched["kernel_matrix_grad"] // 4
    leapfrog = row_grads - chains * steps
    print(f"{name} mcmc(sampler='hmc', {cfg}, {HMC}) on the card: "
          f"{steps} steps of {chains} chains in {wall:.3f} s "
          f"({steps / wall:.3f} steps per second, "
          f"{leapfrog / chains / wall:.3f} leapfrog steps per second per "
          f"chain, {leapfrog / (chains * steps):.3f} leapfrog steps per "
          f"chain and step; the initial fit included), acceptance "
          f"{user.acceptance:.4f}, step size {user.step_size!r}, max "
          f"log-prob {float(np.max(user.log_prob)):.4f}, peak device memory "
          f"{peak:.3f} GiB, launches {launched}; one 4-row gradient call "
          f"{1e3 * grad_wall:.3f} ms (phase 21)", flush=True)
    checks = [
        ("chain vs jax", chain_err <= STATE_TOL,
         f"{chain_err:.3e} (limit {STATE_TOL})"),
        ("log-probs vs jax", lp_err <= ELBO_RTOL,
         f"max rel {lp_err:.3e} (limit {ELBO_RTOL})"),
        ("acceptance vs jax", acc_err <= acc_tol,
         f"|diff| {acc_err:.3e} (limit {acc_tol:.3e})"),
        ("step size vs jax", res.step_size == ref["step_size"],
         f"{res.step_size!r}"),
        ("user's chain shape", user.chain.shape ==
         (run["niter"], chains, len(g.parameters_dict)),
         f"{user.chain.shape}"),
        ("user's log-probs finite", bool(np.all(np.isfinite(
            user.log_prob))), f"{user.log_prob.shape}"),
        ("user's acceptance in [0, 1]", 0 <= user.acceptance <= 1,
         f"{user.acceptance:.4f}"),
        ("user's step size finite and positive",
         bool(np.isfinite(user.step_size) and user.step_size > 0),
         f"{user.step_size!r}"),
    ]
    if algorithm == "hmc":
        expect = 4 * chains * steps * (run["n_leapfrog"] + 1)
        checks.append(("B1' launches", launched["kernel_matrix_grad"] ==
                       expect, f"{launched['kernel_matrix_grad']} vs "
                       f"{expect}"))
    _check(name, checks)


def phase_search(torch, pkg, oracle, ck):
    """``multistart_optimize`` (adam and nm) and the nonparametric
    ``ELBOcalc`` of the headline model on the card against the cached JAX
    results; wall times and B1 launches."""
    from gpyrn_tpu_torch.inference import nonparametric
    from gpyrn_tpu_torch.parallel.multistart import multistart_optimize
    checks = []
    for name, cfg in (("adam", MULTISTART), ("nm", MULTISTART_NM)):
        ref = oracle["multistart"][name]
        g = headline_problem(pkg, device="cuda")
        before = dict(ck.LAUNCHES)
        res, wall = _timed(torch, lambda: multistart_optimize(g, **cfg))
        launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
        e_err = float(np.max(np.abs(res["restart_elbos"] -
                                    ref["restart_elbos"]) /
                             np.abs(ref["restart_elbos"])))
        x_err = _x_rel(res["theta"], ref["theta"])
        print(f"multistart {cfg}: {wall:.3f} s (the final ELBOcalc "
              f"included), winner {res['winner']}, restart ELBOs "
              f"{np.asarray(res['restart_elbos']).tolist()}, launches "
              f"{launched}", flush=True)
        checks += [
            (f"{name}: restart ELBOs vs jax", e_err <= ELBO_RTOL,
             f"max rel {e_err:.3e} (limit {ELBO_RTOL})"),
            (f"{name}: winner vs jax", res["winner"] == ref["winner"],
             f"{res['winner']} vs {ref['winner']}"),
            (f"{name}: winner's theta vs jax", x_err <= THETA_RTOL,
             f"max rel {x_err:.3e} (limit {THETA_RTOL})"),
            (f"{name}: ELBO at the winner vs jax",
             _rel(res["elbo"], ref["elbo"]) <= ELBO_RTOL,
             f"rel {_rel(res['elbo'], ref['elbo']):.3e}")]
        if name == "nm":
            checks.append(("nm: nit vs jax", np.asarray(res["nit"]).tolist()
                           == ref["nit"], f"{np.asarray(res['nit'])}"))

    ref = oracle["npv"]
    g = headline_problem(pkg, device="cuda")
    npv = npv_problem(nonparametric, g, NPV)
    before = ck.LAUNCHES["kernel_matrix"]
    (elbo, mu, std), wall = _timed(torch, lambda: npv.ELBOcalc(
        g.nodes, g.weights, g.means, g.jitters, iterations=NPV["iterations"],
        seed=NPV["seed"]))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    traj_err = float(np.max(np.abs(npv._traj - ref["traj"]) /
                            np.abs(ref["traj"])))
    mu_err = _rel_state_err(mu[:, ::ref["stride"]], ref["mu"])
    print(f"nonparametric ELBOcalc {NPV}, d={npv.d}: {wall:.3f} s, ELBO "
          f"{elbo!r} (jax {ref['elbo']!r}), B1 launches {launched}",
          flush=True)
    checks += [
        ("npv: ELBO vs jax", _rel(elbo, ref["elbo"]) <= ELBO_RTOL,
         f"rel {_rel(elbo, ref['elbo']):.3e} (limit {ELBO_RTOL})"),
        ("npv: trajectory vs jax", traj_err <= ELBO_RTOL,
         f"max rel {traj_err:.3e}"),
        ("npv: means vs jax", mu_err <= STATE_TOL, f"{mu_err:.3e}"),
        ("npv: std-devs vs jax", _x_rel(std, ref["std"]) <= STATE_TOL,
         f"max rel {_x_rel(std, ref['std']):.3e}"),
        ("npv: B1 launches (one lattice per fit)", launched == 4,
         f"{launched}")]
    _check("search", checks)


# ---- the large-N stack (phases 25-28, ``chip_smoke.py --large``) ----------

# lean against dense on the card from one state: the same map, one GP at a
# time against a batch (measured on an H100 at N=10,000: ELBO 6e-15, state
# 4.5e-11)
LEAN_DENSE_RTOL = 1e-10
# the lean float64 sweep against the JAX package's on the CPU, as the fit
# path's limits (phases 6-7)
LEAN_JAX_RTOL = {"elbo": 1e-9, "state": 1e-7}
# three float32 sweeps from one start: the card's lean engine against its
# dense one and against the JAX package's float32 lean engine on the CPU.
# The exact-nugget map is ill-conditioned at N=2000 and float32 rounding
# of one build against another already moves mu by some 1e-3 (measured on
# an H100: 3.3e-3 against the dense engine, 4.7e-3 against the JAX
# package; var 6e-5 and 2e-5)
LEAN_FIT32_TOL = 2e-2
# B1 against its plain version on a slab of rows at N=20,000, as phase 8
B1_SLAB_TOL = {"float64": (1e-12, 1e-14), "float32": (2e-6, 1e-6)}
# kernel_matvec against the float64 dense slab: float32 sums of 50,000
# terms (relative to max |y|), and float64
MATVEC_SLAB_TOL = {"float32": 1e-4, "float64": 1e-12}
# the shell's mixed fit with fit_method='cg' against the JAX package's,
# both polished to the float64 fixed point: 30 float32 CG sweeps leave
# each runtime mid-ascent at its own rounding (3 float64 sweeps after them
# left the card 1.2e-3 from the JAX package on an H100), the converged
# polish lands both on one fixed point (phase 11 measured 8.6e-13 at
# N=1000)
CG_MIXED_RTOL = 1e-9
# predict_iterative against the dense predict at CG tol 1e-8, relative to
# max |mean| and max |std| (measured on an H100: 6.6e-9 and 6.0e-9)
PREDICT_TOL = 1e-6
# LOVE's variances come from a projection of A⁻¹ onto a Krylov space,
# which can only lower the variance reduction, and the combine formula is
# increasing in every lattice variance: its std is never below the CG
# solves' (up to their own error, relative to max |std|); its mean is the
# same CG solve's
# SVI: batch_p = p and κ = 0 is coordinate ascent: with the outputs drawn
# in their own order, the lean engine's sweeps (the same update per GP,
# summed in the same order; 0 on the CPU); with the default draws, whose
# permutations sum the outputs in another order, the dense fit_state
# within the JAX package's own bar (tests/test_svi.py:58-75); fed the JAX
# subsets, the JAX package's run (float64 on both sides)
SVI_EXACT_TOL = 1e-12
SVI_PERMUTED_TOL = 1e-10
SVI_JAX_TOL = 1e-9


def _measured(torch, fn):
    """(result, seconds, peak GiB above what was allocated before) of one
    call on the card."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, dt = _timed(torch, fn)
    return out, dt, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _start(torch, g, dtype):
    """(theta, t, y, yerr2, mu0, var0) of ``g`` in ``dtype``, from the
    heuristic start."""
    theta = g._theta().to(dtype)
    t, y, yerr2 = (x.to(dtype) for x in g._data())
    mu0, var0 = g.engine.init_mu_var(theta, y)
    return theta, t, y, yerr2, mu0, var0


def _all_finite(torch, *xs):
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


def phase_lean_check(torch, pkg, oracle, ck):
    """25(a): one lean float64 sweep and three float32 ones at N=2000,
    against the cached JAX values and the card's dense engine."""
    ref = oracle["lean"]
    g = headline_problem(pkg, N=LEAN_CHECK_N, device="cuda")
    eng = g.engine
    a64 = _start(torch, g, torch.float64)
    before = ck.LAUNCHES["kernel_matrix"]
    (e, mu, var), wall = _timed(torch, lambda: eng.elbo_refine_lean(*a64, 1))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    e_d, mu_d, var_d = eng.elbo_refine(*a64, 1)
    a32 = _start(torch, g, torch.float32)
    (mu32, var32, it32, _), wall32 = _timed(
        torch, lambda: eng.fit_state_lean(*a32, LEAN_FIT32_SWEEPS, 0.0))
    mu32_d, var32_d, _, _ = eng.fit_state(*a32, LEAN_FIT32_SWEEPS, 0.0)
    summary = state_summary(mu.cpu().numpy(), var.cpu().numpy(),
                            ref["stride"])
    summary32 = state_summary(mu32.double().cpu().numpy(),
                              var32.double().cpu().numpy(), ref["stride"])
    print(f"lean N={LEAN_CHECK_N}: elbo_refine_lean(1) {float(e)!r} in "
          f"{wall:.3f} s (the first B1 launch of this process included), "
          f"dense {float(e_d)!r}, jax {ref['refine']['elbo']!r}; "
          f"fit_state_lean float32 {it32} sweeps {wall32:.3f} s", flush=True)
    checks = [("B1 launches (one per GP)", launched == 4, f"{launched}"),
              ("ELBO lean vs jax",
               _rel(float(e), ref["refine"]["elbo"]) <= LEAN_JAX_RTOL["elbo"],
               f"rel {_rel(float(e), ref['refine']['elbo']):.3e}"),
              ("ELBO lean vs dense", _rel(float(e), float(e_d))
               <= LEAN_DENSE_RTOL, f"rel {_rel(float(e), float(e_d)):.3e}")]
    for key, got, dense in (("mu", mu, mu_d), ("var", var, var_d)):
        err = _rel_state_err(summary[key], ref["refine"][key])
        checks.append((f"{key} lean vs jax", err <= LEAN_JAX_RTOL["state"],
                       f"{err:.3e}"))
        err = _rel_state_err(got.cpu().numpy(), dense.cpu().numpy())
        checks.append((f"{key} lean vs dense", err <= LEAN_DENSE_RTOL,
                       f"{err:.3e}"))
    for key, got, dense in (("mu", mu32, mu32_d), ("var", var32, var32_d)):
        err = _rel_state_err(summary32[key], ref["fit_state32"][key])
        checks.append((f"float32 {key} lean vs jax", err <= LEAN_FIT32_TOL,
                       f"{err:.3e}"))
        err = _rel_state_err(got.double().cpu().numpy(),
                             dense.double().cpu().numpy())
        checks.append((f"float32 {key} lean vs dense",
                       err <= LEAN_FIT32_TOL, f"{err:.3e}"))
    _check("lean, N=2000", checks)


def _dense_reckoning(torch, spec, N):
    """The bytes of the dense engine's lattice (one N×N float64 matrix per
    GP) and the card's free memory, printed before the dense call."""
    n_gp = spec.q * (spec.p + 1)
    lattice = n_gp * N * N * 8
    free, total = torch.cuda.mem_get_info()
    print(f"dense N={N}: the lattice of {n_gp} kernel matrices is "
          f"{lattice / 2 ** 30:.2f} GiB (float64); the card has "
          f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free", flush=True)
    return lattice, free


def phase_lean_vs_dense(torch, pkg, ck):
    """25(b): one float64 sweep of the dense and of the lean engine from
    one state, s/sweep (the faster of two calls) and peak, headline and
    flagship; returns the rows."""
    from gpyrn_tpu_torch.models import gprn
    rows = []
    for name in ("headline", "flagship"):
        for N in LEAN_COMPARE_NS:
            g = PROBLEMS[name](pkg, N=N, device="cuda")
            eng = g.engine
            a = _start(torch, g, torch.float64)
            _dense_reckoning(torch, eng.spec, N)
            row = {"model": name, "N": N}
            out = {}
            for which, fn in (
                    ("dense", lambda: eng.elbo_refine(*a, 1)),
                    ("lean", lambda: eng.elbo_refine_lean(*a, 1)),
                    ("dense_updates", lambda: eng.fit_state(*a, 1, 0.0)),
                    ("lean_updates", lambda: eng.fit_state_lean(*a, 1,
                                                                0.0))):
                runs = [_measured(torch, fn) for _ in range(2)]
                out[which] = runs[0][0]
                row[which] = {"s_per_sweep": min(r[1] for r in runs),
                              "walls": [r[1] for r in runs],
                              "peak_gib": max(r[2] for r in runs)}
            saved = gprn.BATCHED_SOLVE_MAX_N
            if saved < N <= MAGMA_BATCHED_SOLVE_MAX_N:
                # the dense sweep again with MAGMA's batched solves, beside
                # the one-matrix-at-a-time solves the engine takes above
                # BATCHED_SOLVE_MAX_N
                gprn.BATCHED_SOLVE_MAX_N = N
                try:
                    runs = [_measured(torch, lambda: eng.elbo_refine(*a, 1))
                            for _ in range(2)]
                finally:
                    gprn.BATCHED_SOLVE_MAX_N = saved
                row["dense_batched_solves"] = {
                    "s_per_sweep": min(r[1] for r in runs),
                    "walls": [r[1] for r in runs]}
            e_rel = _rel(float(out["lean"][0]), float(out["dense"][0]))
            s_err = _rel_state_err(out["lean"][1].cpu().numpy(),
                                   out["dense"][1].cpu().numpy())
            row["ratio"] = row["lean"]["s_per_sweep"] / \
                row["dense"]["s_per_sweep"]
            print(f"lean vs dense {json.dumps(row)}; ELBO rel {e_rel:.3e}, "
                  f"state {s_err:.3e}", flush=True)
            _check(f"lean vs dense, {name} N={N}", [
                ("same ELBO", e_rel <= LEAN_DENSE_RTOL, f"rel {e_rel:.3e}"),
                ("same state", s_err <= LEAN_DENSE_RTOL, f"{s_err:.3e}")])
            rows.append(row)
            del g, eng, a, out
    # torch's batched cholesky_solve (MAGMA) at the sizes around
    # MAGMA_BATCHED_SOLVE_MAX_N, each in a process of its own (a failed
    # launch can leave the context unusable): a reading of the library,
    # the reason for BATCHED_SOLVE_MAX_N
    magma = {}
    for N in (MAGMA_BATCHED_SOLVE_MAX_N, MAGMA_BATCHED_SOLVE_MAX_N + 1000):
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                MAGMA_ARG, str(N)], capture_output=True,
                               text=True)
        magma[N] = "ran" if child.returncode == 0 else \
            f"failed (exit {child.returncode}: " \
            f"{(child.stderr.strip().splitlines() or [''])[-1][:80]})"
    print(f"torch.cholesky_solve on a batch of 3 (MAGMA): {magma}",
          flush=True)
    return rows, magma


def magma_batched_solve(torch, N):
    """One batched ``torch.cholesky_solve`` of 3 identity factors at N on
    the card (a child process of phase 25(b))."""
    L = torch.eye(N, dtype=torch.float64, device="cuda").expand(
        3, N, N).contiguous()
    b = torch.ones((3, N, 1), dtype=torch.float64, device="cuda")
    x = torch.cholesky_solve(b, L)
    torch.cuda.synchronize()
    assert float(x.sum()) == 3 * N


def phase_lean_wide(torch, pkg, ck, lin, state):
    """25(c): the lean engines at N=20,000, then ``ELBOcalc`` there; B1
    against its plain version on a slab and its device time (uncounted).
    Leaves the float64 starting state in ``state``."""
    from gpyrn_tpu_torch.inference import meanfield
    N, n_k = LEAN_WIDE_N, 4
    g = headline_problem(pkg, N=N, device="cuda")
    eng = g.engine
    a32 = _start(torch, g, torch.float32)
    a64 = _start(torch, g, torch.float64)
    results, checks = {}, []
    for label, fn, builds in (
            ("fit_state_lean float32", lambda: eng.fit_state_lean(
                *a32, LEAN_WIDE["fit32_sweeps"], 0.0),
             LEAN_WIDE["fit32_sweeps"]),
            ("elbo_fit_lean float64", lambda: eng.elbo_fit_lean(
                *a64, LEAN_WIDE["elbo_fit_iters"]),
             LEAN_WIDE["elbo_fit_iters"]),
            ("elbo_refine_lean float64", lambda: eng.elbo_refine_lean(
                *a64, LEAN_WIDE["refine_sweeps"]),
             LEAN_WIDE["refine_sweeps"])):
        before = ck.LAUNCHES["kernel_matrix"]
        out, wall, peak = _measured(torch, fn)
        launched = ck.LAUNCHES["kernel_matrix"] - before
        finite = _all_finite(torch, *[x for x in out
                                      if isinstance(x, torch.Tensor)])
        results[label] = {"s_per_sweep": wall / builds, "wall": wall,
                          "peak_gib": peak, "launches": launched}
        print(f"N={N} {label}: {wall:.3f} s ({wall / builds:.3f} s per "
              f"sweep), peak {peak:.3f} GiB, B1 launches {launched}",
              flush=True)
        checks += [(f"{label} finite", finite, ""),
                   (f"{label} B1 launches", launched == n_k * builds,
                    f"{launched} vs {n_k} x {builds}")]
        del out
    before = ck.LAUNCHES["kernel_matrix"]
    (elbo, _, _, n_iter), wall = _timed(
        torch, lambda: g.ELBOcalc(max_iter=LEAN_WIDE["elbo_fit_iters"]))
    launched = ck.LAUNCHES["kernel_matrix"] - before
    print(f"N={N} ELBOcalc(max_iter={LEAN_WIDE['elbo_fit_iters']}): "
          f"{elbo!r} in {wall:.3f} s, B1 launches {launched} (LEAN_N "
          f"{meanfield.LEAN_N})", flush=True)
    checks += [("ELBOcalc takes the lean route (one build per GP and "
                "sweep)", launched == n_k * n_iter and N >= meanfield.LEAN_N,
                f"{launched} vs {n_k} x {n_iter}"),
               ("ELBOcalc finite", np.isfinite(elbo), "")]
    _check(f"lean, N={N}", checks)
    state["wide"] = (g, a64)
    # B1 against its plain version and timed: launches of the comparison,
    # not of the path, so the counts are put back afterwards
    saved = dict(ck.LAUNCHES)
    results["b1"] = b1_wide(torch, ck, lin, a64[1])
    ck.LAUNCHES.update(saved)
    return results


def b1_wide(torch, ck, lin, t64):
    """B1 at N=20,000 (the headline node, QP): a slab of rows against the
    plain formula, then its device time in float64 and float32 against
    its bytes bound and the plain version's time on the slab."""
    from gpyrn_tpu_torch.ops import _build, kernels
    g_pars = (1.0, 30.0, 20.0, 0.7)
    out = {}
    N = t64.shape[0]
    rows = torch.arange(0, N, N // SLAB_ROWS, device="cuda")[:SLAB_ROWS]
    for dtype in (torch.float64, torch.float32):
        t = t64.to(dtype)
        params = torch.tensor(g_pars, dtype=dtype, device="cuda")
        K = lin.kernel_matrix(("QP",), params, t)
        jitter = ck._jitter(("QP",), params, t, lin.TRAIN_NUGGET,
                            lin.F32_JITTER_MULT)
        slab = kernels.evaluate(("QP",), params,
                                r=t[rows][:, None] - t[None, :])
        slab[torch.arange(rows.shape[0], device="cuda"), rows] += jitter
        err = float((K[rows] - slab).abs().max())
        rtol, atol = B1_SLAB_TOL[_dtype_name(dtype)]
        ok = bool(((K[rows] - slab).abs() <= atol + rtol * slab.abs()).all())
        del K
        ms = _device_ms(torch, lambda: lin.kernel_matrix(("QP",), params, t),
                        3, "kernel_matrix_kernel")
        plain_slab_ms = _device_ms(torch, lambda: kernels.evaluate(
            ("QP",), params, r=t[rows][:, None] - t[None, :]), 3)
        item = t.element_size()
        bound_ms, bound_by = _bound(
            item * (N + 5 + N * N),
            OPS_PER_LAG["kernel_matrix"] * N * (N + 1) // 2, dtype)
        per, pipe_ms = _pipe_bound(_build, "kernel_matrix_kernel", dtype,
                                   N * (N + 1) // 2)
        print(f"B1 QP N={N} {_dtype_name(dtype)}: FP-pipe bound {pipe_ms} "
              f"ms ({per} instructions a lag)", flush=True)
        out[_dtype_name(dtype)] = {
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "pipe_bound_ms": pipe_ms, "pipe_instructions_per_lag": per,
            "slab_max_abs_err": err,
            "plain_ms_per_256_rows": plain_slab_ms,
            "plain_ms_reckoned_from_slab": plain_slab_ms * N / SLAB_ROWS}
        print(f"B1 QP N={N} {_dtype_name(dtype)}: {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), at {bound_ms / ms:.3f} of "
              f"it; slab of {SLAB_ROWS} rows vs plain max abs err "
              f"{err:.3e}; plain formula {plain_slab_ms:.4f} ms per slab",
              flush=True)
        _check(f"B1 N={N} {_dtype_name(dtype)}", [
            ("slab vs plain", ok, f"max abs err {err:.3e} (rtol {rtol}, "
             f"atol {atol})")])
    return out


# 26: B1's product entry against its plain version (relative to max |y|,
# MATVEC_SLAB_TOL) and timed at m = 1 (CG), 8 (the register path's widest
# instance), 16 (the tiled path's narrowest tile), 64 (predict_iterative's
# default rhs_chunk) and PREDICT_RHS_CHUNK (phase 28's variance solves),
# beside its bounds, its plain version and a yardstick the port never
# calls: B1's slab entry and torch.matmul over the same row chunks
MATVEC_COLS = (1, 8, 16, 64, PREDICT_RHS_CHUNK)
MATVEC_CHUNK = 2048


def _slab_yardstick(torch, ck, s, pars, t, v, nug, chunk=MATVEC_CHUNK):
    """(K + nug·I) @ v as B1's slab entry (the nugget on its diagonal) and
    ``torch.matmul``, ``chunk`` rows at a time: K is written and read."""
    N = t.shape[0]
    jit = t.new_full((), nug)
    return torch.cat([
        ck.kernel_matrix_slab_cuda(s, pars, t, N, r0, min(chunk, N - r0),
                                   jit) @ v
        for r0 in range(0, N, chunk)])


def matvec_bounds(_build, ck, N, m, dtype, n_params):
    """The product entry's bounds (ms) for N rows and m columns, counting
    only the work the function needs: the bytes of t, V and y; each element
    of K evaluated once (its FP-pipe instructions from the SASS,
    ``pipe_per_element``); the product's N² m fmas.  Register path (m <=
    MATVEC_CAP): the evaluations and the fmas on the FP pipe.  Above it:
    in float64 the product's 2 N² m FLOP on the FP64 tensor cores, beside
    the one evaluation on the FP64 pipe (another unit: the larger binds);
    in float32 both on the one FP32 pipe, added.  ``bound_ms`` is the
    larger of the bytes and operations bounds.  Beside them, as
    diagnostics of the kernel's own overhead, never as its bound: the
    tiled path's evaluations of K as its tiling makes them, ceil(m / bn)
    (``matvec_tile_cols``), and their time on the pipe; the register
    path's SASS issue time, every instruction of its inner loop per
    element (``issue_per_element``) at the issue rate.  Without cuobjdump,
    the element's counted operations (OPS_PER_LAG) stand in for the
    SASS."""
    name = _dtype_name(dtype)
    e = 4 if name == "float32" else 8
    t_bytes = 1e3 * e * (N + 2 * N * m + n_params + 1) / HBM_BYTES_PER_S
    per = pipe_per_element(_build).get(("kernel_matrix_slab_kernel", name))
    rec = {"bytes_ms": t_bytes, "pipe_instructions_per_element": per}
    eval_ms = 1e3 * N * N * (
        OPS_PER_LAG["kernel_matrix"] / PEAK_FLOPS[name] if per is None
        else per / PIPE_INSTR_PER_S[name])
    fma_ms = 1e3 * N * N * m / PIPE_INSTR_PER_S[name]
    rec["eval_bound_ms"] = eval_ms
    if m <= ck.MATVEC_CAP:
        ops_ms = eval_ms + fma_ms
        issue = issue_per_element(_build).get(
            (name, 1 if m == 1 else ck.MATVEC_CAP))
        rec["sass_issue_ms"] = (None if issue is None else
                                1e3 * N * N * issue[0] / issue[2]
                                / ISSUE_PER_S)
    else:
        evals = -(-m // ck.matvec_tile_cols(m, dtype))
        if name == "float64":
            rec["tensor_bound_ms"] = 1e3 * 2 * N * N * m / TENSOR_FP64_FLOPS
            ops_ms = max(rec["tensor_bound_ms"], eval_ms)
        else:
            ops_ms = fma_ms + eval_ms
        rec.update(design_evaluations=evals,
                   design_eval_ms=evals * eval_ms)
    rec["pipe_bound_ms"] = ops_ms
    rec["bound_ms"], rec["bound_by"] = ((t_bytes, "bytes") if t_bytes >= ops_ms
                                        else (ops_ms, "operations"))
    return rec


def matvec_timed(torch, ck, s, pars, t, nug, m):
    """B1's product entry on N = len(t) rows and m random columns against
    its plain version (max abs and relative error), then timed in turns
    (kernel, plain, yardstick, kernel; CUDA events), with its bounds
    (``matvec_bounds``)."""
    from gpyrn_tpu_torch.ops import _build
    N = t.shape[0]
    v = torch.tensor(np.random.default_rng(m).standard_normal((N, m)),
                     dtype=t.dtype, device="cuda")

    def kern():
        return ck.kernel_matvec_cuda(s, pars, t, v, nug)

    def plain():
        return ck.kernel_matvec_ref(s, pars, t, v, nug, MATVEC_CHUNK)

    def yard():
        return _slab_yardstick(torch, ck, s, pars, t, v, nug)

    y, ref = kern(), plain()
    err = float((y - ref).abs().max())
    rel = err / float(ref.abs().max())
    y_err = float((yard() - ref).abs().max() / ref.abs().max())
    del y, ref
    reps = 5 if m <= ck.MATVEC_CAP else 2
    ms_a = _time_ms(torch, kern, reps)
    plain_ms = _time_ms(torch, plain, reps)
    yard_ms = _time_ms(torch, yard, reps)
    ms_b = _time_ms(torch, kern, reps)
    rec = matvec_bounds(_build, ck, N, m, t.dtype, pars.shape[0])
    ms = min(ms_a, ms_b)
    path = "register" if m <= ck.MATVEC_CAP else (
        f"tiled, {rec['design_evaluations']} evaluations of K")
    extra = f"one evaluation {rec['eval_bound_ms']:.4f} ms" + (
        f", tensor cores {rec['tensor_bound_ms']:.4f} ms"
        if "tensor_bound_ms" in rec else "")
    extra += (f"; overhead: SASS issue {rec['sass_issue_ms']} ms"
              if m <= ck.MATVEC_CAP else
              f"; overhead: the tiling's {rec['design_evaluations']} "
              f"evaluations {rec['design_eval_ms']:.4f} ms")
    print(f"product entry QP N={N} m={m} {_dtype_name(t.dtype)} ({path}): "
          f"{ms:.4f} ms ({ms_a:.4f}/{ms_b:.4f}), plain {plain_ms:.4f} ms, "
          f"yardstick (slab entry + matmul) {yard_ms:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel at "
          f"{rec['bound_ms'] / ms:.3f} of it; operations bound "
          f"{rec['pipe_bound_ms']:.4f} ms ({rec['pipe_instructions_per_element']}"
          f" FP-pipe instructions an element), {extra}; bytes "
          f"{rec['bytes_ms']:.4f} ms; vs plain max abs {err:.3e}, rel "
          f"{rel:.3e}; yardstick rel {y_err:.3e}", flush=True)
    torch.cuda.empty_cache()
    return {"N": N, "m": m, "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "yardstick_ms": yard_ms,
            "library_ms": None, **rec}


def _counts(ck):
    """The launch counts and the product entry's instance counts, to put
    back after comparison and timing launches (``_put_back``)."""
    return dict(ck.LAUNCHES), dict(ck.MATVEC_INSTANCES)


def _put_back(ck, counts):
    ck.LAUNCHES.update(counts[0])
    ck.MATVEC_INSTANCES.clear()
    ck.MATVEC_INSTANCES.update(counts[1])


def _solve_problem(torch, dtype):
    rng = np.random.default_rng(1)
    t = torch.tensor(np.sort(rng.uniform(0, 1000, SOLVE_N)), dtype=dtype,
                     device="cuda")
    b = torch.tensor(rng.standard_normal(SOLVE_N), dtype=dtype,
                     device="cuda")
    return t, torch.tensor(SOLVE_PARS, dtype=dtype, device="cuda"), b


def phase_solve(torch, pkg, ck):
    """26: the matrix-free solve at N=50,000, every matvec B1's product
    entry; the entry against its plain version and a float64 slab of K,
    and timed."""
    from gpyrn_tpu_torch.ops import iterative as it
    from gpyrn_tpu_torch.ops import kernels
    t, pars, b = _solve_problem(torch, torch.float32)
    t64, pars64, b64 = (x.double() for x in (t, pars, b))
    s, nug = ("QP",), SOLVE_NUGGET
    out, checks = {}, []
    # comparison and timing launches, not the path's: the counts are put
    # back afterwards
    saved = _counts(ck)
    # kernel_matvec against a float64 dense slab of K
    rows = torch.arange(0, SOLVE_N, SOLVE_N // SLAB_ROWS,
                        device="cuda")[:SLAB_ROWS]
    slab = kernels.evaluate(s, pars64, r=t64[rows][:, None] - t64[None, :])
    y_ref = slab @ b64 + nug * b64[rows]
    for dtype, tt, pp, bb in ((torch.float32, t, pars, b),
                              (torch.float64, t64, pars64, b64)):
        y = it.kernel_matvec(s, pp, tt, bb, nugget=nug)
        err = float((y[rows].double() - y_ref).abs().max()
                    / y_ref.abs().max())
        tol = MATVEC_SLAB_TOL[_dtype_name(dtype)]
        checks.append((f"kernel_matvec {_dtype_name(dtype)} vs float64 "
                       f"slab", err <= tol, f"rel {err:.3e} (limit {tol})"))
    matvec_ms = {_dtype_name(dt): _device_ms(
        torch, lambda: it.kernel_matvec(s, pp, tt, bb, nugget=nug), 3)
        for dt, tt, pp, bb in ((torch.float32, t, pars, b),
                               (torch.float64, t64, pars64, b64))}
    out["matvec_ms"] = matvec_ms
    # the plain version's row chunk trades memory for speed with the same
    # results
    out["matvec_ms_by_chunk"] = {chunk: _device_ms(
        torch, lambda chunk=chunk: ck.kernel_matvec_ref(s, pars, t, b, nug,
                                                        chunk), 3)
        for chunk in (1024, 2048, 4096)}
    print(f"kernel_matvec_ref (plain) N={SOLVE_N} float32 by row chunk: "
          f"{out['matvec_ms_by_chunk']} ms", flush=True)
    # its bound: N² kernel evaluations and a multiply-add each; bytes of
    # t, v and y
    n_ops = (OPS_PER_LAG["kernel_matrix"] + 2) * SOLVE_N * SOLVE_N
    out["matvec_bound"] = {
        _dtype_name(dt): _bound(3 * SOLVE_N * e, n_ops, dt)
        for dt, e in ((torch.float32, 4), (torch.float64, 8))}
    print(f"kernel_matvec N={SOLVE_N}: {matvec_ms} ms per call, bound "
          f"{out['matvec_bound']}", flush=True)
    out["product"] = {}
    for dtype, tt, pp in ((torch.float32, t, pars),
                          (torch.float64, t64, pars64)):
        for m in MATVEC_COLS:
            rec = matvec_timed(torch, ck, s, pp, tt, nug, m)
            out["product"][f"{_dtype_name(dtype)} m={m}"] = rec
            checks.append((f"product entry {_dtype_name(dtype)} m={m} vs "
                           f"plain", rec["rel_err"]
                           <= MATVEC_SLAB_TOL[_dtype_name(dtype)],
                           f"rel {rec['rel_err']:.3e}"))
    _put_back(ck, saved)

    def mv(x):
        return it.kernel_matvec(s, pars, t, x, nugget=nug)

    (x, n_plain), wall = _timed(torch, lambda: it.cg_solve(mv, b,
                                                           **PLAIN_CG))
    out["plain"] = {"iters": n_plain, "wall": wall}
    print(f"plain CG {PLAIN_CG}: {n_plain} iterations, {wall:.3f} s, "
          f"matvec share {n_plain * matvec_ms['float32'] / 1e3 / wall:.3f}",
          flush=True)

    def pre_solve():
        U, _ = it.pivoted_cholesky(s, pars, t, PRE_CG["rank"], nugget=0.0)
        pre = it.split_precond(U, torch.full_like(t, nug))
        return it.cg_solve(mv, b, tol=PRE_CG["tol"],
                           maxiter=PRE_CG["maxiter"], precond_apply=pre,
                           refresh_every=PRE_CG["refresh_every"],
                           return_relres=True), pre

    ((x, n_pre, relres), pre), wall = _timed(torch, pre_solve)
    relres = float(relres)
    out["pre"] = {"iters": n_pre, "wall": wall, "relres": relres,
                  "met_tol": relres <= PRE_CG["tol"]}
    print(f"pivoted-Cholesky rank {PRE_CG['rank']} + split preconditioner "
          f"CG: {n_pre} iterations, {wall:.3f} s, true relres {relres:.3e} "
          f"(requested {PRE_CG['tol']}, met: {relres <= PRE_CG['tol']})",
          flush=True)

    def res64(x):
        return it.kernel_matvec(s, pars64, t64, x, nugget=nug)

    (xr, rel_ref), wall = _timed(torch, lambda: it.cg_refined(
        mv, res64, b64, precond_apply=pre, **REFINED))
    out["refined"] = {"relres": rel_ref, "wall": wall}
    print(f"cg_refined {REFINED} with the float64 kernel_matvec residual: "
          f"relres {rel_ref:.3e}, {wall:.3f} s", flush=True)
    checks += [("plain CG finite", _all_finite(torch, x), ""),
               ("preconditioned CG finite, relres finite",
                np.isfinite(relres), f"{relres:.3e}"),
               ("cg_refined below the float32 solve's relres",
                rel_ref < relres, f"{rel_ref:.3e} vs {relres:.3e}")]
    _check(f"solve, N={SOLVE_N}", checks)
    return out


def phase_cg_fit(torch, pkg, oracle, ck):
    """27: the CG fit at N=50,000, CG against lean at N=10,000, and the
    shell's fit_method='cg' against the cached JAX value."""
    from gpyrn_tpu_torch.models import cg_fit
    from gpyrn_tpu_torch.ops import iterative as it
    out, checks = {}, []
    g = headline_problem(pkg, N=CG_FIT_N, device="cuda")
    g.cg_tol = CG_FIT["cg_tol"]
    a32 = _start(torch, g, torch.float32)
    solves, matvecs = [], {}
    orig_solve, orig_matvec = cg_fit.cg_solve, cg_fit.kernel_matvec

    def counting_solve(*args, **kw):
        res = orig_solve(*args, **kw)
        solves.append(res[1])
        return res

    def counting_matvec(structure, *args, **kw):
        matvecs[structure] = matvecs.get(structure, 0) + 1
        return orig_matvec(structure, *args, **kw)

    cg_fit.cg_solve, cg_fit.kernel_matvec = counting_solve, counting_matvec
    try:
        (mu, var, n, _, rres), wall, peak = _measured(
            torch, lambda: g.cg_engine.fit_state_cg(*a32, CG_FIT["sweeps"],
                                                    1e-12))
    finally:
        cg_fit.cg_solve, cg_fit.kernel_matvec = orig_solve, orig_matvec
    rres = float(rres)
    # the matvecs' share of the fit: each structure's device ms per call
    # (one right-hand side, this fit's parameters) times its calls
    theta, t32 = a32[0], a32[1]
    cores = dict(zip(g.engine.spec.node_structs + g.engine.spec.weight_structs,
                     g.engine._lean_cores(theta)[0]
                     + g.engine._lean_cores(theta)[1]))
    saved = _counts(ck)            # timing launches, not the path's
    mv_ms = {s: _device_ms(torch, lambda s=s: it.kernel_matvec(
        s, cores[s], t32, t32[:, None], nugget=1e-6), 3) for s in matvecs}
    _put_back(ck, saved)
    share = sum(matvecs[s] * mv_ms[s] for s in matvecs) / 1e3 / wall
    out["fit"] = {"s_per_sweep": wall / n, "wall": wall, "relres": rres,
                  "peak_gib": peak, "cg_iters": solves,
                  "matvecs": {str(s): c for s, c in matvecs.items()},
                  "matvec_ms": {str(s): ms for s, ms in mv_ms.items()},
                  "matvec_share": share}
    print(f"CG fit N={CG_FIT_N}: {n} float32 sweeps, {wall:.3f} s "
          f"({wall / n:.3f} s per sweep), achieved relres {rres:.3e} "
          f"(cg_tol {CG_FIT['cg_tol']}), peak {peak:.3f} GiB, CG iterations "
          f"per solve {solves}; kernel_matvec calls {matvecs} at "
          f"{mv_ms} ms: {share:.3f} of the fit", flush=True)
    checks.append(("CG fit finite", _all_finite(torch, mu, var)
                   and np.isfinite(rres), f"{n} sweeps"))
    del g, a32, mu, var

    g = headline_problem(pkg, N=CG_LEAN_N, device="cuda")
    a64 = _start(torch, g, torch.float64)
    mu_l, var_l, _, _ = g.engine.fit_state_lean(*a64, 1, 0.0)
    (mu_c, var_c, _, _, rres_c), wall = _timed(
        torch, lambda: g.cg_engine.fit_state_cg(*a64, 1, 0.0))
    mu_rel = float((mu_c - mu_l).abs().max() / (1 + mu_l.abs().max()))
    var_rel = float((var_c - var_l).abs().max() / var_l.abs().max())
    out["vs_lean"] = {"mu_rel": mu_rel, "var_rel": var_rel, "wall": wall}
    print(f"CG vs lean N={CG_LEAN_N}, one float64 sweep: mu_rel "
          f"{mu_rel:.3e}, var_rel {var_rel:.3e} (CG sweep {wall:.3f} s, "
          f"relres {float(rres_c):.3e})", flush=True)
    checks += [("CG vs lean mu_rel", mu_rel <= CG_LEAN_TOL, f"{mu_rel:.3e}"),
               ("CG vs lean var_rel", var_rel <= CG_LEAN_TOL,
                f"{var_rel:.3e}")]
    del g, a64

    ref = oracle["lean"]["cg_mixed"]
    g = headline_problem(pkg, N=CG_MIXED["N"], device="cuda")
    g.fit_method = 'cg'
    for key in ("refine_sweeps", *CONVERGE):
        setattr(g, key, CG_MIXED[key])
    (elbo, _, _, n_iter), wall = _timed(torch, lambda: g.ELBOcalc(
        precision='mixed', max_iter=CG_MIXED["max_iter"]))
    print(f"ELBOcalc(precision='mixed', fit_method='cg') N={CG_MIXED['N']}: "
          f"{elbo!r} in {n_iter} sweeps, {wall:.3f} s, cg_achieved_relres "
          f"{g.cg_achieved_relres:.3e}; jax {ref['elbo']!r} in "
          f"{ref['n_iter']}, relres {ref['cg_achieved_relres']:.3e}",
          flush=True)
    checks += [("shell CG ELBO vs jax",
                _rel(elbo, ref["elbo"]) <= CG_MIXED_RTOL,
                f"rel {_rel(elbo, ref['elbo']):.3e} (limit {CG_MIXED_RTOL})"),
               ("cg_achieved_relres set", g.mixed_info["bulk"] == "cg" and
                np.isfinite(g.cg_achieved_relres), "")]
    out["shell"] = {"elbo": elbo, "wall": wall,
                    "relres": g.cg_achieved_relres}
    _check("CG fit", checks)
    return out


def phase_predict(torch, pkg, oracle, ck, state):
    """28: predict_iterative against the dense predict at N=5000 and
    timed at N=20,000, LOVE at N=20,000, prior samples at N=50,000, SVI."""
    from gpyrn_tpu_torch.models import iterative as tit
    from gpyrn_tpu_torch.models import svi
    out, checks = {}, []
    g = headline_problem(pkg, N=PREDICT_N, device="cuda")
    a64 = _start(torch, g, torch.float64)
    g._mu, g._var = a64[4:]
    iters, orig = [], tit.cg_solve

    def counting(*args, **kw):
        res = orig(*args, **kw)
        iters.append(res[1])
        return res

    tit.cg_solve = counting
    try:
        (ts, mean, std, _), wall = _timed(
            torch, lambda: tit.predict_iterative(
                g, nn=1000, rhs_chunk=PREDICT_RHS_CHUNK))
        heuristic_iters = list(iters)
        # the same means from a state 10 sweeps into the fit: its small
        # posterior variances condition A = K + diag(v) far worse
        g._mu, g._var = g.engine.fit_state(*a64, 10, 0.0)[:2]
        iters.clear()
        _, fit_wall = _timed(torch, lambda: tit.predict_iterative(
            g, nn=1000, variances=False))
        fitted_iters = list(iters)
    finally:
        tit.cg_solve = orig
    print(f"predict_iterative N={PREDICT_N}: CG iterations per solve from "
          f"the heuristic state {heuristic_iters}; the means alone from a "
          f"10-sweep state {fitted_iters} ({fit_wall:.3f} s)", flush=True)
    out["predict_5k_iters"] = {"heuristic": heuristic_iters,
                               "fitted_means": fitted_iters}
    g._mu, g._var = a64[4:]
    _, mean_d, std_d, _ = g.predict(nn=1000)
    e_mean = float((mean - mean_d).abs().max() / mean_d.abs().max())
    e_std = float((std - std_d).abs().max() / std_d.abs().max())
    print(f"predict_iterative N={PREDICT_N} nn=1000: {wall:.3f} s; against "
          f"the dense predict: mean {e_mean:.3e}, std {e_std:.3e}",
          flush=True)
    checks += [("predict_iterative mean vs dense", e_mean <= PREDICT_TOL,
                f"{e_mean:.3e}"),
               ("predict_iterative std vs dense", e_std <= PREDICT_TOL,
                f"{e_std:.3e}")]
    out["predict_5k"] = {"wall": wall, "mean_err": e_mean, "std_err": e_std}
    del g

    g, a64 = state.pop("wide")
    g._mu, g._var = a64[4], a64[5]
    (ts, mean, std, _), wall, peak = _measured(
        torch, lambda: tit.predict_iterative(g, nn=1000,
                                             rhs_chunk=PREDICT_RHS_CHUNK))
    out["predict_20k"] = {"wall": wall, "peak_gib": peak}
    print(f"predict_iterative N={LEAN_WIDE_N} nn=1000 rhs_chunk="
          f"{PREDICT_RHS_CHUNK}: {wall:.3f} s, peak {peak:.3f} GiB",
          flush=True)
    checks.append(("predict_iterative N=20,000 finite",
                   _all_finite(torch, mean, std), ""))
    love, wall_b = _timed(torch, lambda: tit.build_love(g, rank=LOVE_RANK))
    (_, mean_l, std_l, _), wall_p = _timed(torch, lambda: love.predict(
        nn=1000))
    e_mean = float((mean_l - mean).abs().max() / mean.abs().max())
    below = float((std - std_l).max() / std.abs().max())
    e_std = float((std_l - std).abs().max() / std.abs().max())
    out["love_20k"] = {"build": wall_b, "predict": wall_p,
                       "mean_err": e_mean, "std_err": e_std}
    print(f"LOVE N={LEAN_WIDE_N} rank {LOVE_RANK}: build {wall_b:.3f} s, "
          f"predict(nn=1000) {wall_p:.4f} s; against predict_iterative: "
          f"mean {e_mean:.3e}, std {e_std:.3e} (largest shortfall "
          f"{below:.3e})", flush=True)
    checks += [("LOVE mean vs predict_iterative", e_mean <= PREDICT_TOL,
                f"{e_mean:.3e}"),
               ("LOVE std not below predict_iterative's", below <=
                PREDICT_TOL, f"{below:.3e}"),
               ("LOVE finite", _all_finite(torch, mean_l, std_l), "")]
    del g, a64, love

    g = headline_problem(pkg, N=SAMPLE_N, device="cuda")
    (nodes, weights), wall = _timed(torch, lambda: tit.sample_iterative(
        g, rng=np.random.default_rng(0)))
    out["sample_50k"] = {"wall": wall}
    print(f"sample_iterative N={SAMPLE_N}: {wall:.3f} s, shapes "
          f"{nodes.shape} {weights.shape}", flush=True)
    checks.append(("samples finite", bool(np.isfinite(nodes).all() and
                                          np.isfinite(weights).all()),
                   f"{nodes.shape}, {weights.shape}"))
    del g

    g = headline_problem(pkg, N=SVI_N, device="cuda")
    a64 = _start(torch, g, torch.float64)
    spec = g.engine.spec
    full = svi.make_svi_fit(spec, spec.p)

    def full_err(draws, fit):
        mu_s, var_s = full.fit_state_svi(*a64, 4, 0, 5.0, 0.0, draws=draws)
        mu_f, var_f, _, _ = fit(*a64, 4, 0.0)
        return max(_rel_state_err(mu_s.cpu().numpy(), mu_f.cpu().numpy()),
                   _rel_state_err(var_s.cpu().numpy(), var_f.cpu().numpy()))

    e_full = full_err(np.tile(np.arange(spec.p), (4, 1)),
                      g.engine.fit_state_lean)
    e_perm = full_err(None, g.engine.fit_state)
    ref = oracle["lean"]["svi"]
    sv = svi.make_svi_fit(spec, ref["batch_p"])
    mu_j, var_j = sv.fit_state_svi(*a64, SVI_ORACLE["n_steps"],
                                   SVI_ORACLE["seed"], SVI_ORACLE["t0"],
                                   SVI_ORACLE["kappa"],
                                   draws=np.array(ref["subsets"]))
    summary = state_summary(mu_j.cpu().numpy(), var_j.cpu().numpy(),
                            ref["stride"])
    e_jax = max(_rel_state_err(summary["mu"], ref["mu"]),
                _rel_state_err(summary["var"], ref["var"]))
    print(f"SVI N={SVI_N}: batch_p = p, kappa 0: outputs in order against "
          f"fit_state_lean {e_full:.3e}, default draws against fit_state "
          f"{e_perm:.3e}; fed the JAX subsets against jax {e_jax:.3e}",
          flush=True)
    checks += [("SVI full batch is coordinate ascent (lean)",
                e_full <= SVI_EXACT_TOL, f"{e_full:.3e}"),
               ("SVI full batch, default draws, vs fit_state",
                e_perm <= SVI_PERMUTED_TOL, f"{e_perm:.3e}"),
               ("SVI on the JAX subsets vs jax", e_jax <= SVI_JAX_TOL,
                f"{e_jax:.3e}")]
    g = headline_problem(pkg, N=SVI_TIMED["N"], device="cuda")
    a32 = _start(torch, g, torch.float32)
    sv = svi.make_svi_fit(g.engine.spec, max(1, g.p // 4))
    (mu_t, _), wall = _timed(torch, lambda: sv.fit_state_svi(
        *a32, SVI_TIMED["n_steps"], 0, 5.0, 0.6))
    out["svi"] = {"steps_per_s": SVI_TIMED["n_steps"] / wall,
                  "full_batch_err": e_full, "permuted_err": e_perm,
                  "jax_err": e_jax}
    print(f"SVI N={SVI_TIMED['N']}: {SVI_TIMED['n_steps']} default steps in "
          f"{wall:.3f} s, {SVI_TIMED['n_steps'] / wall:.2f} steps per "
          f"second", flush=True)
    checks.append(("SVI steps finite", _all_finite(torch, mu_t), ""))
    _check("prediction and SVI", checks)
    return out


def large_main(torch, pkg, ck, lin):
    """Phases 25-28 in this process: the launch counts are set to 0 before
    the path and read after it (comparison launches leave them); the last
    line is the JSON record the parent reads."""
    with open(ORACLE) as f:
        oracle = json.load(f)
    state = {}
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    print("== phase 25(a): lean engines, headline model, N=2000", flush=True)
    phase_lean_check(torch, pkg, oracle, ck)
    print("== phase 25(b): dense against lean, one float64 sweep", flush=True)
    rows, magma = phase_lean_vs_dense(torch, pkg, ck)
    print(f"== phase 25(c): lean engines at N={LEAN_WIDE_N}", flush=True)
    wide = phase_lean_wide(torch, pkg, ck, lin, state)
    # B1's product entry's launches on each of phases 26-28 (the path's
    # count runs on; the phases put back their comparison launches)
    matvec = {}
    before = ck.LAUNCHES["kernel_matvec"]
    print(f"== phase 26: the matrix-free solve at N={SOLVE_N}", flush=True)
    solve = phase_solve(torch, pkg, ck)
    matvec["26"] = ck.LAUNCHES["kernel_matvec"] - before
    before = ck.LAUNCHES["kernel_matvec"]
    print("== phase 27: the CG fit", flush=True)
    cg = phase_cg_fit(torch, pkg, oracle, ck)
    matvec["27"] = ck.LAUNCHES["kernel_matvec"] - before
    before = ck.LAUNCHES["kernel_matvec"]
    print("== phase 28: prediction, samples and SVI", flush=True)
    pred = phase_predict(torch, pkg, oracle, ck, state)
    matvec["28"] = ck.LAUNCHES["kernel_matvec"] - before
    launches = dict(ck.LAUNCHES)
    wall = time.perf_counter() - t0
    print(f"large path launches: {launches} (kernel_matvec by phase "
          f"{matvec}); phases 25-28 took {wall:.1f} s", flush=True)
    _check("the product entry on phases 26-28", [
        (f"phase {k} launched kernel_matvec", v > 0, f"{v}")
        for k, v in matvec.items()])
    print(json.dumps({"launches": launches, "matvec_by_phase": matvec,
                      "instances": dict(ck.MATVEC_INSTANCES),
                      "lean_vs_dense": rows,
                      "magma_batched_solve": magma,
                      "wide": wide, "solve": solve, "cg": cg,
                      "predict": pred, "seconds": wall}), flush=True)


# ---- the Keplerian RV workflow and serving (phases 29-32) ---------------

SERVE_DIR = os.path.join(HERE, ".smoke_serving")


def _max_rel(a, b):
    """max |a - b| / max |b| of two arrays."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _host(x):
    return x.detach().cpu().numpy()


def phase_astro(torch, pkg, oracle):
    """``keplerian_rv`` on the card against the CPU and the cached JAX
    values at N=497 and 50,000 for each eccentricity, and its gradient with
    respect to (P, K, e, w, Tp) against the cached ``jax.grad``."""
    from gpyrn_tpu_torch.datasets import load_solar
    from gpyrn_tpu_torch.utils.astro import keplerian_rv
    ref = oracle["astro"]
    times = astro_times(load_solar()[0])
    n_small = min(ASTRO_NS)
    checks, ms = [], {}
    for e in ASTRO_ECCENTRICITIES:
        pars = astro_params(e)
        for n, t in times.items():
            t_gpu = torch.tensor(t, dtype=torch.float64, device="cuda")
            rv, wall = _timed(torch, lambda: keplerian_rv(t_gpu, *pars))
            rv = _host(rv)
            cpu = keplerian_rv(torch.tensor(t), *pars).numpy()
            stride = 1 if n == n_small else ref["stride"]
            jax_ref = ref["rv"][repr(e)][str(n)]
            ms[f"e={e} N={n}"] = 1e3 * wall
            checks += [
                (f"e={e} N={n} finite", bool(np.isfinite(rv).all()),
                 f"{rv.shape}"),
                (f"e={e} N={n} cuda vs cpu",
                 _max_rel(rv, cpu) <= ASTRO_CPU_RTOL,
                 f"{_max_rel(rv, cpu):.3e} (limit {ASTRO_CPU_RTOL})"),
                (f"e={e} N={n} cuda vs jax",
                 _max_rel(rv[::stride], jax_ref) <= ASTRO_JAX_RTOL,
                 f"{_max_rel(rv[::stride], jax_ref):.3e} "
                 f"(limit {ASTRO_JAX_RTOL})")]
        p = torch.tensor(pars, dtype=torch.float64, device="cuda",
                         requires_grad=True)
        t_gpu = torch.tensor(times[n_small], dtype=torch.float64,
                             device="cuda")
        rv = keplerian_rv(t_gpu, P=p[0], K=p[1], e=p[2], w=p[3], T=p[4])
        (grad,) = torch.autograd.grad(rv.sum(), p)
        err = _grad_error(_host(grad), ref["grad"][repr(e)])
        checks.append((f"e={e} gradient vs jax.grad", err <= ASTRO_GRAD_TOL,
                       f"{err:.3e} of max |g| (limit {ASTRO_GRAD_TOL})"))
    print("astro: keplerian_rv wall ms (first call of each, host clock to "
          "synchronize): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()),
          flush=True)
    _check("astro", checks)


def _mean_values_by_row(torch, eng, theta, t):
    """The engine's mean values as computed before the θ batch was
    evaluated in one pass: each row's means alone, stacked (the host-cost
    comparison of phase 30)."""
    from gpyrn_tpu_torch.models.gprn import unpack_parameters
    from gpyrn_tpu_torch.ops import means as means_mod
    out = []
    for row in theta:
        _, _, mean_p, _ = unpack_parameters(eng.spec, row)
        out.append(torch.stack([
            t.new_zeros(t.shape) if s is None
            else means_mod.evaluate(s, mp, t)
            for s, mp in zip(eng.spec.mean_structs, mean_p)]))
    return torch.stack(out)


def phase_solar(torch, pkg, oracle, ck):
    """The solar RV workflow on the card: a converged ``ELBOcalc``,
    ``predict(nn=1000)``, five ``optimize_adam`` steps and a 13-row
    ``elbo_fit_batch`` against the cached JAX values; the host's ms of the
    13-row mean values, in one pass and row by row."""
    ref = oracle["solar"]
    stride = ref["stride"]
    g = solar_problem(pkg, device="cuda")
    (elbo, mu, var, n_iter), dt_fit = _timed(torch, g.ELBOcalc)
    (_, mean, std, _), dt_pred = _timed(
        torch, lambda: g.predict(nn=SOLAR_NN))
    summary = state_summary(_host(mu), _host(var), stride)
    checks = [
        ("n_iter vs jax", n_iter == ref["fit"]["n_iter"],
         f"{n_iter} vs {ref['fit']['n_iter']}"),
        ("ELBO vs jax", _rel(elbo, ref["fit"]["elbo"]) <= ELBO_RTOL,
         f"rel {_rel(elbo, ref['fit']['elbo']):.3e} (limit {ELBO_RTOL})")]
    for key in ("mu", "var"):
        err = _rel_state_err(summary[key], ref["fit"][key])
        checks.append((f"{key} vs jax", err <= STATE_TOL,
                       f"{err:.3e} (limit {STATE_TOL})"))
    for key, got in (("mean", mean), ("std", std)):
        err = _rel_state_err(_host(got)[::stride], ref["predict"][key])
        checks.append((f"predict {key} vs jax", err <= STATE_TOL,
                       f"{err:.3e} (limit {STATE_TOL})"))
    print(f"solar: N={g.N}, converged ELBOcalc {elbo!r} in {n_iter} sweeps "
          f"{dt_fit:.3f} s; predict(nn={SOLAR_NN}) {dt_pred:.3f} s",
          flush=True)

    g = solar_problem(pkg, device="cuda")
    res, dt_adam = _timed(torch, lambda: g.optimize_adam(
        n_steps=ADAM_STEPS, n_sweeps=GRAD_SWEEPS["headline"]))
    x, x_ref = np.asarray(res["x"], dtype=float), \
        np.asarray(ref["adam"]["x"], dtype=float)
    zero = x_ref == 0
    x_err = float(np.max(np.abs(x - x_ref)[~zero] / np.abs(x_ref[~zero])))
    checks += [
        ("adam x vs optax (entries at 0 stay 0: log transform)",
         x_err <= ADAM_X_RTOL and bool(np.all(x[zero] == 0)),
         f"max rel {x_err:.3e} (limit {ADAM_X_RTOL})"),
        ("adam elbo vs optax",
         _rel(res["elbo"], ref["adam"]["elbo"]) <= ELBO_RTOL,
         f"rel {_rel(res['elbo'], ref['adam']['elbo']):.3e}")]
    print(f"solar: {ADAM_STEPS} optimize_adam steps ({GRAD_SWEEPS['headline']}"
          f" sweeps) {dt_adam:.3f} s, elbo {res['elbo']!r}", flush=True)

    g = solar_problem(pkg, device="cuda")
    eng, data = g.engine, g._data()
    thetas, mu0, var0 = _batch_inputs(g, BATCH)
    (elbo_b, mu_b, var_b, n_iter_b, conv_b), wall = _timed(
        torch, lambda: eng.elbo_fit_batch(thetas, *data, mu0, var0,
                                          BATCH["max_iter"]))
    n_iter_b, conv_b = n_iter_b.cpu().tolist(), conv_b.cpu().tolist()
    b = ref["batch"]
    e_err = _max_rel(_host(elbo_b), b["elbo"])
    s_err = max(_rel_state_err(
        state_summary(_host(mu_b[w]), _host(var_b[w]), stride)[key],
        b[key][w]) for w in range(BATCH["rows"]) for key in ("mu", "var"))
    checks += [
        ("batch n_iter and converged vs jax",
         n_iter_b == b["n_iter"] and conv_b == b["converged"],
         f"{n_iter_b} vs {b['n_iter']}"),
        ("batch ELBO vs jax", e_err <= ELBO_RTOL,
         f"max rel {e_err:.3e} (limit {ELBO_RTOL})"),
        ("batch state vs jax", s_err <= STATE_TOL,
         f"{s_err:.3e} (limit {STATE_TOL})")]
    print(f"solar: elbo_fit_batch of {BATCH['rows']} rows {wall:.3f} s, "
          f"{max(n_iter_b)} batched sweeps", flush=True)

    t = data[0]
    counted = dict(ck.LAUNCHES)
    one_pass = eng._mean_values(thetas, t)
    by_row = _mean_values_by_row(torch, eng, thetas, t)
    diff = _max_rel(_host(one_pass), _host(by_row))
    enq, done = _host_ms(torch, lambda: eng._mean_values(thetas, t), 20)
    enq_row, done_row = _host_ms(
        torch, lambda: _mean_values_by_row(torch, eng, thetas, t), 5)
    ck.LAUNCHES.update(counted)
    print(f"solar: the {BATCH['rows']}-row mean values (a Keplerian of 100 "
          f"Newton steps): one pass {enq:.3f} ms of host to enqueue, "
          f"{done:.3f} ms to finish; row by row {enq_row:.3f} / "
          f"{done_row:.3f} ms ({enq_row / enq:.1f}x the host time); the "
          f"two differ by {diff:.3e}", flush=True)
    checks.append(("13-row mean values, one pass vs row by row",
                   diff <= 1e-14, f"{diff:.3e} (limit 1e-14)"))
    _check("solar", checks)


def _serving_models(torch, pkg, oracle):
    """The two served models on the card: the headline at N=1000 with the
    JAX package's converged state, and at N=5000 from the heuristic
    state."""
    ref = oracle["serving"]
    out = {}
    for key, cfg in SERVE.items():
        g = headline_problem(pkg, N=cfg["N"], device="cuda")
        if key == "headline":
            g._mu = g._tensor(ref[key]["state"]["mu"])
            g._var = g._tensor(ref[key]["state"]["var"])
        else:
            g._mu, g._var = g.engine.init_mu_var(g._theta(),
                                                 g._tensor(g.y))
        out[key] = g
    return out


def phase_stack_op(torch, ck, lin, models):
    """``kernel_matrix_stack_op``, the wrapper of the operator that the
    exported program calls, on each served model's node and weight
    structures and parameters as ``Engine.predict`` hands them to it (the
    prediction nugget), in float64 and float32, against
    ``kernel_matrix_stack_ref`` on the same inputs; one B1 launch per
    matrix, and bit for bit the result of ``kernel_matrix_stack_cuda``."""
    from gpyrn_tpu_torch.models.gprn import unpack_parameters
    counted = dict(ck.LAUNCHES)
    for key, g in models.items():
        eng, spec = g.engine, g.engine.spec
        node_p, weight_p, _, _ = unpack_parameters(spec, g._theta())
        structures = list(spec.node_structs) + list(spec.weight_structs)
        core = (list(eng._core(node_p, eng.node_maps))
                + list(eng._core(weight_p, eng.weight_maps)))
        for dtype in (torch.float64, torch.float32):
            rtol, atol = STACK_OP_TOL[_dtype_name(dtype)]
            t = g._tensor(g.time, dtype).contiguous()
            params = [p.to(dtype).contiguous() for p in core]
            args = (params, t, lin.PREDICT_NUGGET, lin.F32_JITTER_MULT)
            ck.reset_launch_counts()
            K = ck.kernel_matrix_stack_op(structures, *args)
            torch.cuda.synchronize()
            launched = dict(ck.LAUNCHES)
            R = ck.kernel_matrix_stack_ref(structures, *args)
            D = ck.kernel_matrix_stack_cuda(structures, *args)
            err = float((K - R).abs().max())
            _check(f"stack operator {key} N={g.N} {_dtype_name(dtype)}", [
                ("B1 launches",
                 launched == {"kernel_matrix": len(structures),
                              "kernel_matrix_grad": 0, "kernel_matvec": 0},
                 f"{launched} (expected {len(structures)} of B1)"),
                ("shape", tuple(K.shape) == (len(structures), g.N, g.N),
                 f"{tuple(K.shape)}"),
                ("vs the plain version",
                 bool(((K - R).abs() <= atol * R.abs().amax()
                       + rtol * R.abs()).all()),
                 f"max abs err {err:.3e}, bit-equal {torch.equal(K, R)} "
                 f"(rtol {rtol}, atol {atol} of max |ref|)"),
                ("bit-equal to kernel_matrix_stack_cuda", torch.equal(K, D),
                 f"{float((K - D).abs().max()):.3e}")])
    ck.LAUNCHES.update(counted)


def phase_serving(torch, pkg, oracle, ck, lin):
    """The served program's B1 operator on both models' structures
    (:func:`phase_stack_op`), then ``export_predict`` of both models on
    the card, saved, loaded and served in a fresh process (``--serve``) that must not import the shell
    or the engine; its outputs against the in-process predict and the JAX
    package's artifact; the float32 artifact against the JAX package's.
    Returns
    (B1 launches of the served requests, the headline artifact's path)."""
    import shutil
    import warnings
    from gpyrn_tpu_torch import serving
    ref = oracle["serving"]
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    models = _serving_models(torch, pkg, oracle)
    phase_stack_op(torch, ck, lin, models)
    manifest = []
    for key, g in models.items():
        path = os.path.join(SERVE_DIR, f"{key}.pt2")
        nbytes, export_s = _timed(torch, lambda: g.export_predict(path))
        manifest.append({"name": key, "path": path, "ns": SERVE[key]["ns"],
                         "time": [float(np.min(g.time)),
                                  float(np.max(g.time))]})
        print(f"serving: {key} (N={g.N}) exported in {export_s:.3f} s, "
              f"artifact {nbytes} bytes", flush=True)
    with open(os.path.join(SERVE_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    lines = _child(SERVE_ARG)
    print("\n".join(lines[:-1]), flush=True)
    served = json.loads(lines[-1])
    checks = [("the serving process loaded neither the shell nor the engine",
               not served["modules"], f"{served['modules']}")]
    for key, g in models.items():
        for n in SERVE[key]["ns"]:
            tstar = serve_times(g.time, n)
            mean, var, (npred, wpred) = g._Prediction(tstar=tstar,
                                                      separate=True)
            local = [_host(x) for x in (mean, var, npred, wpred)]
            got = np.load(os.path.join(SERVE_DIR, f"{key}_{n}.npz"))
            got = [got[f"out{i}"] for i in range(4)]
            e_local = max(_max_rel(a, b) for a, b in zip(got, local))
            e_jax = max(_max_rel(a, b) for a, b in zip(
                serve_summary(got), ref[key]["requests"][str(n)]))
            req = served["requests"][f"{key}_{n}"]
            checks += [
                (f"{key} n*={n} served vs predict",
                 e_local <= SERVE_RTOL["predict"],
                 f"{e_local:.3e} (limit {SERVE_RTOL['predict']})"),
                (f"{key} n*={n} served vs the JAX artifact",
                 e_jax <= SERVE_RTOL["jax"],
                 f"{e_jax:.3e} (limit {SERVE_RTOL['jax']})"),
                (f"{key} n*={n} B1 launches per request",
                 req["launches_per_request"] > 0,
                 f"{req['launches_per_request']}")]

    g = models["headline"]
    tstar = serve_times(g.time, SERVE_F32_N)
    (program32, export32_s) = _timed(torch, lambda: serving.export_predict(
        g, dtype=torch.float32))
    serve32 = serving.ServingPredictor(program32)
    counted = dict(ck.LAUNCHES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out32 = [_host(o) for o in serve32(tstar)]
    ck.LAUNCHES.update(counted)
    e32 = max(_max_rel(a, b) for a, b in zip(
        serve_summary(out32), ref["headline"]["float32"]))
    mean, var = (_host(x) for x in g._Prediction(tstar=tstar))
    print(f"serving: float32 artifact exported in {export32_s:.3f} s; "
          f"against float64 {_max_rel(out32[0], mean):.3e} (mean), "
          f"{_max_rel(out32[1], var):.3e} (var) of max |ref|", flush=True)
    checks += [
        ("float32 artifact vs the JAX package's float32 artifact",
         e32 <= SERVE_RTOL["float32"],
         f"{e32:.3e} (limit {SERVE_RTOL['float32']})"),
        ("float32 artifact: dtype and one narrowing warning",
         serve32.dtype == torch.float32 and out32[0].dtype == np.float32
         and len(caught) == 1, f"{serve32.dtype}, {len(caught)} warning")]
    _check("serving", checks)
    return served["launches"], models["headline"].time


def serve_main(torch):
    """Phase 31's serving process: loads each artifact of the manifest
    with ``serving.load_predict`` alone, answers its requests, writes the
    outputs beside it, and prints the timings, the B1 launches and the
    package modules it loaded as its last line."""
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    from gpyrn_tpu_torch.serving import load_predict
    with open(os.path.join(SERVE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    requests, loads, launches = {}, {}, 0
    for item in manifest:
        serve, load_s = _timed(torch, lambda: load_predict(item["path"]))
        loads[item["name"]] = load_s
        for n in item["ns"]:
            tstar = serve_times(np.asarray(item["time"]), n)
            ck.reset_launch_counts()
            out, first = _timed(torch, lambda: serve(tstar))
            torch.cuda.reset_peak_memory_stats()
            steady = [_timed(torch, lambda: serve(tstar))[1]
                      for _ in range(SERVE_STEADY_REPS)]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            calls = 1 + SERVE_STEADY_REPS
            launched = ck.LAUNCHES["kernel_matrix"]
            launches += launched
            np.savez(os.path.join(SERVE_DIR, f"{item['name']}_{n}.npz"),
                     **{f"out{i}": _host(o) for i, o in enumerate(out)})
            requests[f"{item['name']}_{n}"] = {
                "first_ms": 1e3 * first,
                "steady_ms": 1e3 * float(np.median(steady)),
                "peak_gib": peak, "launches_per_request": launched / calls}
            print(f"serve: {item['name']} n*={n}: first call "
                  f"{1e3 * first:.3f} ms, steady {1e3 * np.median(steady):.3f}"
                  f" ms (median of {SERVE_STEADY_REPS}), peak "
                  f"{peak:.3f} GiB, B1 launches per request "
                  f"{launched / calls:g}", flush=True)
        print(f"serve: {item['name']} loaded in {load_s:.3f} s", flush=True)
    modules = sorted(m for m in sys.modules if m.startswith(
        ("gpyrn_tpu_torch.inference", "gpyrn_tpu_torch.models", "jax",
         "gpyrn_tpu.")))
    print(json.dumps({"requests": requests, "loads": loads,
                      "launches": launches, "modules": modules}), flush=True)


def phase_profiling(torch, timer, path, time):
    """``profiling.trace`` of one served request (N=1000, n*=1000) in this
    process: the written trace must hold B1 among its device records (a
    trace without device records is taken again, up to ``TRACE_TRIES``
    times); then the stage timer's report of phases 29-31."""
    import glob
    import shutil
    from gpyrn_tpu_torch.serving import load_predict
    from gpyrn_tpu_torch.utils.profiling import trace
    serve = load_predict(path)
    tstar = serve_times(time, 1000)
    serve(tstar)
    logdir = os.path.join(SERVE_DIR, "trace")
    for attempt in range(1, TRACE_TRIES + 1):
        shutil.rmtree(logdir, ignore_errors=True)
        with trace(logdir):
            serve(tstar)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace() wrote {files}, not one trace")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        device = [e for e in events if e.get("cat") == "kernel"]
        b1 = [e for e in device if "kernel_matrix_kernel" in e["name"]]
        if b1:
            break
        print(f"trace {attempt} of {TRACE_TRIES}: {len(device)} device "
              "records, none of them B1", file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"trace() wrote no B1 record in {TRACE_TRIES} "
                             "traces")
    busy = sum(e["dur"] for e in device) / 1e3
    print(f"profiling: trace() wrote {os.path.getsize(files[0])} bytes, "
          f"{len(events)} records, {len(device)} device kernels "
          f"({busy:.3f} ms), B1 {len(b1)} launches "
          f"({sum(e['dur'] for e in b1) / 1e3:.4f} ms)", flush=True)
    print("profiling: StageTimer of phases 29-31:\n" + timer.report(),
          flush=True)


# ---- the multi-device layer (phases 33-34) ------------------------------

def panel_fit_problem(pkg, **kw):
    """Phase 33's panel elbo_fit case (the JAX package's dryrun_multichip
    N=192 case): a QuasiPeriodic node and an SE weight, q=1 p=1."""
    rng = np.random.default_rng(11)
    N = PANEL_FIT["N"]
    t = np.sort(rng.uniform(0, 100, N))
    y = np.sin(2 * np.pi * t / 31) + 0.05 * rng.standard_normal(N)
    g = pkg.inference(1, t, y, np.full(N, 0.05), **kw)
    g.set_components(pkg.covfunc.QuasiPeriodic(1., 40., 31., .7),
                     pkg.covfunc.SquaredExponential(1., 50.), [None], [0.05])
    return g


def cg_mesh_system(torch):
    """Phase 33's distributed CG case (the dryrun's): the N=192 panel
    model's times and node kernel, then a right-hand side and a diagonal
    from the same generator, float64 on the card."""
    import gpyrn_tpu_torch as pkg
    rng = np.random.default_rng(11)
    N = CG_MESH["N"]
    t = np.sort(rng.uniform(0, 100, N))
    rng.standard_normal(N)                  # the model's noise
    b, d = rng.standard_normal(N), 0.3 + rng.random(N)
    k = pkg.covfunc.QuasiPeriodic(1., 40., 31., .7)
    return (k.structure, *(torch.tensor(np.asarray(a, dtype=float),
                                        device="cuda")
                           for a in (k.core_params(), t, b, d)))


def chain_priors(g, pr):
    """The device chain's priors of phase 33: the node's first two
    parameters free (log-normal, width PRIOR_WIDTH), the rest frozen by
    ``vars=``."""
    names = list(g.parameters_dict)[:2]
    return names, {n: pr.LogNormal(float(np.log(g.parameters_dict[n])),
                                   PRIOR_WIDTH) for n in names}


def _host_np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# B1's slab entry against its plain version: phase 8's float64 tolerances
SLAB_RTOL, SLAB_ATOL_REL, SLAB_JITTER = 1e-12, 1e-14, 1e-6
# the plain version of a full-width slab is built this many rows at a time
SLAB_REF_CHUNK = 2048


def _slab_against_plain(torch, ck, kernel, t, n_pad, r0, n_rows):
    """One slab of ``kernel``'s matrix over ``t`` (rows [r0, r0 + n_rows)
    of the n_pad-wide padded matrix, B1's slab entry) against its plain
    version, built SLAB_REF_CHUNK rows at a time, and its rows inside N
    bit for bit against B1's full matrix.  Comparison launches."""
    s, p = kernel.structure, t.new_tensor(kernel.core_params())
    N = t.shape[0]
    jit = torch.tensor(SLAB_JITTER, dtype=t.dtype, device=t.device)
    got = ck.kernel_matrix_slab_cuda(s, p, t, n_pad, r0, n_rows, jit)
    err, ok = 0.0, True
    for c in range(0, n_rows, SLAB_REF_CHUNK):
        n = min(SLAB_REF_CHUNK, n_rows - c)
        ref = ck.kernel_matrix_slab_ref(s, p, t, n_pad, r0 + c, n, jit)
        part = got[c:c + n]
        err = max(err, float((part - ref).abs().max()))
        ok &= bool(torch.allclose(part, ref, rtol=SLAB_RTOL,
                                  atol=SLAB_ATOL_REL
                                  * float(ref.abs().max())))
        del ref
    rows = max(0, min(r0 + n_rows, N) - r0)
    full = ck.kernel_matrix_cuda(s, p, t, SLAB_JITTER, 0.0)
    bits = bool(torch.equal(got[:rows, :N], full[r0:r0 + rows]))
    del got, full
    torch.cuda.empty_cache()
    return {"structure": repr(s), "rows": (r0, r0 + n_rows),
            "n_pad": n_pad, "max_abs_err": err, "within_tol": ok,
            "bits_equal_b1_rows": bits}


def slab_check(torch, ck, rank, n_ranks):
    """This rank's slab of each of the headline model's four kernel
    matrices at PANEL_N (the QP node, the three SE weights), as
    ``_slab_against_plain``.  After the path's counts are read."""
    g = headline_problem(__import__("gpyrn_tpu_torch"), N=PANEL_N,
                         device="cuda")
    t = g._tensor(g.time)
    Nl = PANEL_N // n_ranks
    recs = [_slab_against_plain(torch, ck, k, t, PANEL_N, rank * Nl, Nl)
            for k in (*g.nodes, *g.weights)]
    return {"max_abs_err": max(r["max_abs_err"] for r in recs),
            "within_tol": all(r["within_tol"] for r in recs),
            "bits_equal_b1_rows": all(r["bits_equal_b1_rows"]
                                      for r in recs),
            "structures": len(recs)}


def parallel_rank():
    """Phase 33 in one of the PARALLEL_RANKS gloo ranks sharing the card:
    the parallel path with the launch counts set to 0 before it and read
    after it, then this rank's slab against its plain version."""
    import torch
    import torch.distributed as dist
    import gpyrn_tpu_torch as pkg
    from gpyrn_tpu_torch.inference import priors as pr
    from gpyrn_tpu_torch.inference.evidence import batch_elbo
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    from gpyrn_tpu_torch.parallel import (cg_solve_sharded, make_panel_engine,
                                          multistart_optimize)
    from gpyrn_tpu_torch.parallel import mesh as pm
    mesh22 = pm.make_mesh(shape=(2, 2))
    mesh41 = pm.make_mesh(shape=(PARALLEL_RANKS, 1))
    mesh14 = pm.make_mesh(shape=(1, PARALLEL_RANKS))
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    out = {}
    g = flagship_problem(pkg, N=LATTICE["N"], device="cuda")
    g.lattice_axis = pm.LAT_AXIS
    with pm.use_mesh(mesh22):
        res = multistart_optimize(g, mesh=mesh22, **MULTISTART_MESH)
        out["multistart"] = {k: res[k] for k in ("elbo", "restart_elbos",
                                                 "winner")}
        g = flagship_problem(pkg, N=LATTICE["N"], device="cuda")
        g.lattice_axis = pm.LAT_AXIS
        args = _start(torch, g, torch.float64)
        mu, var, it, _ = g.engine.fit_state(*args, LATTICE["max_iter"],
                                            LATTICE["tol"])
        e, _, _ = g.engine.elbo_refine(*args[:4], mu, var, 1)
        out["lattice"] = {"mu": mu, "var": var, "it": it, "elbo": e}
    g = headline_problem(pkg, N=LATTICE["N"], device="cuda")
    thetas = batch_thetas(g.get_parameters(), EVIDENCE_MESH_ROWS, 0.1, 0)
    out["batch_elbo"] = batch_elbo(g, thetas, max_iter=30, mesh=mesh41)
    names, priors = chain_priors(g, pr)
    chain = g.mcmc(priors, p0=np.array([g.parameters_dict[n] for n in names]),
                   vars=names, mesh=mesh41, **CHAIN_MESH)
    out["chain"] = {"chain": chain.chain, "log_prob": chain.log_prob}
    panel = 0
    g = panel_fit_problem(pkg, device="cuda")
    pe = make_panel_engine(g.engine.spec, mesh14, block=PANEL_FIT["block"])
    before = ck.LAUNCHES["kernel_matrix"]
    e, _, _, it, done = pe.elbo_fit_panel(*_start(torch, g, torch.float64),
                                          PANEL_FIT["max_iter"])
    panel += ck.LAUNCHES["kernel_matrix"] - before
    out["panel_fit"] = {"elbo": e, "it": it, "done": done}
    g = headline_problem(pkg, N=PANEL_N, device="cuda")
    pe = make_panel_engine(g.engine.spec, mesh14, block=PANEL_BLOCK)
    before = ck.LAUNCHES["kernel_matrix"]
    e, mu, var = pe.elbo_refine_panel(*_start(torch, g, torch.float64),
                                      PANEL_SWEEPS)
    panel += ck.LAUNCHES["kernel_matrix"] - before
    out["panel"] = {"elbo": e, "mu": mu, "var": var, "dims": tuple(pe.dims)}
    s, pars, t, b, d = cg_mesh_system(torch)
    x, it = cg_solve_sharded(s, pars, t, b, mesh41, d_add=d,
                             nugget=CG_MESH["nugget"], tol=CG_MESH["tol"],
                             maxiter=CG_MESH["maxiter"])
    out["cg"] = {"x": x, "it": it}
    torch.cuda.synchronize()
    out = {k: {kk: _host_np(vv) for kk, vv in v.items()}
           if isinstance(v, dict) else _host_np(v) for k, v in out.items()}
    out.update(rank=dist.get_rank(), launches=dict(ck.LAUNCHES),
               instances=dict(ck.MATVEC_INSTANCES), slab_launches=panel, wall=time.perf_counter() - t0,
               slab=slab_check(torch, ck, dist.get_rank(), PARALLEL_RANKS))
    return out


def phase_parallel_ranks(torch, pkg):
    """33: the parallel path over PARALLEL_RANKS gloo ranks sharing the
    card, against the unsharded calls made here afterwards (comparison
    launches) and the cached JAX value."""
    from gpyrn_tpu_torch.inference import priors as pr
    from gpyrn_tpu_torch.inference.evidence import batch_elbo
    from gpyrn_tpu_torch.ops.iterative import cg_solve, kernel_matvec
    from gpyrn_tpu_torch.parallel import multistart_optimize
    from gpyrn_tpu_torch.parallel.mesh import spawn
    with open(ORACLE) as f:
        ref_jax = json.load(f)["parallel"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, PARALLEL_RANKS, "gloo", "cuda",
                  timeout=PARALLEL_TIMEOUT)
    wall = time.perf_counter() - t0
    r = ranks[0]
    print(f"{PARALLEL_RANKS} gloo ranks on one card: {wall:.1f} s in all "
          f"(the ranks' own path {max(x['wall'] for x in ranks):.1f} s); "
          f"launches per rank {[x['launches'] for x in ranks]}, slab "
          f"launches per rank {[x['slab_launches'] for x in ranks]}",
          flush=True)
    checks = []
    for x in ranks[1:]:
        same = all(np.array_equal(np.asarray(x[k][kk]), np.asarray(r[k][kk]))
                   for k in ("lattice", "panel", "cg", "chain")
                   for kk in r[k])
        checks.append((f"rank {x['rank']} replicates rank 0", same, ""))
    for x in ranks:
        checks.append((f"rank {x['rank']} launched B1's slab entry",
                       x["slab_launches"] > 0, f"{x['slab_launches']}"))
        checks.append((f"rank {x['rank']} slabs of the "
                       f"{x['slab']['structures']} kernels vs plain "
                       "(max abs err)",
                       x["slab"]["within_tol"],
                       f"{x['slab']['max_abs_err']:.3e}"))
        print(f"rank {x['rank']} slab bit-equal to B1's full-matrix rows: "
              f"{x['slab']['bits_equal_b1_rows']}", flush=True)
    # the unsharded calls
    g = flagship_problem(pkg, N=LATTICE["N"], device="cuda")
    ms = multistart_optimize(g, **MULTISTART_MESH)
    err = float(np.max(np.abs(r["multistart"]["restart_elbos"]
                              - ms["restart_elbos"])
                       / np.abs(ms["restart_elbos"])))
    checks.append(("multistart (2, 2) vs unsharded, restart ELBOs",
                   err <= 1e-8 and np.all(np.isfinite(ms["restart_elbos"])),
                   f"rel {err:.3e}"))
    g = flagship_problem(pkg, N=LATTICE["N"], device="cuda")
    args = _start(torch, g, torch.float64)
    mu, var, it, _ = g.engine.fit_state(*args, LATTICE["max_iter"],
                                        LATTICE["tol"])
    e, _, _ = g.engine.elbo_refine(*args[:4], mu, var, 1)
    lat = r["lattice"]
    for key, ref in (("mu", mu), ("var", var)):
        err = float(np.max(np.abs(lat[key] - ref.cpu().numpy())))
        checks.append((f"lat-split fit_state {key} vs unsharded",
                       err <= LATTICE_ATOL and int(lat["it"]) == it,
                       f"max abs {err:.3e}, sweeps {int(lat['it'])} / {it}"))
    checks.append(("lat-split ELBO vs unsharded",
                   _rel(float(lat["elbo"]), float(e)) <= LATTICE_ELBO_RTOL,
                   f"rel {_rel(float(lat['elbo']), float(e)):.3e}"))
    g = headline_problem(pkg, N=LATTICE["N"], device="cuda")
    ref = batch_elbo(g, batch_thetas(g.get_parameters(), EVIDENCE_MESH_ROWS,
                                     0.1, 0), max_iter=30)
    err = float(np.max(np.abs(r["batch_elbo"] - ref) / np.abs(ref)))
    checks.append(("batch_elbo (4, 1) vs unsharded",
                   err <= EVIDENCE_MESH_RTOL, f"rel {err:.3e}"))
    names, priors = chain_priors(g, pr)
    chain = g.mcmc(priors, p0=np.array([g.parameters_dict[n] for n in names]),
                   vars=names, **CHAIN_MESH)
    for key, got in (("chain", chain.chain), ("log_prob", chain.log_prob)):
        rtol, atol = CHAIN_MESH_TOL[key]
        ok = np.allclose(r["chain"][key], got, rtol=rtol, atol=atol)
        checks.append((f"device chain (4, 1) vs unsharded, {key}", ok,
                       f"max abs {np.max(np.abs(r['chain'][key] - got)):.3e}"))
    g = panel_fit_problem(pkg, device="cuda")
    e, _, _, it, _, _ = g.engine.elbo_fit(*_start(torch, g, torch.float64),
                                          PANEL_FIT["max_iter"])
    pf = r["panel_fit"]
    rel = _rel(float(pf["elbo"]), float(e))
    checks.append((f"panel elbo_fit N={PANEL_FIT['N']} (1, 4) vs unsharded",
                   rel <= PANEL_FIT_RTOL and int(pf["it"]) == it,
                   f"rel {rel:.3e}, sweeps {int(pf['it'])} / {it}"))
    g = headline_problem(pkg, N=PANEL_N, device="cuda")
    e, mu, var = g.engine.elbo_refine_lean(*_start(torch, g, torch.float64),
                                           PANEL_SWEEPS)
    pan = r["panel"]
    print(f"panel N={PANEL_N} dims {pan['dims'].tolist()}: elbo "
          f"{float(pan['elbo'])!r}, lean {float(e)!r}, jax "
          f"{ref_jax['refine']['elbo']!r}", flush=True)
    summary = state_summary(pan["mu"], pan["var"], ref_jax["stride"])
    for what, elbo, ref_mu, ref_var in (
            ("lean", float(e), mu.cpu().numpy(), var.cpu().numpy()),
            ("jax", ref_jax["refine"]["elbo"], None, None)):
        rel = _rel(float(pan["elbo"]), elbo)
        checks.append((f"panel N={PANEL_N} ELBO vs {what}",
                       rel <= PANEL_RTOL["elbo"], f"rel {rel:.3e}"))
        for key, want in (("mu", ref_mu), ("var", ref_var)):
            got = pan[key] if want is not None else summary[key]
            want = want if want is not None else ref_jax["refine"][key]
            err = _rel_state_err(got, want)
            checks.append((f"panel N={PANEL_N} {key} vs {what}",
                           err <= PANEL_RTOL["state"], f"{err:.3e}"))
    s, pars, t, b, d = cg_mesh_system(torch)
    nug = CG_MESH["nugget"]
    x, _ = cg_solve(lambda v: kernel_matvec(s, pars, t, v, nugget=nug)
                    + (d[:, None] * v if v.ndim == 2 else d * v), b,
                    tol=CG_MESH["tol"], maxiter=CG_MESH["maxiter"],
                    precond_diag=1.0 + nug + d)
    rtol, atol = CG_MESH_TOL
    x = x.cpu().numpy()
    checks.append(("cg_solve_sharded (4, 1) vs cg_solve",
                   np.allclose(r["cg"]["x"], x, rtol=rtol, atol=atol),
                   f"max abs {np.max(np.abs(r['cg']['x'] - x)):.3e}, "
                   f"{int(r['cg']['it'])} iterations"))
    _check("parallel, 4 ranks", checks)
    launches = {k: sum(x["launches"][k] for x in ranks)
                for k in ranks[0]["launches"]}
    return {"launches": launches, "wall": wall,
            "instances": _merged([x["instances"] for x in ranks]),
            "slab_launches": sum(x["slab_launches"] for x in ranks),
            "slab_max_abs_err": max(x["slab"]["max_abs_err"]
                                    for x in ranks),
            "slab_bits_equal": all(x["slab"]["bits_equal_b1_rows"]
                                   for x in ranks)}


def _merged(counts):
    """The sum of several {instance: launches} dicts."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _slab_times(torch, ck, N, rows=SLAB_ROWS):
    """B1's slab entry on a slab of ``rows`` rows of the headline node's
    padded matrix at N (block 256, one rank; a 256-row slab from the
    middle, a whole-width one from row 0), against its plain version and
    its bound: each element inside N computed once ((rows inside N) · N
    lags of QP), the slab written once."""
    g = headline_problem(__import__("gpyrn_tpu_torch"), N=N, device="cuda")
    node = g.nodes[0]
    t, p = g._tensor(g.time), g._tensor(node.core_params())
    Np = -(-N // PANEL_BLOCK) * PANEL_BLOCK
    rows = min(rows, Np)
    r0 = (Np // 2 // PANEL_BLOCK) * PANEL_BLOCK if rows < Np else 0
    jit = torch.tensor(SLAB_JITTER, dtype=t.dtype, device="cuda")
    ms = _time_ms(torch, lambda: ck.kernel_matrix_slab_cuda(
        node.structure, p, t, Np, r0, rows, jit), 20)
    plain_ms = _time_ms(torch, lambda: ck.kernel_matrix_slab_ref(
        node.structure, p, t, Np, r0, rows, jit), 5)
    inside = max(0, min(r0 + rows, N) - r0) * N
    bound, by = _bound(rows * Np * 8 + N * 8,
                       OPS_PER_LAG["kernel_matrix"] * inside, torch.float64)
    from gpyrn_tpu_torch.ops import _build
    per, pipe_ms = _pipe_bound(_build, "kernel_matrix_slab_kernel",
                               torch.float64, inside)
    torch.cuda.empty_cache()
    return {"N": N, "n_pad": Np, "rows": rows, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "pipe_bound_ms": pipe_ms,
            "pipe_instructions_per_element": per}


def wide_rank():
    """Phase 34 in one NCCL rank alone on the card: the headline model at
    PANEL_WIDE["N"], the panel refine against the lean engine from one
    lean sweep's state, the launches of the panel path, the distributed
    CG at N=50,000; then (comparison launches) the slab entry's
    whole-width slabs of the node and the first weight against their
    plain version, and its times on 256-row and whole-width slabs."""
    import torch
    import gpyrn_tpu_torch as pkg
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    from gpyrn_tpu_torch.ops import iterative as it
    from gpyrn_tpu_torch.parallel import cg_solve_sharded, make_panel_engine
    from gpyrn_tpu_torch.parallel import mesh as pm
    from gpyrn_tpu_torch.parallel.iterative_sharded import slab_matvec
    mesh = pm.make_mesh(shape=(1, 1))
    cfg = PANEL_WIDE
    g = headline_problem(pkg, N=cfg["N"], device="cuda")
    eng = g.engine
    theta, t, y, yerr2, mu0, var0 = _start(torch, g, torch.float64)
    _, mu1, var1 = eng.elbo_refine_lean(theta, t, y, yerr2, mu0, var0, 1)
    (e_l, mu_l, var_l), wall_l, peak_l = _measured(
        torch, lambda: eng.elbo_refine_lean(theta, t, y, yerr2, mu1, var1,
                                            cfg["sweeps"]))
    pe = make_panel_engine(eng.spec, mesh, block=cfg["block"])
    ck.reset_launch_counts()
    (e_p, mu_p, var_p), wall_p, peak_p = _measured(
        torch, lambda: pe.elbo_refine_panel(theta, t, y, yerr2, mu1, var1,
                                            cfg["sweeps"]))
    launches = dict(ck.LAUNCHES)
    out = {"dims": tuple(pe.dims), "n_gp": eng.spec.q * (eng.spec.p + 1),
           "backend": pm.mesh_axis(
        mesh, pm.LAT_AXIS).backend, "launches": launches,
        "lean": {"elbo": float(e_l), "s_per_sweep": wall_l / cfg["sweeps"],
                 "peak_gib": peak_l},
        "panel": {"elbo": float(e_p), "s_per_sweep": wall_p / cfg["sweeps"],
                  "peak_gib": peak_p},
        "elbo_rel": _rel(float(e_p), float(e_l)),
        "mu_err": _rel_state_err(mu_p.cpu().numpy(), mu_l.cpu().numpy()),
        "var_err": _rel_state_err(var_p.cpu().numpy(), var_l.cpu().numpy())}
    del mu_l, var_l, mu_p, var_p
    torch.cuda.empty_cache()
    tt, pars, b = _solve_problem(torch, torch.float32)
    nug = SOLVE_NUGGET
    ck.reset_launch_counts()
    (x_s, it_s), wall_s = _timed(torch, lambda: cg_solve_sharded(
        ("QP",), pars, tt, b, mesh, nugget=nug, **CG_WIDE))
    cg_launches = dict(ck.LAUNCHES)
    out["instances"] = dict(ck.MATVEC_INSTANCES)
    out["launches"] = {k: launches[k] + cg_launches[k] for k in launches}
    # the comparisons: cg_solve, and one rank's slab of the product
    k0 = it.kernel_diag(("QP",), pars, tt, 0.0)
    minv = 1.0 / (k0 + nug)
    (x_r, it_r), wall_r = _timed(torch, lambda: it.cg_solve(
        lambda v: it.kernel_matvec(("QP",), pars, tt, v, nugget=nug,
                                   chunk=CG_WIDE["chunk"]), b,
        tol=CG_WIDE["tol"], maxiter=CG_WIDE["maxiter"],
        precond_apply=lambda r: r * minv[:, None]))
    rtol, atol = CG_MESH_TOL
    r0, n_rows = SOLVE_N // 3, SOLVE_N // 4
    y_slab = slab_matvec(("QP",), pars, tt, b[:, None], r0, n_rows)
    y_all = it.kernel_matvec(("QP",), pars, tt, b[:, None])
    out["cg"] = {"iters": (it_s, it_r), "wall": (wall_s, wall_r),
                 "max_abs": float((x_s - x_r).abs().max()),
                 "ok": bool(torch.allclose(x_s, x_r, rtol=rtol, atol=atol)),
                 "bits_equal": bool(torch.equal(x_s, x_r)),
                 "launches": cg_launches["kernel_matvec"],
                 "slab_rows_bits_equal": bool(torch.equal(
                     y_slab, y_all[r0:r0 + n_rows]))}
    del y_slab, y_all
    Np = -(-cfg["N"] // cfg["block"]) * cfg["block"]
    out["slab_full"] = [_slab_against_plain(torch, ck, k, t, Np, 0, Np)
                        for k in (g.nodes[0], g.weights[0])]
    out["slab_times"] = [_slab_times(torch, ck, n)
                         for n in (PANEL_N, cfg["N"])]
    out["slab_times"].append(_slab_times(torch, ck, cfg["N"], Np))
    return out


def phase_parallel_wide(torch):
    """34: the full-width path on a one-rank NCCL mesh."""
    from gpyrn_tpu_torch.parallel.mesh import spawn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (w,) = spawn(wide_rank, 1, "nccl", "cuda", timeout=PARALLEL_TIMEOUT)
    wall = time.perf_counter() - t0
    cfg = PANEL_WIDE
    print(f"one NCCL rank ({w['backend']}), headline N={cfg['N']} dims "
          f"{list(w['dims'])}: elbo_refine_panel {cfg['sweeps']} sweeps "
          f"{w['panel']['s_per_sweep']:.3f} s/sweep (the prior factors "
          f"included), peak {w['panel']['peak_gib']:.2f} GiB, "
          f"{w['launches']['kernel_matrix']} slab launches "
          f"({w['launches']['kernel_matrix'] / cfg['sweeps']:.2f} per sweep, "
          f"{w['n_gp']} GPs); elbo_refine_lean {w['lean']['s_per_sweep']:.3f} "
          f"s/sweep, peak {w['lean']['peak_gib']:.2f} GiB; phase wall "
          f"{wall:.1f} s", flush=True)
    print(f"cg_solve_sharded N={SOLVE_N} float32 vs cg_solve: iterations "
          f"{w['cg']['iters']}, walls {w['cg']['wall']} s, max |dx| "
          f"{w['cg']['max_abs']:.3e}, x bit-equal: "
          f"{w['cg']['bits_equal']}; "
          f"kernel_matvec launches of cg_solve_sharded "
          f"{w['cg']['launches']}", flush=True)
    for rec in w["slab_times"]:
        print(f"B1 slab entry, {rec['rows']}-row slab at N={rec['N']} "
              f"(Np {rec['n_pad']}): {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), FP-pipe bound {rec['pipe_bound_ms']} "
              f"ms", flush=True)
    slab_checks = []
    for rec in w["slab_full"]:
        print(f"B1 slab entry, whole slab {rec['structure']} rows "
              f"{rec['rows']} of Np {rec['n_pad']}: max abs err vs plain "
              f"{rec['max_abs_err']:.3e}, bit-equal to B1's full-matrix "
              f"rows: {rec['bits_equal_b1_rows']}", flush=True)
        slab_checks.append((f"whole slab {rec['structure']} vs plain",
                            rec["within_tol"],
                            f"max abs err {rec['max_abs_err']:.3e} (rtol "
                            f"{SLAB_RTOL}, atol {SLAB_ATOL_REL}·max|K|)"))
    _check(f"parallel, one NCCL rank, N={cfg['N']}", slab_checks + [
        ("backend", w["backend"] == "nccl", w["backend"]),
        ("slab launches", w["launches"]["kernel_matrix"] > 0,
         f"{w['launches']['kernel_matrix']}"),
        ("ELBO panel vs lean", w["elbo_rel"] <= PANEL_WIDE_RTOL["elbo"],
         f"rel {w['elbo_rel']:.3e}"),
        ("mu panel vs lean", w["mu_err"] <= PANEL_WIDE_RTOL["state"],
         f"{w['mu_err']:.3e}"),
        ("var panel vs lean", w["var_err"] <= PANEL_WIDE_RTOL["state"],
         f"{w['var_err']:.3e}"),
        ("cg_solve_sharded vs cg_solve", w["cg"]["ok"],
         f"max abs {w['cg']['max_abs']:.3e}"),
        ("cg_solve_sharded's x bit-equal to cg_solve's",
         w["cg"]["bits_equal"], ""),
        ("cg_solve_sharded launched kernel_matvec", w["cg"]["launches"] > 0,
         f"{w['cg']['launches']}"),
        ("slab_matvec rows bit-equal to kernel_matvec's",
         w["cg"]["slab_rows_bits_equal"], "")])
    return w, wall


def parallel_main(torch, pkg):
    """Phases 33-34 in this process (its own CUDA context beside the
    ranks it starts): the ranks count their launches; the last line is
    the JSON record the parent reads."""
    from gpyrn_tpu_torch.ops import _build
    _build.build("kernel_matrix")       # once, before the ranks load it
    t0 = time.perf_counter()
    print(f"== phase 33: the multi-device layer, {PARALLEL_RANKS} gloo "
          f"ranks sharing the card", flush=True)
    ranks = phase_parallel_ranks(torch, pkg)
    print(f"== phase 34: full width, headline model at "
          f"N={PANEL_WIDE['N']}, a one-rank NCCL mesh", flush=True)
    wide, _ = phase_parallel_wide(torch)
    launches = {k: ranks["launches"][k] + wide["launches"][k]
                for k in ranks["launches"]}
    matvec = {"33": ranks["launches"]["kernel_matvec"],
              "34": wide["cg"]["launches"]}
    wall = time.perf_counter() - t0
    print(f"parallel path launches: {launches} (kernel_matvec by phase "
          f"{matvec}); phases 33-34 took {wall:.1f} s", flush=True)
    print(json.dumps({
        "launches": launches, "seconds": wall, "matvec_by_phase": matvec,
        "instances": _merged([ranks["instances"], wide["instances"]]),
        "cg_wide": wide["cg"],
        "slab": {"launches": (ranks["slab_launches"]
                              + wide["launches"]["kernel_matrix"]),
                 "max_abs_err": ranks["slab_max_abs_err"],
                 "bits_equal_b1_rows": ranks["slab_bits_equal"],
                 "times": wide["slab_times"]}}), flush=True)


def _theta_rel(x, ref):
    """max over entries of |x - ref| / max(|ref|, 1e-3·max |ref|): the
    parameters relative entry by entry, an entry near 0 against the
    largest."""
    x, ref = np.asarray(x, dtype=float), np.asarray(ref, dtype=float)
    scale = np.maximum(np.abs(ref), 1e-3 * np.max(np.abs(ref)))
    return float(np.max(np.abs(x - ref) / scale))


def _bar(what, err, limit):
    return (what, bool(err <= limit), f"{err:.3e} (limit {limit:.0e})")


def _same(what, got, want):
    got, want = np.asarray(got).tolist(), np.asarray(want).tolist()
    return (what, got == want, f"{got} (jax {want})")


def _nuts_checks(got, ref):
    """The port's own chain (its draws are not the JAX example's): finite,
    the JAX chain's shape, acceptance in (0, 1], each posterior mean
    within NUTS_SIGMAS of the JAX chain's posterior standard deviations."""
    mean, std = np.asarray(got["chain_mean"]), np.asarray(got["chain_std"])
    dist = np.abs(mean - np.asarray(ref["chain_mean"])) \
        / np.asarray(ref["chain_std"])
    return [
        ("chain finite", bool(np.all(np.isfinite(mean))
                              and np.all(np.isfinite(std))),
         f"mean {mean}, std {std}"),
        _same("chain shape", list(got["chain_shape"]), ref["chain_shape"]),
        ("acceptance in (0, 1]", 0.0 < got["acceptance"] <= 1.0,
         f"{got['acceptance']:.3f} (jax {ref['acceptance']:.3f})"),
        ("posterior means within the JAX chain's", bool(np.all(
            dist <= NUTS_SIGMAS)),
         f"{dist.max():.2f} sd (limit {NUTS_SIGMAS})")]


def _gap_check(what, gap, values):
    return _bar(what, gap / np.max(np.abs(values)), EXAMPLE_ITERATIVE_TOL)


def example_checks(n, got, ref):
    """(what, ok, detail) of the port's example ``n`` (the dict its
    ``main`` returns) against the JAX example's values ``ref`` (a section
    of ``tests/torch_examples_reference.json``), at the bars above the
    EXAMPLE_* constants; ``tests/test_torch_examples.py`` holds the
    examples on the CPU to the same checks."""
    def rel(key, limit=ELBO_RTOL):
        return _bar(key, _rel(got[key], ref[key]), limit)

    def pred(key):
        return _bar(key, _max_rel(got[key], ref[key]), EXAMPLE_PREDICT_TOL)

    def theta(key):
        return _bar(key, _theta_rel(got[key], ref[key]), THETA_RTOL)

    def iterative(key):
        return _bar(key, _max_rel(got[key], ref[key]), EXAMPLE_ITERATIVE_TOL)

    if n == 1:
        return [rel("elbo_short"), rel("elbo_long"),
                _bar("tstar", _max_rel(got["tstar"], ref["tstar"]), 0.0),
                pred("mean"), pred("std")]
    if n == 2:
        return [rel("initial_elbo"), rel("elbo", THETA_RTOL),
                rel("fun", THETA_RTOL), theta("theta")]
    if n == 3:
        return [rel("initial_elbo"),
                _same("restarts", len(got["restart_elbos"]),
                      len(ref["restart_elbos"])),
                _same("winner", got["winner"], ref["winner"]),
                rel("elbo", THETA_RTOL),
                _bar("restart_elbos", _x_rel(got["restart_elbos"],
                                             ref["restart_elbos"]),
                     THETA_RTOL), theta("theta")]
    if n == 4:
        return [_same("converged", got["converged"], ref["converged"]),
                _same("iteration", got["iteration"], ref["iteration"]),
                _same("names", [str(s) for s in got["names"]],
                      ref["names"]),
                rel("acceptance"),
                _bar("chain_mean", _x_rel(got["chain_mean"],
                                          ref["chain_mean"]), ELBO_RTOL),
                _bar("chain_std", _x_rel(got["chain_std"],
                                         ref["chain_std"]), ELBO_RTOL),
                rel("logz")]
    if n == 5:
        return [rel("elbo_mixed", MIXED_POLISH3_RTOL), rel("elbo_plain"),
                *_nuts_checks(got, ref),
                _gap_check("CG vs dense gap", got["gap"], ref["mean_cg"]),
                iterative("mean_cg"), iterative("std_cg")]
    if n == 6:
        return [rel("elbo0"), rel("elbo", THETA_RTOL), rel("fun", THETA_RTOL),
                theta("x"), _same("nit", got["nit"], ref["nit"]),
                _same("nfev", got["nfev"], ref["nfev"]),
                _gap_check("LOVE vs dense mean gap", got["love_dmean"],
                           ref["mean_love"]),
                _gap_check("LOVE vs dense std gap", got["love_dstd"],
                           ref["std_love"]),
                iterative("mean_love"), iterative("std_love"),
                *_nuts_checks(got, ref)]
    if n == 7:
        return [rel("e_ref"), rel("e_3sweep", MIXED_POLISH3_RTOL),
                rel("e_conv", EXAMPLE_CONVERGE_RTOL),
                _same("winner", got["winner"], ref["winner"]),
                _bar("restart_elbos", _x_rel(got["restart_elbos"],
                                             ref["restart_elbos"]),
                     THETA_RTOL),
                rel("elbo", THETA_RTOL), theta("theta"),
                _same("nit", got["nit"], ref["nit"])]
    if n == 8:
        return [rel("elbo"), _same("iterations", got["iterations"],
                                   ref["iterations"]),
                pred("served_25"), pred("served_400"), pred("mean_serve"),
                ("served vs in-process", got["dev"] < SERVE_DEV_TOL,
                 f"{got['dev']:.3e} (limit {SERVE_DEV_TOL:.0e})")]
    raise ValueError(f"no example {n}")


def examples_main(torch, ck, numbers=EXAMPLE_NUMBERS):
    """Phase 35 in this process: worked examples ``numbers``, each one's
    ``main("cuda")``, imported by module name, in a temporary working
    directory, its values against the cached JAX examples', its launches
    (set to 0 before it and read after it) and its wall.  Example 3's
    restarts run in the rank ``spawn`` starts, whose launches stay in that
    process: its count is the parent's.  The last line is the JSON record
    the parent reads."""
    import importlib
    import tempfile
    os.environ.setdefault("MPLBACKEND", "Agg")
    sys.path.insert(0, EXAMPLES_DIR)
    with open(EXAMPLES_REFERENCE) as f:
        reference = json.load(f)
    from gpyrn_tpu_torch.ops import _build
    _build.build("kernel_matrix")
    walls, by_example, instances = {}, {}, []
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    for n in numbers:
        module = importlib.import_module(f"torch_example_{n}")
        ck.reset_launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                got, wall = _timed(torch, lambda: module.main("cuda"))
            finally:
                os.chdir(cwd)
        launches = dict(ck.LAUNCHES)
        walls[n], by_example[n] = wall, launches
        instances.append(dict(ck.MATVEC_INSTANCES))
        print(f"example {n}: {wall:.2f} s, launches {launches}",
              flush=True)
        _check(f"example {n}", example_checks(n, got, reference[str(n)]))
        if launches["kernel_matrix"] == 0:
            raise AssertionError(f"example {n} never launched "
                                 "kernel_matrix")
        if n in EXAMPLES_WITH_MATVEC and launches["kernel_matvec"] == 0:
            raise AssertionError(f"example {n} never launched "
                                 "kernel_matvec")
    total = {k: sum(c[k] for c in by_example.values())
             for k in by_example[numbers[0]]}
    seconds = time.perf_counter() - t_phase
    print(f"examples {list(numbers)} launches: {total}; this process took "
          f"{seconds:.1f} s (the examples {sum(walls.values()):.1f} s)",
          flush=True)
    print(json.dumps({"launches": total, "by_example": by_example,
                      "walls": walls, "seconds": seconds,
                      "instances": _merged(instances)}), flush=True)


def _child(arg):
    """The output lines of this script run with ``arg`` in a fresh
    process; its failure fails the run."""
    return _children([[arg]])[0]


def _children(args):
    """The output lines of this script run with each argument list of
    ``args``, the processes side by side; a failure of any fails the
    run."""
    import tempfile
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in args]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *a], stdout=out, stderr=err, text=True)
             for a, (out, err) in zip(args, files)]
    outs = []
    for a, p, (out, err) in zip(args, procs, files):
        p.wait()
        out.seek(0)
        err.seek(0)
        sys.stderr.write(err.read())
        text = out.read()
        out.close()
        err.close()
        if p.returncode != 0:
            sys.stdout.write(text)
            raise AssertionError(f"the child process ({' '.join(a)}) "
                                 f"failed with exit code {p.returncode}")
        outs.append(text.strip().splitlines())
    return outs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    if sys.argv[1:] == [SERVE_ARG]:
        serve_main(torch)
        return
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
    if sys.argv[1:] == [LARGE_ARG]:
        large_main(torch, pkg, ck, lin)
        return
    if sys.argv[1:2] == [MAGMA_ARG]:
        magma_batched_solve(torch, int(sys.argv[2]))
        return
    if sys.argv[1:] == [PARALLEL_ARG]:
        parallel_main(torch, pkg)
        return
    if sys.argv[1:2] == [EXAMPLES_ARG]:
        numbers = (tuple(int(n) for n in sys.argv[2].split(","))
                   if len(sys.argv) > 2 else EXAMPLE_NUMBERS)
        examples_main(torch, ck, numbers)
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
    spilled = phase_build(_build, ck)

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
    if min(grad_launches[k] for k in B1_KERNELS) == 0:
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
    if min(implicit_launches[k] for k in B1_KERNELS) == 0:
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

    # the gradient paths over a batch: the θ-batched gradient, HMC and
    # NUTS on it, the multistart population and nonparametric VI
    ck.reset_launch_counts()
    print("== phase 21: batched gradient, headline model, 4 rows",
          flush=True)
    t_sampler = time.perf_counter()
    grad_wall = phase_batched_grad(torch, pkg, oracle, ck, lin)
    print("== phase 22: HMC, headline model", flush=True)
    phase_sampler(torch, pkg, oracle, ck, "hmc", grad_wall)
    print("== phase 23: NUTS, headline model", flush=True)
    phase_sampler(torch, pkg, oracle, ck, "nuts", grad_wall)
    print("== phase 24: multistart and nonparametric VI, headline model",
          flush=True)
    phase_search(torch, pkg, oracle, ck)
    sampler_launches = dict(ck.LAUNCHES)
    print(f"sampler path launches: {sampler_launches}; phases 21-24 took "
          f"{time.perf_counter() - t_sampler:.1f} s", flush=True)
    if min(sampler_launches[k] for k in B1_KERNELS) == 0:
        raise AssertionError("the sampler path never launched one of its "
                             f"kernels: {sampler_launches}")

    # the large-N stack: the lean engines, the matrix-free solve, the CG
    # fit, prediction and SVI, in a process of its own
    print("== phases 25-28: the large-N stack, in a fresh process",
          flush=True)
    lines = _child(LARGE_ARG)
    print("\n".join(lines[:-1]), flush=True)
    large = json.loads(lines[-1])
    large_launches = large["launches"]
    if large_launches["kernel_matrix"] == 0:
        raise AssertionError("the large-N path never launched "
                             "kernel_matrix")

    # the Keplerian RV workflow, then the served predictive
    from gpyrn_tpu_torch.utils.profiling import StageTimer
    timer = StageTimer()
    t_rv = time.perf_counter()
    ck.reset_launch_counts()
    print("== phase 29: astro, keplerian_rv on the card", flush=True)
    with timer.stage("phase 29: astro"):
        phase_astro(torch, pkg, oracle)
    print("== phase 30: the RV workflow, solar model", flush=True)
    with timer.stage("phase 30: solar"):
        phase_solar(torch, pkg, oracle, ck)
    solar_launches = dict(ck.LAUNCHES)
    print(f"solar path launches: {solar_launches}", flush=True)
    if min(solar_launches[k] for k in B1_KERNELS) == 0:
        raise AssertionError("the solar path never launched one of its "
                             f"kernels: {solar_launches}")
    print("== phase 31: serving, export on the card and a fresh serving "
          "process", flush=True)
    with timer.stage("phase 31: serving"):
        served_launches, headline_time = phase_serving(torch, pkg, oracle,
                                                       ck, lin)
    serving_launches = {"kernel_matrix": served_launches,
                        "kernel_matrix_grad": 0, "kernel_matvec": 0}
    print(f"serving path launches (the serving process): "
          f"{serving_launches}", flush=True)
    print("== phase 32: profiling", flush=True)
    phase_profiling(torch, timer, os.path.join(SERVE_DIR, "headline.pt2"),
                    headline_time)
    import shutil
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    print(f"phases 29-32 took {time.perf_counter() - t_rv:.1f} s",
          flush=True)

    # the multi-device layer, in a process of its own: its ranks count
    # their own launches, set to 0 before the path and read after it
    print("== phases 33-34: the multi-device layer, in a fresh process",
          flush=True)
    lines = _child(PARALLEL_ARG)
    print("\n".join(lines[:-1]), flush=True)
    parallel = json.loads(lines[-1])
    parallel_launches = parallel["launches"]
    if parallel_launches["kernel_matrix"] == 0:
        raise AssertionError("the parallel path never launched "
                             "kernel_matrix")

    # the worked examples, in processes of their own: the counts set to 0
    # before each example and read after it
    print(f"== phase 35: the worked examples on the card, in "
          f"{len(EXAMPLE_GROUPS)} fresh processes side by side "
          f"{list(EXAMPLE_GROUPS)}", flush=True)
    t_examples = time.perf_counter()
    groups = _children([[EXAMPLES_ARG, ",".join(map(str, g))]
                        for g in EXAMPLE_GROUPS])
    records = []
    for lines in groups:
        print("\n".join(lines[:-1]), flush=True)
        records.append(json.loads(lines[-1]))
    examples = {
        "by_example": dict(sorted(
            (n, c) for r in records for n, c in r["by_example"].items())),
        "walls": dict(sorted(
            (n, w) for r in records for n, w in r["walls"].items())),
        "instances": _merged([r["instances"] for r in records])}
    examples_launches = {k: sum(r["launches"][k] for r in records)
                         for k in records[0]["launches"]}
    print(f"examples launches: {examples_launches}; walls (s): "
          f"{examples['walls']}; phase 35 took "
          f"{time.perf_counter() - t_examples:.1f} s", flush=True)

    kernels = []
    for kname, rec in (("kernel_matrix", record),
                       ("kernel_matrix_grad", grad_record)):
        by_path = {"fit": fit_launches[kname], "grad": grad_launches[kname],
                   "mixed": mixed_launches[kname],
                   "implicit": implicit_launches[kname],
                   "batch": batch_launches[kname],
                   "sampler": sampler_launches[kname],
                   "large": large_launches[kname],
                   "solar": solar_launches[kname],
                   "serving": serving_launches[kname],
                   "parallel": parallel_launches[kname],
                   "examples": examples_launches[kname]}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "gpyrn_tpu_torch/csrc/kernel_matrix.cu",
            "replaces": "gpyrn_tpu/ops/pallas_kernels.py:122",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **rec})
    kernels[0]["n20000"] = large["wide"]["b1"]
    # B1's slab entry (the panel path's slabs): its launches on phases
    # 33-34, its error against the plain version, its times
    kernels[0]["slab"] = parallel["slab"]
    # B1's product entry: the matrix-free paths' matvecs; its record is
    # the CG solve's shape (N=50,000, float32, one column), the others
    # beside it
    product = large["solve"]["product"]
    by_path = {"fit": fit_launches["kernel_matvec"],
               "grad": grad_launches["kernel_matvec"],
               "mixed": mixed_launches["kernel_matvec"],
               "implicit": implicit_launches["kernel_matvec"],
               "batch": batch_launches["kernel_matvec"],
               "sampler": sampler_launches["kernel_matvec"],
               "large": large_launches["kernel_matvec"],
               "solar": solar_launches["kernel_matvec"],
               "serving": serving_launches["kernel_matvec"],
               "parallel": parallel_launches["kernel_matvec"],
               "examples": examples_launches["kernel_matvec"]}
    # the product entry's instances the paths launched: none may spill
    instances = _merged([large["instances"], parallel["instances"],
                         examples["instances"]])
    launched_spills = sorted(k for k in instances if k in spilled)
    print(f"B1's product entry, instances the paths launched: {instances}; "
          f"of them spill: {launched_spills}; instances that spill and no "
          f"path launched: {sorted(set(spilled) - set(instances))}",
          flush=True)
    if launched_spills:
        raise AssertionError(f"the paths launched product-entry instances "
                             f"that spill: {launched_spills}")
    main_rec = product["float32 m=1"]
    kernels.append({
        "name": "kernel_matvec", "route": "cuda",
        "source": "gpyrn_tpu_torch/csrc/kernel_matrix.cu",
        "replaces": "gpyrn_tpu/ops/iterative.py:43 (XLA) / B1 slab entry",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_by_phase": {**large["matvec_by_phase"],
                              **parallel["matvec_by_phase"]},
        **{k: main_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "pipe_bound_ms", "sass_issue_ms",
                                    "yardstick_ms")},
        "launches_by_instance": instances, "n50000": product})
    if min(by_path["large"], by_path["parallel"]) == 0:
        raise AssertionError(f"the matrix-free paths never launched "
                             f"kernel_matvec: {by_path}")
    # the worked examples' launches, example by example
    for rec in kernels:
        rec["launches_by_example"] = {
            n: c[rec["name"]] for n, c in examples["by_example"].items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
