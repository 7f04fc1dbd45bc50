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
    QP + 3 × SE list, float64 and float32; and the host's time per call
    of ``linalg.kernel_matrix_stack`` against the matrix-by-matrix build
    with ``torch.stack``;
11. in a fresh process (``chip_smoke.py --profile``): a traced 30-sweep
    gradient call of the headline model, then B1's and B1′'s device times
    against their plain versions' and their bounds.  After some dozens of
    profiled runs and ~150k traced kernels in one process,
    torch.profiler was seen to lose records (an H100, torch 2.11), so the
    profiled work gets a process of its own.

The launch counts are set to 0 before each path (phases 3–5, phases
6–7) and read after it.  The last three lines are the kernels' JSON
record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
# the argument of the child process that runs the profiled phase
PROFILE_ARG = "--profile"
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


def _device_ms(torch, fn, reps, name=None):
    """Device time per call (ms) from a torch.profiler trace of ``reps``
    calls of ``fn``: the summed durations of all its CUDA kernels over
    ``reps``; or, when ``name`` is given, of the kernels whose name holds
    it, each launched once per call: the mean duration of each such
    kernel, summed over their names (unmoved if the trace lost some
    records)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                name is None or name in e.name):
            durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not durations:
        raise AssertionError("the profiler saw no device time")
    if name is None:
        return sum(map(sum, durations.values())) / reps / 1e3
    return sum(sum(d) / len(d) for d in durations.values()) / 1e3


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g_gpu.ELBOcalc()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    km = sum(e.time_range.elapsed_us() for e in kernels
             if "kernel_matrix_kernel" in e.name) / 1e3
    print(f"{name}: traced converged ELBOcalc: wall {1e3 * wall:.3f} ms, "
          f"device kernels {busy:.3f} ms in {len(kernels)} launches "
          f"(idle share {1 - busy / (1e3 * wall):.3f}), kernel_matrix "
          f"{km:.4f} ms ({km / busy:.5f} of device time)", flush=True)


def _traced(torch, fn):
    """One traced call: (wall ms, [(kernel name, device ms)] of every CUDA
    kernel the trace holds)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    return wall, kernels


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


def profile_main(torch, pkg, ck, lin):
    """Everything timed by torch.profiler, run in a fresh process: the
    traced gradient call, then B1's and B1′'s times.  Its last line is
    the JSON of the two kernels' records."""
    trace_grad_path(torch, pkg)
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

    print("== phase 11: a traced gradient call and the kernels' times, in "
          "a fresh process", flush=True)
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            PROFILE_ARG], capture_output=True, text=True)
    lines = child.stdout.strip().splitlines()
    sys.stderr.write(child.stderr)
    if child.returncode != 0:
        sys.stdout.write(child.stdout)
        raise AssertionError(f"the profiling process failed with exit code "
                             f"{child.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    records = json.loads(lines[-1])["records"]
    record, grad_record = records["kernel_matrix"], \
        records["kernel_matrix_grad"]

    kernels = []
    for kname, rec in (("kernel_matrix", record),
                       ("kernel_matrix_grad", grad_record)):
        by_path = {"fit": fit_launches[kname], "grad": grad_launches[kname]}
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
