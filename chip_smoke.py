#!/usr/bin/env python3
"""Smoke run of gpyrn_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the run
ends non-zero:

1. environment: torch / CUDA / nvcc versions and the card's name and
   power limit (fails without a CUDA device);
2. build: compiles ``gpyrn_tpu_torch/csrc/kernel_matrix.cu`` with nvcc
   into ``gpyrn_tpu_torch/_build/`` and reports the time;
3. kernel vs plain version on the card: six structures,
   N ∈ {3, 255, 257, 1000, 4096}, float64 and float32, jitter multiplier
   4 and 0, with the kernel's and the plain version's times;
4. main path, headline model (N=1000, q=1, p=3, QuasiPeriodic node,
   SquaredExponential weights): a 10-sweep ``ELBOcalc`` on the card
   against the same on the CPU and against the JAX package's cached value
   (``chip_smoke_oracle.json``), then a converged ``ELBOcalc`` and
   ``predict(nn=1000)`` on the card;
5. main path, flagship model (N=1000, q=2, p=3, Periodic + Matern52
   nodes, Linear means): the same checks.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "chip_smoke_oracle.json")
N_MAIN = 1000
FIT_SWEEPS = 10

# parity tolerances of the main path (relative ELBO; max-abs/(1+max) of
# the variational state): the card's cuSOLVER and the CPU's LAPACK round
# differently, and the contraction of the sweep map damps the difference
ELBO_RTOL = 1e-9
STATE_TOL = 1e-7


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
KERNEL_NS = (3, 255, 257, 1000, 4096)
TIMED_NS = (1000, 4096)


def state_summary(mu, var, stride=97):
    """Strided samples of the variational state (what the cached oracle
    keeps of it)."""
    mu = np.asarray(mu, dtype=float).ravel()
    var = np.asarray(var, dtype=float).ravel()
    return {"mu": mu[::stride].tolist(), "var": var[::stride].tolist()}


def _rel_state_err(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


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
    """Device time per call (ms) from a torch.profiler trace: the summed
    durations of the CUDA kernels ``fn`` launches (only those whose name
    holds ``name``, when given), over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and (name is None or name in e.name))
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return total_us / reps / 1e3


def phase_kernels(torch, ck, lin):
    """Kernel vs plain version on the card; returns the record of the
    headline node's structure at N=1000 in float64."""
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
                    worst = max(worst, float(err.max()) / max(k0, 1e-300))
            print(f"kernel_matrix {structure} {str(dtype)[6:]}: "
                  f"N={list(KERNEL_NS)} mult=(4, 0) agree", flush=True)
    launched = ck.LAUNCHES["kernel_matrix"] - before
    if launched != n_cases:
        raise AssertionError(f"launch counter moved by {launched}, "
                             f"expected {n_cases}")
    print(f"kernel vs plain: {n_cases} cases agree, worst max-abs-err / "
          f"k(0) = {worst:.3e}", flush=True)

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
                if (dtype == torch.float64 and structure == ("QP",)
                        and N == N_MAIN):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "call_ms": call_ms,
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

    print("== phase 1: environment", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device count "
          f"{torch.cuda.device_count()}", flush=True)
    print(_run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {smi}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    path = _build.build("kernel_matrix")
    print(f"built {os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print("== phase 3: kernel vs plain version on the card", flush=True)
    record = phase_kernels(torch, ck, lin)

    with open(ORACLE) as f:
        oracle = json.load(f)
    # the main path: every launch from here on is the port's own
    ck.reset_launch_counts()
    for i, name in enumerate(("headline", "flagship"), start=4):
        print(f"== phase {i}: main path, {name} model", flush=True)
        phase_main(torch, pkg, name, oracle[name], ck)
    launches = ck.LAUNCHES["kernel_matrix"]
    if launches == 0:
        raise AssertionError("the main path never launched kernel_matrix")

    print(json.dumps({"kernels": [{
        "name": "kernel_matrix", "route": "cuda",
        "source": "gpyrn_tpu_torch/csrc/kernel_matrix.cu",
        "replaces": "gpyrn_tpu/ops/pallas_kernels.py:122",
        "launches": launches, **record}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
