"""One run of one cell: set-up, a measured window, the correctness check
and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's structure, parameters and data;
* ``reference/kernels/<Name>.py``, ``reference/means/<Name>.py``: the
  plain reference's component of each package class a configuration
  names;
* ``traffic/<traffic>.json``: the mix's parameters, read by the one
  generator (``generator.py``), and the entry it drives
  (``entries/<entry>.py``);
* ``workloads/<cell>.json``: the cell's configuration and mix, and what
  its correctness check compares and the limit of each number;
* ``metrics/<metric>.py``: a reader ``read(run)`` of one metric, which
  returns None when the run holds nothing it reads.

The window is a closed loop: each batch of fits starts when the one
before it has returned, as a sampler's next step waits for its fits.  Its
batches come from ``--seed`` (``generator.Batches``), and it closes at
the first batch (or pass) boundary after the window's seconds: a rate is
all the work done over all the time it took, and no batch is cut.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from h100_bench import generator, port, trace as trace_mod
from h100_bench.reference import gprn as ref
from h100_bench.results import Fits

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpyrn_tpu")


class Unit(NamedTuple):
    """One batch of fits in the window."""
    seconds: float
    rows: int
    sweeps: int          # the batch's sweeps: its rows' largest count
    n_iter: np.ndarray   # (rows,) each row's sweeps
    traced: bool


class Run(NamedTuple):
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    dtype: str
    setup_s: float
    window_s: float
    units: list
    trace: Optional[trace_mod.Trace]

    @property
    def untraced(self):
        return [u for u in self.units if not u.traced]


class Bench:
    """The benchmark's files under ``root`` and its ``BENCHMARK.json``."""

    def __init__(self, root=ROOT, benchmark=REPO / "BENCHMARK.json"):
        self.root = Path(root)
        self.spec = json.loads(Path(benchmark).read_text())

    def _json(self, kind, name):
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} file {path}")
        return json.loads(path.read_text())

    def cell(self, name):
        if name not in {w["name"] for w in self.spec["workloads"]}:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        return self._json("workloads", name)

    def config(self, name):
        return self._json("configs", name)

    def traffic(self, name):
        return self._json("traffic", name)

    def metrics(self, kind, cell):
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those whose ``workloads`` list it (an end-to-end metric
        without the list goes with every cell)."""
        if kind == "end_to_end":
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric):
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"h100_bench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def entry(self, name):
        return importlib.import_module(f"h100_bench.entries.{name}").Entry


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that this benchmark may not load,
    each compared whole (``gpyrn_tpu_torch`` is not ``gpyrn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _rel(a, b):
    """max |a - b| / max |b|, inf where either side is not finite."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return math.inf
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def compare(model, chosen, pool, device, max_iter):
    """The checks' numbers over the ``chosen`` fits [(theta row, walker or
    None, Fits of one row on the host)]: the plain reference ``model``
    fits each row again in float64 on ``device``, from its walker's state
    where it has one (the reference fits the walkers itself first), in
    chunks of rows that fit in the device's free memory."""
    import torch

    def put(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    t, y, yerr2 = put(pool.t), put(pool.y), put(pool.yerr ** 2)
    theta = put(np.stack([c[0] for c in chosen]))
    start = None
    if chosen[0][1] is not None:
        walkers = sorted({int(c[1]) for c in chosen})
        mu, var = ref.walker_states(model, put(pool.walkers[walkers]), t, y,
                                    yerr2, max_iter)
        at = torch.as_tensor([walkers.index(int(c[1])) for c in chosen],
                             device=device)
        start = (mu[at], var[at])
    r_elbo, r_mu, r_var, r_n, _ = (x.cpu().numpy() for x in ref.elbo_fit(
        model, theta, t, y, yerr2, max_iter, start))
    elbo_rel = state_rel = 0.0
    n_iter_diff = 0
    for k, (_, _, fits) in enumerate(chosen):
        e, r = float(fits.elbo), float(r_elbo[k])
        elbo_rel = max(elbo_rel, abs(e - r) / abs(r)
                       if math.isfinite(e) and math.isfinite(r)
                       else math.inf)
        state_rel = max(state_rel, _rel(fits.mu, r_mu[k]),
                        _rel(fits.var, r_var[k]))
        n_iter_diff += int(int(fits.n_iter) != int(r_n[k]))
    return {"elbo_rel": elbo_rel, "state_rel": state_rel,
            "n_iter_diff": n_iter_diff}


def _window(program, batches, states, seconds, traced, device, entry):
    """The measured window: ``(units, fits, rows, traces, seconds)``, the
    window's batches, what each returned and its rows [(theta, walkers)],
    and in a traced run the two traces (keyed by whether the host was
    recorded).  ``states`` (mu, var) are the walkers' states, for mixes
    with walkers.

    A traced run traces its first batch with the device alone (the
    per-layer readings), then one with the host's operators too (the
    breakdown's idle gaps); each is taken again on the next batch if it
    came back with no device interval."""
    from torch.profiler import record_function
    span = f"h100_bench: {entry}"
    units, fits, rows = [], [], []
    traces = {False: None, True: None}
    tries = 0
    opened = time.perf_counter()
    while True:
        theta, walkers = batches.next()
        start = None if walkers is None else (states[0][walkers],
                                              states[1][walkers])
        want = [h for h in (False, True) if traces[h] is None] \
            if traced else []
        u0 = time.perf_counter()
        if want:
            def unit():
                with record_function(trace_mod.SLICE):
                    with record_function(span):
                        out = program.fit(theta, start)
                    _sync(device)
                return out
            out, tr = trace_mod.profile(unit, host=want[0])
            tries += 1
            if tr.device:
                traces[want[0]] = tr
            elif tries >= 2 * trace_mod.TRIES:
                raise RuntimeError(f"{tries} traces of the window held no "
                                   f"device interval")
        else:
            out = program.fit(theta, start)
            _sync(device)
        sec = time.perf_counter() - u0
        n_iter = out.n_iter.cpu().numpy()
        units.append(Unit(sec, len(theta), int(n_iter.max()), n_iter,
                          bool(want)))
        fits.append(out)
        rows.append((theta, walkers))
        if time.perf_counter() - opened >= seconds and batches.boundary \
                and (not traced or (
                None not in traces.values()
                and any(not u.traced for u in units))):
            return units, fits, rows, traces, time.perf_counter() - opened


def _chosen(units, fits, rows, batches, k):
    """The ``k`` fits the check compares, drawn from the seed with the one
    that took most sweeps: [(row, walker or None, Fits of the row on the
    host)]."""
    index = [(u, r) for u, unit in enumerate(units) for r in range(unit.rows)]
    longest = int(np.argmax(np.concatenate([u.n_iter for u in units])))
    out = []
    for i in batches.sample(len(index), k, must=[longest]):
        u, r = index[i]
        f, (theta, walkers) = fits[u], rows[u]
        out.append((theta[r], None if walkers is None else int(walkers[r]),
                    Fits(f.elbo[r].cpu().numpy(), f.mu[r].cpu().numpy(),
                         f.var[r].cpu().numpy(), f.n_iter[r].cpu().numpy())))
    return out


def run_cell(bench, name, seed, seconds, traced, device="cuda", dtype=None,
             t_start=None):
    """One run of the cell ``name`` with a window of ``seconds``: the
    result line (a dict, ``checks`` last).  ``dtype`` puts the package's
    path in that dtype in place of the configuration's (the control)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    dtype = dtype or config["dtype"]
    # the reference's components, before set-up: a missing file fails here
    model = ref.Model(config)
    pool = generator.pool(config, traffic, seed)
    batches = generator.Batches(config, traffic, pool, seed)
    program = bench.entry(traffic["entry"])(config, traffic, pool, device,
                                            port.DTYPES[dtype])
    states = None
    if pool.walkers is not None:
        # the sampler's first call: every walker fitted once
        states = program.walker_states(pool.walkers)
        h = int(traffic["rows"])
        program.warm_up(pool.walkers[:h], (states[0][:h], states[1][:h]))
    else:
        program.warm_up(np.tile(generator.theta0(config),
                                (int(traffic["rows"]), 1)))
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    units, fits, rows, traces, window_s = _window(
        program, batches, states, seconds, traced, device, traffic["entry"])
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # what the window produced, to the host; the program's state freed
    elbo_all = np.concatenate([f.elbo.cpu().numpy() for f in fits])
    failed = int((~np.isfinite(elbo_all)).sum())
    check = cell["check"]
    chosen = _chosen(units, fits, rows, batches, int(check["sample"]))
    del fits, program, states
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(cell, config, traffic, dtype, setup_s, window_s, units,
              traces[False])
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, name):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif kind == "end_to_end":
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
    n_iter = np.concatenate([u.n_iter for u in units])
    log("batches (s): " + " ".join(f"{u.seconds:.4f}" for u in units))
    log(f"window: {window_s:.4f} s, {len(units)} batches, {elbo_all.size} "
        f"fits, {sum(u.sweeps for u in units)} batched sweeps, sweeps a fit "
        f"{n_iter.mean():.3f} (least {n_iter.min()}, most {n_iter.max()}); "
        f"set-up {setup_s:.4f} s; peak {memory_peak} bytes")

    r0 = time.perf_counter()
    numbers = compare(model, chosen, pool, device,
                      int(traffic["max_iter"]))
    log(f"reference: {len(chosen)} fits in {time.perf_counter() - r0:.3f} s")
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in check["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    line = {"correct": correct, "attempted": int(elbo_all.size),
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else device,
                       "kind": torch.cuda.get_device_name(0) if cuda
                       else "cpu",
                       "count": next(int(w["chips"])
                                     for w in bench.spec["workloads"]
                                     if w["name"] == name),
                       "memory_peak_bytes": int(memory_peak),
                       "power_limit_w": power_limit_w() if cuda else None}}
    if traced:
        line["device"]["busy_s"] = traces[False].busy_s
        line["device"]["window_s"] = traces[False].window_s
        line["breakdown"] = trace_mod.breakdown(traces[True])
    line["checks"] = checks
    return line
