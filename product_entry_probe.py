#!/usr/bin/env python3
"""Times B1's product entry against variants of its own design on one
NVIDIA GPU (Hopper, sm_90a).

    python3 product_entry_probe.py [--parent-source PATH] [--out PATH]

Each variant is ``gpyrn_tpu_torch/csrc/kernel_matrix.cu`` with a few lines
replaced (``VARIANTS``), written to ``gpyrn_tpu_torch/_build/probe/`` and
built by nvcc with the package's flags, all builds started together; every
build keeps the SE and QP leaf instances only (the others run the
interpreter), which is all that is timed.  The package's source carries
none of these variants:

* ``main``: the source as the package builds it;
* ``m8n8k4``: the tiled path's float64 product on ``mma.sync`` m8n8k4 (the
  sm_80 shape) in place of m16n8k8 and m16n8k4;
* ``bk32``: float64 k-blocks of 32 columns in place of 36;
* ``narrow``: float32's narrow tile (64 x 128) above 128 columns too;
* ``u2``, ``u4``: the register path's one-column float32 instance taking
  two or four columns a pass, in place of its plain column loop;
* ``widths``: the register path at every power of two up to 32 columns
  (64-column steps, so that two steps of 32 float64 columns fit the 48 KB
  of static shared memory);
* ``tiled``: the tiled path at every m;
* ``parent`` (with ``--parent-source``): another version of the source.

On QP(1, 300, 200, 0.7) and SE(1, 300) at N=50,000 (nugget 1e-2), each
call is held against the plain version (max error over max |y|) and
timed with CUDA events (the median of the calls after two warm-ups),
the variants of a reading in turns, the first one first and last.
Prints ptxas's resources of the variants' product-entry instances, one
line per reading, the card's name and power limit, and writes every
reading to ``--out`` (default ``OUT``).  Needs one card and nvcc; exits
non-zero without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 50000
STRUCTS = {"QP": (("QP",), (1.0, 300.0, 200.0, 0.7)),
           "SE": (("SE",), (1.0, 300.0))}
NUGGET = 1e-2
OUT = os.path.join(HERE, "gpyrn_tpu_torch", "_build", "probe",
                   "product_entry_probe.json")

_M8N8K4 = """\
  for (int k = 0; k < BK; k += 4) {
    double a[8], b[4];
#pragma unroll
    for (int mi = 0; mi < 8; ++mi) a[mi] = ka[(k + q) * ld + 8 * mi];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) b[ni] = vb[(k + q) * vld + 8 * ni];
#pragma unroll
    for (int mi = 0; mi < 8; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        double* c = acc + 2 * (4 * mi + ni);
        asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};"
            : "+d"(c[0]), "+d"(c[1]) : "d"(a[mi]), "d"(b[ni]));
      }
  }
"""
_LADDER = """\
  if (m == 1) {
    RUN(1);
  } else if (m <= 2) {
    RUN(2);
  } else if (m <= 4) {
    RUN(4);
  } else if (m <= 8) {
    RUN(8);
  } else if (m <= 16) {
    RUN(16);
  } else {
    RUN(32);
  }
"""
# (pattern, replacement) pairs, each pattern a regular expression that
# must match the source exactly once
VARIANTS = {
    "main": (),
    "m8n8k4": (
        (r"  for \(int k = 0; k \+ 8 <= BK; k \+= 8\) mt_mma_step<8>.*\n"
         r"  if constexpr \(BK % 8 == 4\) mt_mma_step<4>.*\n", _M8N8K4),
        (r"return 64 \* wm \+ 16 \* \(f / 16\) \+ 8 \* \(f % 4 / 2\) \+ g;",
         "return 64 * wm + 8 * (f / 8) + g;"),
        (r"return 32 \* wn \+ 8 \* \(f / 4 % 4\) \+ 2 \* q \+ f % 2;",
         "return 32 * wn + 8 * (f / 2 % 4) + 2 * q + f % 2;")),
    "bk32": ((r"sizeof\(T\) == 4 \? 48 : 36;", "sizeof(T) == 4 ? 48 : 32;"),
             (r"  static_assert\(WIDE \?[^;]*;\n", "")),
    "narrow": ((r"return sizeof\(T\) == 4 && m > 128;", "return 0;"),),
    "u2": ((r"sizeof\(T\) == 4 && W == 1 \? 1 : 4;",
            "sizeof(T) == 4 && W == 1 ? 2 : 4;"),),
    "u4": ((r"sizeof\(T\) == 4 && W == 1 \? 1 : 4;",
            "sizeof(T) == 4 && W == 1 ? 4 : 4;"),),
    "widths": ((r"#define MV_STAGE 256", "#define MV_STAGE 64"),
               (r"#define MV_CAP 8 ", "#define MV_CAP 32 "),
               (r"  if \(m == 1\) \{\n    RUN\(1\);\n  \} else \{\n"
                r"    RUN\(MV_CAP\);\n  \}\n", _LADDER)),
    "tiled": ((r"  if \(m <= MV_CAP\) \{\n    const int groups",
               "  if (false) {\n    const int groups"),),
}
STAGE = {"widths": 64}
LEAVES = "#define FOR_EACH_LEAF(X) X(OP_SE) X(OP_QP)\n"


def variant_source(src, patches):
    """src with SE's and QP's leaf instances only and each patch made."""
    src, n = re.subn(r"#define FOR_EACH_LEAF\(X\)(?:[^\n]*\\\n)*[^\n]*\n",
                     LEAVES, src)
    assert n == 1, "FOR_EACH_LEAF"
    for pattern, new in patches:
        src, n = re.subn(pattern, lambda _: new, src)
        assert n == 1, f"{pattern!r} matched {n} times"
    return src


def build_all(_build, parent):
    """Starts one nvcc per variant, all together; returns {variant:
    (library path, nvcc's output)} once every build has ended."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.source_path("kernel_matrix").read_text()
    sources = {name: variant_source(src, p) for name, p in VARIANTS.items()}
    if parent:
        with open(parent) as f:
            sources["parent"] = variant_source(f.read(), ())
    procs = {}
    t0 = time.perf_counter()
    for name, text in sources.items():
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = (str(lib), log)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} "
          f"s (together)", flush=True)
    return built


def report_resources(_build, built):
    """ptxas's registers, stack frame and spills of each variant's SE and
    QP product-entry instances."""
    inst = re.compile(r"_Z\d+(kernel_matvec(?:_tiled)?_kernel)I([df])"
                      r"Li(3|5)E(?:Li(\d+)E)?")
    for name, (_, log) in built.items():
        for entry, use in sorted(_build.resource_usage(log).items()):
            m = inst.match(entry)
            if m:
                print(f"{name}: ptxas {m[1]}<{m[2]}, "
                      f"{'SE' if m[3] == '3' else 'QP'}, {m[4]}>: "
                      f"{use['registers']} registers, {use['stack_frame']} "
                      f"bytes stack frame, {use['spill_stores']} / "
                      f"{use['spill_loads']} bytes spill stores / loads",
                      flush=True)


def time_ms(torch, fn, reps):
    for _ in range(2):
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("product_entry_probe: no CUDA device")
    sys.path.insert(0, HERE)
    from gpyrn_tpu_torch.ops import _build
    from gpyrn_tpu_torch.ops import cuda_kernels as ck
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-source")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    built = build_all(_build, args.parent_source)
    report_resources(_build, built)
    fns = {}
    for name, (lib, _) in built.items():
        cdll = ctypes.CDLL(lib)
        for dt, sym in ck._MATVEC_SYMBOLS.items():
            fns[(name, dt)] = getattr(cdll, sym)
            fns[(name, dt)].argtypes = ck._matvec_argtypes()
            fns[(name, dt)].restype = ctypes.c_int
    rng = np.random.default_rng(1)
    t64 = torch.tensor(np.sort(rng.uniform(0, 1000, N)), dtype=torch.float64,
                       device="cuda")

    def groups(stage):
        """csrc mv_groups at N for steps of ``stage`` columns."""
        want = -(-4096 // -(-N // 128))
        return -(-N // (-(-(-(-N // want)) // stage) * stage))

    def entry(name, dt, structure, pars, v):
        t, p = t64.to(dt), torch.tensor(pars, dtype=dt, device="cuda")
        nug = torch.tensor(NUGGET, dtype=dt, device="cuda")
        m = v.shape[1]
        y = torch.empty((N, m), dtype=dt, device="cuda")
        partial = torch.empty((groups(STAGE.get(name, 256)), N, m)
                              if m <= 32 else (1,), dtype=dt, device="cuda")
        call = (t.device.index, t.data_ptr(), p.data_ptr(), v.data_ptr(),
                nug.data_ptr(), y.data_ptr(), partial.data_ptr(), N, m, 0, N,
                p.shape[0], *ck._program_args(structure),
                torch.cuda.current_stream().cuda_stream)

        def run():
            err = fns[(name, dt)](*call)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return y
        return run, t, p

    record = {"card": smi, "N": N, "readings": []}

    def reading(what, dt, st, m, order):
        structure, pars = STRUCTS[st]
        v = torch.tensor(np.random.default_rng(m).standard_normal((N, m)),
                         dtype=dt, device="cuda")
        _, t, p = entry("main", dt, structure, pars, v)
        ref = ck.kernel_matvec_ref(structure, p, t, v, NUGGET, 2048)
        for name in order:
            run, _, _ = entry(name, dt, structure, pars, v)
            rel = float((run() - ref).abs().max() / ref.abs().max())
            ms = time_ms(torch, run, 3 if m > 100 else 7)
            print(f"{what}: {name} {str(dt)[6:]} {st} m={m}: {ms:.4f} ms "
                  f"(rel err vs plain {rel:.3e})", flush=True)
            record["readings"].append({"what": what, "variant": name,
                                       "dtype": str(dt)[6:], "structure": st,
                                       "m": m, "ms": ms, "rel_err": rel})
        torch.cuda.empty_cache()

    f32, f64 = torch.float32, torch.float64
    par = ["parent"] if "parent" in built else []
    for m in (64, 1000):
        reading("mma shape", f64, "QP", m, ["main", "m8n8k4", "main"])
        reading("float64 k-block", f64, "QP", m, ["main", "bk32", "bk32",
                                                  "main"])
    reading("float32 tile", f32, "QP", 1000, ["main", "narrow", "narrow",
                                              "main"])
    for st in ("SE", "QP"):
        reading("one-column float32 pass", f32, st, 1,
                par + ["main", "u2", "u4", "main"] + par)
    for dt in (f32, f64):
        for m in (4, 8, 16, 32):
            reading("MV_CAP", dt, "QP", m, ["widths", "tiled", "widths"])
    if par:
        for dt in (f32, f64):
            for st, m in (("SE", 1), ("QP", 1), ("QP", 8), ("QP", 64),
                          ("QP", 1000)):
                if dt == f32 and m == 1:
                    continue   # read above
                reading("parent", dt, st, m, ["parent", "main", "main",
                                              "parent"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
