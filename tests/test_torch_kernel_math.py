"""The arithmetic of the CUDA kernels B1 and B1′, built for the host.

``csrc/kernel_matrix.cu`` compiles its element math (``eval_program``,
``leaf_grad``, ``element_grad``) as plain C++ when it is not compiled by
nvcc.  Here the host's C++ compiler builds that math into a small library
with a loop over the elements in place of the kernels' tiles, and both
kernels' formulas are held against the plain PyTorch versions on the CPU:

* forward: ``k(t_i − t_j)`` against the registry formula, max error over
  max |K| ≤ 1e-13 in float64, 1e-6 in float32 (the host's libm against
  torch's exp / sin / pow);
* gradient: ``Σ G ∂k/∂θ`` against ``kernel_matrix_grad_ref`` (autograd),
  |difference| ≤ 1e-12 (float64) or 1e-5 (float32) of ``Σ |G| |∂k/∂θ|``
  per parameter: the hand-derived derivatives take other operations than
  autograd's chain rule, and the sums run in another order.

The times hold a repeated value, so r = 0 occurs off the diagonal as well
as on it.  The kernels themselves run only on the card
(``tests/test_torch_card.py``).  Needs a C++ compiler; the file imports no
jax."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import LEAF_CASES
from gpyrn_tpu_torch.ops import _build
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.ops import kernels as tk

CASES = LEAF_CASES + [
    (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)),
    (("*", ("QP",), ("C",)), (1.1, 20.0, 13.0, 0.6, 0.8)),
    (("*", ("NRQP",), ("+", ("QNP",), ("+", ("PAC",), ("QCP",)))),
     (1.0, 1.1, 1.3, 15.0, 9.0, 0.9, 1.0, 1.3, 15.0, 9.0, 0.9, 1.1, 3.0,
      7.0, 1.0, 15.0, 9.0, 1.5)),
    (("+", ("*", ("RQP",), ("GammaExp",)), ("*", ("PW",), ("+", ("CP",),
                                                           ("NP",)))),
     (1.0, 1.2, 15.0, 9.0, 0.8, 1.1, 1.4, 6.0, 30.0, 1.0, 9.0, 1.5, 1.0,
      1.3, 9.0, 0.9)),
]
TOLS = {torch.float64: (1e-13, 1e-12), torch.float32: (1e-6, 1e-5)}
N = 33

HARNESS = r"""
#include "kernel_matrix.cu"

static Program program(const int* ops, const int* offs, const int* lhs,
                       const int* rhs, int n_ops) {
  Program p;
  p.n_ops = n_ops;
  for (int k = 0; k < MAX_OPS; ++k) {
    const bool used = k < n_ops;
    p.op[k] = used ? ops[k] : 0;
    p.off[k] = used ? offs[k] : 0;
    p.lhs[k] = used ? lhs[k] : -1;
    p.rhs[k] = used ? rhs[k] : -1;
  }
  return p;
}

template <typename T>
static void matrix(const T* t, const T* par, T* out, int n, const int* ops,
                   const int* offs, const int* lhs, const int* rhs,
                   int n_ops) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      out[i * n + j] = eval_program<T>(p, par, t[i] - t[j]);
}

template <typename T>
static void grad(const T* t, const T* par, const T* G, T* out, int n,
                 int n_params, const int* ops, const int* offs,
                 const int* lhs, const int* rhs, int n_ops) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  T acc[MAX_PARAMS];
  for (int m = 0; m < MAX_PARAMS; ++m) acc[m] = T(0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      element_grad<T>(p, par, t[i] - t[j], G[i * n + j], acc);
  for (int m = 0; m < n_params; ++m) out[m] = acc[m];
}

extern "C" {
void matrix_f64(const double* t, const double* par, double* out, int n,
                const int* o, const int* f, const int* l, const int* r,
                int k) { matrix<double>(t, par, out, n, o, f, l, r, k); }
void matrix_f32(const float* t, const float* par, float* out, int n,
                const int* o, const int* f, const int* l, const int* r,
                int k) { matrix<float>(t, par, out, n, o, f, l, r, k); }
void grad_f64(const double* t, const double* par, const double* G,
              double* out, int n, int m, const int* o, const int* f,
              const int* l, const int* r, int k) {
  grad<double>(t, par, G, out, n, m, o, f, l, r, k);
}
void grad_f32(const float* t, const float* par, const float* G, float* out,
              int n, int m, const int* o, const int* f, const int* l,
              const int* r, int k) {
  grad<float>(t, par, G, out, n, m, o, f, l, r, k);
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernels' element "
                    "math for the host")
    out = tmp_path_factory.mktemp("kernel_math")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    lib = out / "libkernel_math.so"
    # -ffp-contract=off: no fused multiply-add, as -fmad=false on the card
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(_build.source_path("kernel_matrix")
                                       .parent),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(dtype, n_par):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(N + n_par)
    t = np.sort(rng.uniform(0, 100, N)).astype(npdt)
    t[5] = t[4]                    # r = 0 off the diagonal too
    G = rng.standard_normal((N, N)).astype(npdt)
    return t, G


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("structure,pars", CASES,
                         ids=[str(c[0]) for c in CASES])
def test_element_math_matches_autograd(structure, pars, dtype, host_lib):
    fwd_tol, grad_tol = TOLS[dtype]
    sfx = "f64" if dtype == torch.float64 else "f32"
    t, G = _inputs(dtype, len(pars))
    par = np.asarray(pars, dtype=t.dtype)
    prog = ck.encode_program(structure)
    code = (_ints(prog.ops), _ints(prog.offsets), _ints(prog.lhs),
            _ints(prog.rhs), len(prog.ops))

    K = np.zeros((N, N), dtype=t.dtype)
    getattr(host_lib, f"matrix_{sfx}")(_ptr(t), _ptr(par), _ptr(K), N, *code)
    tt, pp = torch.tensor(t), torch.tensor(par)
    K_ref = tk.evaluate(structure, pp, r=tt[:, None] - tt[None, :]).numpy()
    assert np.max(np.abs(K - K_ref)) <= fwd_tol * np.max(np.abs(K_ref))

    g = np.zeros(len(pars), dtype=t.dtype)
    getattr(host_lib, f"grad_{sfx}")(_ptr(t), _ptr(par), _ptr(G), _ptr(g), N,
                                     len(pars), *code)
    g_ref = ck.kernel_matrix_grad_ref(structure, pp, tt,
                                      torch.tensor(G)).numpy()
    t64 = torch.tensor(t, dtype=torch.float64)
    J = torch.autograd.functional.jacobian(
        lambda q: tk.evaluate(structure, q, r=t64[:, None] - t64[None, :]),
        torch.tensor(pars, dtype=torch.float64)).numpy()
    scale = np.einsum("ij,ijm->m", np.abs(G.astype(np.float64)), np.abs(J))
    assert np.all(np.isfinite(g))
    assert np.all(np.abs(g - g_ref) <= grad_tol * scale), \
        (g, g_ref, np.abs(g - g_ref) / scale)
