"""The arithmetic of the CUDA kernels B1 and B1′, built for the host.

``csrc/kernel_matrix.cu`` compiles its element math (``leaf_consts``,
``leaf``, ``leaf_vd``, ``program_value``, ``program_grad``) and its
tile-pair index map as plain C++ when it is not compiled by nvcc.  Here the
host's C++ compiler builds them into a small library with loops over the
elements in place of the kernels' tiles, and both kernels' formulas are
held against the plain PyTorch versions on the CPU:

* forward: ``k(t_i − t_j)`` against the registry formula, max error over
  max |K| ≤ 1e-13 in float64, 1e-6 in float32 (the host's libm against
  torch's exp / sin / pow); the instance the launcher would pick (a single
  leaf's, the pair's) equals the interpreter bit for bit;
* gradient: the fused value-and-derivative leaf, as ``Σ G ∂k/∂θ`` against
  ``kernel_matrix_grad_ref`` (autograd), |difference| ≤ 1e-12 (float64) or
  1e-5 (float32) of ``Σ |G| |∂k/∂θ|`` per parameter: the hand-derived
  derivatives take other operations than autograd's chain rule, and the
  sums run in another order; by the interpreter and by the picked instance;
* the symmetric walk: each lag once, weighted ``G[i,j] + G[j,i]``, against
  the two-sided sum, to the same tolerance;
* the tile-pair index map: every pair I ≥ J exactly once, in order;
* B1's slab entry (rows [r0, r0 + n_rows) of the padded matrix): the
  element rule ``slab_element`` gives the full matrix's rows bit for bit
  inside the N × N matrix, the jitter on its diagonal only, identity in
  the padded rows and columns, and the plain version
  ``kernel_matrix_slab_ref`` to the forward tolerance.
* B1's product entry ((K + nugget·I) @ V, rows [r0, r0 + n_rows)) run
  block by block and thread by thread through the source's own steps
  (``mv_group_range``, ``mv_row_stage``, ``mv_sum_groups`` of the
  register path; ``mt_eval`` of the tiled path's producers,
  ``mt_product`` and ``mt_store`` of its consumers, with the tile shape
  the launcher picks): ragged row tiles, steps, partial sums, K's
  k-blocks, column tiles, the column groups of N=600 summed in order;
  m ∈ {1, 3} (the register path's one- and eight-column instances), then
  the tiled path at MV_CAP + 1 and around its widest column tile (BN,
  BN + 3, 2 BN + 5), against ``kernel_matvec_ref`` to 1e-13 of max |y| in
  float64 and (QP, the float32 micro-tiles and partials) to 1e-5 in
  float32; a slab's rows equal the whole product's bit for bit; the
  group count and the column tile equal the wrapper's
  (``matvec_groups``, ``matvec_tile_cols``).

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
# how the harness reads the program: by the interpreter, or by the instance
# the launcher would pick for it (a single leaf's, the pair's)
INTERPRETER, PICKED = 0, 1
# how it walks the elements: all of them, or each lag once (i >= j) with
# the weight G[i, j] + G[j, i]
TWO_SIDED, SYMMETRIC = 0, 1

HARNESS = r"""
#include <vector>
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

// what a block sets up before its element loop
template <typename T>
struct Setup {
  T cst[MAX_OPS * N_CONSTS];
  T p0[LEAF_PARAMS], c0[N_CONSTS], p1[LEAF_PARAMS], c1[N_CONSTS];
  int off1;
  Setup(const Program& prog, const T* par, int n_params) {
    for (int k = 0; k < prog.n_ops; ++k)
      if (is_leaf_op(prog.op[k]))
        leaf_consts<T>(prog.op[k], par + prog.off[k], cst + k * N_CONSTS);
    off1 = prog.n_ops > 1 ? prog.off[1] : 0;
    for (int m = 0; m < LEAF_PARAMS; ++m) {
      p0[m] = m < n_params ? par[m] : T(0);
      p1[m] = off1 + m < n_params ? par[off1 + m] : T(0);
    }
    for (int m = 0; m < N_CONSTS; ++m) {
      c0[m] = cst[m];
      c1[m] = cst[N_CONSTS + m];
    }
  }
};

template <typename T>
static void matrix(const T* t, const T* par, T* out, int n, int n_params,
                   const int* ops, const int* offs, const int* lhs,
                   const int* rhs, int n_ops, int picked) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  const Setup<T> s(p, par, n_params);
  const int mode = picked ? program_mode(p) : MODE_ANY;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      const T r = t[i] - t[j];
      T v;
#define ARGS p, s.p0, s.c0, s.p1, s.c1, par, s.cst, r
#define CASE(OP) case OP: v = program_value<T, OP>(ARGS); break;
      switch (mode) {
        FOR_EACH_LEAF(CASE)
        case MODE_PAIR: v = program_value<T, MODE_PAIR>(ARGS); break;
        default: v = program_value<T, MODE_ANY>(ARGS); break;
      }
#undef CASE
#undef ARGS
      out[i * n + j] = v;
    }
}

template <typename T>
static void grad(const T* t, const T* par, const T* G, T* out, int n,
                 int n_params, const int* ops, const int* offs,
                 const int* lhs, const int* rhs, int n_ops, int picked,
                 int symmetric) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  const Setup<T> s(p, par, n_params);
  const int mode = picked ? program_mode(p) : MODE_ANY;
  T acc0[LEAF_PARAMS], acc1[LEAF_PARAMS], acc[MAX_PARAMS];
  for (int m = 0; m < LEAF_PARAMS; ++m) acc0[m] = acc1[m] = T(0);
  for (int m = 0; m < MAX_PARAMS; ++m) acc[m] = T(0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < (symmetric ? i + 1 : n); ++j) {
      const T r = t[i] - t[j];
      const T g = symmetric && i != j ? G[i * n + j] + G[j * n + i]
                                      : G[i * n + j];
#define ARGS p, s.p0, s.p1, par, r, g, acc0, acc1, acc
#define CASE(OP) case OP: program_grad<T, OP>(ARGS); break;
      switch (mode) {
        FOR_EACH_LEAF(CASE)
        case MODE_PAIR: program_grad<T, MODE_PAIR>(ARGS); break;
        default: program_grad<T, MODE_ANY>(ARGS); break;
      }
#undef CASE
#undef ARGS
    }
  // the sums' places among the parameters, as the kernel's reduction has them
  if (mode >= OP_C) {
    for (int m = 0; m < leaf_n_params(mode); ++m) out[m] = acc0[m];
  } else if (mode == MODE_PAIR) {
    for (int m = 0; m < leaf_n_params(p.op[0]); ++m) out[m] = acc0[m];
    for (int m = 0; m < leaf_n_params(p.op[1]); ++m)
      out[s.off1 + m] = acc1[m];
  } else {
    for (int m = 0; m < n_params; ++m) out[m] = acc[m];
  }
}

// B1's slab entry, element by element: rows [r0, r0 + n_rows) of the
// n_pad x n_pad matrix, each element from the picked instance and
// slab_element's rule
template <typename T>
static void slab(const T* t, const T* par, T jit, T* out, int n, int n_pad,
                 int r0, int n_rows, int n_params, const int* ops,
                 const int* offs, const int* lhs, const int* rhs,
                 int n_ops) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  const Setup<T> s(p, par, n_params);
  const int mode = program_mode(p);
  for (int li = 0; li < n_rows; ++li)
    for (int j = 0; j < n_pad; ++j) {
      const int i = r0 + li;
      const T r = (i < n ? t[i] : T(0)) - (j < n ? t[j] : T(0));
      T v;
#define ARGS p, s.p0, s.c0, s.p1, s.c1, par, s.cst, r
#define CASE(OP) case OP: v = program_value<T, OP>(ARGS); break;
      switch (mode) {
        FOR_EACH_LEAF(CASE)
        case MODE_PAIR: v = program_value<T, MODE_PAIR>(ARGS); break;
        default: v = program_value<T, MODE_ANY>(ARGS); break;
      }
#undef CASE
#undef ARGS
      out[(size_t)li * n_pad + j] = slab_element<T>(i, j, n, v, jit);
    }
}

// B1's product entry as the card runs it, each block's threads in turn:
// the register path (W sums a thread) over the column groups, then the
// groups' sum pass
template <typename T, int MODE, int W>
static void matvec_register(const Program& p, const Setup<T>& s,
                            const T* par, const T* t, const T* v, T nugget,
                            T* y, int n, int m, int r0, int n_rows) {
  const int groups = mv_groups(n);
  std::vector<T> partial((size_t)groups * n_rows * m);
  std::vector<T> ts(MV_STAGE), vs(MV_STAGE * W);
  for (int g = 0; g < groups; ++g) {
    int j0, j1;
    mv_group_range(n, g, &j0, &j1);
    for (int li = 0; li < n_rows; ++li) {
      T acc[W];
      for (int c = 0; c < W; ++c) acc[c] = T(0);
      for (int s0 = j0; s0 < j1; s0 += MV_STAGE) {
        const int cnt = j1 - s0 < MV_STAGE ? j1 - s0 : MV_STAGE;
        for (int k = 0; k < cnt; ++k) {
          ts[k] = t[s0 + k];
          for (int c = 0; c < W; ++c)
            vs[k * W + c] = c < m ? v[(size_t)(s0 + k) * m + c] : T(0);
        }
        mv_row_stage<T, MODE, W>(p, s.p0, s.c0, s.p1, s.c1, par, s.cst,
                                 t[r0 + li], ts.data(), vs.data(), cnt, acc);
      }
      for (int c = 0; c < W && c < m; ++c)
        partial[((size_t)g * n_rows + li) * m + c] = acc[c];
    }
  }
  const size_t total = (size_t)n_rows * m;
  for (size_t at = 0; at < total; ++at)
    y[at] = mv_add_nugget(mv_sum_groups(&partial[at], groups, total), nugget,
                          v[(size_t)(r0 + at / m) * m + at % m]);
}

// the tiled path: per block (row tile, column tile) and k-block, t's
// slice and V's tile, its producers' evaluations of the K tile, its
// consumers' products; then the consumers' stores
template <typename T, int MODE>
static void matvec_tiled(const Program& p, const Setup<T>& s, const T* par,
                         const T* t, const T* v, T nugget, T* y, int n,
                         int m, int r0, int n_rows) {
  const int bn = mt_bn<T>(m), bm = mt_bm<T>(m), np = mt_producers<T>(m);
  const int nc = bm * bn / MT_SUMS, per = MT_SUMS, bk = mt_bk<T>();
  std::vector<T> kt(bk * (bm + 4)), vs(bk * (bn + 4)), ts(bk),
      acc(nc * per);
  for (int li0 = 0; li0 < n_rows; li0 += bm)
    for (int c0 = 0; c0 < m; c0 += bn) {
      for (auto& a : acc) a = T(0);
      for (int j0 = 0; j0 < n; j0 += bk) {
        for (int k = 0; k < bk; ++k) {
          ts[k] = j0 + k < n ? t[j0 + k] : T(0);
          for (int c = 0; c < bn; ++c) {
            const int j = j0 + k, col = c0 + c;
            vs[k * (bn + 4) + c] =
                j < n && col < m ? v[(size_t)j * m + col] : T(0);
          }
        }
        for (int q = 0; q < np; ++q) {
          const int er = li0 + q % bm;
          const T ti = er < n_rows ? t[r0 + er] : T(0);
          mt_eval<T, MODE>(p, s.p0, s.c0, s.p1, s.c1, par, s.cst, ti,
                           ts.data(), n, j0, bm, np, q, kt.data());
        }
        for (int tid = 0; tid < nc; ++tid)
          mt_product(kt.data(), vs.data(), bm, bn, tid, &acc[tid * per]);
      }
      for (int tid = 0; tid < nc; ++tid)
        mt_store<T>(y, v, nugget, &acc[tid * per], tid, bm, bn, li0, c0, r0,
                    n_rows, m);
    }
}

template <typename T>
static void matvec(const T* t, const T* par, const T* v, T nugget, T* y,
                   int n, int m, int r0, int n_rows, int n_params,
                   const int* ops, const int* offs, const int* lhs,
                   const int* rhs, int n_ops) {
  const Program p = program(ops, offs, lhs, rhs, n_ops);
  const Setup<T> s(p, par, n_params);
#define ARGS p, s, par, t, v, nugget, y, n, m, r0, n_rows
#define RUN_MODE(MODE)                                      \
  if (m > MV_CAP) matvec_tiled<T, MODE>(ARGS);               \
  else if (m == 1) matvec_register<T, MODE, 1>(ARGS);        \
  else matvec_register<T, MODE, MV_CAP>(ARGS);
#define CASE(OP) case OP: RUN_MODE(OP); break;
  switch (program_mode(p)) {
    FOR_EACH_LEAF(CASE)
    case MODE_PAIR: RUN_MODE(MODE_PAIR); break;
    default: RUN_MODE(MODE_ANY); break;
  }
#undef CASE
#undef RUN_MODE
#undef ARGS
}

extern "C" {
void matvec_f64(const double* t, const double* par, const double* v,
                double nugget, double* y, int n, int m, int r0, int n_rows,
                int n_params, const int* o, const int* f, const int* l,
                const int* r, int k) {
  matvec<double>(t, par, v, nugget, y, n, m, r0, n_rows, n_params, o, f, l,
                 r, k);
}
void matvec_f32(const float* t, const float* par, const float* v,
                float nugget, float* y, int n, int m, int r0, int n_rows,
                int n_params, const int* o, const int* f, const int* l,
                const int* r, int k) {
  matvec<float>(t, par, v, nugget, y, n, m, r0, n_rows, n_params, o, f, l,
                r, k);
}
int mv_groups_of(int n) { return mv_groups(n); }
int mt_bn_of(int m, int bytes) {
  return bytes == 4 ? mt_bn<float>(m) : mt_bn<double>(m);
}
void slab_f64(const double* t, const double* par, double jit, double* out,
              int n, int n_pad, int r0, int n_rows, int m, const int* o,
              const int* f, const int* l, const int* r, int k) {
  slab<double>(t, par, jit, out, n, n_pad, r0, n_rows, m, o, f, l, r, k);
}
void slab_f32(const float* t, const float* par, float jit, float* out,
              int n, int n_pad, int r0, int n_rows, int m, const int* o,
              const int* f, const int* l, const int* r, int k) {
  slab<float>(t, par, jit, out, n, n_pad, r0, n_rows, m, o, f, l, r, k);
}
void matrix_f64(const double* t, const double* par, double* out, int n,
                int m, const int* o, const int* f, const int* l,
                const int* r, int k, int picked) {
  matrix<double>(t, par, out, n, m, o, f, l, r, k, picked);
}
void matrix_f32(const float* t, const float* par, float* out, int n, int m,
                const int* o, const int* f, const int* l, const int* r,
                int k, int picked) {
  matrix<float>(t, par, out, n, m, o, f, l, r, k, picked);
}
void grad_f64(const double* t, const double* par, const double* G,
              double* out, int n, int m, const int* o, const int* f,
              const int* l, const int* r, int k, int picked, int symmetric) {
  grad<double>(t, par, G, out, n, m, o, f, l, r, k, picked, symmetric);
}
void grad_f32(const float* t, const float* par, const float* G, float* out,
              int n, int m, const int* o, const int* f, const int* l,
              const int* r, int k, int picked, int symmetric) {
  grad<float>(t, par, G, out, n, m, o, f, l, r, k, picked, symmetric);
}
int mode_of(const int* o, const int* f, const int* l, const int* r, int k) {
  return program_mode(program(o, f, l, r, k));
}
// 0 if tile_pair lists the pairs (0,0), (1,0), (1,1), (2,0), ... of a
// tiles x tiles matrix, each once, over exactly n_tile_pairs indices;
// else 1 + the first index that is wrong
long long tile_pairs_wrong_at(int tiles) {
  long long p = 0;
  for (int I = 0; I < tiles; ++I)
    for (int J = 0; J <= I; ++J, ++p) {
      int i, j;
      tile_pair(p, &i, &j);
      if (i != I || j != J) return 1 + p;
    }
  return p == n_tile_pairs(tiles) ? 0 : 1 + p;
}
void tile_pair_at(long long p, int* I, int* J) { tile_pair(p, I, J); }
int leaf_n_params_of(int op) { return leaf_n_params(op); }
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


def _code(structure):
    prog = ck.encode_program(structure)
    return (_ints(prog.ops), _ints(prog.offsets), _ints(prog.lhs),
            _ints(prog.rhs), len(prog.ops))


def _grad_scale(structure, pars, t, G):
    """Σ |G| |∂k/∂θ| per parameter, in float64."""
    t64 = torch.tensor(t, dtype=torch.float64)
    J = torch.autograd.functional.jacobian(
        lambda q: tk.evaluate(structure, q, r=t64[:, None] - t64[None, :]),
        torch.tensor(pars, dtype=torch.float64)).numpy()
    return np.einsum("ij,ijm->m", np.abs(G.astype(np.float64)), np.abs(J))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("structure,pars", CASES,
                         ids=[str(c[0]) for c in CASES])
def test_element_math_matches_autograd(structure, pars, dtype, host_lib):
    fwd_tol, grad_tol = TOLS[dtype]
    sfx = "f64" if dtype == torch.float64 else "f32"
    t, G = _inputs(dtype, len(pars))
    par = np.asarray(pars, dtype=t.dtype)
    code = _code(structure)
    tt, pp = torch.tensor(t), torch.tensor(par)
    K_ref = tk.evaluate(structure, pp, r=tt[:, None] - tt[None, :]).numpy()
    g_ref = ck.kernel_matrix_grad_ref(structure, pp, tt,
                                      torch.tensor(G)).numpy()
    scale = _grad_scale(structure, pars, t, G)

    Ks = {}
    for how in (INTERPRETER, PICKED):
        K = np.zeros((N, N), dtype=t.dtype)
        getattr(host_lib, f"matrix_{sfx}")(_ptr(t), _ptr(par), _ptr(K), N,
                                           len(pars), *code, how)
        assert np.max(np.abs(K - K_ref)) <= fwd_tol * np.max(np.abs(K_ref))
        Ks[how] = K
        # the fused value-and-derivative leaf, summed over all elements
        g = np.zeros(len(pars), dtype=t.dtype)
        getattr(host_lib, f"grad_{sfx}")(_ptr(t), _ptr(par), _ptr(G), _ptr(g),
                                         N, len(pars), *code, how, TWO_SIDED)
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - g_ref) <= grad_tol * scale), \
            (how, g, g_ref, np.abs(g - g_ref) / scale)
    # the picked instance repeats the interpreter's operations
    np.testing.assert_array_equal(Ks[PICKED], Ks[INTERPRETER])
    # every leaf is even in r: K equals its transpose to the bit
    np.testing.assert_array_equal(Ks[PICKED], Ks[PICKED].T)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("structure,pars", CASES,
                         ids=[str(c[0]) for c in CASES])
def test_symmetric_pair_sum_matches_two_sided(structure, pars, dtype,
                                              host_lib):
    """Each lag once with the weight G[i,j] + G[j,i] (G not symmetric)
    gives the two-sided sum Σ G ∂k/∂θ."""
    _, grad_tol = TOLS[dtype]
    sfx = "f64" if dtype == torch.float64 else "f32"
    t, G = _inputs(dtype, len(pars))
    assert np.abs(G - G.T).max() > 0.1
    par = np.asarray(pars, dtype=t.dtype)
    code = _code(structure)
    scale = _grad_scale(structure, pars, t, G)
    got = {}
    for walk in (TWO_SIDED, SYMMETRIC):
        g = np.zeros(len(pars), dtype=t.dtype)
        getattr(host_lib, f"grad_{sfx}")(_ptr(t), _ptr(par), _ptr(G), _ptr(g),
                                         N, len(pars), *code, PICKED, walk)
        got[walk] = g
    assert np.all(np.abs(got[SYMMETRIC] - got[TWO_SIDED])
                  <= grad_tol * scale), (got, scale)


def test_launcher_picks_the_instance(host_lib):
    """A single leaf runs its own instance, two leaves joined by + or *
    the pair's, anything longer the interpreter."""
    for (tag,), _ in LEAF_CASES:
        assert host_lib.mode_of(*_code((tag,))) == ck.OPCODES[tag]
    assert host_lib.mode_of(*_code(("+", ("SE",), ("M32",)))) == -1
    assert host_lib.mode_of(*_code(("*", ("QP",), ("C",)))) == -1
    assert host_lib.mode_of(
        *_code(("+", ("SE",), ("*", ("QP",), ("C",))))) == -2
    for tag, code in ck.OPCODES.items():
        n_par = 0 if tag in "+*" else tk.n_params((tag,))
        assert host_lib.leaf_n_params_of(code) == n_par
    assert max(tk.n_params((tag,)) for (tag,), _ in LEAF_CASES) == 6


@pytest.mark.parametrize("tiles", [1, 2, 3, 32, 128, 2048])
def test_tile_pair_index_map(tiles, host_lib):
    """Every tile pair I ≥ J exactly once, in row order."""
    host_lib.tile_pairs_wrong_at.restype = ctypes.c_longlong
    assert host_lib.tile_pairs_wrong_at(tiles) == 0


def test_tile_pair_index_map_at_the_largest_matrix(host_lib):
    """The ends of every row near the largest index the launcher takes
    (65535 tiles a side), where a float square root is off by one."""
    host_lib.tile_pair_at.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
    I, J = ctypes.c_int(), ctypes.c_int()
    for row in (1, 2, 4095, 4096, 46340, 46341, 65533, 65534):
        first = row * (row + 1) // 2
        for p, expected in ((first, (row, 0)), (first - 1, (row - 1, row - 1)),
                            (first + row, (row, row))):
            host_lib.tile_pair_at(p, ctypes.byref(I), ctypes.byref(J))
            assert (I.value, J.value) == expected, p


# slabs of a 33-row matrix padded to 48: the first of four 12-row slabs,
# one that straddles N, the last (all padding), and one covering it all
SLABS = ((0, 12), (24, 12), (36, 12), (0, 48))
SLAB_CASES = [c for c in CASES if c[0] in
              (("QP",), ("+", ("SE",), ("M32",)))] + [CASES[-1]]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("structure,pars", SLAB_CASES,
                         ids=[str(c[0]) for c in SLAB_CASES])
def test_slab_index_map(structure, pars, dtype, host_lib):
    fwd_tol, _ = TOLS[dtype]
    sfx = "f64" if dtype == torch.float64 else "f32"
    npdt = np.float64 if dtype == torch.float64 else np.float32
    t, _ = _inputs(dtype, len(pars))
    par = np.asarray(pars, dtype=t.dtype)
    code = _code(structure)
    n_pad, jit = 48, npdt(1e-6)
    cjit = ctypes.c_double(jit) if sfx == "f64" else ctypes.c_float(jit)
    K = np.zeros((N, N), dtype=t.dtype)
    getattr(host_lib, f"matrix_{sfx}")(_ptr(t), _ptr(par), _ptr(K), N,
                                       len(pars), *code, PICKED)
    K[np.arange(N), np.arange(N)] += jit
    fn = getattr(host_lib, f"slab_{sfx}")
    for r0, rows in SLABS:
        out = np.full((rows, n_pad), np.nan, dtype=t.dtype)
        fn(_ptr(t), _ptr(par), cjit, _ptr(out), N, n_pad, r0, rows,
           len(pars), *code)
        nv = max(0, min(rows, N - r0))
        # inside the matrix: the full matrix's rows, jitter and all
        np.testing.assert_array_equal(out[:nv, :N], K[r0:r0 + nv])
        # identity in the padding, nothing else
        eye = np.eye(n_pad, dtype=t.dtype)[r0:r0 + rows]
        np.testing.assert_array_equal(out[:, N:], eye[:, N:])
        np.testing.assert_array_equal(out[nv:], eye[nv:])
        ref = ck.kernel_matrix_slab_ref(structure, torch.tensor(par),
                                        torch.tensor(t), n_pad, r0, rows,
                                        torch.tensor(jit)).numpy()
        assert np.max(np.abs(out - ref)) <= fwd_tol * np.max(np.abs(ref))


# B1's product entry: N=600 has three column groups (256, 256, 88 columns:
# a ragged step and partial sum), five 128-row tiles (the last ragged); the
# tiled path's tiles of 64 or 128 rows, its k-blocks of 36 (float64) or 48
# (float32) columns and its column tiles are ragged too
MATVEC_N = 600
MATVEC_TOL = 1e-13
MATVEC_CASES = [c for c in CASES if c[0] in
                (("QP",), ("+", ("SE",), ("M32",)))] + [CASES[-1]]
# (r0, n_rows): the whole product, a slab from row 0 and one that ends at N
MATVEC_SLABS = ((0, None), (0, 150), (333, 267))
# the tiled path's widest column tile (csrc mt_bn)
TILE_COLS = {np.float64: ck.MATVEC_TILE_COLS[torch.float64],
             np.float32: ck.MATVEC_TILE_COLS[torch.float32]}
# m: the register path's one- and eight-column instances (1, 3), then the
# tiled path at MV_CAP + 1 and around its column tiles: BN, BN + 3 (a
# ragged second tile), 2 BN + 5
MATVEC_COLS = [1, 3, ck.MATVEC_CAP + 1, TILE_COLS[np.float64],
               TILE_COLS[np.float64] + 3, 2 * TILE_COLS[np.float64] + 5]
MATVEC_F32_TOL = 1e-5


def _matvec_case(host_lib, structure, pars, m, npdt):
    """The host runner's product at every slab of MATVEC_SLABS against
    kernel_matvec_ref (max error over max |y|), and each slab's rows
    against the whole product's, bit for bit; returns the largest
    error."""
    rng = np.random.default_rng(MATVEC_N + m)
    t = np.sort(rng.uniform(0, 100, MATVEC_N)).astype(npdt)
    t[5] = t[4]
    v = rng.standard_normal((MATVEC_N, m)).astype(npdt)
    par = np.asarray(pars, dtype=npdt)
    code = _code(structure)
    nugget = 0.3
    fn, cnug = ((host_lib.matvec_f64, ctypes.c_double(nugget))
                if npdt == np.float64 else
                (host_lib.matvec_f32, ctypes.c_float(nugget)))
    whole, worst = None, 0.0
    for r0, n_rows in MATVEC_SLABS:
        rows = MATVEC_N - r0 if n_rows is None else n_rows
        y = np.full((rows, m), np.nan, dtype=npdt)
        fn(_ptr(t), _ptr(par), _ptr(v), cnug, _ptr(y), MATVEC_N, m, r0, rows,
           len(pars), *code)
        ref = ck.kernel_matvec_ref(structure, torch.tensor(par),
                                   torch.tensor(t), torch.tensor(v), nugget,
                                   64, r0, n_rows).numpy()
        worst = max(worst, float(np.max(np.abs(y - ref))
                                 / np.max(np.abs(ref))))
        if whole is None:
            whole = y
        else:   # a row's sums do not depend on the slab
            np.testing.assert_array_equal(y, whole[r0:r0 + rows])
    return worst


@pytest.mark.parametrize("m", MATVEC_COLS)
@pytest.mark.parametrize("structure,pars", MATVEC_CASES,
                         ids=[str(c[0]) for c in MATVEC_CASES])
def test_product_entry_matches_its_plain_version(structure, pars, m,
                                                 host_lib):
    assert host_lib.mv_groups_of(MATVEC_N) == ck.matvec_groups(MATVEC_N) == 3
    assert _matvec_case(host_lib, structure, pars, m,
                        np.float64) <= MATVEC_TOL


@pytest.mark.parametrize("m", [1, 9, 64, 65, 128, 129, 256, 257, 1000])
def test_tile_cols_equal_the_sources(m, host_lib):
    """The wrapper's mirror of the tiled path's column tile (csrc mt_bn)."""
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        bn = ck.matvec_tile_cols(m, dtype)
        assert host_lib.mt_bn_of(m, size) == bn
        assert bn >= min(m, ck.MATVEC_TILE_COLS[dtype]) and bn % 64 == 0


# float32: the register path's two instances, the tiled path's narrow
# shape and its wide one (above 128 columns), whose one column tile is
# ragged here
F32_COLS = [1, ck.MATVEC_CAP, ck.MATVEC_CAP + 1, 200]


@pytest.mark.parametrize("m", F32_COLS)
def test_product_entry_in_float32(m, host_lib):
    """The float32 steps (the tiled path's 8 x 8 micro-tiles and their
    fresh partial every k-block) against the float32 plain version, 1e-5
    of max |y| (the card test's limit); slabs bit for bit."""
    assert ck.matvec_tile_cols(F32_COLS[-1], torch.float32) > 128
    structure, pars = MATVEC_CASES[0]
    assert _matvec_case(host_lib, structure, pars, m,
                        np.float32) <= MATVEC_F32_TOL


@pytest.mark.parametrize("n", [1, 31, 127, 128, 129, 600, 4096, 20000,
                               50000, 200000])
def test_product_entry_groups(n, host_lib):
    """The wrapper sizes the partial sums by the source's group count; a
    group is whole steps of 256 columns, and the groups cover N."""
    groups = ck.matvec_groups(n)
    assert host_lib.mv_groups_of(n) == groups
    assert 1 <= groups <= n
    row_tiles = -(-n // ck.MATVEC_THREADS)
    assert groups * row_tiles <= ck.MATVEC_TARGET_BLOCKS + row_tiles
