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
  register path; ``mt_eval``, ``mt_product``, ``mt_store`` of the tiled
  path, float64): ragged row tiles, steps, partial sums, K tiles, rows
  and chunks of V,
  the column groups of N=600 summed in order, m ∈ {1, 3, MV_CAP + 1}
  (the register path's one- and eight-column instances, the tiled path),
  against ``kernel_matvec_ref`` to 1e-13 of max |y| in float64; a slab's
  rows equal the whole product's bit for bit; the group count equals the
  wrapper's ``matvec_groups``.

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

// the tiled path: per block of MT_ROWS rows, per K tile, its threads'
// evaluations, then per chunk of V their products and stores
template <typename T, int MODE>
static void matvec_tiled(const Program& p, const Setup<T>& s, const T* par,
                         const T* t, const T* v, T nugget, T* y, int n,
                         int m, int r0, int n_rows) {
  const int cols = mt_cols<T>();
  std::vector<T> kt(MT_LD * cols), vs(MT_K * MT_VLD), ti(MT_ROWS), tj(cols),
      acc(MT_THREADS * 16);
  const int tiles = (n + cols - 1) / cols;
  for (int li0 = 0; li0 < n_rows; li0 += MT_ROWS) {
    for (int r = 0; r < MT_ROWS; ++r)
      ti[r] = li0 + r < n_rows ? t[r0 + li0 + r] : T(0);
    for (int k = 0; k < tiles; ++k) {
      const int jt = k * cols;
      const int cnt = n - jt < cols ? n - jt : cols;
      for (int q = 0; q < cols; ++q) tj[q] = q < cnt ? t[jt + q] : T(0);
      for (int tid = 0; tid < MT_THREADS; ++tid)
        mt_eval<T, MODE>(p, s.p0, s.c0, s.p1, s.c1, par, s.cst, ti.data(),
                         tj.data(), cnt, tid, kt.data());
      for (int mc = 0; mc < m; mc += MT_M) {
        for (auto& a : acc) a = T(0);
        for (int s0 = 0; s0 < cnt; s0 += MT_K) {
          const int sc = cnt - s0 < MT_K ? cnt - s0 : MT_K;
          for (int q = 0; q < MT_K * MT_M; ++q) {
            const int jj = q / MT_M, col = mc + q % MT_M;
            vs[jj * MT_VLD + q % MT_M] =
                jj < sc && col < m ? v[(size_t)(jt + s0 + jj) * m + col]
                                   : T(0);
          }
          for (int tid = 0; tid < MT_THREADS; ++tid)
            mt_product(kt.data(), vs.data(), s0, sc, tid,
                          reinterpret_cast<T(*)[4]>(&acc[tid * 16]));
        }
        for (int tid = 0; tid < MT_THREADS; ++tid)
          mt_store<T>(y, v, nugget,
                      reinterpret_cast<const T(*)[4]>(&acc[tid * 16]), tid,
                      li0, r0, n_rows, mc, m, k == 0, k == tiles - 1);
      }
    }
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
int mv_groups_of(int n) { return mv_groups(n); }
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
# tiled path's 64-row blocks and K tiles of 128 columns are ragged too
MATVEC_N = 600
MATVEC_TOL = 1e-13
MATVEC_CASES = [c for c in CASES if c[0] in
                (("QP",), ("+", ("SE",), ("M32",)))] + [CASES[-1]]
# (r0, n_rows): the whole product, a slab from row 0 and one that ends at N
MATVEC_SLABS = ((0, None), (0, 150), (333, 267))


@pytest.mark.parametrize("m", [1, 3, ck.MATVEC_CAP + 1])
@pytest.mark.parametrize("structure,pars", MATVEC_CASES,
                         ids=[str(c[0]) for c in MATVEC_CASES])
def test_product_entry_matches_its_plain_version(structure, pars, m,
                                                 host_lib):
    rng = np.random.default_rng(MATVEC_N + m)
    t = np.sort(rng.uniform(0, 100, MATVEC_N))
    t[5] = t[4]
    v = rng.standard_normal((MATVEC_N, m))
    par = np.asarray(pars, dtype=np.float64)
    code = _code(structure)
    nugget = 0.3
    assert host_lib.mv_groups_of(MATVEC_N) == ck.matvec_groups(MATVEC_N) == 3
    whole = None
    for r0, n_rows in MATVEC_SLABS:
        rows = MATVEC_N - r0 if n_rows is None else n_rows
        y = np.full((rows, m), np.nan)
        host_lib.matvec_f64(_ptr(t), _ptr(par), _ptr(v),
                            ctypes.c_double(nugget), _ptr(y), MATVEC_N, m,
                            r0, rows, len(pars), *code)
        ref = ck.kernel_matvec_ref(structure, torch.tensor(par),
                                   torch.tensor(t), torch.tensor(v), nugget,
                                   64, r0, n_rows).numpy()
        assert np.max(np.abs(y - ref)) <= MATVEC_TOL * np.max(np.abs(ref))
        if whole is None:
            whole = y
        else:   # a row's sums do not depend on the slab
            np.testing.assert_array_equal(y, whole[r0:r0 + rows])


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
