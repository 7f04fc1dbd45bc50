// Dense kernel matrices of the GPRN engine, for Hopper (sm_90a), and their
// gradient:
//
//     out[i, j] = k(t_i - t_j; params) + (i == j) * jitter          (B1)
//     g[m]      = sum_ij G[i, j] * dk(t_i - t_j; params) / dparams[m] (B1')
//
// for one stationary kernel structure, in float or double.
//
// B1 replaces gpyrn_tpu/ops/pallas_kernels.py::_build, the tiled Pallas
// kernel of the JAX package; B1' is its backward, which the JAX package
// takes by autodiff through the Pallas kernel.
//
// B1 has a second entry, the slab (kernel_matrix_slab_kernel): rows
// [r0, r0 + n_rows) of the padded n_pad x n_pad matrix, identity past n,
// the row slab that one rank of the panel-sharded engine holds.  The JAX
// package builds that slab in plain jnp (gpyrn_tpu/parallel/panel_fit.py,
// _slab_kernel); here it shares B1's element math, one block per tile,
// no mirror.
//
// What bounds them.  Neither kernel is bound by its bytes (B1 writes N^2
// values once, B1' reads N^2 once): every element costs an exp, a sin or a
// pow and a few divisions in IEEE arithmetic (no fast math, no FMA
// contraction), which in float64 are some hundreds of operations of the
// FP64 pipe, against 8 bytes of traffic.  The lever is fewer
// transcendentals, and the design takes half of them away:
//
//   * Each lag once.  Every leaf is even in r (it reads |r|, r*r or
//     (-2r)*r only) and t_i - t_j = -(t_j - t_i) exactly, so K and dk/dp
//     are symmetric to the bit.  Both kernels walk the 32 x 32 tile pairs
//     (I, J) with I >= J only.  B1 stores a value at (i, j) and, through a
//     32 x 33 shared-memory tile, at (j, i), both stores along rows.  B1'
//     reads G's tile (I, J) and tile (J, I), both along rows, hands the
//     second across through shared memory, and weighs dk/dp once with
//     G[i, j] + G[j, i] (G is not symmetric in general).  A diagonal tile
//     is computed in full.
//   * One pass per leaf in B1': leaf_vd returns k and all its parameter
//     derivatives from one exp / sincospi / pow, and the parameter-only
//     factors are reciprocals taken outside the element loop.
//   * Sums in registers.  A structure that is a single leaf (every one the
//     engine's models use) runs a kernel instance compiled for that leaf
//     (template parameter MODE = its op code): parameters, constants and
//     the at most 6 sums have compile-time indices, so there is no stack
//     frame (but for B1's periodic leaves in float, where the math
//     library's sinf / cosf keep 32 bytes for a large-argument reduction
//     that these lags never take; B1' uses sincospi, which has none).
//     Two leaves joined by + or * (MODE_PAIR) run with the op codes
//     read at run time but the same static arrays.  Any longer program
//     runs the interpreter (MODE_ANY), whose arrays live in local memory.
//   * Parameter-only terms of B1 (theta^2, ell^2, 2 ell^2, ...) are formed
//     once per block into shared memory (leaf_consts), by the operations
//     the plain version uses, in its order: no bit of K changes.  Divisions
//     by them stay divisions, for the same reason.
//   * Persistent blocks in B1': a few blocks per SM (the wrapper's
//     grad_blocks) stride over the tile pairs in a fixed order and reduce
//     once at the end: shuffles inside a
//     warp, one shared-memory step across the warps, one partial row per
//     block; a second kernel sums the rows in a fixed order.  No atomics:
//     the result is the same bit for bit from run to run on one card.
//   * 16-byte accesses: a thread owns 2 (double) or 4 (float) neighbouring
//     columns and loads or stores them as one double2 / float4 when N is a
//     multiple of that width and the base pointer is aligned; otherwise the
//     same thread takes them one by one.  The ragged edge is masked, not
//     padded.
//
// Neither B1 nor B1' holds a matrix product (nothing for wgmma), and a
// tile's whole input is two length-32 slices of t (nothing for TMA to
// fetch).
//
// B1's product entry (kernel_matvec_kernel, kernel_matvec_tiled_kernel):
//
//     y[i, c] = sum_j<N k(t_i - t_j) V[j, c] + nugget V[i, c],
//               i in [r0, r0 + n_rows), c < m,
//
// the matrix-free kernel matvec, without K ever in device memory.  It
// replaces gpyrn_tpu/ops/iterative.py::kernel_matvec, which the JAX package
// leaves to XLA (row chunks of K, each written out and multiplied), and
// takes the slab entry's element rule: each element is program_value of
// B1's instance for the structure, with B1's leaf_consts, so K has B1's
// bits.  What bounds it: the evaluations of K on the FP pipe (45 float /
// 68 double FP-pipe instructions an element for QP, more in all SASS
// instructions, which share the SM's issue slots) against 3 N values of
// traffic for m = 1; for many columns also the 2 N^2 m operations of the
// product, on the FP64 tensor cores in double (67 TFLOP/s on an H100 SXM)
// and the FP32 pipe in float.  So:
//
//   * m <= MV_CAP (the register path): one thread per row; a block of
//     MV_THREADS rows walks its group of columns in steps of MV_STAGE,
//     t and V of the next step copied into shared memory with cp.async
//     while the current one is read (two buffers).  A row's m sums stay in
//     registers; four columns (two in the one-column float instance) are
//     evaluated together from one broadcast load of their times.  Every element is evaluated once.
//   * Sums in a fixed tree: a fresh partial over each MV_SUM columns, the
//     partials of a column group added in order, the groups added in order
//     by a second kernel (kernel_matvec_sum).  A float32 sum over 50,000
//     terms so rounds like a tree, not like one long chain.  The product's
//     multiply-add is one fma (__fma_rn); the element keeps B1's rounding.
//   * Filling the card: the columns split into groups (mv_group_cols) so
//     that N's row tiles times the groups come to about MV_TARGET_BLOCKS
//     blocks.  The split is chosen from N alone, never from r0 or n_rows,
//     so a rank's slab of rows gets the bits of the same rows of the whole
//     product.  No atomics: the same bits from run to run.
//   * m > MV_CAP (the tiled path), output-stationary and warp-specialized:
//     block (x, c) owns a bm x bn tile of y in registers and walks all N
//     columns of K in k-blocks of bk (48 in float, 36 in double), in
//     order, through a ring of three stages in shared memory.  Its producer
//     warps copy each k-block's slice of t and bk x bn tile of V in
//     (cp.async, one k-block ahead) and evaluate its bm x bk tile of K on
//     the FP pipe; its consumer warps multiply each K tile into the sums
//     while the producers evaluate the next: in double on the tensor cores
//     (mma.sync m16n8k8 in float64, a warp a 64 x 32 tile; a k-block's
//     last 4 columns on m16n8k4), in float on the CUDA cores (an 8 x 8
//     micro-tile a thread from 16-byte loads, a fresh partial every
//     k-block; TF32 would not keep float's digits).
//     Named barriers hand each stage over (full: the producers arrive,
//     the consumers wait; empty: the other way round).  y is written
//     once, with the nugget's term; no sum goes to memory and back.  The
//     grid is the row tiles times the column tiles of m: at N = 20,000,
//     m = 1000, 313 x 8 = 2,504 blocks in double.
//   * Why the split: the element's code is long, branchy (the math
//     library's fallbacks) and dependent, so its latency is hidden only by
//     many warps in flight, while the sums want many registers.  setmaxnreg
//     shares the SM's 65,536 registers (one block an SM): the narrow shape
//     gives 128 consumers 208 registers (64 sums and their operands, or 64
//     sums and 64 partials) and 768 producers 48; the wide shape, float's
//     above 128 columns, 256 consumers 160 and 512 producers 40.  (Without
//     the split every thread of a block that holds the sums has their
//     registers, and too few warps are left to hide the evaluations;
//     sharing K's tiles between the column tiles of a cluster cost more in
//     cross-SM fences than the evaluations it saved: both timed slower on
//     an H100, PERF.md section 6.)
//   * The tile's width bn is set by K's evaluations: each element of K is
//     evaluated ceil(m / bn) times.  One evaluation at N = 50,000 needs the
//     FP64 pipe for >= 10.0 ms (67 instructions an element at 16.75 * 10^12
//     a second) and the issue slots for >= 12 ms (163 SASS instructions an
//     element); the product at m = 1000 needs the tensor cores for >= 74.6
//     ms (2 N^2 m = 5 * 10^12 FLOP at 67 * 10^12), which bn = 128 about
//     balances (8 evaluations).  The consumers' registers cap the tile at
//     MT_SUMS sums a consumer: 64 x 128, or 128 x 64 for m <= 64 so that a
//     narrow V wastes no columns; float's wide shape takes 64 x 256, 4
//     evaluations at m = 1000 (in double its 256 producers were too few).
//     Shared memory: three stages of the K tile bk x (bm + 4), V's tile
//     bk x (bn + 4) and t's bk values: 170 KB in double, 113 KB (narrow) or
//     185 KB (wide) in float; the +4 keeps the float64 fragment loads
//     (8 rows x 4 columns a warp) off each other's banks and the float
//     loads 16-byte aligned.  bk is a multiple of the producer lanes that
//     share a tile's columns (6, 8 or 12 in float, 6 or 12 in double), so
//     every producer evaluates as many elements of a tile as every other;
//     48 in double would need two stages, which timed slower.
//   * Fixed order, no atomics, no split of N: an output's sum runs over the
//     k-blocks in order, fixed by N, so a slab's rows get the bits of the
//     same rows of the whole product whatever its row tiles.
//
// Not here: each lag once (K's symmetry), which needs a scatter to y_j.
//
// The kernel structure arrives as a postfix program (one op code and one
// parameter offset per entry; leaves push k(r), ADD / MUL combine two
// earlier entries, named by index), built by
// gpyrn_tpu_torch/ops/cuda_kernels.py::encode_program.  The program is the
// same for every thread, so evaluating it never diverges.  Every formula of
// B1 repeats the operation order of gpyrn_tpu_torch/ops/kernels.py, and the
// library is compiled without FMA contraction (-fmad=false), so each
// operation rounds as the plain version's does and the two agree to the
// last bits of the math library's exp / sin.
//
// Without __CUDACC__ only the element math, the tile-pair index map, the
// slab's element rule and the product entry's per-thread steps below are
// compiled (plain C++): the CPU tests build them with the host compiler and
// hold the kernels' arithmetic against autograd of the plain version, and
// the product's tiles and sums against its plain version.

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#else
#include <cmath>
#define __device__
#define __host__
#define __forceinline__ inline
#endif
#include <stddef.h>

// Op codes.  Must equal OPCODES in gpyrn_tpu_torch/ops/cuda_kernels.py
// (a CPU test reads this table and compares).
enum Op : int {
  OP_ADD = 0,
  OP_MUL = 1,
  OP_C = 2,
  OP_SE = 3,
  OP_P = 4,
  OP_QP = 5,
  OP_RQ = 6,
  OP_RQP = 7,
  OP_COS = 8,
  OP_EXP = 9,
  OP_M32 = 10,
  OP_M52 = 11,
  OP_GammaExp = 12,
  OP_PW = 13,
  OP_PAC = 14,
  OP_NP = 15,
  OP_QNP = 16,
  OP_NRQP = 17,
  OP_CP = 18,
  OP_QCP = 19,
};
#define N_OPCODES 20

// X(op) for every leaf op code: the single-leaf instances of both kernels.
#define FOR_EACH_LEAF(X)                                                  \
  X(OP_C) X(OP_SE) X(OP_P) X(OP_QP) X(OP_RQ) X(OP_RQP) X(OP_COS)          \
  X(OP_EXP) X(OP_M32) X(OP_M52) X(OP_GammaExp) X(OP_PW) X(OP_PAC)         \
  X(OP_NP) X(OP_QNP) X(OP_NRQP) X(OP_CP) X(OP_QCP)

// How a kernel instance reads its program (template parameter MODE): a leaf
// op code (>= OP_C) for a program that is that one leaf, or one of these.
#define MODE_PAIR (-1)  // leaf, leaf, ADD or MUL: op codes read at run time
#define MODE_ANY (-2)   // any program: the interpreter

// Limits.  Must equal MAX_OPS / MAX_STACK / MAX_PARAMS in cuda_kernels.py.
#define MAX_OPS 32
#define MAX_STACK 8
#define MAX_PARAMS 64
#define LEAF_PARAMS 6  // the most parameters of one leaf (NRQP)
#define N_CONSTS 6     // parameter-only terms kept per leaf (leaf_consts)

// Tiles (both kernels): a block of THREADS threads covers TILE x TILE
// elements; a thread owns 16 bytes of neighbouring columns in each of its
// rows.  TILE must equal TILE in cuda_kernels.py, which sizes both grids.
#define TILE 32
#define THREADS 256
#define WARPS (THREADS / 32)
// B1': the blocks per SM that a kernel instance's registers must allow.  A
// leaf whose derivatives fit 64 registers a thread runs 4 blocks per SM;
// the four periodic (1 + w)^-alpha leaves, the pair and the interpreter
// would spill there and get 128.
#define GRAD_MIN_BLOCKS_LIGHT 4
#define GRAD_MIN_BLOCKS_HEAVY 2

struct Program {
  int n_ops;
  int op[MAX_OPS];
  int off[MAX_OPS];
  int lhs[MAX_OPS];  // the two entries an ADD / MUL combines (-1 at a leaf)
  int rhs[MAX_OPS];
};

// Constants as the plain version spells them (Python's math.pi,
// math.sqrt(3.0), math.sqrt(5.0), 2 * math.pi, 3 * math.sqrt(5.0)),
// rounded to the working type where they are used.
#define K_PI 3.14159265358979323846
#define K_SQRT3 1.73205080756887729353
#define K_SQRT5 2.23606797749978969641

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
// sin(pi u) and cos(pi u): the reduction of u modulo 2 is exact, so the
// card's sincospi has no slow path for large arguments (and so no stack
// frame), unlike sin(pi * u).  B1' uses it; B1 must round as the plain
// version does and keeps sin / cos of the rounded product.
__device__ __forceinline__ void m_sincospi(float u, float* s, float* c) {
#ifdef __CUDACC__
  sincospif(u, s, c);
#else
  *s = sinf(float(K_PI) * u);
  *c = cosf(float(K_PI) * u);
#endif
}
__device__ __forceinline__ void m_sincospi(double u, double* s, double* c) {
#ifdef __CUDACC__
  sincospi(u, s, c);
#else
  *s = sin(K_PI * u);
  *c = cos(K_PI * u);
#endif
}

__host__ __device__ __forceinline__ constexpr bool is_leaf_op(int op) {
  return op >= OP_C && op < N_OPCODES;
}

// The number of parameters a leaf reads.
__host__ __device__ __forceinline__ constexpr int leaf_n_params(int op) {
  return (op == OP_C || op == OP_PW) ? 1
         : (op == OP_SE || op == OP_COS || op == OP_EXP || op == OP_M32 ||
            op == OP_M52) ? 2
         : (op == OP_P || op == OP_RQ || op == OP_GammaExp || op == OP_PAC ||
            op == OP_CP) ? 3
         : (op == OP_QP || op == OP_NP || op == OP_QCP) ? 4
         : (op == OP_RQP || op == OP_QNP) ? 5
         : (op == OP_NRQP) ? 6 : 0;
}

// The parameter-only terms of one leaf's formula, c[0 .. N_CONSTS): each is
// the sub-expression the plain version forms, by the same operations in the
// same order, so leaf() below rounds as before.
template <typename T>
__device__ __forceinline__ void leaf_consts(int op, const T* p, T* c) {
#pragma unroll
  for (int m = 0; m < N_CONSTS; ++m) c[m] = T(0);
  switch (op) {
    case OP_C:
    case OP_COS:
    case OP_EXP:
    case OP_M32:
    case OP_GammaExp:
      c[0] = p[0] * p[0];
      return;
    case OP_SE:  // theta, ell
      c[0] = p[0] * p[0];
      c[1] = p[1] * p[1];
      return;
    case OP_P:   // theta, P, ell
    case OP_CP:  // amplitude, P, ell
      c[0] = p[0] * p[0];
      c[1] = p[2] * p[2];
      return;
    case OP_QP:   // theta, ell_e, P, ell_p
    case OP_QCP:  // amplitude, ell_e, P, ell_p
      c[0] = p[0] * p[0];
      c[1] = p[3] * p[3];
      c[2] = T(2) * (p[1] * p[1]);
      return;
    case OP_RQ:  // theta, alpha, ell
      c[0] = p[0] * p[0];
      c[1] = p[1] * (p[2] * p[2]);
      c[2] = -p[1];
      return;
    case OP_RQP:  // theta, alpha, ell_e, P, ell_p
      c[0] = p[0] * p[0];
      c[1] = p[4] * p[4];
      c[2] = (T(2) * p[1]) * (p[2] * p[2]);
      c[3] = -p[1];
      return;
    case OP_M52:  // theta, ell
      c[0] = p[0] * p[0];
      c[1] = T(3.0 * K_SQRT5) * p[1];
      c[2] = T(3) * (p[1] * p[1]);
      return;
    case OP_PW:  // eta
      c[0] = T(0.5) * p[0];
      return;
    case OP_PAC: {  // amplitude, ell_1, ell_2
      const T den = p[1] * p[1] + p[2] * p[2];
      const T a = m_sqrt(((T(2) * p[1]) * p[2]) / den);
      c[0] = (p[0] * p[0]) * a;
      c[1] = den;
      return;
    }
    case OP_NP:  // amplitude, alpha2, P, ell
      c[0] = p[0] * p[0];
      c[1] = p[1] * (p[3] * p[3]);
      c[2] = -p[1];
      return;
    case OP_QNP:  // amplitude, alpha2, ell_e, P, ell_p
      c[0] = p[0] * p[0];
      c[1] = p[1] * (p[4] * p[4]);
      c[2] = -p[1];
      c[3] = p[2] * p[2];
      return;
    case OP_NRQP:  // amplitude, alpha1, alpha2, ell_e, P, ell_p
      c[0] = p[0] * p[0];
      c[1] = p[2] * (p[5] * p[5]);
      c[2] = -p[2];
      c[3] = p[1] * (p[3] * p[3]);
      c[4] = -p[1];
      return;
  }
}

// One leaf kernel at lag r; p points at its parameters, c at its
// leaf_consts.  Each case follows the matching function of
// gpyrn_tpu_torch/ops/kernels.py term by term.
template <typename T>
__device__ __forceinline__ T leaf(int op, const T* p, const T* c, T r) {
  const T pi = T(K_PI);
  const T ar = m_abs(r);
  switch (op) {
    case OP_C:  // c^2
      return c[0];
    case OP_SE:  // theta^2 exp(-r^2 / 2 ell^2)
      return c[0] * m_exp((T(-0.5) * (r * r)) / c[1]);
    case OP_P: {  // theta^2 exp(-2 sin^2(pi |r| / P) / ell^2)
      const T s = m_sin((pi * ar) / p[1]);
      return c[0] * m_exp((T(-2) * (s * s)) / c[1]);
    }
    case OP_QP: {  // theta, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[2]);
      const T term1 = (T(-2) * (s * s)) / c[1];
      const T term2 = (r * r) / c[2];
      return c[0] * m_exp(term1 - term2);
    }
    case OP_RQ: {  // theta, alpha, ell
      const T b = T(1) + (T(0.5) * (r * r)) / c[1];
      return c[0] * m_pow(b, c[2]);
    }
    case OP_RQP: {  // theta, alpha, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[3]);
      const T e = m_exp((T(-2) * (s * s)) / c[1]);
      const T b = T(1) + (r * r) / c[2];
      return (c[0] * e) * m_pow(b, c[3]);
    }
    case OP_COS:  // theta^2 cos(2 pi |r| / P)
      return c[0] * m_cos((T(2.0 * K_PI) * ar) / p[1]);
    case OP_EXP:  // theta^2 exp(-|r| / ell)
      return c[0] * m_exp((-ar) / p[1]);
    case OP_M32: {  // theta, ell
      const T s = (T(K_SQRT3) * ar) / p[1];
      return (c[0] * (T(1) + s)) * m_exp(-s);
    }
    case OP_M52: {  // theta, ell
      const T num = (c[1] * ar) + T(5) * (ar * ar);
      const T poly = T(1) + num / c[2];
      return (c[0] * poly) * m_exp((T(-K_SQRT5) * ar) / p[1]);
    }
    case OP_GammaExp:  // theta, gamma, l
      return c[0] * m_exp(-m_pow(ar / p[2], p[1]));
    case OP_PW: {  // eta
      const T a = m_abs(r / c[0]);
      const T u = T(1) - a;
      const T pw = (T(3) * a + T(1)) * ((u * u) * u);
      return a > T(1) ? T(0) : pw;
    }
    case OP_PAC:  // amplitude, ell_1, ell_2
      return c[0] * m_exp(((T(-2) * r) * r) / c[1]);
    case OP_NP: {  // amplitude, alpha2, P, ell
      const T s = m_sin((pi * ar) / p[2]);
      return c[0] * m_pow(T(1) + (T(2) * (s * s)) / c[1], c[2]);
    }
    case OP_QNP: {  // amplitude, alpha2, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[3]);
      const T a = m_pow(T(1) + (T(2) * (s * s)) / c[1], c[2]);
      const T b = m_exp((T(-0.5) * (r * r)) / c[3]);
      return (c[0] * a) * b;
    }
    case OP_NRQP: {  // amplitude, alpha1, alpha2, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[4]);
      const T a = m_pow(T(1) + (T(2) * (s * s)) / c[1], c[2]);
      const T b = m_pow(T(1) + (T(0.5) * (r * r)) / c[3], c[4]);
      return (c[0] * a) * b;
    }
    case OP_CP: {  // amplitude, P, ell
      const T co = m_cos((pi * ar) / p[1]);
      return c[0] * m_exp((T(-2) * (co * co)) / c[1]);
    }
    case OP_QCP: {  // amplitude, ell_e, P, ell_p
      const T co = m_cos((pi * ar) / p[2]);
      const T term1 = (T(-2) * (co * co)) / c[1];
      const T term2 = (r * r) / c[2];
      return c[0] * m_exp(term1 - term2);
    }
  }
  return T(0);
}

// The interpreter of B1: par holds the program's parameters, cst the
// leaf_consts of entry k at cst + k * N_CONSTS.
template <typename T>
__device__ __forceinline__ T eval_program(const Program& prog, const T* par,
                                          const T* cst, T r) {
  T stack[MAX_STACK];
  int top = 0;
  for (int k = 0; k < prog.n_ops; ++k) {
    const int op = prog.op[k];
    if (op == OP_ADD) {
      --top;
      stack[top - 1] = stack[top - 1] + stack[top];
    } else if (op == OP_MUL) {
      --top;
      stack[top - 1] = stack[top - 1] * stack[top];
    } else {
      stack[top++] = leaf<T>(op, par + prog.off[k], cst + k * N_CONSTS, r);
    }
  }
  return stack[0];
}

// k(r) of a program, as the kernel instance of MODE reads it: a single leaf
// and a pair take their parameters and constants from p0 / c0 (and p1 / c1),
// which the caller indexes only at compile time; any other program runs
// the interpreter on par / cst.
template <typename T, int MODE>
__device__ __forceinline__ T program_value(const Program& prog, const T* p0,
                                           const T* c0, const T* p1,
                                           const T* c1, const T* par,
                                           const T* cst, T r) {
  if constexpr (MODE >= OP_C) {
    return leaf<T>(MODE, p0, c0, r);
  } else if constexpr (MODE == MODE_PAIR) {
    const T k0 = leaf<T>(prog.op[0], p0, c0, r);
    const T k1 = leaf<T>(prog.op[1], p1, c1, r);
    return prog.op[2] == OP_ADD ? k0 + k1 : k0 * k1;
  } else {
    return eval_program<T>(prog, par, cst, r);
  }
}

// One leaf's value and derivatives in one pass: returns k(r) and writes
// d[m] = d k(r) / d p[m] for the leaf's own parameters, from one exp /
// sincospi / pow.  Derived by hand from the formulas above; divisions by
// parameter-only terms are products with reciprocals that do not depend on
// r, so a caller that keeps p in registers pays for them once, outside its
// element loop.  Where a derivative carries |r| (or a power of x = |r| / l)
// as a factor it is 0 on the diagonal r = 0, as autograd of the plain
// version gives it; GammaExp's d/dgamma of x^gamma = x^gamma log x is taken
// as 0 at x = 0 (no 0 * -inf), and its d/dl is written as gamma x^gamma / l,
// finite at x = 0.  PW passes nothing outside its support |r| > eta / 2.
// (1 + w)^-alpha takes its d/dalpha as (w / (1 + w) - log1p(w)) (1 + w)^-alpha.
// Every case is even in r.
template <typename T>
__device__ __forceinline__ T leaf_vd(int op, const T* p, T r, T* d) {
  const T pi = T(K_PI);
  const T ar = m_abs(r);
  const T r2 = r * r;
  switch (op) {
    case OP_C:
      d[0] = T(2) * p[0];
      return p[0] * p[0];
    case OP_SE: {  // theta, ell
      const T l2 = p[1] * p[1];
      const T e = m_exp((T(-0.5) * r2) * (T(1) / l2));
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = k * (r2 * (T(1) / (l2 * p[1])));
      return k;
    }
    case OP_P: {  // theta, P, ell
      const T u = ar * (T(1) / p[1]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T l2 = p[2] * p[2];
      const T e = m_exp((T(-2) * (s * s)) * (T(1) / l2));
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = (k * (((T(4) * s) * c) * x)) * (T(1) / (l2 * p[1]));
      d[2] = (k * (T(4) * (s * s))) * (T(1) / (l2 * p[2]));
      return k;
    }
    case OP_QP: {  // theta, ell_e, P, ell_p
      const T u = ar * (T(1) / p[2]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T lp2 = p[3] * p[3];
      const T le2 = p[1] * p[1];
      const T e = m_exp((T(-2) * (s * s)) * (T(1) / lp2) -
                        r2 * (T(1) / (T(2) * le2)));
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = k * (r2 * (T(1) / (le2 * p[1])));
      d[2] = (k * (((T(4) * s) * c) * x)) * (T(1) / (lp2 * p[2]));
      d[3] = (k * (T(4) * (s * s))) * (T(1) / (lp2 * p[3]));
      return k;
    }
    case OP_RQ: {  // theta, alpha, ell
      const T w = (T(0.5) * r2) * (T(1) / (p[1] * (p[2] * p[2])));
      const T b = T(1) + w;
      const T ib = T(1) / b;
      const T a = m_pow(b, -p[1]);
      const T k = (p[0] * p[0]) * a;
      d[0] = (T(2) * p[0]) * a;
      d[1] = k * (w * ib - m_log1p(w));
      d[2] = (k * (((T(2) * p[1]) * (T(1) / p[2])) * w)) * ib;
      return k;
    }
    case OP_RQP: {  // theta, alpha, ell_e, P, ell_p
      const T u = ar * (T(1) / p[3]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T lp2 = p[4] * p[4];
      const T e = m_exp((T(-2) * (s * s)) * (T(1) / lp2));
      const T w = r2 * (T(1) / ((T(2) * p[1]) * (p[2] * p[2])));
      const T b = T(1) + w;
      const T ib = T(1) / b;
      const T a = m_pow(b, -p[1]);
      const T k = ((p[0] * p[0]) * e) * a;
      d[0] = ((T(2) * p[0]) * e) * a;
      d[1] = k * (w * ib - m_log1p(w));
      d[2] = (k * (((T(2) * p[1]) * (T(1) / p[2])) * w)) * ib;
      d[3] = (k * (((T(4) * s) * c) * x)) * (T(1) / (lp2 * p[3]));
      d[4] = (k * (T(4) * (s * s))) * (T(1) / (lp2 * p[4]));
      return k;
    }
    case OP_COS: {  // theta, P
      const T ip = T(1) / p[1];
      const T u = (T(2) * ar) * ip;
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      d[0] = (T(2) * p[0]) * c;
      d[1] = (((p[0] * p[0]) * s) * x) * ip;
      return (p[0] * p[0]) * c;
    }
    case OP_EXP: {  // theta, ell
      const T il = T(1) / p[1];
      const T e = m_exp((-ar) * il);
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = (k * ar) * (il * il);
      return k;
    }
    case OP_M32: {  // theta, ell
      const T il = T(1) / p[1];
      const T s = (T(K_SQRT3) * ar) * il;
      const T e = m_exp(-s);
      d[0] = ((T(2) * p[0]) * (T(1) + s)) * e;
      d[1] = (((p[0] * p[0]) * e) * (s * s)) * il;
      return ((p[0] * p[0]) * (T(1) + s)) * e;
    }
    case OP_M52: {  // theta, ell
      const T il = T(1) / p[1];
      const T s = (T(K_SQRT5) * ar) * il;
      const T e = m_exp(-s);
      const T poly = T(1) + s + (s * s) * T(1.0 / 3.0);
      d[0] = ((T(2) * p[0]) * poly) * e;
      d[1] = (((p[0] * p[0]) * e) * ((s * s) * (T(1) + s))) *
             (il * T(1.0 / 3.0));
      return ((p[0] * p[0]) * poly) * e;
    }
    case OP_GammaExp: {  // theta, gamma, l
      const T il = T(1) / p[2];
      const T x = ar * il;
      const T z = m_pow(x, p[1]);
      const T e = m_exp(-z);
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = x > T(0) ? -((k * z) * m_log(x)) : T(0);
      d[2] = ((k * p[1]) * z) * il;
      return k;
    }
    case OP_PW: {  // eta
      const T a = m_abs(r * (T(1) / (T(0.5) * p[0])));
      const T u = T(1) - a;
      const bool in = !(a > T(1));
      d[0] = in ? ((T(12) * (a * a)) * (u * u)) * (T(1) / p[0]) : T(0);
      return in ? (T(3) * a + T(1)) * ((u * u) * u) : T(0);
    }
    case OP_PAC: {  // amplitude, ell_1, ell_2
      const T l1 = p[1], l2 = p[2];
      const T den = l1 * l1 + l2 * l2;
      const T iden = T(1) / den;
      const T iden2 = iden * iden;
      const T a = m_sqrt(((T(2) * l1) * l2) * iden);
      const T b = m_exp(((T(-2) * r) * r) * iden);
      const T amp2 = p[0] * p[0];
      const T da1 = ((l2 * (l2 * l2 - l1 * l1)) * iden2) / a;
      const T da2 = ((l1 * (l1 * l1 - l2 * l2)) * iden2) / a;
      const T db = (b * (T(4) * r2)) * iden2;
      d[0] = ((T(2) * p[0]) * a) * b;
      d[1] = amp2 * (da1 * b + a * (db * l1));
      d[2] = amp2 * (da2 * b + a * (db * l2));
      return (amp2 * a) * b;
    }
    case OP_NP: {  // amplitude, alpha2, P, ell
      const T u = ar * (T(1) / p[2]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T l2 = p[3] * p[3];
      const T w = (T(2) * (s * s)) * (T(1) / (p[1] * l2));
      const T b = T(1) + w;
      const T ib = T(1) / b;
      const T a = m_pow(b, -p[1]);
      const T k = (p[0] * p[0]) * a;
      d[0] = (T(2) * p[0]) * a;
      d[1] = k * (w * ib - m_log1p(w));
      d[2] = ((k * (((T(4) * s) * c) * x)) * (T(1) / (l2 * p[2]))) * ib;
      d[3] = (k * (((T(2) * p[1]) * (T(1) / p[3])) * w)) * ib;
      return k;
    }
    case OP_QNP: {  // amplitude, alpha2, ell_e, P, ell_p
      const T u = ar * (T(1) / p[3]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T lp2 = p[4] * p[4];
      const T le2 = p[2] * p[2];
      const T w = (T(2) * (s * s)) * (T(1) / (p[1] * lp2));
      const T b = T(1) + w;
      const T ib = T(1) / b;
      const T a = m_pow(b, -p[1]);
      const T e = m_exp((T(-0.5) * r2) * (T(1) / le2));
      const T k = ((p[0] * p[0]) * a) * e;
      d[0] = ((T(2) * p[0]) * a) * e;
      d[1] = k * (w * ib - m_log1p(w));
      d[2] = k * (r2 * (T(1) / (le2 * p[2])));
      d[3] = ((k * (((T(4) * s) * c) * x)) * (T(1) / (lp2 * p[3]))) * ib;
      d[4] = (k * (((T(2) * p[1]) * (T(1) / p[4])) * w)) * ib;
      return k;
    }
    case OP_NRQP: {  // amplitude, alpha1, alpha2, ell_e, P, ell_p
      const T u = ar * (T(1) / p[4]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T lp2 = p[5] * p[5];
      const T w2 = (T(2) * (s * s)) * (T(1) / (p[2] * lp2));
      const T b2 = T(1) + w2;
      const T ib2 = T(1) / b2;
      const T a = m_pow(b2, -p[2]);
      const T w1 = (T(0.5) * r2) * (T(1) / (p[1] * (p[3] * p[3])));
      const T b1 = T(1) + w1;
      const T ib1 = T(1) / b1;
      const T b = m_pow(b1, -p[1]);
      const T k = ((p[0] * p[0]) * a) * b;
      d[0] = ((T(2) * p[0]) * a) * b;
      d[1] = k * (w1 * ib1 - m_log1p(w1));
      d[2] = k * (w2 * ib2 - m_log1p(w2));
      d[3] = (k * (((T(2) * p[1]) * (T(1) / p[3])) * w1)) * ib1;
      d[4] = ((k * (((T(4) * s) * c) * x)) * (T(1) / (lp2 * p[4]))) * ib2;
      d[5] = (k * (((T(2) * p[2]) * (T(1) / p[5])) * w2)) * ib2;
      return k;
    }
    case OP_CP: {  // amplitude, P, ell
      const T u = ar * (T(1) / p[1]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T l2 = p[2] * p[2];
      const T e = m_exp((T(-2) * (c * c)) * (T(1) / l2));
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = -((k * (((T(4) * c) * s) * x)) * (T(1) / (l2 * p[1])));
      d[2] = (k * (T(4) * (c * c))) * (T(1) / (l2 * p[2]));
      return k;
    }
    case OP_QCP: {  // amplitude, ell_e, P, ell_p
      const T u = ar * (T(1) / p[2]);
      const T x = pi * u;
      T s, c;
      m_sincospi(u, &s, &c);
      const T lp2 = p[3] * p[3];
      const T le2 = p[1] * p[1];
      const T e = m_exp((T(-2) * (c * c)) * (T(1) / lp2) -
                        r2 * (T(1) / (T(2) * le2)));
      const T k = (p[0] * p[0]) * e;
      d[0] = (T(2) * p[0]) * e;
      d[1] = k * (r2 * (T(1) / (le2 * p[1])));
      d[2] = -((k * (((T(4) * c) * s) * x)) * (T(1) / (lp2 * p[2])));
      d[3] = (k * (T(4) * (c * c))) * (T(1) / (lp2 * p[3]));
      return k;
    }
  }
  return T(0);
}

// The interpreter of B1': one element's contribution g * dk(r)/dp to acc.
// The program runs forward keeping every entry's value and every leaf's
// derivatives (d, indexed like the parameters), then the adjoint g walks
// back through it (ADD passes it to both entries, MUL to each times the
// other's value) and weighs each leaf's derivatives.
template <typename T>
__device__ __forceinline__ void element_grad(const Program& prog, const T* p,
                                             T r, T g, T* acc) {
  const int n = prog.n_ops;
  T val[MAX_OPS];
  T adj[MAX_OPS];
  T d[MAX_PARAMS];
  for (int k = 0; k < n; ++k) {
    const int op = prog.op[k];
    if (op == OP_ADD) {
      val[k] = val[prog.lhs[k]] + val[prog.rhs[k]];
    } else if (op == OP_MUL) {
      val[k] = val[prog.lhs[k]] * val[prog.rhs[k]];
    } else {
      val[k] = leaf_vd<T>(op, p + prog.off[k], r, d + prog.off[k]);
    }
    adj[k] = T(0);
  }
  adj[n - 1] = g;
  for (int k = n - 1; k >= 0; --k) {
    const int op = prog.op[k];
    const T a = adj[k];
    if (op == OP_ADD) {
      adj[prog.lhs[k]] += a;
      adj[prog.rhs[k]] += a;
    } else if (op == OP_MUL) {
      adj[prog.lhs[k]] += a * val[prog.rhs[k]];
      adj[prog.rhs[k]] += a * val[prog.lhs[k]];
    } else {
      const int off = prog.off[k];
      const int np = leaf_n_params(op);
      for (int m = 0; m < np; ++m) acc[off + m] += a * d[off + m];
    }
  }
}

// One element's contribution g * dk(r)/dp as the kernel instance of MODE
// takes it.  A single leaf adds into acc0[0 .. its parameters), a pair into
// acc0 and acc1 (one per leaf), both indexed only at compile time; any other
// program runs the interpreter on par and adds into acc[0 .. n_params).
template <typename T, int MODE>
__device__ __forceinline__ void program_grad(const Program& prog, const T* p0,
                                             const T* p1, const T* par, T r,
                                             T g, T* acc0, T* acc1, T* acc) {
  if constexpr (MODE >= OP_C) {
    T d[LEAF_PARAMS] = {};
    leaf_vd<T>(MODE, p0, r, d);
#pragma unroll
    for (int m = 0; m < leaf_n_params(MODE); ++m) acc0[m] += g * d[m];
  } else if constexpr (MODE == MODE_PAIR) {
    T d0[LEAF_PARAMS] = {};
    T d1[LEAF_PARAMS] = {};
    const T k0 = leaf_vd<T>(prog.op[0], p0, r, d0);
    const T k1 = leaf_vd<T>(prog.op[1], p1, r, d1);
    const bool mul = prog.op[2] == OP_MUL;
    const T a0 = mul ? g * k1 : g;
    const T a1 = mul ? g * k0 : g;
    // a leaf's unused derivatives are 0
#pragma unroll
    for (int m = 0; m < LEAF_PARAMS; ++m) {
      acc0[m] += a0 * d0[m];
      acc1[m] += a1 * d1[m];
    }
  } else {
    element_grad<T>(prog, par, r, g, acc);
  }
}

// The instance a program runs: its leaf's, the pair's, or the interpreter.
static inline int program_mode(const Program& prog) {
  if (prog.n_ops == 1 && is_leaf_op(prog.op[0])) return prog.op[0];
  if (prog.n_ops == 3 && is_leaf_op(prog.op[0]) && is_leaf_op(prog.op[1]) &&
      !is_leaf_op(prog.op[2]) && prog.off[0] == 0) {
    return MODE_PAIR;
  }
  return MODE_ANY;
}

// The tile pairs (I, J), I >= J, of a matrix of `tiles` x `tiles` tiles, in
// the order both kernels walk them: pair p is row I = the largest I with
// I (I + 1) / 2 <= p, column J = p - I (I + 1) / 2.  The square root only
// proposes I; the two integer loops make it exact at every p.
__host__ __device__ __forceinline__ long long n_tile_pairs(long long tiles) {
  return tiles * (tiles + 1) / 2;
}

__host__ __device__ __forceinline__ void tile_pair(long long p, int* I,
                                                   int* J) {
  long long i = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  *I = (int)i;
  *J = (int)(p - i * (i + 1) / 2);
}

// B1's slab entry, one element (i, j) of the n_pad x n_pad matrix whose
// rows [r0, r0 + n_rows) the entry writes: the kernel value k = k(t_i -
// t_j) with the jitter on the diagonal inside the n x n matrix, identity
// in the padded rows and columns (the panel-sharded engine's padding).  k
// is read only inside the matrix.
template <typename T>
__host__ __device__ __forceinline__ T slab_element(int i, int j, int n, T k,
                                                   T jit) {
  if (i >= n || j >= n) return i == j ? T(1) : T(0);
  return i == j ? k + jit : k;
}

// ---- B1's product entry: the per-thread steps, shared with the host ------
//
// Sizes.  MV_CAP and MV_STAGE must equal MATVEC_CAP and MATVEC_STAGE in
// cuda_kernels.py.
#define MV_THREADS 128          // register path: rows of a block, one a thread
#define MV_STAGE 256            // register path: columns staged per step
#define MV_SUM 32               // register path: columns of a fresh partial
#define MV_CAP 8                // the register path takes m <= MV_CAP
#define MV_TARGET_BLOCKS 4096   // blocks the column split aims at
#define MT_SUMS 64              // tiled path: the sums a consumer thread holds

__device__ __forceinline__ float mv_fma(float a, float b, float c) {
#ifdef __CUDACC__
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}
__device__ __forceinline__ double mv_fma(double a, double b, double c) {
#ifdef __CUDACC__
  return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

// The register path's column groups, from N alone: about MV_TARGET_BLOCKS
// blocks over the row tiles of all N rows, whole steps of MV_STAGE columns.
__host__ __device__ __forceinline__ int mv_group_cols(int n) {
  const long long row_tiles = (n + MV_THREADS - 1) / MV_THREADS;
  const long long want = (MV_TARGET_BLOCKS + row_tiles - 1) / row_tiles;
  long long cols = (n + want - 1) / want;
  cols = (cols + MV_STAGE - 1) / MV_STAGE * MV_STAGE;
  return (int)cols;
}

__host__ __device__ __forceinline__ int mv_groups(int n) {
  const int cols = mv_group_cols(n);
  return (n + cols - 1) / cols;
}

// Group g's columns [*j0, *j1).
__host__ __device__ __forceinline__ void mv_group_range(int n, int g, int* j0,
                                                        int* j1) {
  const int cols = mv_group_cols(n);
  *j0 = g * cols;
  *j1 = n < *j0 + cols ? n : *j0 + cols;
}

// The last two roundings of y: the sum, then the nugget's term.
template <typename T>
__device__ __forceinline__ T mv_add_nugget(T s, T nugget, T v) {
  return s + nugget * v;
}

// Two or four neighbouring values from shared memory (aligned to their
// size on the card: 8- or 16-byte loads; a broadcast where a warp reads
// one address).
__device__ __forceinline__ void load2(const float* p, float* v) {
#ifdef __CUDACC__
  const float2 x = *reinterpret_cast<const float2*>(p);
  v[0] = x.x;
  v[1] = x.y;
#else
  for (int u = 0; u < 2; ++u) v[u] = p[u];
#endif
}
__device__ __forceinline__ void load2(const double* p, double* v) {
#ifdef __CUDACC__
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
#else
  for (int u = 0; u < 2; ++u) v[u] = p[u];
#endif
}
__device__ __forceinline__ void load4(const float* p, float* v) {
#ifdef __CUDACC__
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
#else
  for (int u = 0; u < 4; ++u) v[u] = p[u];
#endif
}
__device__ __forceinline__ void load4(const double* p, double* v) {
#ifdef __CUDACC__
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
#else
  for (int u = 0; u < 4; ++u) v[u] = p[u];
#endif
}

// U neighbouring values (U = 1, 2 or 4) from shared memory, aligned to U.
template <int U, typename T>
__device__ __forceinline__ void load_cols(const T* p, T* v) {
  if constexpr (U == 4) {
    load4(p, v);
  } else if constexpr (U == 2) {
    load2(p, v);
  } else {
    v[0] = p[0];
  }
}

// Register path: the columns a pass of a row's loop loads and evaluates
// together (their times, and for W = 1 their values, in one load; their
// evaluations unrolled): four, but one in the one-column float instances,
// whose plain column loop the compiler unrolls itself: there, passes of
// two or four columns keep registers live across the math library's
// out-of-line division fallback, which ptxas saves as spills (an H100
// build, PERF.md section 6).
template <typename T, int W>
__host__ __device__ constexpr int mv_pass_cols() {
  return sizeof(T) == 4 && W == 1 ? 1 : 4;
}

// Register path: the W values of one staged column of V (16-byte loads
// where W is a multiple of 4; the staged rows are 16-byte aligned).
template <typename T, int W>
__device__ __forceinline__ void mv_load_row(const T* p, T* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4) load4(p + c, v + c);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = p[c];
  }
}

// Register path, one thread on one staged step: row time ti against the
// cnt <= MV_STAGE columns ts[0 .. cnt) and their values vs[j * W + c];
// acc[c] gains one partial sum per MV_SUM columns, each taken from 0, its
// products added in column order.  A pass takes mv_pass_cols columns,
// which leaves each sum's order as it is.
template <typename T, int MODE, int W>
__device__ __forceinline__ void mv_row_stage(
    const Program& prog, const T* p0, const T* c0, const T* p1, const T* c1,
    const T* par, const T* cst, T ti, const T* ts, const T* vs, int cnt,
    T* acc) {
  constexpr int U = mv_pass_cols<T, W>();
  static_assert(MV_SUM % 4 == 0, "a partial's columns come in whole passes");
  for (int s = 0; s < cnt; s += MV_SUM) {
    const int e = cnt < s + MV_SUM ? cnt : s + MV_SUM;
    T part[W];
#pragma unroll
    for (int c = 0; c < W; ++c) part[c] = T(0);
    int j = s;
    for (; U > 1 && j + U <= e; j += U) {
      T tj[U], vv[U];
      load_cols<U>(ts + j, tj);
      if constexpr (W == 1) load_cols<U>(vs + j, vv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T k = program_value<T, MODE>(prog, p0, c0, p1, c1, par, cst,
                                           ti - tj[u]);
        if constexpr (W == 1) {
          part[0] = mv_fma(k, vv[u], part[0]);
        } else {
          T vw[W];
          mv_load_row<T, W>(vs + (j + u) * W, vw);
#pragma unroll
          for (int c = 0; c < W; ++c) part[c] = mv_fma(k, vw[c], part[c]);
        }
      }
    }
    for (; j < e; ++j) {  // what the passes leave: every column at U = 1
      const T k = program_value<T, MODE>(prog, p0, c0, p1, c1, par, cst,
                                         ti - ts[j]);
#pragma unroll
      for (int c = 0; c < W; ++c) part[c] = mv_fma(k, vs[j * W + c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = acc[c] + part[c];
  }
}

// The groups' partial sums of one output, partial[g * stride], in order.
template <typename T>
__device__ __forceinline__ T mv_sum_groups(const T* partial, int groups,
                                           size_t stride) {
  T s = partial[0];
  for (int g = 1; g < groups; ++g) s = s + partial[(size_t)g * stride];
  return s;
}

// Tiled path: a block's tile of y, bm x bn, is MT_SUMS outputs a consumer
// thread, in registers: an 8 x 8 micro-tile of floats (and its partials),
// or 64 doubles of a warp's 64 x 32 tile of mma accumulators.  A block's
// shape (setmaxnreg shares the SM's 65,536 registers between its consumer
// and producer threads; one block an SM):
//   narrow: 128 consumers (208 registers) and 768 producers (48): tiles
//     128 x 64 (m <= 64) or 64 x 128;
//   wide, float at m > 128: 256 consumers (160 registers) and 512
//     producers (40): 64 x 256 tiles, so that K is evaluated ceil(m / 256)
//     times, not ceil(m / 128) (in double the consumers' registers would
//     leave room for 256 producers only, too few: slower on an H100).
// K's columns come in k-blocks of bk, 48 in float and 36 in double, so
// that every producer evaluates as many elements of a K tile as every
// other (48 columns over 6, 8 or 12 producer lanes, 36 over 6 or 12),
// through a ring of three stages (in double three stages of 48 would not
// fit).
template <typename T, int WIDE>
struct MtShape {
  static constexpr int consumers = WIDE ? 256 : 128;
  static constexpr int producers = WIDE ? 512 : 768;
  static constexpr int threads = consumers + producers;
  static constexpr int consumer_regs = WIDE ? 160 : 208;
  static constexpr int producer_regs = WIDE ? 40 : 48;
  // setmaxnreg moves registers only within the block's own allocation,
  // threads x (65,536 / threads rounded down to 8): a block that asked
  // for more would wait in setmaxnreg.inc for ever
  static_assert(consumers * consumer_regs + producers * producer_regs <=
                    threads * (65536 / threads / 8 * 8),
                "the block's registers after setmaxnreg");
  static constexpr int bk = sizeof(T) == 4 ? 48 : 36;
  static constexpr int stages = 3;
  // a tile of bn columns has producers * bn / (consumers * MT_SUMS) lanes
  // of producers over its columns (bn 64 or 128 narrow, 256 wide)
  static_assert(WIDE ? sizeof(T) == 8 ||
                           bk % (producers * 256 / (consumers * MT_SUMS)) == 0
                     : bk % (producers * 64 / (consumers * MT_SUMS)) == 0 &&
                           bk % (producers * 128 / (consumers * MT_SUMS)) == 0,
                "every producer lane of a tile evaluates as many columns");
};

// The tile's columns bn for m columns of V: 64 for m <= 64, else 128, or
// 256 in the wide shape; the tile's rows are bm = consumers * MT_SUMS /
// bn.  It depends on m alone, so a slab of rows sums as the whole product
// does.
template <typename T>
__host__ __device__ __forceinline__ int mt_wide(int m) {
  return sizeof(T) == 4 && m > 128;
}
template <typename T>
__host__ __device__ __forceinline__ int mt_bn(int m) {
  return m <= 64 ? 64 : mt_wide<T>(m) ? 256 : 128;
}
template <typename T>
__host__ __device__ __forceinline__ int mt_bm(int m) {
  return (mt_wide<T>(m) ? 256 : 128) * MT_SUMS / mt_bn<T>(m);
}
// the producer threads of m's shape
template <typename T>
__host__ __device__ __forceinline__ int mt_producers(int m) {
  return mt_wide<T>(m) ? MtShape<T, 1>::producers
                       : MtShape<T, 0>::producers;
}
template <typename T>
__host__ __device__ __forceinline__ constexpr int mt_bk() {
  return MtShape<T, 0>::bk;
}

// Tiled path, producer thread p's part of the K tile of the k-block [j0,
// j0 + mt_bk): kt[k * (bm + 4) + r] = k(ti - ts[k]) for the tile's row
// r = p % bm, every (np / bm)-th column from p / bm (np producers); 0 past
// N.
// ts holds t[j0 + k].  The +4 keeps the float64 operand loads off each
// other's banks.  One element at a time: its code is branchy (the math
// library's fallbacks), so its latency is hidden by the many producer
// warps, not by interleaving.
template <typename T, int MODE>
__device__ __forceinline__ void mt_eval(const Program& prog, const T* p0,
                                        const T* c0, const T* p1, const T* c1,
                                        const T* par, const T* cst, T ti,
                                        const T* ts, int n, int j0, int bm,
                                        int np, int p, T* kt) {
  const int r = p % bm;
#pragma unroll 1
  for (int k = p / bm; k < mt_bk<T>(); k += np / bm) {
    kt[k * (bm + 4) + r] =
        j0 + k < n ? program_value<T, MODE>(prog, p0, c0, p1, c1, par, cst,
                                            ti - ts[k])
                   : T(0);
  }
}

// Tiled path: where consumer thread tid's output f lies in the block's
// bm x bn tile.  In float, thread (ty, tx) = (tid / (bn / 8), tid %
// (bn / 8)) holds rows ty * 4 + [0, 4) and bm / 2 + ty * 4 + [0, 4),
// columns tx * 4 + [0, 4) and bn / 2 + tx * 4 + [0, 4) (16-byte loads
// that meet no bank twice), f = 8 * row + column of the micro-tile.  In
// double, warp w takes rows 64 (w % (bm / 64)) + [0, 64) and columns
// 32 (w / (bm / 64)) + [0, 32): four by four m16n8 accumulator tiles,
// lane l holding rows l / 4 and l / 4 + 8, columns 2 (l % 4) + [0, 2) of
// each, f = 4 (4 mi + ni) + v.
template <typename T>
__host__ __device__ __forceinline__ int mt_row(int tid, int f, int bm,
                                               int bn) {
  if (sizeof(T) == 4) {
    const int i = f / 8;
    return tid / (bn / 8) * 4 + i % 4 + i / 4 * (bm / 2);
  }
  const int wm = tid / 32 % (bm / 64), g = tid % 32 / 4;
  return 64 * wm + 16 * (f / 16) + 8 * (f % 4 / 2) + g;
}
template <typename T>
__host__ __device__ __forceinline__ int mt_col(int tid, int f, int bm,
                                               int bn) {
  if (sizeof(T) == 4) {
    const int jj = f % 8;
    return tid % (bn / 8) * 4 + jj % 4 + jj / 4 * (bn / 2);
  }
  const int wn = tid / 32 / (bm / 64), q = tid % 4;
  return 32 * wn + 8 * (f / 4 % 4) + 2 * q + f % 2;
}

// Tiled path, float: consumer thread tid's 8 x 8 outputs gain one
// k-block's sums, a fresh partial over its mt_bk columns (products in
// column order, fma), then added to the outputs: the register path's
// partials of 32 columns, so a sum over 50,000 columns rounds like 1,563
// partials, not one chain.  kt as mt_eval writes it, vs[k * (bn + 4) + c]
// the k-block's rows of V.
__device__ __forceinline__ void mt_product(const float* kt, const float* vs,
                                           int bm, int bn, int tid,
                                           float* acc) {
  const int ld = bm + 4, vld = bn + 4;
  const int ty = tid / (bn / 8), tx = tid % (bn / 8);
  float part[64];
#pragma unroll
  for (int f = 0; f < 64; ++f) part[f] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < mt_bk<float>(); ++k) {
    float a[8], b[8];
    load4(kt + k * ld + ty * 4, a);
    load4(kt + k * ld + bm / 2 + ty * 4, a + 4);
    load4(vs + k * vld + tx * 4, b);
    load4(vs + k * vld + bn / 2 + tx * 4, b + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[8 * i + j] = mv_fma(a[i], b[j],
                                                           part[8 * i + j]);
  }
#pragma unroll
  for (int f = 0; f < 64; ++f) acc[f] = acc[f] + part[f];
}

#ifdef __CUDACC__
// The float64 tensor-core step d = c + a b on one m16n8k<K> tile (K = 4
// or 8, shapes PTX ISA 7.8 added for sm_90), the accumulators in place.
template <int K>
__device__ __forceinline__ void mma_f64(double* c, const double* a,
                                        const double* b) {
  static_assert(K == 4 || K == 8, "m16n8k4 or m16n8k8");
  if constexpr (K == 8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
}

// Tiled path, double: the warp's 4 x 4 m16n8 tiles gain the K columns
// [k, k + K) of the k-block, one step's operands at a time (with the 64
// sums, the consumers' 208 registers hold no more).  ka and vb point at
// the lane's first row of A and column of B.
template <int K>
__device__ __forceinline__ void mt_mma_step(const double* ka,
                                            const double* vb, int ld,
                                            int vld, int k, int q,
                                            double* acc) {
  constexpr int KV = K / 4;
  double a[4][2 * KV], b[4][KV];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int u = 0; u < 2 * KV; ++u)
      a[mi][u] = ka[(k + q + 4 * (u / 2)) * ld + 16 * mi + 8 * (u % 2)];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int u = 0; u < KV; ++u) b[ni][u] = vb[(k + q + 4 * u) * vld + 8 * ni];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_f64<K>(acc + 4 * (4 * mi + ni), a[mi], b[ni]);
}
#endif

// Tiled path, double: thread tid's 64 accumulators gain one k-block's
// products on the tensor cores (mma.sync in float64): m16n8k8 over the
// k-block's columns in steps of 8, m16n8k4 over its last 4.  The operands
// come from shared memory as the fragment layouts of PTX ISA 7.8 place
// them: lane l = 4 g + q holds A's rows g and g + 8, columns q + 4 u, and
// B's rows q + 4 u, column g.  The accumulators run in one chain over the
// k-blocks.  Without the card, each output's products of a k-block are
// taken by fma in column order.
__device__ __forceinline__ void mt_product(const double* kt, const double* vs,
                                           int bm, int bn, int tid,
                                           double* acc) {
  const int ld = bm + 4, vld = bn + 4;
  constexpr int BK = mt_bk<double>();
  static_assert(BK % 8 == 0 || BK % 8 == 4, "steps of 8 columns, then 4");
#ifdef __CUDACC__
  const int w = tid / 32, g = tid % 32 / 4, q = tid % 4;
  const double* ka = kt + 64 * (w % (bm / 64)) + g;
  const double* vb = vs + 32 * (w / (bm / 64)) + g;
#pragma unroll 1
  for (int k = 0; k + 8 <= BK; k += 8) mt_mma_step<8>(ka, vb, ld, vld, k, q, acc);
  if constexpr (BK % 8 == 4) mt_mma_step<4>(ka, vb, ld, vld, BK - 4, q, acc);
#else
  for (int f = 0; f < MT_SUMS; ++f) {
    const int row = mt_row<double>(tid, f, bm, bn);
    const int col = mt_col<double>(tid, f, bm, bn);
    for (int k = 0; k < BK; ++k) {
      acc[f] = mv_fma(kt[k * ld + row], vs[k * vld + col], acc[f]);
    }
  }
#endif
}

// Tiled path, the epilogue: thread tid's outputs of the tile whose first
// row is li0 (of the n_rows rows of the slab; global row r0 + li) and
// first column c0 (of m) go to y once, with the nugget's term.
template <typename T>
__device__ __forceinline__ void mt_store(T* y, const T* v, T nugget,
                                         const T* acc, int tid, int bm,
                                         int bn, int li0, int c0, int r0,
                                         int n_rows, int m) {
#pragma unroll
  for (int f = 0; f < MT_SUMS; ++f) {
    const int li = li0 + mt_row<T>(tid, f, bm, bn);
    const int c = c0 + mt_col<T>(tid, f, bm, bn);
    if (li >= n_rows || c >= m) continue;
    y[(size_t)li * (size_t)m + c] =
        mv_add_nugget(acc[f], nugget, v[(size_t)(r0 + li) * (size_t)m + c]);
  }
}
#ifdef __CUDACC__

// A thread's share of a tile: VEC neighbouring columns (16 bytes) in each of
// PASSES rows, ROWS_PER_PASS rows apart.
template <typename T>
struct Share {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int THREADS_PER_ROW = TILE / VEC;
  static constexpr int ROWS_PER_PASS = THREADS / THREADS_PER_ROW;
  static constexpr int PASSES = TILE / ROWS_PER_PASS;
};

__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// v[0 .. VEC) to a[row, col .. col + VEC) of a rows x cols matrix, inside
// the matrix only; one 16-byte store when `vec` (cols a multiple of VEC
// and a aligned, so a column in range has its whole group in range).
template <typename T>
__device__ __forceinline__ void store_group(T* a, int row, int col,
                                            const T* v, int rows, int cols,
                                            bool vec) {
  if (row >= rows || col >= cols) return;
  T* at = a + (size_t)row * (size_t)cols + (size_t)col;
  if (vec) {
    store16(at, v);
    return;
  }
#pragma unroll
  for (int u = 0; u < Share<T>::VEC; ++u) {
    if (col + u < cols) at[u] = v[u];
  }
}

// The same group read (0 outside the matrix).
template <typename T>
__device__ __forceinline__ void load_group(const T* a, int row, int col, T* v,
                                           int n, bool vec) {
#pragma unroll
  for (int u = 0; u < Share<T>::VEC; ++u) v[u] = T(0);
  if (row >= n || col >= n) return;
  const T* at = a + (size_t)row * (size_t)n + (size_t)col;
  if (vec) {
    load16(at, v);
    return;
  }
#pragma unroll
  for (int u = 0; u < Share<T>::VEC; ++u) {
    if (col + u < n) v[u] = at[u];
  }
}

// The slices of t a tile pair reads (0 outside the matrix).
template <typename T>
__device__ __forceinline__ void load_times(const T* __restrict__ t, int n,
                                           int I, int J, T* ti, T* tj) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    const int i = I * TILE + tid;
    ti[tid] = i < n ? t[i] : T(0);
  } else if (tid < 2 * TILE) {
    const int j = J * TILE + tid - TILE;
    tj[tid - TILE] = j < n ? t[j] : T(0);
  }
}

// What every block of B1 and its entries sets up first: the parameters and
// their leaf_consts (once per block) in shared memory, a single leaf's and
// a pair's copied to registers.
template <typename T, int MODE>
__device__ __forceinline__ void block_params(const T* __restrict__ params,
                                             int n_params,
                                             const Program& prog, T* par,
                                             T* cst, T* p0, T* c0, T* p1,
                                             T* c1) {
  const int tid = threadIdx.x;
  for (int k = tid; k < n_params; k += blockDim.x) par[k] = params[k];
  __syncthreads();
  if constexpr (MODE >= OP_C) {
    if (tid == 0) leaf_consts<T>(MODE, par, cst);
  } else {
    if (tid < prog.n_ops && is_leaf_op(prog.op[tid])) {
      leaf_consts<T>(prog.op[tid], par + prog.off[tid], cst + tid * N_CONSTS);
    }
  }
  __syncthreads();
  if constexpr (MODE != MODE_ANY) {
    const int off1 = MODE == MODE_PAIR ? prog.off[1] : 0;
#pragma unroll
    for (int k = 0; k < LEAF_PARAMS; ++k) {
      p0[k] = par[k];
      p1[k] = par[off1 + k];
    }
#pragma unroll
    for (int k = 0; k < N_CONSTS; ++k) {
      c0[k] = cst[k];
      c1[k] = cst[N_CONSTS + k];
    }
  }
}

// B1.  Block b takes tile pair b (the grid is one block per pair): the
// values of tile (I, J) go to the matrix along their rows and, for I > J,
// through `tile` to the mirrored tile (J, I) along its rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
kernel_matrix_kernel(const T* __restrict__ t, const T* __restrict__ params,
                     const T* __restrict__ jitter, T* __restrict__ out,
                     int n, int n_params, bool vec, const Program prog) {
  typedef Share<T> S;
  __shared__ T par[MAX_PARAMS];
  __shared__ T cst[(MODE == MODE_ANY ? MAX_OPS : 2) * N_CONSTS];
  __shared__ T ti[TILE];
  __shared__ T tj[TILE];
  __shared__ T tile[TILE][TILE + 1];
  const int tid = threadIdx.x;
  T p0[LEAF_PARAMS], c0[N_CONSTS], p1[LEAF_PARAMS], c1[N_CONSTS];
  block_params<T, MODE>(params, n_params, prog, par, cst, p0, c0, p1, c1);
  const T jit = jitter[0];
  const int cx = (tid % S::THREADS_PER_ROW) * S::VEC;  // first column
  const int ry = tid / S::THREADS_PER_ROW;             // row in a pass
  int I, J;
  tile_pair(blockIdx.x, &I, &J);
  load_times<T>(t, n, I, J, ti, tj);
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < S::PASSES; ++pass) {
    const int li = ry + pass * S::ROWS_PER_PASS;
    const int i = I * TILE + li;
    T v[S::VEC];
#pragma unroll
    for (int u = 0; u < S::VEC; ++u) {
      v[u] = program_value<T, MODE>(prog, p0, c0, p1, c1, par, cst,
                                    ti[li] - tj[cx + u]);
      if (i == J * TILE + cx + u) v[u] = v[u] + jit;
    }
    store_group<T>(out, i, J * TILE + cx, v, n, n, vec);
    if (I != J) {
#pragma unroll
      for (int u = 0; u < S::VEC; ++u) tile[li][cx + u] = v[u];
    }
  }
  if (I != J) {  // the same for the whole block
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < S::PASSES; ++pass) {
      const int lj = ry + pass * S::ROWS_PER_PASS;
      T v[S::VEC];
#pragma unroll
      for (int u = 0; u < S::VEC; ++u) v[u] = tile[cx + u][lj];
      store_group<T>(out, J * TILE + lj, I * TILE + cx, v, n, n, vec);
    }
  }
}

// B1's slab entry: rows [r0, r0 + n_rows) of the n_pad x n_pad matrix
// K(t, t) + jitter I padded with identity past n, the row slab a rank of
// the panel-sharded engine holds (gpyrn_tpu/parallel/panel_fit.py::
// _slab_kernel there).  Block (x, y) writes tile (y, x) of the slab, every
// element once: a slab is not symmetric, so there is no mirror, and a lag
// t_i - t_j above the diagonal gives the bits of t_j - t_i (every leaf is
// even in r), so each element equals B1's at the same row and column.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
kernel_matrix_slab_kernel(const T* __restrict__ t,
                          const T* __restrict__ params,
                          const T* __restrict__ jitter, T* __restrict__ out,
                          int n, int n_pad, int r0, int n_rows, int n_params,
                          bool vec, const Program prog) {
  typedef Share<T> S;
  __shared__ T par[MAX_PARAMS];
  __shared__ T cst[(MODE == MODE_ANY ? MAX_OPS : 2) * N_CONSTS];
  __shared__ T ti[TILE];
  __shared__ T tj[TILE];
  const int tid = threadIdx.x;
  T p0[LEAF_PARAMS], c0[N_CONSTS], p1[LEAF_PARAMS], c1[N_CONSTS];
  block_params<T, MODE>(params, n_params, prog, par, cst, p0, c0, p1, c1);
  const T jit = jitter[0];
  const int cx = (tid % S::THREADS_PER_ROW) * S::VEC;
  const int ry = tid / S::THREADS_PER_ROW;
  const int I = blockIdx.y, J = blockIdx.x;
  if (tid < TILE) {
    const int i = r0 + I * TILE + tid;
    ti[tid] = i < n ? t[i] : T(0);
  } else if (tid < 2 * TILE) {
    const int j = J * TILE + tid - TILE;
    tj[tid - TILE] = j < n ? t[j] : T(0);
  }
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < S::PASSES; ++pass) {
    const int li = ry + pass * S::ROWS_PER_PASS;
    const int row = I * TILE + li;
    T v[S::VEC];
#pragma unroll
    for (int u = 0; u < S::VEC; ++u) {
      v[u] = slab_element<T>(
          r0 + row, J * TILE + cx + u, n,
          program_value<T, MODE>(prog, p0, c0, p1, c1, par, cst,
                                 ti[li] - tj[cx + u]),
          jit);
    }
    store_group<T>(out, row, J * TILE + cx, v, n_rows, n_pad, vec);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// B1', first pass: block b sums G[i, j] dk(t_i - t_j)/dp over the tile
// pairs b, b + gridDim.x, ... into partial[b, 0 .. n_params).  For I > J an
// element stands for its mirror too: its weight is G[i, j] + G[j, i], the
// second read along the rows of tile (J, I) into `tile`.
__host__ __device__ __forceinline__ constexpr int grad_min_blocks(int mode) {
  return (mode < OP_C || mode == OP_RQP || mode == OP_NP || mode == OP_QNP ||
          mode == OP_NRQP) ? GRAD_MIN_BLOCKS_HEAVY : GRAD_MIN_BLOCKS_LIGHT;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, grad_min_blocks(MODE))
kernel_matrix_grad_kernel(const T* __restrict__ t,
                          const T* __restrict__ params,
                          const T* __restrict__ G, T* __restrict__ partial,
                          int n, int n_params, bool vec, const Program prog) {
  typedef Share<T> S;
  __shared__ T par[MAX_PARAMS];
  __shared__ T ti[TILE];
  __shared__ T tj[TILE];
  __shared__ T tile[TILE][TILE + 1];
  __shared__ T red[WARPS * MAX_PARAMS];
  const int tid = threadIdx.x;
  for (int k = tid; k < n_params; k += THREADS) par[k] = params[k];
  __syncthreads();
  // a single leaf and a pair keep parameters and sums in registers
  T p0[LEAF_PARAMS], p1[LEAF_PARAMS], acc0[LEAF_PARAMS], acc1[LEAF_PARAMS];
  T acc[MODE == MODE_ANY ? MAX_PARAMS : 1];
  const int off1 = MODE == MODE_PAIR ? prog.off[1] : 0;
#pragma unroll
  for (int m = 0; m < LEAF_PARAMS; ++m) {
    p0[m] = par[m];
    p1[m] = par[off1 + m];
    acc0[m] = T(0);
    acc1[m] = T(0);
  }
  if constexpr (MODE == MODE_ANY) {
    for (int m = 0; m < n_params; ++m) acc[m] = T(0);
  }
  const int cx = (tid % S::THREADS_PER_ROW) * S::VEC;
  const int ry = tid / S::THREADS_PER_ROW;
  const int tiles = (n + TILE - 1) / TILE;
  const long long pairs = n_tile_pairs(tiles);

  for (long long pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    int I, J;
    tile_pair(pair, &I, &J);
    __syncthreads();  // the last pair's readers are done
    load_times<T>(t, n, I, J, ti, tj);
    if (I != J) {  // tile[j][i] = G[J * TILE + j, I * TILE + i]
#pragma unroll
      for (int pass = 0; pass < S::PASSES; ++pass) {
        const int lj = ry + pass * S::ROWS_PER_PASS;
        T w[S::VEC];
        load_group<T>(G, J * TILE + lj, I * TILE + cx, w, n, vec);
#pragma unroll
        for (int u = 0; u < S::VEC; ++u) tile[lj][cx + u] = w[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < S::PASSES; ++pass) {
      const int li = ry + pass * S::ROWS_PER_PASS;
      const int i = I * TILE + li;
      T g[S::VEC];
      load_group<T>(G, i, J * TILE + cx, g, n, vec);
#pragma unroll
      for (int u = 0; u < S::VEC; ++u) {
        const int lj = cx + u;
        if (i < n && J * TILE + lj < n) {
          const T weight = I != J ? g[u] + tile[lj][li] : g[u];
          program_grad<T, MODE>(prog, p0, p1, par, ti[li] - tj[lj], weight,
                                acc0, acc1, acc);
        }
      }
    }
  }

  // one reduction per block: shuffles inside each warp, then the warps'
  // sums in a fixed order
  const int lane = tid % 32, warp = tid / 32;
  if constexpr (MODE >= OP_C) {
#pragma unroll
    for (int m = 0; m < leaf_n_params(MODE); ++m) {
      const T s = warp_sum(acc0[m]);
      if (lane == 0) red[warp * MAX_PARAMS + m] = s;
    }
  } else if constexpr (MODE == MODE_PAIR) {
    const int np0 = leaf_n_params(prog.op[0]);
    const int np1 = leaf_n_params(prog.op[1]);
#pragma unroll
    for (int m = 0; m < LEAF_PARAMS; ++m) {
      const T s0 = warp_sum(acc0[m]);
      const T s1 = warp_sum(acc1[m]);
      if (lane == 0 && m < np0) red[warp * MAX_PARAMS + m] = s0;
      if (lane == 0 && m < np1) red[warp * MAX_PARAMS + off1 + m] = s1;
    }
  } else {
    for (int m = 0; m < n_params; ++m) {
      const T s = warp_sum(acc[m]);
      if (lane == 0) red[warp * MAX_PARAMS + m] = s;
    }
  }
  __syncthreads();
  for (int m = tid; m < n_params; m += THREADS) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * MAX_PARAMS + m];
    partial[(size_t)blockIdx.x * (size_t)n_params + m] = s;
  }
}

// B1', second pass: out[m] = the sum of column m of the partial rows, each
// thread over a fixed stride of rows, then a tree in shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel_matrix_grad_sum(const T* __restrict__ partial, T* __restrict__ out,
                       int n_blocks, int n_params) {
  __shared__ T red[THREADS];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  T s = T(0);
  for (int b = tid; b < n_blocks; b += THREADS) {
    s += partial[(size_t)b * (size_t)n_params + m];
  }
  red[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[m] = red[0];
}

// ---- B1's product entry ----------------------------------------------------

// Register path: starts the copy of columns [j0, min(j0 + MV_STAGE, j1))
// of t and V into ts / vs (cp.async, one commit); a column of V past m is 0.
template <typename T, int W>
__device__ __forceinline__ void mv_fill(const T* __restrict__ t,
                                        const T* __restrict__ v, int m,
                                        int j0, int j1, T* ts, T* vs) {
  for (int k = threadIdx.x; k < MV_STAGE; k += MV_THREADS) {
    const int j = j0 + k;
    if (j >= j1) continue;
    __pipeline_memcpy_async(ts + k, t + j, sizeof(T));
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < m) {
        __pipeline_memcpy_async(vs + k * W + c, v + (size_t)j * m + c,
                                sizeof(T));
      } else {
        vs[k * W + c] = T(0);
      }
    }
  }
  __pipeline_commit();
}

// Register path.  Block (x, g) takes rows [x * MV_THREADS, ...) of the
// slab, one a thread, against column group g.  With one group the block
// writes y; with more, its sums go to partial[g, row, c] and
// kernel_matvec_sum adds them.
template <typename T, int MODE, int W>
__global__ void __launch_bounds__(MV_THREADS)
kernel_matvec_kernel(const T* __restrict__ t, const T* __restrict__ params,
                     const T* __restrict__ v, const T* __restrict__ nugget,
                     T* __restrict__ out, int n, int m, int r0, int n_rows,
                     int n_params, int groups, const Program prog) {
  __shared__ T par[MAX_PARAMS];
  __shared__ T cst[(MODE == MODE_ANY ? MAX_OPS : 2) * N_CONSTS];
  __shared__ __align__(16) T ts[2][MV_STAGE];
  __shared__ __align__(16) T vs[2][MV_STAGE * W];
  T p0[LEAF_PARAMS], c0[N_CONSTS], p1[LEAF_PARAMS], c1[N_CONSTS];
  block_params<T, MODE>(params, n_params, prog, par, cst, p0, c0, p1, c1);
  const int li = blockIdx.x * MV_THREADS + threadIdx.x;
  const bool row = li < n_rows;
  const T ti = row ? t[r0 + li] : T(0);
  int j0, j1;
  mv_group_range(n, blockIdx.y, &j0, &j1);
  const int steps = (j1 - j0 + MV_STAGE - 1) / MV_STAGE;
  T acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = T(0);
  mv_fill<T, W>(t, v, m, j0, j1, ts[0], vs[0]);
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    if (s + 1 < steps) {  // the next step's copy runs under this one
      mv_fill<T, W>(t, v, m, j0 + (s + 1) * MV_STAGE, j1, ts[b ^ 1],
                    vs[b ^ 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int left = j1 - j0 - s * MV_STAGE;
    if (row) {
      mv_row_stage<T, MODE, W>(prog, p0, c0, p1, c1, par, cst, ti, ts[b],
                               vs[b], left < MV_STAGE ? left : MV_STAGE,
                               acc);
    }
    __syncthreads();  // before the copy two steps on overwrites this buffer
  }
  if (!row) return;
  const size_t i = (size_t)(r0 + li);
  if (groups == 1) {
    const T nug = nugget[0];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < m) {
        out[(size_t)li * m + c] = mv_add_nugget(acc[c], nug, v[i * m + c]);
      }
    }
  } else {
    T* part = out + ((size_t)blockIdx.y * n_rows + li) * (size_t)m;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < m) part[c] = acc[c];
    }
  }
}

// Register path, second pass: y[row, c] = the groups' partial sums in
// order, then the nugget's term.
template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel_matvec_sum(const T* __restrict__ partial, const T* __restrict__ v,
                  const T* __restrict__ nugget, T* __restrict__ y, int m,
                  int r0, int n_rows, int groups) {
  const size_t total = (size_t)n_rows * (size_t)m;
  const size_t at = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (at >= total) return;
  const size_t li = at / m, c = at % m;
  y[at] = mv_add_nugget(mv_sum_groups(partial + at, groups, total), nugget[0],
                        v[((size_t)r0 + li) * (size_t)m + c]);
}

// Tiled path: producer thread p starts its share of the copy of k-block
// [j0, j0 + mt_bk) (cp.async, one commit): t's slice into ts, and V's
// rows, columns [c0, c0 + bn), into vs[k * (bn + 4) + c], 16 bytes a copy
// when `vec` (m a multiple of 16 bytes' values, v 16-byte aligned, so a
// column in range has its whole group in range), else one value; 0 past
// N and past m.
template <typename T, int NP>
__device__ __forceinline__ void mt_fill(const T* __restrict__ t,
                                        const T* __restrict__ v, int n,
                                        int m, int j0, int c0, int bn,
                                        bool vec, int p, T* ts, T* vs) {
  const int vld = bn + 4;
  constexpr int BK = mt_bk<T>();
  for (int k = p; k < BK; k += NP) {
    if (j0 + k < n) {
      __pipeline_memcpy_async(ts + k, t + j0 + k, sizeof(T));
    } else {
      ts[k] = T(0);
    }
  }
  if (vec) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int per_row = bn / VEC;
    for (int x = p; x < BK * per_row; x += NP) {
      const int k = x / per_row, c = x % per_row * VEC;
      const int j = j0 + k, col = c0 + c;
      T* to = vs + k * vld + c;
      if (j < n && col < m) {
        __pipeline_memcpy_async(to, v + (size_t)j * m + col, 16);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) to[u] = T(0);
      }
    }
  } else {
    for (int x = p; x < BK * bn; x += NP) {
      const int k = x / bn, c = x % bn;
      const int j = j0 + k, col = c0 + c;
      T* to = vs + k * vld + c;
      if (j < n && col < m) {
        __pipeline_memcpy_async(to, v + (size_t)j * m + col, sizeof(T));
      } else {
        *to = T(0);
      }
    }
  }
  __pipeline_commit();
}

// Tiled path: one stage of the ring in shared memory, the K tile
// [bk][bm + 4], V's k-block [bk][bn + 4] and t's slice [bk].
template <typename T>
__host__ __device__ __forceinline__ int mt_stage_values(int bm, int bn) {
  return mt_bk<T>() * (bm + 4 + bn + 4 + 1);
}

// Named barriers of the tiled path (0 is __syncthreads'): stage s's full
// barrier (the producers arrive, the consumers wait) and empty barrier
// (the other way round), and the producers' own.
#define MT_FULL(s) (1 + (s))
#define MT_EMPTY(s) (4 + (s))
#define MT_PRODUCED 7

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Tiled path (m > MV_CAP), output-stationary and warp-specialized.  Block
// (x, c) owns the bm x bn tile of y at rows [x * bm, ...) of the slab and
// columns [c * bn, ...) and walks all N columns of K in k-blocks of bk,
// in order, through a ring of S::stages stages.  Its S::producers
// threads (S::producer_regs registers each after setmaxnreg) copy each
// k-block's slice of t and tile of V in (cp.async, one k-block ahead) and
// evaluate its K tile on the FP pipe: the element's long, branchy
// dependent chains want many warps in flight.  Its S::consumers threads
// (S::consumer_regs registers) hold the sums and multiply each K tile in
// (the tensor cores in double, the FP32 pipe in float) while the
// producers evaluate the next.  y is written once, by the consumers.
template <typename T, int MODE, int WIDE>
__global__ void __launch_bounds__(MtShape<T, WIDE>::threads, 1)
kernel_matvec_tiled_kernel(const T* __restrict__ t,
                           const T* __restrict__ params,
                           const T* __restrict__ v,
                           const T* __restrict__ nugget, T* __restrict__ y,
                           int n, int m, int r0, int n_rows, int n_params,
                           bool vec, const Program prog) {
  typedef MtShape<T, WIDE> S;
  __shared__ T par[MAX_PARAMS];
  __shared__ T cst[(MODE == MODE_ANY ? MAX_OPS : 2) * N_CONSTS];
  extern __shared__ __align__(16) unsigned char mt_smem[];
  constexpr int BK = S::bk;
  const int bn = mt_bn<T>(m), bm = S::consumers * MT_SUMS / bn;
  T* ring = reinterpret_cast<T*>(mt_smem);
  const int stage = mt_stage_values<T>(bm, bn);
  T p0[LEAF_PARAMS], c0[N_CONSTS], p1[LEAF_PARAMS], c1[N_CONSTS];
  block_params<T, MODE>(params, n_params, prog, par, cst, p0, c0, p1, c1);
  const int tid = threadIdx.x;
  const int li0 = blockIdx.x * bm, col0 = blockIdx.y * bn;
  const int kblocks = (n + BK - 1) / BK;
  // a stage's K tile, V's k-block, t's slice
#define KT(s) (ring + (s) * stage)
#define VS(s) (KT(s) + BK * (bm + 4))
#define TS(s) (VS(s) + BK * (bn + 4))
  if (tid >= S::consumers) {  // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        S::producer_regs));
    const int p = tid - S::consumers;
    const int er = li0 + p % bm;  // the slab row this thread evaluates
    const T ti = er < n_rows ? t[r0 + er] : T(0);
    mt_fill<T, S::producers>(t, v, n, m, 0, col0, bn, vec, p, TS(0), VS(0));
    for (int kb = 0; kb < kblocks; ++kb) {
      const int s = kb % S::stages;
      if (kb + 1 < kblocks) {  // the next k-block's copy runs under this one
        const int s1 = (kb + 1) % S::stages;
        // the consumers are done with that stage's last k-block
        if (kb + 1 >= S::stages) bar_sync(MT_EMPTY(s1), S::threads);
        mt_fill<T, S::producers>(t, v, n, m, (kb + 1) * BK, col0, bn, vec, p,
                                 TS(s1), VS(s1));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      bar_sync(MT_PRODUCED, S::producers);  // every copy of k-block kb in
      mt_eval<T, MODE>(prog, p0, c0, p1, c1, par, cst, ti, TS(s), n,
                       kb * BK, bm, S::producers, p, KT(s));
      bar_arrive(MT_FULL(s), S::threads);
    }
    return;
  }
  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::consumer_regs));
  T acc[MT_SUMS];
#pragma unroll
  for (int f = 0; f < MT_SUMS; ++f) acc[f] = T(0);
  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % S::stages;
    bar_sync(MT_FULL(s), S::threads);
    mt_product(KT(s), VS(s), bm, bn, tid, acc);
    // the producers wait for this stage only while they have k-blocks left
    if (kb + S::stages < kblocks) bar_arrive(MT_EMPTY(s), S::threads);
  }
#undef KT
#undef VS
#undef TS
  mt_store<T>(y, v, nugget[0], acc, tid, bm, bn, li0, col0, r0, n_rows, m);
}

// Launches the tiled path's instance of shape WIDE.
template <typename T, int MODE, int WIDE>
static int run_tiled(cudaStream_t s, const T* t, const T* params,
                     const T* v, const T* nugget, T* y, int n, int m, int r0,
                     int n_rows, int n_params, bool vec,
                     const Program& prog) {
  typedef MtShape<T, WIDE> S;
  const int bn = mt_bn<T>(m), bm = S::consumers * MT_SUMS / bn;
  const size_t smem =
      (size_t)S::stages * mt_stage_values<T>(bm, bn) * sizeof(T);
  const dim3 grid((unsigned)((n_rows + bm - 1) / bm),
                  (unsigned)((m + bn - 1) / bn));
  cudaError_t err = cudaFuncSetAttribute(
      kernel_matvec_tiled_kernel<T, MODE, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel_matvec_tiled_kernel<T, MODE, WIDE><<<grid, S::threads, smem, s>>>(
      t, params, v, nugget, y, n, m, r0, n_rows, n_params, vec, prog);
  return (int)cudaGetLastError();
}

// Checks the arguments every launch shares and fills the program; returns
// a CUDA error code (0 when all is well).
static int make_program(int n, int n_params, const int* ops, const int* offs,
                        const int* lhs, const int* rhs, int n_ops,
                        Program* prog) {
  if (n < 1 || (n + TILE - 1) / TILE > 65535 || n_params < 1 ||
      n_params > MAX_PARAMS || n_ops < 1 || n_ops > MAX_OPS) {
    return (int)cudaErrorInvalidValue;
  }
  prog->n_ops = n_ops;
  for (int k = 0; k < MAX_OPS; ++k) {
    const bool used = k < n_ops;
    prog->op[k] = used ? ops[k] : 0;
    prog->off[k] = used ? offs[k] : 0;
    prog->lhs[k] = used ? lhs[k] : -1;
    prog->rhs[k] = used ? rhs[k] : -1;
    if (!used) continue;
    if (ops[k] < 0 || ops[k] >= N_OPCODES || offs[k] < 0 ||
        offs[k] + leaf_n_params(ops[k]) > n_params) {
      return (int)cudaErrorInvalidValue;
    }
    if (!is_leaf_op(ops[k]) &&
        (lhs[k] < 0 || lhs[k] >= k || rhs[k] < 0 || rhs[k] >= k)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

template <typename T>
static bool aligned16(const T* a, int n) {
  return n % Share<T>::VEC == 0 && ((uintptr_t)a) % 16 == 0;
}

template <typename T>
static int launch(int device, const T* t, const T* params, const T* jitter,
                  T* out, int n, int n_params, const int* ops,
                  const int* offs, const int* lhs, const int* rhs, int n_ops,
                  void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, lhs, rhs, n_ops, &prog);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(out, n);
  // one block per tile pair: at most 65535 * 65536 / 2 < 2^31
  const unsigned grid = (unsigned)n_tile_pairs((n + TILE - 1) / TILE);
  cudaStream_t s = (cudaStream_t)stream;
#define RUN(MODE)                                                  \
  kernel_matrix_kernel<T, MODE><<<grid, THREADS, 0, s>>>(          \
      t, params, jitter, out, n, n_params, vec, prog)
#define CASE(OP) case OP: RUN(OP); break;
  switch (program_mode(prog)) {
    FOR_EACH_LEAF(CASE)
    case MODE_PAIR: RUN(MODE_PAIR); break;
    default: RUN(MODE_ANY); break;
  }
#undef CASE
#undef RUN
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_slab(int device, const T* t, const T* params,
                       const T* jitter, T* out, int n, int n_pad, int r0,
                       int n_rows, int n_params, const int* ops,
                       const int* offs, const int* lhs, const int* rhs,
                       int n_ops, void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, lhs, rhs, n_ops, &prog);
  if (bad) return bad;
  if (n_pad < n || r0 < 0 || n_rows < 1 || n_pad - n_rows < r0 ||
      (n_rows + TILE - 1) / TILE > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(out, n_pad);
  const dim3 grid((unsigned)((n_pad + TILE - 1) / TILE),
                  (unsigned)((n_rows + TILE - 1) / TILE));
  cudaStream_t s = (cudaStream_t)stream;
#define RUN(MODE)                                                     \
  kernel_matrix_slab_kernel<T, MODE><<<grid, THREADS, 0, s>>>(        \
      t, params, jitter, out, n, n_pad, r0, n_rows, n_params, vec, prog)
#define CASE(OP) case OP: RUN(OP); break;
  switch (program_mode(prog)) {
    FOR_EACH_LEAF(CASE)
    case MODE_PAIR: RUN(MODE_PAIR); break;
    default: RUN(MODE_ANY); break;
  }
#undef CASE
#undef RUN
  return (int)cudaGetLastError();
}

// n_blocks is the grid, at least one block and at most one per tile pair;
// partial holds n_blocks rows of n_params.
template <typename T>
static int launch_grad(int device, const T* t, const T* params, const T* G,
                       T* partial, T* out, int n, int n_params, int n_blocks,
                       const int* ops, const int* offs, const int* lhs,
                       const int* rhs, int n_ops, void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, lhs, rhs, n_ops, &prog);
  if (bad) return bad;
  if (n_blocks < 1 ||
      (long long)n_blocks > n_tile_pairs((n + TILE - 1) / TILE)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(G, n);
  cudaStream_t s = (cudaStream_t)stream;
#define RUN(MODE)                                                  \
  kernel_matrix_grad_kernel<T, MODE><<<n_blocks, THREADS, 0, s>>>( \
      t, params, G, partial, n, n_params, vec, prog)
#define CASE(OP) case OP: RUN(OP); break;
  switch (program_mode(prog)) {
    FOR_EACH_LEAF(CASE)
    case MODE_PAIR: RUN(MODE_PAIR); break;
    default: RUN(MODE_ANY); break;
  }
#undef CASE
#undef RUN
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel_matrix_grad_sum<T><<<n_params, THREADS, 0, s>>>(partial, out,
                                                         n_blocks, n_params);
  return (int)cudaGetLastError();
}

// The register path's instance for m columns: W = 1, or MV_CAP.
template <typename T, int MODE>
static void run_register(dim3 grid, cudaStream_t s, const T* t,
                         const T* params, const T* v, const T* nugget,
                         T* out, int n, int m, int r0, int n_rows,
                         int n_params, int groups, const Program& prog) {
#define RUN(W)                                                              \
  kernel_matvec_kernel<T, MODE, W><<<grid, MV_THREADS, 0, s>>>(             \
      t, params, v, nugget, out, n, m, r0, n_rows, n_params, groups, prog)
  if (m == 1) {
    RUN(1);
  } else {
    RUN(MV_CAP);
  }
#undef RUN
}

// partial holds mv_groups(n) x n_rows x m values when the register path
// runs and there is more than one group; it may be null otherwise.
template <typename T>
static int launch_matvec(int device, const T* t, const T* params,
                         const T* v, const T* nugget, T* y, T* partial,
                         int n, int m, int r0, int n_rows, int n_params,
                         const int* ops, const int* offs, const int* lhs,
                         const int* rhs, int n_ops, void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, lhs, rhs, n_ops, &prog);
  if (bad) return bad;
  if (m < 1 || r0 < 0 || n_rows < 1 || r0 > n - n_rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= MV_CAP) {
    const int groups = mv_groups(n);
    if (groups > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n_rows + MV_THREADS - 1) / MV_THREADS),
                    (unsigned)groups);
    T* out = groups == 1 ? y : partial;
#define RUN(MODE)                                                     \
  run_register<T, MODE>(grid, s, t, params, v, nugget, out, n, m, r0, \
                        n_rows, n_params, groups, prog)
#define CASE(OP) case OP: RUN(OP); break;
    switch (program_mode(prog)) {
      FOR_EACH_LEAF(CASE)
      case MODE_PAIR: RUN(MODE_PAIR); break;
      default: RUN(MODE_ANY); break;
    }
#undef CASE
#undef RUN
    err = cudaGetLastError();
    if (err != cudaSuccess || groups == 1) return (int)err;
    const size_t total = (size_t)n_rows * (size_t)m;
    kernel_matvec_sum<T><<<(unsigned)((total + THREADS - 1) / THREADS),
                           THREADS, 0, s>>>(partial, v, nugget, y, m, r0,
                                            n_rows, groups);
    return (int)cudaGetLastError();
  }
  if ((m + mt_bn<T>(m) - 1) / mt_bn<T>(m) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = m % (16 / (int)sizeof(T)) == 0 &&
                   ((uintptr_t)v) % 16 == 0;
  // the wide shape is float's
#define RUN(MODE)                                                           \
  if constexpr (sizeof(T) == 4) {                                           \
    if (mt_wide<T>(m)) {                                                    \
      return run_tiled<T, MODE, 1>(s, t, params, v, nugget, y, n, m, r0,    \
                                   n_rows, n_params, vec, prog);            \
    }                                                                       \
  }                                                                         \
  return run_tiled<T, MODE, 0>(s, t, params, v, nugget, y, n, m, r0,        \
                               n_rows, n_params, vec, prog)
#define CASE(OP) case OP: RUN(OP);
  switch (program_mode(prog)) {
    FOR_EACH_LEAF(CASE)
    case MODE_PAIR: RUN(MODE_PAIR);
    default: RUN(MODE_ANY);
  }
#undef CASE
#undef RUN
}

extern "C" int gpyrn_kernel_matvec_f64(
    int device, const double* t, const double* params, const double* v,
    const double* nugget, double* y, double* partial, int n, int m, int r0,
    int n_rows, int n_params, const int* ops, const int* offs,
    const int* lhs, const int* rhs, int n_ops, void* stream) {
  return launch_matvec<double>(device, t, params, v, nugget, y, partial, n, m,
                          r0, n_rows, n_params, ops, offs, lhs, rhs, n_ops,
                          stream);
}

extern "C" int gpyrn_kernel_matvec_f32(
    int device, const float* t, const float* params, const float* v,
    const float* nugget, float* y, float* partial, int n, int m, int r0,
    int n_rows, int n_params, const int* ops, const int* offs,
    const int* lhs, const int* rhs, int n_ops, void* stream) {
  return launch_matvec<float>(device, t, params, v, nugget, y, partial, n, m,
                          r0, n_rows, n_params, ops, offs, lhs, rhs, n_ops,
                          stream);
}


extern "C" int gpyrn_kernel_matrix_f64(int device, const double* t,
                                       const double* params,
                                       const double* jitter, double* out,
                                       int n, int n_params,
                                       const int* ops, const int* offs,
                                       const int* lhs, const int* rhs,
                                       int n_ops, void* stream) {
  return launch<double>(device, t, params, jitter, out, n, n_params,
                        ops, offs, lhs, rhs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_f32(int device, const float* t,
                                       const float* params,
                                       const float* jitter, float* out,
                                       int n, int n_params,
                                       const int* ops, const int* offs,
                                       const int* lhs, const int* rhs,
                                       int n_ops, void* stream) {
  return launch<float>(device, t, params, jitter, out, n, n_params,
                       ops, offs, lhs, rhs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_slab_f64(
    int device, const double* t, const double* params, const double* jitter,
    double* out, int n, int n_pad, int r0, int n_rows, int n_params,
    const int* ops, const int* offs, const int* lhs, const int* rhs,
    int n_ops, void* stream) {
  return launch_slab<double>(device, t, params, jitter, out, n, n_pad, r0,
                             n_rows, n_params, ops, offs, lhs, rhs, n_ops,
                             stream);
}

extern "C" int gpyrn_kernel_matrix_slab_f32(
    int device, const float* t, const float* params, const float* jitter,
    float* out, int n, int n_pad, int r0, int n_rows, int n_params,
    const int* ops, const int* offs, const int* lhs, const int* rhs,
    int n_ops, void* stream) {
  return launch_slab<float>(device, t, params, jitter, out, n, n_pad, r0,
                            n_rows, n_params, ops, offs, lhs, rhs, n_ops,
                            stream);
}

extern "C" int gpyrn_kernel_matrix_grad_f64(
    int device, const double* t, const double* params, const double* G,
    double* partial, double* out, int n, int n_params, int n_blocks,
    const int* ops, const int* offs, const int* lhs, const int* rhs,
    int n_ops, void* stream) {
  return launch_grad<double>(device, t, params, G, partial, out, n, n_params,
                             n_blocks, ops, offs, lhs, rhs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_grad_f32(
    int device, const float* t, const float* params, const float* G,
    float* partial, float* out, int n, int n_params, int n_blocks,
    const int* ops, const int* offs, const int* lhs, const int* rhs,
    int n_ops, void* stream) {
  return launch_grad<float>(device, t, params, G, partial, out, n, n_params,
                            n_blocks, ops, offs, lhs, rhs, n_ops, stream);
}

#endif  // __CUDACC__

