// Dense kernel matrices of the GPRN engine, for Hopper (sm_90a), and their
// gradient:
//
//     out[i, j] = k(t_i - t_j; params) + (i == j) * jitter          (B1)
//     g[m]      = sum_ij G[i, j] * dk(t_i - t_j; params) / dparams[m] (B1')
//
// for one stationary kernel structure, in float or double.
//
// B1 replaces gpyrn_tpu/ops/pallas_kernels.py::_build, the tiled Pallas
// kernel of the JAX package.  Bound by stores: the output is N^2 x 8 bytes
// in float64 (8 MB at N = 1000, 134 MB at N = 4096), and each element costs
// a few dozen FP64 operations for its transcendentals (exp, sin, pow).  The
// design keeps out of device memory the N x N lag matrix and the chain of
// N^2 temporaries that the plain PyTorch version (one tensor per operation
// of the formula) writes and reads back: each element is formed in
// registers from two loads of the time vector and stored once.
//
// B1' is B1's backward, the dK/dtheta contraction, which the JAX package
// takes by autodiff through the Pallas kernel.  Bound by its one read of G
// (the same N^2 bytes) and the FP64 transcendentals.  Each thread walks the
// program forward for one element, keeping every entry's value, then walks
// the adjoint G[i, j] back through it into per-thread sums of the
// parameters' derivatives (hand-derived below, leaf_grad); a block sums its
// threads in shared memory into one partial row, and a second kernel sums
// the rows in a fixed order.  No atomics: the result is the same from run
// to run.  Neither the N x N lag matrix nor any N^2 derivative tensor is
// formed.
//
// The kernel structure arrives as a postfix program (one op code and one
// parameter offset per entry; leaves push k(r), ADD / MUL combine the top
// two, whose entries are also named by index for the backward walk), built
// by gpyrn_tpu_torch/ops/cuda_kernels.py::encode_program.  The program is
// the same for every thread, so evaluating it never diverges.  Every
// formula of B1 repeats the operation order of
// gpyrn_tpu_torch/ops/kernels.py, and the library is compiled without FMA
// contraction (-fmad=false), so each operation rounds as the plain version's
// does and the two agree to the last bits of the math library's exp / sin.
//
// Tiles (both kernels): a block of 32 x 8 threads covers 32 columns x 32
// rows; each warp reads or stores 32 neighbouring elements of a row, and
// each thread walks 4 rows.  The ragged edge is masked, not padded.
//
// Without __CUDACC__ only the element math below is compiled (plain C++):
// the CPU tests build it with the host compiler and hold both kernels'
// arithmetic against autograd of the plain version.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <cmath>
#define __device__
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

// Limits.  Must equal MAX_OPS / MAX_STACK / MAX_PARAMS in cuda_kernels.py.
#define MAX_OPS 32
#define MAX_STACK 8
#define MAX_PARAMS 64

#define TILE_X 32   // columns per block (one warp: coalesced stores along j)
#define TILE_Y 32   // rows per block
#define BLOCK_Y 8   // thread rows per block; each thread covers TILE_Y / BLOCK_Y rows

// Constants as the plain version spells them (Python's math.pi,
// math.sqrt(3.0), math.sqrt(5.0), 2 * math.pi, 3 * math.sqrt(5.0)),
// rounded to the working type where they are used.
#define K_PI 3.14159265358979323846
#define K_SQRT3 1.73205080756887729353
#define K_SQRT5 2.23606797749978969641

struct Program {
  int n_ops;
  int op[MAX_OPS];
  int off[MAX_OPS];
  int lhs[MAX_OPS];  // the two entries an ADD / MUL combines (-1 at a leaf)
  int rhs[MAX_OPS];
};

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

// One leaf kernel at lag r; p points at its parameters.  Each case follows
// the matching function of gpyrn_tpu_torch/ops/kernels.py term by term.
template <typename T>
__device__ __forceinline__ T leaf(int op, const T* p, T r) {
  const T pi = T(K_PI);
  const T ar = m_abs(r);
  switch (op) {
    case OP_C:  // c^2
      return p[0] * p[0];
    case OP_SE: {  // theta^2 exp(-r^2 / 2 ell^2)
      return (p[0] * p[0]) * m_exp((T(-0.5) * (r * r)) / (p[1] * p[1]));
    }
    case OP_P: {  // theta^2 exp(-2 sin^2(pi |r| / P) / ell^2)
      const T s = m_sin((pi * ar) / p[1]);
      return (p[0] * p[0]) * m_exp((T(-2) * (s * s)) / (p[2] * p[2]));
    }
    case OP_QP: {  // theta, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[2]);
      const T term1 = (T(-2) * (s * s)) / (p[3] * p[3]);
      const T term2 = (r * r) / (T(2) * (p[1] * p[1]));
      return (p[0] * p[0]) * m_exp(term1 - term2);
    }
    case OP_RQ: {  // theta, alpha, ell
      const T b = T(1) + (T(0.5) * (r * r)) / (p[1] * (p[2] * p[2]));
      return (p[0] * p[0]) * m_pow(b, -p[1]);
    }
    case OP_RQP: {  // theta, alpha, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[3]);
      const T e = m_exp((T(-2) * (s * s)) / (p[4] * p[4]));
      const T b = T(1) + (r * r) / ((T(2) * p[1]) * (p[2] * p[2]));
      return ((p[0] * p[0]) * e) * m_pow(b, -p[1]);
    }
    case OP_COS:  // theta^2 cos(2 pi |r| / P)
      return (p[0] * p[0]) * m_cos((T(2.0 * K_PI) * ar) / p[1]);
    case OP_EXP:  // theta^2 exp(-|r| / ell)
      return (p[0] * p[0]) * m_exp((-ar) / p[1]);
    case OP_M32: {  // theta, ell
      const T s = (T(K_SQRT3) * ar) / p[1];
      return ((p[0] * p[0]) * (T(1) + s)) * m_exp(-s);
    }
    case OP_M52: {  // theta, ell
      const T num = ((T(3.0 * K_SQRT5) * p[1]) * ar) + T(5) * (ar * ar);
      const T poly = T(1) + num / (T(3) * (p[1] * p[1]));
      return ((p[0] * p[0]) * poly) * m_exp((T(-K_SQRT5) * ar) / p[1]);
    }
    case OP_GammaExp:  // theta, gamma, l
      return (p[0] * p[0]) * m_exp(-m_pow(ar / p[2], p[1]));
    case OP_PW: {  // eta
      const T a = m_abs(r / (T(0.5) * p[0]));
      const T u = T(1) - a;
      const T pw = (T(3) * a + T(1)) * ((u * u) * u);
      return a > T(1) ? T(0) : pw;
    }
    case OP_PAC: {  // amplitude, ell_1, ell_2
      const T den = p[1] * p[1] + p[2] * p[2];
      const T a = m_sqrt(((T(2) * p[1]) * p[2]) / den);
      const T b = m_exp(((T(-2) * r) * r) / den);
      return ((p[0] * p[0]) * a) * b;
    }
    case OP_NP: {  // amplitude, alpha2, P, ell
      const T s = m_sin((pi * ar) / p[2]);
      const T a = m_pow(T(1) + (T(2) * (s * s)) / (p[1] * (p[3] * p[3])),
                        -p[1]);
      return (p[0] * p[0]) * a;
    }
    case OP_QNP: {  // amplitude, alpha2, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[3]);
      const T a = m_pow(T(1) + (T(2) * (s * s)) / (p[1] * (p[4] * p[4])),
                        -p[1]);
      const T b = m_exp((T(-0.5) * (r * r)) / (p[2] * p[2]));
      return ((p[0] * p[0]) * a) * b;
    }
    case OP_NRQP: {  // amplitude, alpha1, alpha2, ell_e, P, ell_p
      const T s = m_sin((pi * ar) / p[4]);
      const T a = m_pow(T(1) + (T(2) * (s * s)) / (p[2] * (p[5] * p[5])),
                        -p[2]);
      const T b = m_pow(T(1) + (T(0.5) * (r * r)) / (p[1] * (p[3] * p[3])),
                        -p[1]);
      return ((p[0] * p[0]) * a) * b;
    }
    case OP_CP: {  // amplitude, P, ell
      const T c = m_cos((pi * ar) / p[1]);
      return (p[0] * p[0]) * m_exp((T(-2) * (c * c)) / (p[2] * p[2]));
    }
    case OP_QCP: {  // amplitude, ell_e, P, ell_p
      const T c = m_cos((pi * ar) / p[2]);
      const T term1 = (T(-2) * (c * c)) / (p[3] * p[3]);
      const T term2 = (r * r) / (T(2) * (p[1] * p[1]));
      return (p[0] * p[0]) * m_exp(term1 - term2);
    }
  }
  return T(0);
}

template <typename T>
__device__ __forceinline__ T eval_program(const Program& prog, const T* p,
                                          T r) {
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
      stack[top++] = leaf<T>(op, p + prog.off[k], r);
    }
  }
  return stack[0];
}

// d k(r) / d p[m] of one leaf, times the adjoint, added into acc[m] for the
// leaf's own parameters.  Derived by hand from the formulas above.  Where a
// derivative carries |r| (or a power of x = |r| / l) as a factor it is 0 on
// the diagonal r = 0, as autograd of the plain version gives it; GammaExp's
// d/dgamma of x^gamma = x^gamma log x is taken as 0 at x = 0 (no 0 * -inf),
// and its d/dl is written as gamma x^gamma / l, finite at x = 0.  PW passes
// nothing outside its support |r| > eta / 2.  (1 + w)^-alpha takes its
// d/dalpha as (w / (1 + w) - log1p(w)) (1 + w)^-alpha.
template <typename T>
__device__ __forceinline__ void leaf_grad(int op, const T* p, T r, T adj,
                                          T* acc) {
  const T pi = T(K_PI);
  const T ar = m_abs(r);
  const T r2 = r * r;
  switch (op) {
    case OP_C:
      acc[0] += adj * (T(2) * p[0]);
      return;
    case OP_SE: {  // theta, ell
      const T e = m_exp((T(-0.5) * r2) / (p[1] * p[1]));
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] += adj * (((p[0] * p[0]) * e) * (r2 / ((p[1] * p[1]) * p[1])));
      return;
    }
    case OP_P: {  // theta, P, ell
      const T x = (pi * ar) / p[1];
      const T s = m_sin(x), c = m_cos(x);
      const T l2 = p[2] * p[2];
      const T e = m_exp((T(-2) * (s * s)) / l2);
      const T k = (p[0] * p[0]) * e;
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] += adj * (k * (((T(4) * s) * c) * x) / (l2 * p[1]));
      acc[2] += adj * (k * (T(4) * (s * s)) / (l2 * p[2]));
      return;
    }
    case OP_QP: {  // theta, ell_e, P, ell_p
      const T x = (pi * ar) / p[2];
      const T s = m_sin(x), c = m_cos(x);
      const T lp2 = p[3] * p[3];
      const T e = m_exp((T(-2) * (s * s)) / lp2 - r2 / (T(2) * (p[1] * p[1])));
      const T k = (p[0] * p[0]) * e;
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] += adj * (k * (r2 / ((p[1] * p[1]) * p[1])));
      acc[2] += adj * (k * (((T(4) * s) * c) * x) / (lp2 * p[2]));
      acc[3] += adj * (k * (T(4) * (s * s)) / (lp2 * p[3]));
      return;
    }
    case OP_RQ: {  // theta, alpha, ell
      const T w = (T(0.5) * r2) / (p[1] * (p[2] * p[2]));
      const T b = T(1) + w;
      const T a = m_pow(b, -p[1]);
      const T k = (p[0] * p[0]) * a;
      acc[0] += adj * ((T(2) * p[0]) * a);
      acc[1] += adj * (k * (w / b - m_log1p(w)));
      acc[2] += adj * (k * ((T(2) * p[1]) * w) / (b * p[2]));
      return;
    }
    case OP_RQP: {  // theta, alpha, ell_e, P, ell_p
      const T x = (pi * ar) / p[3];
      const T s = m_sin(x), c = m_cos(x);
      const T lp2 = p[4] * p[4];
      const T e = m_exp((T(-2) * (s * s)) / lp2);
      const T w = r2 / ((T(2) * p[1]) * (p[2] * p[2]));
      const T b = T(1) + w;
      const T a = m_pow(b, -p[1]);
      const T k = ((p[0] * p[0]) * e) * a;
      acc[0] += adj * (((T(2) * p[0]) * e) * a);
      acc[1] += adj * (k * (w / b - m_log1p(w)));
      acc[2] += adj * (k * ((T(2) * p[1]) * w) / (b * p[2]));
      acc[3] += adj * (k * (((T(4) * s) * c) * x) / (lp2 * p[3]));
      acc[4] += adj * (k * (T(4) * (s * s)) / (lp2 * p[4]));
      return;
    }
    case OP_COS: {  // theta, P
      const T x = (T(2.0 * K_PI) * ar) / p[1];
      acc[0] += adj * ((T(2) * p[0]) * m_cos(x));
      acc[1] += adj * (((p[0] * p[0]) * m_sin(x)) * x / p[1]);
      return;
    }
    case OP_EXP: {  // theta, ell
      const T e = m_exp((-ar) / p[1]);
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] += adj * (((p[0] * p[0]) * e) * ar / (p[1] * p[1]));
      return;
    }
    case OP_M32: {  // theta, ell
      const T s = (T(K_SQRT3) * ar) / p[1];
      const T e = m_exp(-s);
      acc[0] += adj * (((T(2) * p[0]) * (T(1) + s)) * e);
      acc[1] += adj * (((p[0] * p[0]) * e) * (s * s) / p[1]);
      return;
    }
    case OP_M52: {  // theta, ell
      const T s = (T(K_SQRT5) * ar) / p[1];
      const T e = m_exp(-s);
      const T poly = T(1) + s + (s * s) / T(3);
      acc[0] += adj * (((T(2) * p[0]) * poly) * e);
      acc[1] += adj * (((p[0] * p[0]) * e) * ((s * s) * (T(1) + s)) /
                       (T(3) * p[1]));
      return;
    }
    case OP_GammaExp: {  // theta, gamma, l
      const T x = ar / p[2];
      const T z = m_pow(x, p[1]);
      const T e = m_exp(-z);
      const T k = (p[0] * p[0]) * e;
      acc[0] += adj * ((T(2) * p[0]) * e);
      if (x > T(0)) acc[1] -= adj * ((k * z) * m_log(x));
      acc[2] += adj * ((k * p[1]) * z / p[2]);
      return;
    }
    case OP_PW: {  // eta
      const T a = m_abs(r / (T(0.5) * p[0]));
      if (a > T(1)) return;
      const T u = T(1) - a;
      acc[0] += adj * ((T(12) * (a * a)) * (u * u) / p[0]);
      return;
    }
    case OP_PAC: {  // amplitude, ell_1, ell_2
      const T l1 = p[1], l2 = p[2];
      const T den = l1 * l1 + l2 * l2;
      const T den2 = den * den;
      const T a = m_sqrt(((T(2) * l1) * l2) / den);
      const T b = m_exp(((T(-2) * r) * r) / den);
      const T amp2 = p[0] * p[0];
      const T da1 = (l2 * (l2 * l2 - l1 * l1)) / (den2 * a);
      const T da2 = (l1 * (l1 * l1 - l2 * l2)) / (den2 * a);
      const T db1 = b * ((T(4) * r2) * l1) / den2;
      const T db2 = b * ((T(4) * r2) * l2) / den2;
      acc[0] += adj * (((T(2) * p[0]) * a) * b);
      acc[1] += adj * (amp2 * (da1 * b + a * db1));
      acc[2] += adj * (amp2 * (da2 * b + a * db2));
      return;
    }
    case OP_NP: {  // amplitude, alpha2, P, ell
      const T x = (pi * ar) / p[2];
      const T s = m_sin(x), c = m_cos(x);
      const T l2 = p[3] * p[3];
      const T w = (T(2) * (s * s)) / (p[1] * l2);
      const T b = T(1) + w;
      const T a = m_pow(b, -p[1]);
      const T k = (p[0] * p[0]) * a;
      acc[0] += adj * ((T(2) * p[0]) * a);
      acc[1] += adj * (k * (w / b - m_log1p(w)));
      acc[2] += adj * (k * (((T(4) * s) * c) * x) / ((l2 * p[2]) * b));
      acc[3] += adj * (k * ((T(2) * p[1]) * w) / (b * p[3]));
      return;
    }
    case OP_QNP: {  // amplitude, alpha2, ell_e, P, ell_p
      const T x = (pi * ar) / p[3];
      const T s = m_sin(x), c = m_cos(x);
      const T lp2 = p[4] * p[4];
      const T w = (T(2) * (s * s)) / (p[1] * lp2);
      const T b = T(1) + w;
      const T a = m_pow(b, -p[1]);
      const T e = m_exp((T(-0.5) * r2) / (p[2] * p[2]));
      const T k = ((p[0] * p[0]) * a) * e;
      acc[0] += adj * (((T(2) * p[0]) * a) * e);
      acc[1] += adj * (k * (w / b - m_log1p(w)));
      acc[2] += adj * (k * (r2 / ((p[2] * p[2]) * p[2])));
      acc[3] += adj * (k * (((T(4) * s) * c) * x) / ((lp2 * p[3]) * b));
      acc[4] += adj * (k * ((T(2) * p[1]) * w) / (b * p[4]));
      return;
    }
    case OP_NRQP: {  // amplitude, alpha1, alpha2, ell_e, P, ell_p
      const T x = (pi * ar) / p[4];
      const T s = m_sin(x), c = m_cos(x);
      const T lp2 = p[5] * p[5];
      const T w2 = (T(2) * (s * s)) / (p[2] * lp2);
      const T b2 = T(1) + w2;
      const T a = m_pow(b2, -p[2]);
      const T w1 = (T(0.5) * r2) / (p[1] * (p[3] * p[3]));
      const T b1 = T(1) + w1;
      const T b = m_pow(b1, -p[1]);
      const T k = ((p[0] * p[0]) * a) * b;
      acc[0] += adj * (((T(2) * p[0]) * a) * b);
      acc[1] += adj * (k * (w1 / b1 - m_log1p(w1)));
      acc[2] += adj * (k * (w2 / b2 - m_log1p(w2)));
      acc[3] += adj * (k * ((T(2) * p[1]) * w1) / (b1 * p[3]));
      acc[4] += adj * (k * (((T(4) * s) * c) * x) / ((lp2 * p[4]) * b2));
      acc[5] += adj * (k * ((T(2) * p[2]) * w2) / (b2 * p[5]));
      return;
    }
    case OP_CP: {  // amplitude, P, ell
      const T x = (pi * ar) / p[1];
      const T s = m_sin(x), c = m_cos(x);
      const T l2 = p[2] * p[2];
      const T e = m_exp((T(-2) * (c * c)) / l2);
      const T k = (p[0] * p[0]) * e;
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] -= adj * (k * (((T(4) * c) * s) * x) / (l2 * p[1]));
      acc[2] += adj * (k * (T(4) * (c * c)) / (l2 * p[2]));
      return;
    }
    case OP_QCP: {  // amplitude, ell_e, P, ell_p
      const T x = (pi * ar) / p[2];
      const T s = m_sin(x), c = m_cos(x);
      const T lp2 = p[3] * p[3];
      const T e = m_exp((T(-2) * (c * c)) / lp2 - r2 / (T(2) * (p[1] * p[1])));
      const T k = (p[0] * p[0]) * e;
      acc[0] += adj * ((T(2) * p[0]) * e);
      acc[1] += adj * (k * (r2 / ((p[1] * p[1]) * p[1])));
      acc[2] -= adj * (k * (((T(4) * c) * s) * x) / (lp2 * p[2]));
      acc[3] += adj * (k * (T(4) * (c * c)) / (lp2 * p[3]));
      return;
    }
  }
}

// One element's contribution g * dk(r)/dp to acc: the program run forward
// keeping every entry's value, then the adjoint g walked back through it
// (ADD passes it to both entries, MUL to each times the other's value).
template <typename T>
__device__ __forceinline__ void element_grad(const Program& prog, const T* p,
                                             T r, T g, T* acc) {
  const int n = prog.n_ops;
  if (n == 1) {  // a single leaf: no values to keep
    leaf_grad<T>(prog.op[0], p + prog.off[0], r, g, acc + prog.off[0]);
    return;
  }
  T val[MAX_OPS];
  T adj[MAX_OPS];
  for (int k = 0; k < n; ++k) {
    const int op = prog.op[k];
    if (op == OP_ADD) {
      val[k] = val[prog.lhs[k]] + val[prog.rhs[k]];
    } else if (op == OP_MUL) {
      val[k] = val[prog.lhs[k]] * val[prog.rhs[k]];
    } else {
      val[k] = leaf<T>(op, p + prog.off[k], r);
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
      leaf_grad<T>(op, p + prog.off[k], r, a, acc + prog.off[k]);
    }
  }
}

#ifdef __CUDACC__

template <typename T>
__global__ void __launch_bounds__(TILE_X * BLOCK_Y)
kernel_matrix_kernel(const T* __restrict__ t, const T* __restrict__ params,
                     const T* __restrict__ jitter, T* __restrict__ out,
                     int n, int n_params, const Program prog) {
  __shared__ T par[MAX_PARAMS];
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  for (int k = tid; k < n_params; k += TILE_X * BLOCK_Y) par[k] = params[k];
  __syncthreads();

  const int j = blockIdx.x * TILE_X + threadIdx.x;
  if (j >= n) return;
  const T tj = t[j];
  const T jit = jitter[0];
#pragma unroll
  for (int k = 0; k < TILE_Y / BLOCK_Y; ++k) {
    const int i = blockIdx.y * TILE_Y + threadIdx.y + k * BLOCK_Y;
    if (i >= n) break;
    T v = eval_program<T>(prog, par, t[i] - tj);
    if (i == j) v = v + jit;
    out[(size_t)i * (size_t)n + (size_t)j] = v;
  }
}

#define GRAD_THREADS (TILE_X * BLOCK_Y)

// B1': per-block partial sums of g[m] = sum G[i, j] dk(t_i - t_j)/dp[m],
// one row of n_params per block, over the same tiles as the forward.
template <typename T>
__global__ void __launch_bounds__(GRAD_THREADS)
kernel_matrix_grad_kernel(const T* __restrict__ t,
                          const T* __restrict__ params,
                          const T* __restrict__ G, T* __restrict__ partial,
                          int n, int n_params, const Program prog) {
  __shared__ T par[MAX_PARAMS];
  __shared__ T red[GRAD_THREADS];
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  for (int k = tid; k < n_params; k += GRAD_THREADS) par[k] = params[k];
  __syncthreads();

  T acc[MAX_PARAMS];
  for (int m = 0; m < n_params; ++m) acc[m] = T(0);
  const int j = blockIdx.x * TILE_X + threadIdx.x;
  if (j < n) {
    const T tj = t[j];
#pragma unroll
    for (int k = 0; k < TILE_Y / BLOCK_Y; ++k) {
      const int i = blockIdx.y * TILE_Y + threadIdx.y + k * BLOCK_Y;
      if (i >= n) break;
      element_grad<T>(prog, par, t[i] - tj,
                      G[(size_t)i * (size_t)n + (size_t)j], acc);
    }
  }
  // every thread takes part in the block sums, in range or not
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int m = 0; m < n_params; ++m) {
    red[tid] = acc[m];
    __syncthreads();
    for (int s = GRAD_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) partial[block * (size_t)n_params + m] = red[0];
    __syncthreads();
  }
}

// B1', second pass: out[m] = the sum of column m of the partial rows, each
// thread over a fixed stride of rows, then a tree in shared memory.
template <typename T>
__global__ void __launch_bounds__(GRAD_THREADS)
kernel_matrix_grad_sum(const T* __restrict__ partial, T* __restrict__ out,
                       int n_blocks, int n_params) {
  __shared__ T red[GRAD_THREADS];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  T s = T(0);
  for (int b = tid; b < n_blocks; b += GRAD_THREADS) {
    s += partial[(size_t)b * (size_t)n_params + m];
  }
  red[tid] = s;
  __syncthreads();
  for (int w = GRAD_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[m] = red[0];
}

// Checks the arguments every launch shares and fills the program; returns
// a CUDA error code (0 when all is well).
static int make_program(int n, int n_params, const int* ops,
                        const int* offs, const int* lhs, const int* rhs,
                        int n_ops, Program* prog) {
  if (n < 1 || (n + TILE_Y - 1) / TILE_Y > 65535 || n_params < 1 ||
      n_params > MAX_PARAMS || n_ops < 1 || n_ops > MAX_OPS) {
    return (int)cudaErrorInvalidValue;
  }
  prog->n_ops = n_ops;
  for (int k = 0; k < MAX_OPS; ++k) {
    const bool used = k < n_ops;
    prog->op[k] = used ? ops[k] : 0;
    prog->off[k] = used ? offs[k] : 0;
    prog->lhs[k] = used && lhs ? lhs[k] : -1;
    prog->rhs[k] = used && rhs ? rhs[k] : -1;
    if (used && lhs && (ops[k] == OP_ADD || ops[k] == OP_MUL) &&
        (lhs[k] < 0 || lhs[k] >= k || rhs[k] < 0 || rhs[k] >= k)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

template <typename T>
static int launch(int device, const T* t, const T* params, const T* jitter,
                  T* out, int n, int n_params, const int* ops,
                  const int* offs, int n_ops, void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, nullptr, nullptr, n_ops,
                         &prog);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TILE_X, BLOCK_Y);
  const dim3 grid((n + TILE_X - 1) / TILE_X, (n + TILE_Y - 1) / TILE_Y);
  kernel_matrix_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      t, params, jitter, out, n, n_params, prog);
  return (int)cudaGetLastError();
}

// partial holds ceil(n / TILE_X) * ceil(n / TILE_Y) rows of n_params.
template <typename T>
static int launch_grad(int device, const T* t, const T* params, const T* G,
                       T* partial, T* out, int n, int n_params,
                       const int* ops, const int* offs, const int* lhs,
                       const int* rhs, int n_ops, void* stream) {
  Program prog;
  int bad = make_program(n, n_params, ops, offs, lhs, rhs, n_ops, &prog);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TILE_X, BLOCK_Y);
  const dim3 grid((n + TILE_X - 1) / TILE_X, (n + TILE_Y - 1) / TILE_Y);
  kernel_matrix_grad_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      t, params, G, partial, n, n_params, prog);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel_matrix_grad_sum<T><<<n_params, GRAD_THREADS, 0,
                              (cudaStream_t)stream>>>(
      partial, out, (int)(grid.x * grid.y), n_params);
  return (int)cudaGetLastError();
}
extern "C" int gpyrn_kernel_matrix_f64(int device, const double* t,
                                       const double* params,
                                       const double* jitter, double* out,
                                       int n, int n_params, const int* ops,
                                       const int* offs, int n_ops,
                                       void* stream) {
  return launch<double>(device, t, params, jitter, out, n, n_params, ops,
                        offs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_f32(int device, const float* t,
                                       const float* params,
                                       const float* jitter, float* out,
                                       int n, int n_params, const int* ops,
                                       const int* offs, int n_ops,
                                       void* stream) {
  return launch<float>(device, t, params, jitter, out, n, n_params, ops,
                       offs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_grad_f64(
    int device, const double* t, const double* params, const double* G,
    double* partial, double* out, int n, int n_params, const int* ops,
    const int* offs, const int* lhs, const int* rhs, int n_ops,
    void* stream) {
  return launch_grad<double>(device, t, params, G, partial, out, n, n_params,
                             ops, offs, lhs, rhs, n_ops, stream);
}

extern "C" int gpyrn_kernel_matrix_grad_f32(
    int device, const float* t, const float* params, const float* G,
    float* partial, float* out, int n, int n_params, const int* ops,
    const int* offs, const int* lhs, const int* rhs, int n_ops,
    void* stream) {
  return launch_grad<float>(device, t, params, G, partial, out, n, n_params,
                            ops, offs, lhs, rhs, n_ops, stream);
}

#endif  // __CUDACC__
