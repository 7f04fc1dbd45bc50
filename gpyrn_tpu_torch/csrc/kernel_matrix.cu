// Dense kernel matrices of the GPRN engine, for Hopper (sm_90a):
//
//     out[i, j] = k(t_i - t_j; params) + (i == j) * jitter
//
// for one stationary kernel structure, in float or double.
//
// Replaces gpyrn_tpu/ops/pallas_kernels.py::_build, the tiled Pallas
// kernel of the JAX package.  Bound by stores: the output is N^2 x 8 bytes
// in float64 (8 MB at N = 1000, 134 MB at N = 4096), and each element costs
// a few dozen FP64 operations for its transcendentals (exp, sin, pow).  The
// design keeps out of device memory the N x N lag matrix and the chain of
// N^2 temporaries that the plain PyTorch version (one tensor per operation
// of the formula) writes and reads back: each element is formed in
// registers from two loads of the time vector and stored once.
//
// The kernel structure arrives as a postfix program (one op code and one
// parameter offset per entry; leaves push k(r), ADD / MUL combine the top
// two), built by gpyrn_tpu_torch/ops/cuda_kernels.py::encode_program.  The
// program is the same for every thread, so evaluating it never diverges.
// Every formula repeats the operation order of
// gpyrn_tpu_torch/ops/kernels.py, and the library is compiled without FMA
// contraction (-fmad=false), so each operation rounds as the plain version's
// does and the two agree to the last bits of the math library's exp / sin.
//
// Tiles: a block of 32 x 8 threads covers 32 columns x 32 rows; each warp
// stores 32 neighbouring elements of a row, and each thread walks 4 rows.
// The ragged edge is masked, not padded.

#include <cuda_runtime.h>
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

template <typename T>
static int launch(int device, const T* t, const T* params, const T* jitter,
                  T* out, int n, int n_params, const int* ops,
                  const int* offs, int n_ops, void* stream) {
  if (n < 1 || (n + TILE_Y - 1) / TILE_Y > 65535 || n_params < 0 ||
      n_params > MAX_PARAMS || n_ops < 1 || n_ops > MAX_OPS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Program prog;
  prog.n_ops = n_ops;
  for (int k = 0; k < MAX_OPS; ++k) {
    prog.op[k] = k < n_ops ? ops[k] : 0;
    prog.off[k] = k < n_ops ? offs[k] : 0;
  }
  const dim3 block(TILE_X, BLOCK_Y);
  const dim3 grid((n + TILE_X - 1) / TILE_X, (n + TILE_Y - 1) / TILE_Y);
  kernel_matrix_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      t, params, jitter, out, n, n_params, prog);
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
