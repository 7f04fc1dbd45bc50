"""Dense kernel matrices: the hand-written CUDA kernels and their plain twins.

Replaces ``gpyrn_tpu/ops/pallas_kernels.py::_build`` (the tiled Pallas
kernel; public wrapper ``pallas_kernel_matrix``).  It computes, for one
stationary kernel structure on the (N,) time vector,

    K[i, j] = k(t_i - t_j; params) + (i == j) * jitter,
    jitter  = max(nugget, jitter_mult * eps * N * k(0)),

where ``tr K = N k(0)`` for a stationary kernel, so the jitter needs no
pass over K.  ``jitter_mult`` is ``linalg.F32_JITTER_MULT`` from
``kernel_matrix`` and 0 (the exact nugget) from ``kernel_matrix_plain``.

Neither kernel (``csrc/kernel_matrix.cu``) is bound by its bytes (N² × 8
in float64, 8 MB at N = 1000): an element costs an exp, a sin or a pow and
some divisions in IEEE arithmetic, hundreds of FP64 operations.  So the
design computes each lag once: every leaf is even in r, K and ∂k/∂θ are
symmetric to the bit, and both kernels walk the 32 × 32 tile pairs I ≥ J
only, handing the mirrored tile across through shared memory.  The N × N
lag matrix and the chain of N² temporaries that :func:`kernel_matrix_ref`
writes (one tensor per operation of the formula) never reach device
memory.  The structure tree is lowered here to a postfix program
(:func:`encode_program`); a program that is one leaf, or two leaves joined
by ``+`` or ``*``, runs a kernel instance with everything in registers,
and a longer one an interpreter, so no structure needs its own build.

Its gradient with respect to ``params`` is a second kernel of the same
source (B1′, :func:`kernel_matrix_grad_cuda`): the contraction
``g[m] = Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params[m]`` of the adjoint G with the
kernel's parameter derivatives, where the JAX package takes the gradient
by autodiff through the Pallas kernel.  A few persistent blocks per SM
(:func:`grad_blocks`) each write one row of partial sums, and a second
kernel adds the rows in a fixed order: no atomics, the same bits from run
to run.  ``_KernelMatrixStack`` joins the two for autograd; the jitter is
computed outside it by differentiable tensor ops, so its gradient is
``trace(G)`` chained through ``k(0)``.  ``t`` takes no gradient (the JAX
package differentiates θ only).

:func:`kernel_matrix_slab_cuda` is B1's slab entry: rows [r0, r0 + n_rows)
of the ``(n_pad, n_pad)`` matrix K(t, t) + jitter·I padded with identity
past N, the row slab that one rank of the panel-sharded engine
(``parallel/panel_fit.py``) holds; it replaces the JAX package's plain-jnp
slab (``gpyrn_tpu/parallel/panel_fit.py``, ``_slab_kernel``), one block per
32 × 32 tile with B1's element math, so each element equals B1's at the
same place.  No gradient (no parallel path differentiates it);
:func:`kernel_matrix_slab_ref` is its plain version.

:func:`kernel_matvec_cuda` is B1's product entry: rows [r0, r0 + n_rows)
of ``(K(t, t) + nugget·I) @ V`` with each element of K evaluated by B1's
element math in registers and never written to memory.  It replaces the
JAX package's ``gpyrn_tpu/ops/iterative.py::kernel_matvec`` (row chunks of
K built and multiplied by XLA) on the card; ``ops/iterative.kernel_matvec``
and the sharded CG's row slabs launch it.  For m ≤ ``MATVEC_CAP`` columns
a thread keeps a row's sums in registers and the columns split into
groups fixed by N alone (:func:`matvec_groups`), summed in order by a
second kernel; above, a block keeps a tile of y in registers
(:func:`matvec_tile_cols` columns of V) and walks K's columns in order,
each K tile evaluated into shared memory and multiplied in, on the FP64
tensor cores in float64.  No gradient (no caller
differentiates a matvec); :func:`kernel_matvec_ref` is its plain version,
the JAX package's chunked formula.

:func:`kernel_matrix_rows_cuda` builds a lattice, W rows of a list of S
structures, straight into one ``(W, S, N, N)`` tensor (one B1 launch per
slice, one B1′ launch per slice of the adjoint in the backward), which
saves the copy of ``torch.stack``; each structure is checked, and its
jitters computed, once for all W rows.  :func:`kernel_matrix_stack_cuda`
is its one-row case, a ``(B, N, N)`` stack, and :func:`kernel_matrix_cuda`
the one-matrix case.  All three launch on a CUDA tensor and raise on
anything else.  :func:`kernel_matrix_ref`, :func:`kernel_matrix_stack_ref`,
:func:`kernel_matrix_rows_ref` and :func:`kernel_matrix_grad_ref` are the
plain PyTorch versions: the CPU path runs the first three (and autograd
through them), and on the card only the tests and ``chip_smoke.py`` call
them, to compare.

``torch.export`` traces with fake tensors, which have no ``data_ptr()``
for a ctypes launch, so the stack is also the custom operator
``torch.ops.gpyrn_torch.kernel_matrix_stack`` (:func:`kernel_matrix_stack_op`):
an opaque node of the exported graph whose CUDA implementation launches B1
as :func:`kernel_matrix_stack_cuda` does and whose CPU implementation is
the plain version.  ``linalg.kernel_matrix_stack`` takes it only while
exporting (the served posterior predictive); every other path launches
directly.
"""
from __future__ import annotations

import ast
import ctypes
import functools
from typing import NamedTuple

import torch

from gpyrn_tpu_torch.ops import _build
from gpyrn_tpu_torch.ops import kernels as _k
from gpyrn_tpu_torch.utils import profiling as _profiling

__all__ = ["OPCODES", "Program", "cuda_supported", "encode_program",
           "kernel_matrix_ref", "kernel_matrix_cuda",
           "kernel_matrix_stack_ref", "kernel_matrix_stack_cuda",
           "kernel_matrix_rows_ref", "kernel_matrix_rows_cuda",
           "kernel_matrix_grad_ref", "kernel_matrix_grad_cuda",
           "kernel_matrix_slab_ref", "kernel_matrix_slab_cuda",
           "kernel_matvec_ref", "kernel_matvec_cuda", "matvec_groups",
           "matvec_tile_cols", "matvec_instance", "MATVEC_INSTANCES",
           "kernel_matrix_stack_op", "grad_blocks", "LAUNCHES",
           "reset_launch_counts"]

# Op codes of the postfix program.  Must equal ``enum Op`` in
# csrc/kernel_matrix.cu (a CPU test compares the two tables).
OPCODES = {
    "+": 0, "*": 1, "C": 2, "SE": 3, "P": 4, "QP": 5, "RQ": 6, "RQP": 7,
    "COS": 8, "EXP": 9, "M32": 10, "M52": 11, "GammaExp": 12, "PW": 13,
    "PAC": 14, "NP": 15, "QNP": 16, "NRQP": 17, "CP": 18, "QCP": 19,
}
# Limits of the kernel's program and parameter buffers (csrc defines).
MAX_OPS = 32
MAX_STACK = 8
MAX_PARAMS = 64
# Tile of both kernels (csrc TILE), and the cap of B1′'s grid of persistent
# blocks: 8 per SM, twice what an SM holds at once (4 blocks of 256 threads
# at 64 registers); at N = 1000 that is every tile pair.
TILE = 32
GRAD_BLOCKS_PER_SM = 8

# The stationary leaves the kernel evaluates: the Pallas kernel's set
# (``pallas_kernels.py::_SAFE_TAGS``).  WhiteNoise (it branches on the
# input's shape), the derivative kernels and the non-stationary kernels
# take the plain path on every device, as in the JAX package.
_LEAVES = frozenset(OPCODES) - {"+", "*"}

# B1's product entry (csrc MV_* defines): the register path takes m ≤
# MATVEC_CAP columns of V, MATVEC_THREADS rows a block, whole steps of
# MATVEC_STAGE columns, and its column groups aim at MATVEC_TARGET_BLOCKS
# blocks over N's row tiles.
MATVEC_CAP = 8
MATVEC_THREADS = 128
MATVEC_STAGE = 256
MATVEC_TARGET_BLOCKS = 4096
# The tiled path's widest tile of V's columns (csrc mt_bn), by dtype.
MATVEC_TILE_COLS = {torch.float32: 256, torch.float64: 128}

# Launches of each kernel, counted where the kernel is launched (B1's slab
# entry counts as B1; the product entry, its sum pass included, once per
# call): the counters ``launches.<kernel>`` of ``utils/profiling.py``.
LAUNCHES = _profiling.counters(
    "launches", ("kernel_matrix", "kernel_matrix_grad", "kernel_matvec"))
# The product entry's launches by kernel instance, "<dtype> <leaf | pair |
# any> <W=1 | W=MATVEC_CAP | tiled | wide>": which instances a path runs
# (their ptxas resources are checked against it).
MATVEC_INSTANCES: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    MATVEC_INSTANCES.clear()


def tile_pairs(n: int) -> int:
    """The tile pairs (I, J), I ≥ J, both kernels walk for an n × n
    matrix: B1's grid, and the most blocks B1′ takes."""
    tiles = -(-n // TILE)
    return tiles * (tiles + 1) // 2


def grad_blocks(n: int, sm_count: int) -> int:
    """B1′'s grid, and the rows of its partial buffer: persistent blocks,
    ``GRAD_BLOCKS_PER_SM`` per SM, never more than the tile pairs.  It
    depends on n and the card only."""
    return min(tile_pairs(n), GRAD_BLOCKS_PER_SM * sm_count)


def cuda_supported(structure) -> bool:
    """Whether a kernel structure runs through the CUDA kernel."""
    tag = structure[0]
    if tag in ("+", "*"):
        return cuda_supported(structure[1]) and cuda_supported(structure[2])
    return tag in _LEAVES


class Program(NamedTuple):
    """The kernels' postfix program: per entry an op code, a parameter
    offset (leaves read ``params[offset:]``) and, for ``+`` / ``*``, the
    indices of the two entries it combines (−1 at a leaf), which the
    backward kernel walks in reverse; ``depth`` is the deepest stack the
    forward evaluation reaches."""
    ops: list
    offsets: list
    lhs: list
    rhs: list
    depth: int


def encode_program(structure) -> Program:
    """Lower a supported structure tree to the kernels' postfix program."""
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    ops, offsets, lhs, rhs = [], [], [], []

    def emit(op, off, left, right):
        ops.append(op)
        offsets.append(off)
        lhs.append(left)
        rhs.append(right)
        return len(ops) - 1

    def walk(s, off, depth):
        """Emit ``s``; return (its entry's index, the deepest stack)."""
        tag = s[0]
        if tag in ("+", "*"):
            i1, d1 = walk(s[1], off, depth)
            i2, d2 = walk(s[2], off + _k.n_params(s[1]), depth + 1)
            return emit(OPCODES[tag], 0, i1, i2), max(d1, d2)
        return emit(OPCODES[tag], off, -1, -1), depth + 1

    _, depth = walk(structure, 0, 0)
    if len(ops) > MAX_OPS or depth > MAX_STACK:
        raise ValueError(f"structure {structure!r} needs {len(ops)} ops and "
                         f"stack depth {depth}; the kernel takes at most "
                         f"{MAX_OPS} and {MAX_STACK}")
    return Program(ops, offsets, lhs, rhs, depth)


def _jitter(structure, params, t, nugget, jitter_mult):
    """max(nugget, jitter_mult·eps·N·k(0)) as a 0-d tensor on t's device
    (no host synchronisation); for ``params`` of shape (n_params, W), the
    W jitters of its columns."""
    k0 = _k.evaluate(structure, params,
                     r=torch.zeros((), dtype=t.dtype, device=t.device))
    eps = torch.finfo(t.dtype).eps
    # maximum, not clamp_min: at a tie the gradient splits as in JAX
    return torch.maximum(jitter_mult * eps * t.shape[0] * k0,
                         k0.new_full((), nugget))


def _jittered_ref(structure, params, t, jitter):
    r = t[:, None] - t[None, :]
    K = _k.evaluate(structure, params, r=r)
    return K + jitter * torch.eye(t.shape[0], dtype=t.dtype, device=t.device)


def kernel_matrix_ref(structure, params, t, nugget, jitter_mult):
    """Plain PyTorch version of the kernel: the dense lag matrix, the
    registry formula on it, and the same jitter on the diagonal."""
    return _jittered_ref(structure, params, t,
                         _jitter(structure, params, t, nugget, jitter_mult))


def kernel_matrix_grad_ref(structure, params, t, G):
    """Plain PyTorch version of B1′: ``Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params``
    (the kernel matrix without its jitter), by autograd through the
    registry formula."""
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        K = _k.evaluate(structure, p, r=t[:, None] - t[None, :])
        (g,) = torch.autograd.grad(K, p, grad_outputs=G)
    return g


# the library's entry points per dtype: (B1, B1′)
_SYMBOLS = {torch.float64: ("gpyrn_kernel_matrix_f64",
                            "gpyrn_kernel_matrix_grad_f64"),
            torch.float32: ("gpyrn_kernel_matrix_f32",
                            "gpyrn_kernel_matrix_grad_f32")}


# The three lookups below are the same on every launch of a fit or a
# gradient call, so each is made once per process and argument.

def _argtypes(grad):
    """The C entry points' arguments (a CPU test reads them off the
    source): device, t, params, jitter | G, [partial,] out, n, n_params,
    [n_blocks,] ops, offs, lhs, rhs, n_ops, stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return ([i, p, p, p] + [p] * (1 + int(grad)) + [i, i] + [i] * int(grad)
            + [p, p, p, p, i, p])


@functools.lru_cache(maxsize=None)
def _function(dtype, grad=False):
    fn = getattr(_build.load("kernel_matrix"), _SYMBOLS[dtype][int(grad)])
    fn.argtypes = _argtypes(grad)
    fn.restype = ctypes.c_int
    return fn


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=256)
def _program_args(structure):
    prog = encode_program(structure)
    return (_ints(prog.ops), _ints(prog.offsets), _ints(prog.lhs),
            _ints(prog.rhs), len(prog.ops))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _check(structure, params, t, rows=False):
    """Refuse what B1 does not take: ``params`` is the structure's 1-D
    parameter tensor, or with ``rows`` a (W, n_params) tensor of them."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError("kernel_matrix_cuda takes CUDA tensors; "
                         "kernel_matrix_ref is the CPU version")
    if t.dtype not in _SYMBOLS:
        raise ValueError(f"kernel_matrix_cuda takes float32 or float64, "
                         f"got {t.dtype}")
    if t.ndim != 1 or t.shape[0] < 1 or not t.is_contiguous():
        raise ValueError(f"t must be a non-empty contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")
    shape = "(W, n_params)" if rows else "1-D"
    if (params.device != t.device or params.dtype != t.dtype
            or params.ndim != 1 + int(rows) or not params.is_contiguous()
            or (rows and params.shape[0] < 1)):
        raise ValueError(f"params must be a contiguous {shape} tensor on "
                         f"t's device and in t's dtype")
    if not cuda_supported(structure):
        raise ValueError(f"structure {structure!r} has no CUDA kernel")
    n_par = _k.n_params(structure)
    if params.shape[-1] != n_par:
        raise ValueError(f"structure {structure!r} takes {n_par} parameters, "
                         f"got {params.shape[-1]}")
    if n_par > MAX_PARAMS:
        raise ValueError(f"structure {structure!r} has {n_par} parameters; "
                         f"the kernel takes at most {MAX_PARAMS}")


def _launch(fn, t, params, jitter, out, n_par, program, stream):
    """B1 on the card: K + jitter·I into ``out``.  ``params``, ``jitter``
    and ``out`` are data pointers (the structure's parameters, its 0-d
    jitter, a contiguous (N, N) slice); ``fn``, ``program`` and ``stream``
    the launch lookups, made once per lattice."""
    n = t.shape[0]
    err = fn(t.device.index, t.data_ptr(), params, jitter, out, n, n_par,
             *program, stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix launch failed with CUDA "
                           f"error {err} (N={n}, {t.dtype})")
    LAUNCHES["kernel_matrix"] += 1


def _launch_grad(structure, params, t, G):
    """B1′ on the card: the (n_params,) contraction of a contiguous (N, N)
    adjoint G with dK/dparams."""
    n, n_par = t.shape[0], params.shape[0]
    n_blocks = grad_blocks(n, _sm_count(t.device.index))
    partial = torch.empty((n_blocks, n_par), dtype=t.dtype, device=t.device)
    out = torch.empty((n_par,), dtype=t.dtype, device=t.device)
    err = _function(t.dtype, grad=True)(
        t.device.index, t.data_ptr(), params.data_ptr(), G.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, n_par, n_blocks,
        *_program_args(structure),
        torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix_grad launch failed with CUDA "
                           f"error {err} (N={n}, {t.dtype})")
    LAUNCHES["kernel_matrix_grad"] += 1
    return out


def _launch_lattice(t, structures, params, jitters):
    """The (W, S, N, N) lattice into one new buffer, one B1 launch per
    slice: ``params[s]`` the contiguous (W, n_params_s) parameters of
    structure s, ``jitters[s]`` its contiguous (W,) jitters."""
    S, n = len(structures), t.shape[0]
    W = params[0].shape[0]
    out = torch.empty((W, S, n, n), dtype=t.dtype, device=t.device)
    fn = _function(t.dtype)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    size = t.element_size()
    for s, structure in enumerate(structures):
        program = _program_args(structure)
        n_par = params[s].shape[1]
        p0, j0 = params[s].data_ptr(), jitters[s].data_ptr()
        for w in range(W):
            _launch(fn, t, p0 + w * n_par * size, j0 + w * size,
                    out.data_ptr() + (w * S + s) * n * n * size, n_par,
                    program, stream)
    return out


class _KernelMatrixStack(torch.autograd.Function):
    """The (W, S, N, N) lattice of K_ws = kernel_s(t; params_s[w]) +
    jitter_s[w]·I: one B1 launch per slice of one buffer; in the backward
    one B1′ launch per slice of G, and trace(G_ws) for each jitter.
    Inputs after ``structures`` are the S contiguous parameter tensors
    (W, n_params_s), then the S contiguous jitter tensors (W,)."""

    @staticmethod
    def forward(ctx, t, structures, *inputs):
        S = len(structures)
        params = inputs[:S]
        out = _launch_lattice(t, structures, params, inputs[S:])
        ctx.save_for_backward(t, *params)
        ctx.structures = structures
        return out

    @staticmethod
    def backward(ctx, G):
        t, *params = ctx.saved_tensors
        S, W = len(params), params[0].shape[0]
        G = G.contiguous()
        grads = [None] * (2 * S)
        for s in range(S):
            if ctx.needs_input_grad[2 + s]:
                grads[s] = torch.stack([
                    _launch_grad(ctx.structures[s], params[s][w], t, G[w, s])
                    for w in range(W)])
        if any(ctx.needs_input_grad[2 + S:]):
            traces = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)   # (W, S)
            for s in range(S):
                if ctx.needs_input_grad[2 + S + s]:
                    grads[S + s] = traces[:, s]
        return (None, None, *grads)


def _check_no_grad(t):
    if t.requires_grad:
        raise ValueError("kernel_matrix_cuda differentiates params only; "
                         "t must not require grad")


def kernel_matrix_cuda(structure, params, t, nugget, jitter_mult):
    """Dense K(t, t) + jitter·I on the card, by the CUDA kernel;
    differentiable with respect to ``params`` (B1′ in the backward).

    ``t`` is a contiguous (N,) float32/float64 CUDA tensor that takes no
    gradient, ``params`` the structure's (n_params,) core parameters on the
    same device in the same dtype.  Launches on the current stream and does
    not synchronise."""
    _check(structure, params, t)
    n = t.shape[0]
    return kernel_matrix_rows_cuda((structure,), (params[None],), t, nugget,
                                   jitter_mult).view(n, n)


def kernel_matrix_stack_ref(structures, params, t, nugget, jitter_mult):
    """Plain PyTorch version of :func:`kernel_matrix_stack_cuda`: the
    per-structure plain versions, stacked."""
    return torch.stack([kernel_matrix_ref(s, p, t, nugget, jitter_mult)
                        for s, p in zip(structures, params)])


def kernel_matrix_rows_ref(structures, params, t, nugget, jitter_mult):
    """Plain PyTorch version of :func:`kernel_matrix_rows_cuda`: the plain
    stack of every row, stacked."""
    return torch.stack([
        kernel_matrix_stack_ref(structures, [p[w] for p in params], t,
                                nugget, jitter_mult)
        for w in range(params[0].shape[0])])


def _count_check(structures, params):
    if not structures or len(structures) != len(params):
        raise ValueError(f"need one parameter tensor per structure and at "
                         f"least one, got {len(structures)} structures and "
                         f"{len(params)} parameter tensors")


def kernel_matrix_stack_cuda(structures, params, t, nugget, jitter_mult):
    """The ``(B, N, N)`` stack of dense K_b(t, t) + jitter_b·I for B kernel
    structures on the card, each built by the CUDA kernel straight into its
    slice of one tensor; differentiable with respect to every ``params[b]``
    (B1′ on the matching slice of the adjoint).  Arguments as
    :func:`kernel_matrix_cuda`, with a sequence of structures and one
    parameter tensor for each: the one-row case of
    :func:`kernel_matrix_rows_cuda`."""
    structures, params = tuple(structures), tuple(params)
    _count_check(structures, params)
    for s, p in zip(structures, params):
        _check(s, p, t)
    return kernel_matrix_rows_cuda(structures, [p[None] for p in params], t,
                                   nugget, jitter_mult)[0]


def kernel_matrix_rows_cuda(structures, params, t, nugget, jitter_mult):
    """The ``(W, S, N, N)`` lattice of dense K_ws(t, t) + jitter_ws·I on
    the card: W rows of the S kernel structures ``structures``, where
    ``params[s]`` is the contiguous (W, n_params_s) tensor of structure s's
    core parameters, one row per lattice row.  One B1 launch per matrix,
    straight into its slice of one tensor; each structure is checked, and
    its W jitters computed, once (no host read).  Differentiable with
    respect to every ``params[s]``; ``t`` as in :func:`kernel_matrix_cuda`.
    """
    structures, params = tuple(structures), tuple(params)
    _count_check(structures, params)
    for s, p in zip(structures, params):
        _check(s, p, t, rows=True)
    if len({p.shape[0] for p in params}) != 1:
        raise ValueError(f"every parameter tensor needs the same rows, got "
                         f"{[p.shape[0] for p in params]}")
    _check_no_grad(t)
    jitters = [_jitter(s, p.T, t, float(nugget), float(jitter_mult))
               .contiguous() for s, p in zip(structures, params)]
    return _KernelMatrixStack.apply(t, structures, *params, *jitters)


def kernel_matrix_grad_cuda(structure, params, t, G):
    """B1′ on the card: ``Σᵢⱼ G[i, j] ∂k(t_i − t_j)/∂params`` as an
    (n_params,) tensor (the jitter excluded), for the same arguments as
    :func:`kernel_matrix_cuda` and an (N, N) adjoint ``G`` in t's dtype on
    t's device.  Launches two kernels on the current stream (the
    per-block partial sums and their fixed-order total) and does not
    synchronise; the same input gives the same bits on one card."""
    _check(structure, params, t)
    n = t.shape[0]
    if (not isinstance(G, torch.Tensor) or G.device != t.device
            or G.dtype != t.dtype or tuple(G.shape) != (n, n)):
        raise ValueError(f"G must be an ({n}, {n}) tensor on t's device and "
                         f"in t's dtype")
    return _launch_grad(structure, params, t, G.contiguous())


# ---- B1's slab entry: a row slab of the padded matrix ----------------------

def kernel_matrix_slab_ref(structure, params, t, n_pad, r0, n_rows, jitter):
    """Plain PyTorch version of :func:`kernel_matrix_slab_cuda`: the
    registry formula on the slab's lags (and coordinates, for a
    non-stationary structure), identity past N, ``jitter`` (a 0-d tensor)
    on the diagonal inside the N × N matrix."""
    n = t.shape[0]
    rows = torch.arange(r0, r0 + n_rows, device=t.device)
    cols = torch.arange(n_pad, device=t.device)
    ti = t[rows.clamp(max=n - 1)][:, None]
    tj = t[cols.clamp(max=n - 1)][None, :]
    if _k.is_nonstationary(structure):
        K = _k.evaluate(structure, params, r=ti - tj, t1=ti, t2=tj)
    else:
        K = _k.evaluate(structure, params, r=ti - tj)
    K = torch.broadcast_to(K, (n_rows, n_pad))
    eye = rows[:, None] == cols[None, :]
    valid = (rows < n)[:, None] & (cols < n)[None, :]
    K = torch.where(valid, K + torch.where(eye, jitter, 0.0), eye.to(K.dtype))
    return K


_SLAB_SYMBOLS = {torch.float64: "gpyrn_kernel_matrix_slab_f64",
                 torch.float32: "gpyrn_kernel_matrix_slab_f32"}


def _slab_argtypes():
    """The slab entry's arguments: device, t, params, jitter, out, n,
    n_pad, r0, n_rows, n_params, ops, offs, lhs, rhs, n_ops, stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return [i, p, p, p, p, i, i, i, i, i, p, p, p, p, i, p]


@functools.lru_cache(maxsize=None)
def _slab_function(dtype):
    fn = getattr(_build.load("kernel_matrix"), _SLAB_SYMBOLS[dtype])
    fn.argtypes = _slab_argtypes()
    fn.restype = ctypes.c_int
    return fn


def kernel_matrix_slab_cuda(structure, params, t, n_pad, r0, n_rows, jitter):
    """B1's slab entry on the card: rows ``[r0, r0 + n_rows)`` of the
    ``(n_pad, n_pad)`` matrix K(t, t) + jitter·I, identity in the rows and
    columns past N = ``len(t)``, as a new ``(n_rows, n_pad)`` tensor.
    ``t`` and ``params`` as :func:`kernel_matrix_cuda`; ``jitter`` a 0-d
    tensor on t's device in t's dtype, added on the diagonal inside the
    N × N matrix only.  One launch on the current stream; no gradient."""
    _check(structure, params, t)
    n = t.shape[0]
    n_pad, r0, n_rows = int(n_pad), int(r0), int(n_rows)
    if not (n_pad >= n and 0 <= r0 and n_rows >= 1 and r0 + n_rows <= n_pad):
        raise ValueError(f"the slab rows [{r0}, {r0 + n_rows}) must lie in "
                         f"the padded matrix of {n_pad} >= N = {n} rows")
    if (not isinstance(jitter, torch.Tensor) or jitter.device != t.device
            or jitter.dtype != t.dtype or jitter.numel() != 1):
        raise ValueError("jitter must be a 0-d tensor on t's device and in "
                         "t's dtype")
    _check_no_grad(t)
    if params.requires_grad:
        raise ValueError("kernel_matrix_slab_cuda takes no gradient")
    out = torch.empty((n_rows, n_pad), dtype=t.dtype, device=t.device)
    jitter = jitter.reshape(()).contiguous()
    err = _slab_function(t.dtype)(
        t.device.index, t.data_ptr(), params.data_ptr(), jitter.data_ptr(),
        out.data_ptr(), n, n_pad, r0, n_rows, params.shape[0],
        *_program_args(structure),
        torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix_slab launch failed with CUDA "
                           f"error {err} (N={n}, rows {r0}..{r0 + n_rows} of "
                           f"{n_pad}, {t.dtype})")
    LAUNCHES["kernel_matrix"] += 1
    return out


# ---- B1's product entry: (K + nugget·I) @ V, K never in memory -------------

def _kernel_block(structure, params, rows, t):
    """K(rows, t), the (len(rows), N) block of the kernel matrix."""
    if _k.is_nonstationary(structure):
        return _k.evaluate(structure, params, t1=rows[:, None],
                           t2=t[None, :])
    return _k.evaluate(structure, params, r=rows[:, None] - t[None, :])


def _matvec_rows(n, r0, n_rows):
    """(r0, n_rows) of a product's rows, n_rows None for all from r0."""
    r0 = int(r0)
    n_rows = n - r0 if n_rows is None else int(n_rows)
    if not (0 <= r0 and n_rows >= 1 and r0 + n_rows <= n):
        raise ValueError(f"the rows [{r0}, {r0 + n_rows}) must lie in the "
                         f"N = {n} rows of K")
    return r0, n_rows


def kernel_matvec_ref(structure, params, t, v, nugget=0.0, chunk=2048,
                      r0=0, n_rows=None):
    """Plain version of :func:`kernel_matvec_cuda`: rows [r0, r0 + n_rows)
    of (K(t, t) + nugget·I) @ v with K rebuilt in ``chunk``-row blocks
    (:func:`_kernel_block`, the last one ragged) and multiplied; any
    structure, the non-stationary ones too.  ``v`` (N,) or (N, m)."""
    r0, n_rows = _matvec_rows(t.shape[0], r0, n_rows)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    rows = t[r0:r0 + n_rows]
    C = int(min(chunk, n_rows))
    y = torch.cat([_kernel_block(structure, params, rows[s:s + C], t) @ v
                   for s in range(0, n_rows, C)])
    y = y + nugget * v[r0:r0 + n_rows]
    return y[:, 0] if squeeze else y


def matvec_groups(n: int) -> int:
    """The column groups of the product entry's register path (csrc
    ``mv_groups``): about MATVEC_TARGET_BLOCKS blocks over the row tiles
    of all N rows, each group whole steps of MATVEC_STAGE columns.  It
    depends on N alone, so a slab of rows sums as the whole product does."""
    row_tiles = -(-n // MATVEC_THREADS)
    want = -(-MATVEC_TARGET_BLOCKS // row_tiles)
    cols = -(-n // want)
    cols = -(-cols // MATVEC_STAGE) * MATVEC_STAGE
    return -(-n // cols)


def matvec_tile_cols(m: int, dtype) -> int:
    """The columns of V a block of the product entry's tiled path takes
    (csrc ``mt_bn``): the least of 64, 128 and ``MATVEC_TILE_COLS`` that
    holds m, else the largest; it depends on m alone."""
    bn = 64
    while bn < m and bn < MATVEC_TILE_COLS[dtype]:
        bn *= 2
    return bn


def matvec_instance(structure, m: int, dtype) -> str:
    """The product entry's kernel instance for a structure B1 takes, m
    columns and dtype, as ``MATVEC_INSTANCES`` names it."""
    if len(structure) == 1:
        mode = structure[0]
    elif all(len(s) == 1 for s in structure[1:]):
        mode = "pair"
    else:
        mode = "any"
    if m <= MATVEC_CAP:
        width = f"W={1 if m == 1 else MATVEC_CAP}"
    else:   # the tiled path's wide shape takes float32 above 128 columns
        width = ("wide" if matvec_tile_cols(m, dtype) > 128 else "tiled")
    return f"{str(dtype).replace('torch.', '')} {mode} {width}"


_MATVEC_SYMBOLS = {torch.float64: "gpyrn_kernel_matvec_f64",
                   torch.float32: "gpyrn_kernel_matvec_f32"}


def _matvec_argtypes():
    """The product entry's arguments: device, t, params, v, nugget, y,
    partial, n, m, r0, n_rows, n_params, ops, offs, lhs, rhs, n_ops,
    stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return [i, p, p, p, p, p, p, i, i, i, i, i, p, p, p, p, i, p]


@functools.lru_cache(maxsize=None)
def _matvec_function(dtype):
    fn = getattr(_build.load("kernel_matrix"), _MATVEC_SYMBOLS[dtype])
    fn.argtypes = _matvec_argtypes()
    fn.restype = ctypes.c_int
    return fn


def kernel_matvec_cuda(structure, params, t, v, nugget=0.0, r0=0,
                       n_rows=None):
    """B1's product entry on the card: rows ``[r0, r0 + n_rows)`` of
    ``(K(t, t) + nugget·I) @ v`` as a new ``(n_rows, m)`` tensor, each
    element of K evaluated once by B1's element math and never stored.
    ``t`` and ``params`` as :func:`kernel_matrix_cuda`; ``v`` a contiguous
    (N, m) tensor on t's device in t's dtype; ``nugget`` a number or a 0-d
    tensor on t's device.  One launch on the current stream (two with the
    column groups' sum); no gradient.  The same inputs give the same bits,
    and a row's bits do not depend on r0 or n_rows."""
    n = t.shape[0]
    r0, n_rows = _matvec_rows(n, r0, n_rows)
    if (not isinstance(v, torch.Tensor) or v.ndim != 2 or v.shape[0] != n
            or v.shape[1] < 1):
        raise ValueError(f"v must be an ({n}, m) tensor with m >= 1, got "
                         f"{tuple(getattr(v, 'shape', ()))}")
    if params.requires_grad or v.requires_grad or (
            isinstance(nugget, torch.Tensor) and nugget.requires_grad):
        raise ValueError("kernel_matvec_cuda takes no gradient")
    _check(structure, params, t)
    _check_no_grad(t)
    if v.device != t.device or v.dtype != t.dtype or not v.is_contiguous():
        raise ValueError("v must be contiguous, on t's device and in t's "
                         "dtype")
    if isinstance(nugget, torch.Tensor):
        if nugget.device != t.device or nugget.numel() != 1:
            raise ValueError("a tensor nugget must be 0-d on t's device")
        nug = nugget.to(t.dtype).reshape(()).contiguous()
    else:
        nug = t.new_full((), float(nugget))
    m = v.shape[1]
    y = torch.empty((n_rows, m), dtype=t.dtype, device=t.device)
    groups = matvec_groups(n)
    partial = (torch.empty((groups, n_rows, m), dtype=t.dtype,
                           device=t.device)
               if m <= MATVEC_CAP and groups > 1 else None)
    err = _matvec_function(t.dtype)(
        t.device.index, t.data_ptr(), params.data_ptr(), v.data_ptr(),
        nug.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), n, m, r0, n_rows,
        params.shape[0], *_program_args(structure),
        torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_matvec launch failed with CUDA error "
                           f"{err} (N={n}, m={m}, rows {r0}..{r0 + n_rows}, "
                           f"{t.dtype})")
    LAUNCHES["kernel_matvec"] += 1
    key = matvec_instance(structure, m, t.dtype)
    MATVEC_INSTANCES[key] = MATVEC_INSTANCES.get(key, 0) + 1
    return y


# ---- the custom operator of the exported program -------------------------

@functools.lru_cache(maxsize=256)
def _parse_structure(text):
    """A structure tree from its ``repr`` (the operator's schema has no
    nested-tuple type), parsed once per text."""
    return ast.literal_eval(text)


@torch.library.custom_op(
    "gpyrn_torch::kernel_matrix_stack", mutates_args=(), device_types="cpu",
    schema="(Tensor t, Tensor[] params, Tensor[] jitters, str[] structures)"
           " -> Tensor")
def _stack_op(t, params, jitters, structures):
    """CPU: the plain version, matrix by matrix."""
    return torch.stack([
        _jittered_ref(_parse_structure(s), p, t, j)
        for s, p, j in zip(structures, params, jitters)])


@_stack_op.register_kernel("cuda")
def _stack_op_cuda(t, params, jitters, structures):
    """CUDA: one B1 launch per matrix into one (B, N, N) buffer, as
    :func:`kernel_matrix_stack_cuda`; raises on what B1 does not take."""
    parsed = tuple(_parse_structure(s) for s in structures)
    _count_check(parsed, params)
    for s, p in zip(parsed, params):
        _check(s, p, t)
    return _launch_lattice(t, parsed, [p[None] for p in params],
                           [j.reshape(1).contiguous() for j in jitters])[0]


@_stack_op.register_fake
def _stack_op_fake(t, params, jitters, structures):
    n = t.shape[0]
    return t.new_empty((len(params), n, n))


def kernel_matrix_stack_op(structures, params, t, nugget, jitter_mult):
    """:func:`kernel_matrix_stack_cuda` (on a CUDA tensor) or
    :func:`kernel_matrix_stack_ref` (on a CPU tensor) through the custom
    operator ``gpyrn_torch::kernel_matrix_stack``, with the jitters
    computed beside it by tensor operations: the form ``torch.export``
    can trace.  No gradient."""
    structures = tuple(structures)
    _count_check(structures, params)
    jitters = [_jitter(s, p, t, float(nugget), float(jitter_mult))
               for s, p in zip(structures, params)]
    return torch.ops.gpyrn_torch.kernel_matrix_stack(
        t, list(params), jitters, [repr(s) for s in structures])
