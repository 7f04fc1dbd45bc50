"""The CUDA kernel-matrix kernel of gpyrn_tpu_torch (``csrc/kernel_matrix.cu``).

On the CPU: its plain twin ``kernel_matrix_ref`` and the linalg functions
against the JAX package's Pallas kernel, run in interpret mode as
``tests/test_pallas_kernels.py`` runs it (rtol = atol = 1e-12); the
postfix program the wrapper hands the kernel, run by a small numpy
interpreter, against the twin; and the kernel's op-code table, read from
the CUDA source, against the Python one.  The kernel itself runs only on
the card: ``tests/test_torch_card.py``."""
import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpyrn_tpu.ops import linalg as jlin
from gpyrn_tpu.ops.pallas_kernels import (pallas_kernel_matrix,
                                          pallas_supported)
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.ops import kernels as tk
from gpyrn_tpu_torch.ops import linalg as tlin

CASES = [
    (("SE",), (1.2, 8.0)),
    (("QP",), (1.1, 20.0, 13.0, 0.6)),
    (("M52",), (1.2, 5.0)),
    (("P",), (1.1, 9.0, 0.7)),
    (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)),
    (("*", ("QP",), ("C",)), (1.1, 20.0, 13.0, 0.6, 0.8)),
]
SIZES = (3, 255, 257)
MULTS = (jlin.F32_JITTER_MULT, 0.0)
CU_SOURCE = (Path(ck.__file__).resolve().parents[1] / "csrc"
             / "kernel_matrix.cu")


def _times(N):
    return np.sort(np.random.default_rng(N).uniform(0, 100, N))


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.fixture(scope="module")
def pallas_out():
    """The JAX Pallas kernel (interpret mode), one run per case."""
    cache = {}

    def get(structure, pars, N, mult):
        key = (structure, N, mult)
        if key not in cache:
            cache[key] = np.asarray(pallas_kernel_matrix(
                structure, jnp.asarray(pars), jnp.asarray(_times(N)),
                jlin.TRAIN_NUGGET, mult, interpret=True))
        return cache[key]
    return get


@pytest.mark.parametrize("mult", MULTS)
@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("structure,pars", CASES)
def test_twin_matches_pallas(structure, pars, N, mult, pallas_out):
    ref = pallas_out(structure, pars, N, mult)
    got = ck.kernel_matrix_ref(structure, _f64(pars),
                               _f64(_times(N)),
                               tlin.TRAIN_NUGGET, mult)
    assert got.shape == (N, N) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("structure,pars", CASES)
def test_linalg_functions_match_pallas(structure, pars, N, pallas_out):
    """kernel_matrix (mult 4) and kernel_matrix_plain (mult 0) on a CPU
    tensor take the twin and agree with the Pallas kernel."""
    t = _f64(_times(N))
    before = ck.LAUNCHES["kernel_matrix"]
    for fn, mult in ((tlin.kernel_matrix, jlin.F32_JITTER_MULT),
                     (tlin.kernel_matrix_plain, 0.0)):
        got = fn(structure, _f64(pars), t, tlin.TRAIN_NUGGET)
        np.testing.assert_allclose(got.numpy(),
                                   pallas_out(structure, pars, N, mult),
                                   rtol=1e-12, atol=1e-12)
    assert ck.LAUNCHES["kernel_matrix"] == before   # no launch on the CPU


def test_supported_set_matches_pallas():
    for structure in [("SE",), ("+", ("SE",), ("M52",)), ("WN",), ("HP", 3),
                      ("*", ("SE",), ("LIN",)), ("d", ("SE",)),
                      ("*", ("QCP",), ("+", ("PW",), ("GammaExp",)))]:
        assert ck.cuda_supported(structure) == pallas_supported(structure)
    for tag in tk._REGISTRY:
        structure = ("QHP", 2) if tag == "QHP" else \
            ("HP", 3) if tag == "HP" else (tag,)
        assert ck.cuda_supported(structure) == pallas_supported(structure)


def test_unsupported_structures_take_the_plain_path():
    """WhiteNoise, derivatives and non-stationary kernels never reach the
    kernel and keep the JAX package's nugget rules."""
    t = _times(40)
    for structure, pars in [(("WN",), (0.4,)), (("d", ("SE",)), (1.2, 8.0)),
                            (("HP", 3), (3.0, 1.0, 9.0, 0.8)),
                            (("+", ("SE",), ("LIN",)), (1.0, 8.0, 0.5))]:
        for jfn, tfn in ((jlin.kernel_matrix, tlin.kernel_matrix),
                         (jlin.kernel_matrix_plain,
                          tlin.kernel_matrix_plain)):
            ref = np.asarray(jfn(structure, jnp.asarray(pars),
                                 jnp.asarray(t)))
            got = tfn(structure, _f64(pars), _f64(t))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                       atol=1e-12)


def _run_program(ops, offsets, pars, r):
    """numpy interpreter of the kernel's postfix program."""
    names = {code: tag for tag, code in ck.OPCODES.items()}
    stack = []
    for op, off in zip(ops, offsets):
        tag = names[op]
        if tag == "+":
            b = stack.pop()
            stack.append(stack.pop() + b)
        elif tag == "*":
            b = stack.pop()
            stack.append(stack.pop() * b)
        else:
            n = tk.n_params((tag,))
            stack.append(tk.evaluate((tag,), _f64(pars[off:off + n]),
                                     r=_f64(r)).numpy())
    assert len(stack) == 1
    return stack[0]


PROGRAM_CASES = CASES + [
    (("+", ("*", ("P",), ("SE",)), ("*", ("RQ",), ("+", ("COS",), ("C",)))),
     (1.1, 9.0, 0.7, 1.0, 12.0, 0.9, 1.5, 6.0, 1.1, 7.0, 0.3)),
    (("*", ("NRQP",), ("+", ("QNP",), ("+", ("PAC",), ("QCP",)))),
     (1.0, 1.1, 1.3, 15.0, 9.0, 0.9, 1.0, 1.3, 15.0, 9.0, 0.9, 1.1, 3.0,
      7.0, 1.0, 15.0, 9.0, 1.5)),
] + [((tag,), pars) for tag, pars in [
    ("RQP", (1.0, 1.2, 15.0, 9.0, 0.8)), ("EXP", (0.8, 4.0)),
    ("GammaExp", (1.1, 1.4, 6.0)), ("PW", (12.0,)), ("NP", (1.0, 1.3, 9.0,
                                                             0.9)),
    ("CP", (1.0, 9.0, 1.5))]]


@pytest.mark.parametrize("structure,pars", PROGRAM_CASES)
def test_program_encodes_structure(structure, pars):
    prog = ck.encode_program(structure)
    ops, offsets, depth = prog.ops, prog.offsets, prog.depth
    n_leaves = sum(op not in (ck.OPCODES["+"], ck.OPCODES["*"])
                   for op in ops)
    assert len(ops) == 2 * n_leaves - 1
    assert 1 <= depth <= ck.MAX_STACK
    t = _times(30)
    r = t[:, None] - t[None, :]
    got = _run_program(ops, offsets, pars, r)
    ref = tk.evaluate(structure, _f64(pars), r=_f64(r))
    np.testing.assert_array_equal(got, ref.numpy())


def _run_by_children(prog, pars, r):
    """numpy evaluation of the program through its child indices (the
    order the backward kernel walks), instead of the stack."""
    names = {code: tag for tag, code in ck.OPCODES.items()}
    val = []
    for op, off, lhs, rhs in zip(prog.ops, prog.offsets, prog.lhs, prog.rhs):
        tag = names[op]
        if tag in ("+", "*"):
            assert 0 <= lhs < len(val) and 0 <= rhs < len(val)
            val.append(val[lhs] + val[rhs] if tag == "+"
                       else val[lhs] * val[rhs])
        else:
            assert lhs == rhs == -1
            n = tk.n_params((tag,))
            val.append(tk.evaluate((tag,), _f64(pars[off:off + n]),
                                   r=_f64(r)).numpy())
    return val[-1]


@pytest.mark.parametrize("structure,pars", PROGRAM_CASES)
def test_program_children_name_the_operands(structure, pars):
    """Every + / * entry names the two entries it combines; each entry but
    the last is the operand of exactly one other, and the evaluation by
    child indices equals the tree's."""
    prog = ck.encode_program(structure)
    children = [c for c in prog.lhs + prog.rhs if c >= 0]
    assert sorted(children) == list(range(len(prog.ops) - 1))
    t = _times(30)
    r = t[:, None] - t[None, :]
    np.testing.assert_array_equal(
        _run_by_children(prog, pars, r),
        tk.evaluate(structure, _f64(pars), r=_f64(r)).numpy())


def test_program_children_of_a_small_tree():
    prog = ck.encode_program(("*", ("+", ("SE",), ("C",)), ("QP",)))
    assert prog.ops == [3, 2, 0, 5, 1]
    assert prog.offsets == [0, 2, 0, 3, 0]
    assert prog.lhs == [-1, -1, 0, -1, 2]
    assert prog.rhs == [-1, -1, 1, -1, 3]
    assert prog.depth == 2


def test_program_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        ck.encode_program(("WN",))
    deep = ("SE",)
    for _ in range(ck.MAX_STACK):
        deep = ("+", ("C",), deep)
    with pytest.raises(ValueError):
        ck.encode_program(deep)


def test_cuda_source_tables_match_python():
    src = CU_SOURCE.read_text()
    table = {name: int(code) for name, code in
             re.findall(r"^\s*OP_(\w+) = (\d+),", src, re.MULTILINE)}
    expected = {{"+": "ADD", "*": "MUL"}.get(tag, tag): code
                for tag, code in ck.OPCODES.items()}
    assert table == expected
    for name in ("MAX_OPS", "MAX_STACK", "MAX_PARAMS"):
        value = re.search(rf"#define {name} (\d+)", src).group(1)
        assert int(value) == getattr(ck, name), name
    # the tile both grids are sized from
    assert int(re.search(r"#define TILE (\d+)", src).group(1)) == ck.TILE
    # the most parameters of a leaf: the kernels' register arrays
    most = max(tk.n_params((tag,)) for tag in ck._LEAVES)
    assert int(re.search(r"#define LEAF_PARAMS (\d+)", src).group(1)) == most
    assert int(re.search(r"#define N_OPCODES (\d+)", src).group(1)) == \
        len(ck.OPCODES)
    # every leaf has its single-leaf kernel instance
    listed = re.search(r"#define FOR_EACH_LEAF\(X\)(.*?)\n\n", src,
                       re.DOTALL).group(1)
    assert set(re.findall(r"X\(OP_(\w+)\)", listed)) == set(ck._LEAVES)
    # every leaf op has a case in the kernel's switch
    for name in expected:
        if name not in ("ADD", "MUL"):
            assert f"case OP_{name}:" in src, name


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4096, 100000])
def test_grid_sizes(n):
    """B1 runs one block per tile pair; B1′'s grid, which is also the
    number of rows of its partial buffer, is capped per SM and depends on
    n and the card's SM count only."""
    tiles = -(-n // ck.TILE)
    pairs = tiles * (tiles + 1) // 2
    assert ck.tile_pairs(n) == pairs
    if tiles <= 200:
        assert pairs == len([(i, j) for i in range(tiles)
                             for j in range(i + 1)])
    for sms in (1, 108, 132):
        blocks = ck.grad_blocks(n, sms)
        assert blocks == min(pairs, ck.GRAD_BLOCKS_PER_SM * sms)
        assert 1 <= blocks <= pairs
    # the largest matrix the launcher takes keeps the grid inside an int
    assert ck.tile_pairs(65535 * ck.TILE) < 2 ** 31


def test_c_entry_points_take_the_wrappers_arguments():
    """Each ``extern "C"`` entry point of the source declares the argument
    types the wrapper passes (pointers and ints, in order), and B1's grid
    is the launcher's own: one block per tile pair, no grid argument."""
    import ctypes
    src = CU_SOURCE.read_text()
    for dtype, (fwd, grad) in ck._SYMBOLS.items():
        for symbol, is_grad in ((fwd, False), (grad, True)):
            decl = re.search(rf'extern "C" int {symbol}\((.*?)\)', src,
                             re.DOTALL).group(1)
            kinds = [ctypes.c_void_p if "*" in arg else ctypes.c_int
                     for arg in decl.split(",")]
            assert kinds == ck._argtypes(is_grad), symbol
            assert ("n_blocks" in decl) == is_grad, symbol
    assert re.search(r"kernel_matrix_kernel<T, MODE><<<grid,", src)
    assert re.search(r"grid = \(unsigned\)n_tile_pairs\(\(n \+ TILE - 1\) "
                     r"/ TILE\)", src)


def test_ptxas_report_is_parsed():
    from gpyrn_tpu_torch.ops import _build
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z25kernel_matrix_grad_kernelIdLi5EEvPKT_S2_S2_PS0_iib7Program' for 'sm_90a'
ptxas info    : Function properties for _Z25kernel_matrix_grad_kernelIdLi5EEvPKT_S2_S2_PS0_iib7Program
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 13568 bytes smem
ptxas info    : Compile time = 812.000 ms
ptxas info    : Compiling entry function '_Z20kernel_matrix_kernelIfLin2EEvPKT_S2_S2_PS0_iib7Program' for 'sm_90a'
ptxas info    : Function properties for _Z20kernel_matrix_kernelIfLin2EEvPKT_S2_S2_PS0_iib7Program
    96 bytes stack frame, 24 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""
    usage = _build.resource_usage(log)
    assert usage == {
        "_Z25kernel_matrix_grad_kernelIdLi5EEvPKT_S2_S2_PS0_iib7Program":
            {"registers": 62, "stack_frame": 0, "spill_stores": 0,
             "spill_loads": 0},
        "_Z20kernel_matrix_kernelIfLin2EEvPKT_S2_S2_PS0_iib7Program":
            {"registers": 32, "stack_frame": 96, "spill_stores": 24,
             "spill_loads": 52}}


STACK_CASES = {
    "supported": [(("QP",), (1.1, 20.0, 13.0, 0.6)), (("SE",), (1.0, 30.0)),
                  (("SE",), (1.05, 30.0)),
                  (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0))],
    "with an unsupported structure": [
        (("QP",), (1.1, 20.0, 13.0, 0.6)), (("WN",), (0.4,)),
        (("+", ("SE",), ("LIN",)), (1.0, 8.0, 0.5)),
        (("HP", 3), (3.0, 1.0, 9.0, 0.8))],
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("cases", list(STACK_CASES))
def test_linalg_stack_equals_the_matrices_one_by_one(cases, dtype):
    """linalg.kernel_matrix_stack on a CPU tensor: exactly the per-matrix
    kernel_matrix, stacked, and the same gradient (1e-12 of the largest
    entry in float64, 1e-5 in float32), whether or not the CUDA kernel
    supports every structure of the list."""
    structures = [s for s, _ in STACK_CASES[cases]]
    t = torch.tensor(_times(40), dtype=dtype)
    G = torch.tensor(np.random.default_rng(3).standard_normal(
        (len(structures), 40, 40)), dtype=dtype)

    def run(build):
        params = [torch.tensor(pars, dtype=dtype, requires_grad=True)
                  for _, pars in STACK_CASES[cases]]
        K = build(params)
        return K.detach(), torch.autograd.grad(K, params, grad_outputs=G)

    before = dict(ck.LAUNCHES)
    for nugget in (tlin.TRAIN_NUGGET, tlin.PREDICT_NUGGET):
        K, g = run(lambda ps: tlin.kernel_matrix_stack(structures, ps, t,
                                                       nugget))
        K_ref, g_ref = run(lambda ps: torch.stack(
            [tlin.kernel_matrix(s, p, t, nugget)
             for s, p in zip(structures, ps)]))
        assert K.shape == (len(structures), 40, 40) and K.dtype == dtype
        assert torch.equal(K, K_ref)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for a, b in zip(g, g_ref):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    assert ck.LAUNCHES == before                   # no launch on the CPU


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("cases", list(STACK_CASES))
def test_linalg_rows_equal_the_stacks_row_by_row(cases, dtype):
    """linalg.kernel_matrix_rows on a CPU tensor: row w is exactly
    kernel_matrix_stack of row w's parameters, with either jitter rule, and
    the gradient of every (W, n) parameter tensor is the per-row stacks'
    (1e-12 of the largest entry in float64, 1e-5 in float32)."""
    structures = [s for s, _ in STACK_CASES[cases]]
    W = 3
    t = torch.tensor(_times(24), dtype=dtype)
    rng = np.random.default_rng(5)
    base = [np.asarray(pars) * np.exp(0.1 * rng.standard_normal(
        (W, len(pars)))) for _, pars in STACK_CASES[cases]]
    G = torch.tensor(rng.standard_normal((W, len(structures), 24, 24)),
                     dtype=dtype)
    before = dict(ck.LAUNCHES)
    for mult in (tlin.F32_JITTER_MULT, 0.0):
        rows = [torch.tensor(b, dtype=dtype, requires_grad=True)
                for b in base]
        K = tlin.kernel_matrix_rows(structures, rows, t, jitter_mult=mult)
        g = torch.autograd.grad(K, rows, grad_outputs=G)
        assert K.shape == (W, len(structures), 24, 24)
        per_row = [[torch.tensor(b[w], dtype=dtype, requires_grad=True)
                    for b in base] for w in range(W)]
        for w in range(W):
            Kw = tlin.kernel_matrix_stack(structures, per_row[w], t,
                                          jitter_mult=mult)
            assert torch.equal(K[w], Kw.detach())
            gw = torch.autograd.grad(Kw, per_row[w], grad_outputs=G[w])
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            for a, b in zip((x[w] for x in g), gw):
                assert float((a - b).abs().max()) <= \
                    tol * float(b.abs().max())
    with pytest.raises(ValueError, match="jitter_mult"):
        tlin.kernel_matrix_rows(structures, rows, t, jitter_mult=1.0)
    assert ck.LAUNCHES == before                   # no launch on the CPU


def test_rows_wrapper_refuses_what_it_does_not_take():
    t = _f64(_times(10))
    rows = torch.tensor([[1.0, 2.0], [1.5, 2.5]], dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ck.kernel_matrix_rows_cuda([("SE",)], [rows], t, 1e-6, 4.0)
    with pytest.raises(ValueError, match="one parameter tensor"):
        ck.kernel_matrix_rows_cuda([("SE",), ("SE",)], [rows], t, 1e-6, 4.0)
    with pytest.raises(ValueError, match="at least one"):
        ck.kernel_matrix_rows_cuda([], [], t, 1e-6, 4.0)


def test_stack_wrapper_refuses_what_it_does_not_take():
    t = _f64(_times(10))
    with pytest.raises(ValueError, match="CUDA"):
        ck.kernel_matrix_stack_cuda([("SE",)], [_f64([1.0, 2.0])], t, 1e-6,
                                    4.0)
    with pytest.raises(ValueError, match="one parameter tensor"):
        ck.kernel_matrix_stack_cuda([("SE",), ("SE",)], [_f64([1.0, 2.0])],
                                    t, 1e-6, 4.0)
    with pytest.raises(ValueError, match="at least one"):
        ck.kernel_matrix_stack_cuda([], [], t, 1e-6, 4.0)


def test_wrapper_refuses_cpu_tensors():
    t = _f64(_times(10))
    with pytest.raises(ValueError, match="CUDA"):
        ck.kernel_matrix_cuda(("SE",), torch.tensor([1.0, 2.0]), t,
                              1e-6, 4.0)


def test_jitter_rule():
    """max(nugget, mult·eps·N·k(0)): the scaled term wins in float32."""
    N = 1000
    t = torch.tensor(_times(N), dtype=torch.float32)
    pars = torch.tensor([1.5, 8.0], dtype=torch.float32)
    K = ck.kernel_matrix_ref(("SE",), pars, t, 1e-6, 4.0)
    expected = 4.0 * float(torch.finfo(torch.float32).eps) * N * 1.5 ** 2
    assert math.isclose(float(K[0, 0]) - 1.5 ** 2, expected, rel_tol=1e-3)
    K0 = ck.kernel_matrix_ref(("SE",), pars, t, 1e-6, 0.0)
    assert float(K0[3, 3]) == float(np.float32(1.5 ** 2) + np.float32(1e-6))


LINALG_CASES = CASES[:2] + [
    (("WN",), (0.4,)),
    (("HP", 3), (3.0, 1.0, 9.0, 0.8)),
    (("QHP", 2), (2.0, 1.0, 15.0, 9.0, 0.8)),
    (("POLY",), (1.0, 0.01, 2.0, 1.5)),
    (("+", ("SE",), ("LIN",)), (1.0, 8.0, 0.5)),
]


@pytest.mark.parametrize("structure,pars", LINALG_CASES)
def test_linalg_helpers_match_jax(structure, pars):
    """kernel_diag, cross_kernel_matrix and the no-nugget quirk of a
    top-level HP/QHP/POLY kernel, against the JAX package."""
    t = _times(40)
    ts = np.linspace(-5.0, 105.0, 23)
    for jfn, tfn, args in (
            (jlin.kernel_diag, tlin.kernel_diag, (t,)),
            (jlin.kernel_diag, tlin.kernel_diag, (ts, jlin.PREDICT_NUGGET)),
            (jlin.cross_kernel_matrix, tlin.cross_kernel_matrix, (ts, t)),
            (jlin.kernel_matrix, tlin.kernel_matrix, (t,))):
        ref = np.asarray(jfn(structure, jnp.asarray(pars),
                             *[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args]))
        got = tfn(structure, _f64(pars),
                  *[_f64(a) if isinstance(a, np.ndarray) else a
                    for a in args])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_psd_jitter_matches_jax(dtype):
    rng = np.random.default_rng(9)
    X = rng.standard_normal((3, 20, 20)).astype(dtype)
    S = X @ X.transpose(0, 2, 1)
    ref = np.asarray(jlin.psd_jitter(jnp.asarray(S)))
    got = tlin.psd_jitter(torch.tensor(S))
    assert got.dtype == torch.tensor(S).dtype
    np.testing.assert_allclose(got.numpy(), ref,
                               rtol=1e-12 if dtype == np.float64 else 1e-6)
