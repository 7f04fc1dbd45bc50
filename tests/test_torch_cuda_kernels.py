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
    for name in ("TILE_X", "TILE_Y"):     # B1′'s partial rows, one per tile
        value = re.search(rf"#define {name} (\d+)", src).group(1)
        assert int(value) == ck.TILE, name
    # every leaf op has a case in the kernel's switch
    for name in expected:
        if name not in ("ADD", "MUL"):
            assert f"case OP_{name}:" in src, name


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
