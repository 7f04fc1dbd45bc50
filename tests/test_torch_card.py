"""gpyrn_tpu_torch on the card: the CUDA kernel-matrix kernel (B1) and its
backward (B1′) against their plain twins (ragged sizes, exact symmetry,
a non-symmetric adjoint, the same bits from run to run), the stacked
function and its backward, and the main path and the gradient path on the
card against the same on the CPU.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports no jax, so the card's machine runs it
without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import LEAF_CASES
import gpyrn_tpu_torch as gt
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
    (("*", ("NRQP",), ("+", ("QNP",), ("+", ("PAC",), ("QCP",)))),
     (1.0, 1.1, 1.3, 15.0, 9.0, 0.9, 1.0, 1.3, 15.0, 9.0, 0.9, 1.1, 3.0,
      7.0, 1.0, 15.0, 9.0, 1.5)),
    (("+", ("*", ("RQP",), ("GammaExp",)), ("*", ("PW",), ("+", ("CP",),
                                                           ("NP",)))),
     (1.0, 1.2, 15.0, 9.0, 0.8, 1.1, 1.4, 6.0, 30.0, 1.0, 9.0, 1.5, 1.0,
      1.3, 9.0, 0.9)),
    (("+", ("RQ",), ("+", ("COS",), ("EXP",))),
     (0.9, 1.5, 6.0, 1.1, 7.0, 0.8, 4.0)),
]


# sizes around the tile (32) and the 16-byte groups (2 doubles, 4 floats)
RAGGED_NS = (1, 2, 3, 4, 31, 32, 33, 34, 255, 256, 257)


def _times(N):
    return np.sort(np.random.default_rng(N).uniform(0, 100, N))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("structure,pars", CASES)
def test_kernel_matches_twin(structure, pars, dtype, cuda):
    """f64: rtol 1e-12, atol 1e-14·k(0); f32: rtol 2e-6, atol 1e-6·k(0)
    (float32 transcendentals may differ by an ulp or two)."""
    rtol, atol = (1e-12, 1e-14) if dtype == torch.float64 else (2e-6, 1e-6)
    for N in RAGGED_NS + (1000,):
        t = torch.tensor(_times(N), dtype=dtype, device=cuda)
        p = torch.tensor(pars, dtype=dtype, device=cuda)
        k0 = abs(float(tk.evaluate(structure, p, r=torch.zeros(
            (), dtype=dtype, device=cuda))))
        for mult in (tlin.F32_JITTER_MULT, 0.0):
            before = ck.LAUNCHES["kernel_matrix"]
            got = ck.kernel_matrix_cuda(structure, p, t, 1e-6, mult)
            assert ck.LAUNCHES["kernel_matrix"] == before + 1
            ref = ck.kernel_matrix_ref(structure, p, t, 1e-6, mult)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol * k0)
            # each lag is computed once and stored at (i, j) and (j, i)
            assert torch.equal(got, got.T)


@pytest.mark.cuda
def test_wrapper_refuses_what_it_does_not_take(cuda):
    t = torch.tensor(_times(20), dtype=torch.float64, device=cuda)
    p = torch.tensor([1.2, 8.0], dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ck.kernel_matrix_cuda(("SE",), p.float(), t, 1e-6, 4.0)
    with pytest.raises(ValueError):
        ck.kernel_matrix_cuda(("SE",), p, t[::2], 1e-6, 4.0)
    with pytest.raises(ValueError):
        ck.kernel_matrix_cuda(("SE",), p[:1], t, 1e-6, 4.0)
    with pytest.raises(ValueError):
        ck.kernel_matrix_cuda(("WN",), p[:1], t, 1e-6, 4.0)
    with pytest.raises(ValueError):
        ck.kernel_matrix_cuda(("SE",), p, t.half(), 1e-6, 4.0)


GRAD_CASES = LEAF_CASES + CASES


def _abs_contraction(structure, p, t, G):
    """Σ |G| |∂k/∂θ| per parameter, the scale of the B1′ tolerance."""
    r = t[:, None] - t[None, :]
    out = []
    for m in range(p.shape[0]):
        e = torch.zeros_like(p)
        e[m] = 1.0
        _, dk = torch.func.jvp(lambda q: tk.evaluate(structure, q, r=r),
                               (p,), (e,))
        out.append((G.abs() * dk.abs()).sum())
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("structure,pars", GRAD_CASES)
def test_grad_kernel_matches_twin(structure, pars, dtype, cuda):
    """B1′ against autograd of the plain version, r = 0 included (the
    diagonal and a repeated time): |difference| ≤ 1e-12 (f64) or 1e-4
    (f32) of Σ |G| |∂k/∂θ| per parameter, since the two sum in other
    orders and take the derivatives by other operations."""
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for N in RAGGED_NS + (1000,):
        times = _times(N)
        if N > 5:
            times[5] = times[4]
        t = torch.tensor(times, dtype=dtype, device=cuda)
        p = torch.tensor(pars, dtype=dtype, device=cuda)
        G = torch.tensor(np.random.default_rng(N).standard_normal((N, N)),
                         dtype=dtype, device=cuda)
        before = ck.LAUNCHES["kernel_matrix_grad"]
        got = ck.kernel_matrix_grad_cuda(structure, p, t, G)
        assert ck.LAUNCHES["kernel_matrix_grad"] == before + 1
        ref = ck.kernel_matrix_grad_ref(structure, p, t, G)
        scale = _abs_contraction(structure, p, t, G)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= tol * scale).all()), \
            (structure, N, got, ref)
        # no atomics: a second call gives the same bits
        assert torch.equal(got, ck.kernel_matrix_grad_cuda(structure, p, t, G))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernel_takes_each_side_of_the_adjoint(dtype, cuda):
    """G is not symmetric: an adjoint that is 0 below the diagonal, and one
    that is 0 above it, each give their own contraction (the kernel weighs
    a lag with G[i, j] + G[j, i], it does not assume them equal)."""
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    structure, pars = ("QP",), (1.1, 20.0, 13.0, 0.6)
    for N in (33, 100, 257):
        t = torch.tensor(_times(N), dtype=dtype, device=cuda)
        p = torch.tensor(pars, dtype=dtype, device=cuda)
        G = torch.tensor(np.random.default_rng(N).standard_normal((N, N)),
                         dtype=dtype, device=cuda)
        for part in (torch.triu(G, 1), torch.tril(G, -1), G):
            got = ck.kernel_matrix_grad_cuda(structure, p, t, part)
            ref = ck.kernel_matrix_grad_ref(structure, p, t, part)
            scale = _abs_contraction(structure, p, t, G)
            assert bool(((got - ref).abs() <= tol * scale).all()), (N, got,
                                                                   ref)


@pytest.mark.cuda
def test_kernels_take_an_unaligned_buffer(cuda):
    """A matrix whose first byte is not on a 16-byte boundary takes the
    element-by-element path and gives the same values."""
    N = 64
    t = torch.tensor(_times(N), dtype=torch.float64, device=cuda)
    p = torch.tensor([1.1, 20.0, 13.0, 0.6], dtype=torch.float64, device=cuda)
    store = torch.tensor(np.random.default_rng(2).standard_normal(N * N + 1),
                         dtype=torch.float64, device=cuda)
    G = store[1:].view(N, N)
    assert G.data_ptr() % 16 == 8 and G.is_contiguous()
    torch.testing.assert_close(
        ck.kernel_matrix_grad_cuda(("QP",), p, t, G),
        ck.kernel_matrix_grad_cuda(("QP",), p, t, G.clone()),
        rtol=1e-13, atol=0)


STACK = [(("QP",), (1.1, 20.0, 13.0, 0.6)), (("SE",), (1.0, 30.0)),
         (("SE",), (1.05, 30.0)), (("SE",), (1.1, 30.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stack_matches_its_plain_version(dtype, cuda):
    """kernel_matrix_stack_cuda: one (B, N, N) buffer, B launches of B1, B
    of B1′ in the backward; values equal the single-matrix wrapper's to the
    bit, gradients agree with autograd of the plain version (float64 1e-11,
    float32 1e-3 of the largest entry: the jitter's trace term is summed in
    another order)."""
    structures = [s for s, _ in STACK]
    for N in (33, 256, 1000):
        t = torch.tensor(_times(N), dtype=dtype, device=cuda)
        G = torch.tensor(
            np.random.default_rng(N).standard_normal((len(STACK), N, N)),
            dtype=dtype, device=cuda)
        grads = {}
        for name, fn in (("cuda", ck.kernel_matrix_stack_cuda),
                         ("plain", ck.kernel_matrix_stack_ref)):
            params = [torch.tensor(pars, dtype=dtype, device=cuda,
                                   requires_grad=True) for _, pars in STACK]
            before = dict(ck.LAUNCHES)
            K = fn(structures, params, t, 1e-6, tlin.F32_JITTER_MULT)
            grads[name] = torch.autograd.grad(K, params, grad_outputs=G)
            launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
            expected = len(STACK) if name == "cuda" else 0
            assert launched == {"kernel_matrix": expected,
                                "kernel_matrix_grad": expected}
            if name == "cuda":
                assert K.shape == (len(STACK), N, N) and K.is_contiguous()
                for b, (s, p) in enumerate(zip(structures, params)):
                    assert torch.equal(K[b], ck.kernel_matrix_cuda(
                        s, p.detach(), t, 1e-6, tlin.F32_JITTER_MULT))
        tol = 1e-11 if dtype == torch.float64 else 1e-3
        for g, g_ref in zip(grads["cuda"], grads["plain"]):
            assert float((g - g_ref).abs().max()) <= \
                tol * float(g_ref.abs().max()), (N, g, g_ref)


@pytest.mark.cuda
def test_linalg_stack_dispatch(cuda):
    """ops/linalg.kernel_matrix_stack: the stacked function when the kernel
    supports every structure, matrix by matrix when one is not."""
    t = torch.tensor(_times(64), dtype=torch.float64, device=cuda)
    structures = [s for s, _ in STACK]
    params = [torch.tensor(pars, dtype=torch.float64, device=cuda)
              for _, pars in STACK]
    before = ck.LAUNCHES["kernel_matrix"]
    K = tlin.kernel_matrix_stack(structures, params, t)
    assert ck.LAUNCHES["kernel_matrix"] == before + 4
    for b in range(4):
        assert torch.equal(K[b], tlin.kernel_matrix(structures[b], params[b],
                                                    t))
    mixed = tlin.kernel_matrix_stack(
        structures[:2] + [("WN",)],
        params[:2] + [torch.tensor([0.3], dtype=torch.float64, device=cuda)],
        t)
    assert mixed.shape == (3, 64, 64) and torch.equal(mixed[:2], K[:2])


@pytest.mark.cuda
def test_kernel_backward_launches_the_grad_kernel(cuda):
    """Autograd through kernel_matrix_cuda reaches B1′ (and the jitter's
    trace(G)), and agrees with autograd through the plain version."""
    t = torch.tensor(_times(64), dtype=torch.float64, device=cuda)
    G = torch.tensor(np.random.default_rng(1).standard_normal((64, 64)),
                     dtype=torch.float64, device=cuda)
    for mult in (tlin.F32_JITTER_MULT, 1e9):     # nugget wins / scaled wins
        p = torch.tensor([1.1, 20.0, 13.0, 0.6], dtype=torch.float64,
                         device=cuda, requires_grad=True)
        before = dict(ck.LAUNCHES)
        K = ck.kernel_matrix_cuda(("QP",), p, t, 1e-6, mult)
        (g,) = torch.autograd.grad(K, p, grad_outputs=G)
        assert ck.LAUNCHES["kernel_matrix"] == before["kernel_matrix"] + 1
        assert ck.LAUNCHES["kernel_matrix_grad"] == \
            before["kernel_matrix_grad"] + 1
        p_ref = p.detach().requires_grad_(True)
        K_ref = ck.kernel_matrix_ref(("QP",), p_ref, t, 1e-6, mult)
        (g_ref,) = torch.autograd.grad(K_ref, p_ref, grad_outputs=G)
        torch.testing.assert_close(g, g_ref, rtol=1e-11, atol=1e-11)
    with pytest.raises(ValueError, match="t must not require grad"):
        ck.kernel_matrix_cuda(("QP",), p, t.clone().requires_grad_(True),
                              1e-6, 4.0)


@pytest.mark.cuda
def test_linalg_gradient_reaches_the_grad_kernel(cuda):
    """On a CUDA tensor the gradient of ops/linalg.kernel_matrix goes
    through B1′, never through the plain version's autograd."""
    t = torch.tensor(_times(64), dtype=torch.float64, device=cuda)
    p = torch.tensor([1.2, 8.0], dtype=torch.float64, device=cuda,
                     requires_grad=True)
    before = ck.LAUNCHES["kernel_matrix_grad"]
    K = tlin.kernel_matrix(("SE",), p, t)
    # K is slice 0 of the one-matrix stack the autograd Function returns
    assert K.grad_fn is not None
    nodes = [K.grad_fn] + [fn for fn, _ in K.grad_fn.next_functions]
    assert any("KernelMatrix" in type(fn).__name__ for fn in nodes)
    K.sum().backward()
    assert ck.LAUNCHES["kernel_matrix_grad"] == before + 1


@pytest.mark.cuda
def test_linalg_launches_the_kernel(cuda):
    t = torch.tensor(_times(64), dtype=torch.float64, device=cuda)
    before = ck.LAUNCHES["kernel_matrix"]
    tlin.kernel_matrix(("QP",), torch.tensor(
        [1.1, 20.0, 13.0, 0.6], dtype=torch.float64, device=cuda), t)
    tlin.kernel_matrix_plain(("SE",), torch.tensor(
        [1.0, 5.0], dtype=torch.float64, device=cuda), t)
    tlin.kernel_matrix(("WN",), torch.tensor(
        [0.3], dtype=torch.float64, device=cuda), t)      # plain path
    assert ck.LAUNCHES["kernel_matrix"] == before + 2


def _model(device):
    rng = np.random.default_rng(4)
    N = 48
    t = np.sort(rng.uniform(0, 60, N))
    data = []
    for i in range(3):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gt.inference(2, t, *data, device=device)
    g.set_components(
        [gt.covfunc.Periodic(1.0, 9.0, 0.6), gt.covfunc.Matern52(1.0, 5.0)],
        [gt.covfunc.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
         for k in range(6)],
        [gt.meanfunc.Linear(0.01, 0.0) for _ in range(3)], [0.1, 0.12, 0.14])
    return g


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu(cuda):
    g_gpu, g_cpu = _model(cuda), _model("cpu")
    before = ck.LAUNCHES["kernel_matrix"]
    e_gpu, mu_gpu, var_gpu, it_gpu = g_gpu.ELBOcalc()
    assert ck.LAUNCHES["kernel_matrix"] == before + 2 + 6
    e_cpu, mu_cpu, var_cpu, it_cpu = g_cpu.ELBOcalc()
    assert it_gpu == it_cpu
    assert abs(e_gpu - e_cpu) <= 1e-9 * abs(e_cpu)
    for a, b in ((mu_gpu, mu_cpu), (var_gpu, var_cpu)):
        assert mu_gpu.device.type == "cuda"
        err = (a.cpu() - b).abs().max() / (1 + b.abs().max())
        assert float(err) <= 1e-7
    _, m_gpu, s_gpu, _ = g_gpu.predict(nn=64)
    _, m_cpu, s_cpu, _ = g_cpu.predict(nn=64)
    torch.testing.assert_close(m_gpu.cpu(), m_cpu, rtol=1e-7, atol=1e-7)
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, rtol=1e-7, atol=1e-7)


@pytest.mark.cuda
def test_gradient_path_on_card_matches_cpu(cuda):
    """elbo_value_and_grad of the same model on the card and on the CPU:
    value relative 1e-9, gradient 1e-7 of max |g|; B1 and B1′ each run
    q + q·p = 8 times per call."""
    values = {}
    for device in (cuda, "cpu"):
        g = _model(device)
        theta = g._theta()
        mu0, var0 = g.engine.init_mu_var(theta, g._tensor(g.y))
        before = dict(ck.LAUNCHES)
        values[str(device)] = g.engine.elbo_value_and_grad(
            theta, *g._data(), mu0, var0, 3)
        launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
        expected = 8 if device == cuda else 0
        assert launched == {"kernel_matrix": expected,
                            "kernel_matrix_grad": expected}
    (v_gpu, g_gpu), (v_cpu, g_cpu) = values["cuda"], values["cpu"]
    assert abs(float(v_gpu) - float(v_cpu)) <= 1e-9 * abs(float(v_cpu))
    assert float((g_gpu.cpu() - g_cpu).abs().max()) <= \
        1e-7 * float(g_cpu.abs().max())
