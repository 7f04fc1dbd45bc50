"""gpyrn_tpu_torch on the card: the CUDA kernel-matrix kernel (B1) and its
backward (B1′) against their plain twins (ragged sizes, exact symmetry,
a non-symmetric adjoint, the same bits from run to run), the stacked
function and its backward, and the main path, the gradient path, the
converged-state paths and the batched paths (the θ-batched fit,
``optimize_device``, the samplers, ``batch_elbo``) on the card against the
same on the CPU; the θ-batched fit's count of host reads against the syncs
torch sees.

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
from gpyrn_tpu_torch.ops import iterative as ti
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
                                "kernel_matrix_grad": expected,
                                "kernel_matvec": 0}
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_match_their_plain_version(dtype, cuda):
    """kernel_matrix_rows_cuda: one (W, S, N, N) buffer, W·S launches of
    B1 and of B1′ in the backward; each row equals the one-row stack to the
    bit, values and gradients agree with the plain version (gradients as
    in the stack's test)."""
    structures = [s for s, _ in STACK]
    W, S = 5, len(STACK)
    rng = np.random.default_rng(W)
    base = [np.asarray(pars) * np.exp(0.1 * rng.standard_normal(
        (W, len(pars)))) for _, pars in STACK]
    for N in (33, 1000):
        t = torch.tensor(_times(N), dtype=dtype, device=cuda)
        G = torch.tensor(rng.standard_normal((W, S, N, N)), dtype=dtype,
                         device=cuda)
        out = {}
        for name, fn in (("cuda", ck.kernel_matrix_rows_cuda),
                         ("plain", ck.kernel_matrix_rows_ref)):
            rows = [torch.tensor(b, dtype=dtype, device=cuda,
                                 requires_grad=True) for b in base]
            before = dict(ck.LAUNCHES)
            K = fn(structures, rows, t, 1e-6, tlin.F32_JITTER_MULT)
            grads = torch.autograd.grad(K, rows, grad_outputs=G)
            launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
            expected = W * S if name == "cuda" else 0
            assert launched == {"kernel_matrix": expected,
                                "kernel_matrix_grad": expected,
                                "kernel_matvec": 0}
            out[name] = (K.detach(), grads)
        (K, g), (R, g_ref) = out["cuda"], out["plain"]
        assert K.shape == (W, S, N, N) and K.is_contiguous()
        rtol, atol = ((1e-12, 1e-14) if dtype == torch.float64
                      else (2e-6, 1e-6))
        assert bool(((K - R).abs() <= atol * R.abs().amax()
                     + rtol * R.abs()).all())
        for w in range(W):
            assert torch.equal(K[w], ck.kernel_matrix_stack_cuda(
                structures, [torch.tensor(b[w], dtype=dtype, device=cuda)
                             for b in base], t, 1e-6, tlin.F32_JITTER_MULT))
        tol = 1e-11 if dtype == torch.float64 else 1e-3
        for a, b in zip(g, g_ref):
            assert float((a - b).abs().max()) <= \
                tol * float(b.abs().max()), (N, a, b)


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


def _model(device, N=48):
    """The flagship (``rv3-2node``'s structure and parameters), q = 2."""
    rng = np.random.default_rng(4)
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
                            "kernel_matrix_grad": expected,
                            "kernel_matvec": 0}
    (v_gpu, g_gpu), (v_cpu, g_cpu) = values["cuda"], values["cpu"]
    assert abs(float(v_gpu) - float(v_cpu)) <= 1e-9 * abs(float(v_cpu))
    assert float((g_gpu.cpu() - g_cpu).abs().max()) <= \
        1e-7 * float(g_cpu.abs().max())


def _headline_small(device, N=64):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, N))
    data = []
    for i in range(3):
        data += [np.sin(2 * np.pi * t / (20 + 5 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gt.inference(1, t, *data, device=device)
    g.set_components([gt.covfunc.QuasiPeriodic(1.0, 30.0, 20.0, 0.7)],
                     [gt.covfunc.SquaredExponential(1.0 + 0.05 * k, 30.0)
                      for k in range(3)], [None] * 3, [0.1] * 3)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_nugget_stack_on_card_matches_plain(dtype, cuda):
    """``kernel_matrix_stack(jitter_mult=0)`` on a CUDA tensor: one B1
    launch per matrix into one buffer, equal to the plain version (B1's
    tolerances) with k(0) + nugget exactly on the diagonal."""
    rtol, atol = (1e-12, 1e-14) if dtype == torch.float64 else (2e-6, 1e-6)
    structures = [("QP",)] + [("SE",)] * 3
    pars = [(1.0, 30.0, 20.0, 0.7)] + [(1.0 + 0.05 * k, 30.0)
                                       for k in range(3)]
    t = torch.tensor(_times(257), dtype=dtype, device=cuda)
    params = [torch.tensor(q, dtype=dtype, device=cuda) for q in pars]
    before = ck.LAUNCHES["kernel_matrix"]
    K = tlin.kernel_matrix_stack(structures, params, t, 1e-6,
                                 jitter_mult=0.0)
    assert ck.LAUNCHES["kernel_matrix"] == before + 4
    R = ck.kernel_matrix_stack_ref(structures, params, t, 1e-6, 0.0)
    assert K.shape == (4, 257, 257) and K.is_contiguous()
    torch.testing.assert_close(K, R, rtol=rtol, atol=atol)
    assert torch.equal(torch.diagonal(K, dim1=1, dim2=2),
                       torch.diagonal(R, dim1=1, dim2=2))


@pytest.mark.cuda
def test_mixed_fit_on_card_matches_cpu(cuda):
    """The mixed fit polished to the float64 fixed point lands on the same
    ELBO on the card and on the CPU (relative 1e-7; the float32 bulks
    differ by rounding), and launches B1 for the jittered and the
    exact-nugget float32 lattices and once per float64 polish call."""
    out = {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        g.refine_sweeps, g.refine_tol = 'converge', 1e-10
        before = ck.LAUNCHES["kernel_matrix"]
        elbo, mu, var, n_iter = g.ELBOcalc(precision='mixed')
        launched = ck.LAUNCHES["kernel_matrix"] - before
        polish = g.mixed_info["polish_sweeps"]
        assert launched == (4 * (2 + polish) if device == cuda else 0)
        assert mu.dtype == torch.float64 and mu.device.type == str(
            device).split(":")[0]
        assert g.mixed_info["nonfinite_merits"] == 0
        out[str(device)] = elbo
    assert abs(out["cuda"] - out["cpu"]) <= 1e-7 * abs(out["cpu"])


@pytest.mark.cuda
def test_implicit_gradient_on_card_matches_cpu(cuda):
    """``elbo_grad(method='implicit')`` on the card and on the CPU: value
    relative 1e-9, gradient 1e-6 of max |g| (two GMRES runs, each held to
    1e-10); B1′ runs for 2 pull-backs × 4 matrices, whatever the number of
    Krylov steps."""
    out = {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        before = dict(ck.LAUNCHES)
        out[str(device)] = g.elbo_grad(method='implicit', fit_max_iter=4000)
        launched = {k: ck.LAUNCHES[k] - before[k] for k in before}
        expected = 8 if device == cuda else 0
        assert launched == {"kernel_matrix": expected,
                            "kernel_matrix_grad": expected,
                            "kernel_matvec": 0}
        assert g.implicit_info["pullbacks"] > 4
        assert g.implicit_info["adjoint_residual"] < 1e-10
        assert g._mu.device.type == str(device).split(":")[0]
    (v_gpu, g_gpu), (v_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(v_gpu - v_cpu) <= 1e-9 * abs(v_cpu)
    assert np.max(np.abs(g_gpu - g_cpu)) <= 1e-6 * np.max(np.abs(g_cpu))


def _rows(g, rows=4, seed=3):
    theta0 = g.get_parameters(include_frozen=True)
    out = theta0[None, :] * np.exp(
        0.1 * np.random.default_rng(seed).standard_normal((rows,
                                                            theta0.size)))
    out[0] = theta0
    return out


@pytest.mark.cuda
def test_batched_fit_on_card_matches_cpu(cuda):
    """``elbo_fit_batch`` of four rows on the card and on the CPU: ELBO
    relative 1e-9, state 1e-7, equal sweep counts; B1 runs once per matrix
    of every row, into one buffer."""
    out = {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        eng, data = g.engine, g._data()
        thetas = g._tensor(_rows(g))
        mu0, var0 = eng.init_mu_var(thetas, data[1])
        before = ck.LAUNCHES["kernel_matrix"]
        res = eng.elbo_fit_batch(thetas, *data, mu0, var0, 200)
        launched = ck.LAUNCHES["kernel_matrix"] - before
        assert launched == (16 if device == cuda else 0)
        assert res[0].device.type == str(device).split(":")[0]
        out[str(device)] = [r.cpu() for r in res]
        fixed = eng.elbo_fixed_batch(thetas, *data, mu0, var0, 3)
        for w in range(4):
            one = eng.elbo_fixed(thetas[w], *data, mu0[w], var0[w], 3)
            assert abs(float(fixed[w] - one)) <= 1e-9 * abs(float(one))
    (e, mu, var, n, c), (e_c, mu_c, var_c, n_c, c_c) = out["cuda"], \
        out["cpu"]
    assert torch.equal(n, n_c) and torch.equal(c, c_c)
    torch.testing.assert_close(e, e_c, rtol=1e-9, atol=0)
    for a, b in ((mu, mu_c), (var, var_c)):
        assert float((a - b).abs().max() / (1 + b.abs().max())) <= 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_headline_small, _model])
def test_batched_fit_host_reads_are_its_syncs(make, cuda):
    """``elbo_fit_batch`` of twelve rows (q = 1 and q = 2) under
    ``set_sync_debug_mode("warn")``: torch warns once for each call that
    synchronizes, and ``gprn.batch.host_reads`` rose by as many, so the
    counter's call sites are all the loop's syncs.  A first fit runs under
    the mode uncounted, so that one-off syncs of the mode's first use are
    not the fit's."""
    import warnings

    from gpyrn_tpu_torch.utils import profiling
    g = make(cuda)
    eng, data = g.engine, g._data()
    thetas = g._tensor(_rows(g, rows=12, seed=5))
    mu0, var0 = eng.init_mu_var(thetas, data[1])
    torch.cuda.synchronize()
    got = []
    try:
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(2):
            before = profiling.counts()["gprn.batch.host_reads"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = eng.elbo_fit_batch(thetas, *data, mu0, var0, 200)
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            got.append((profiling.counts()["gprn.batch.host_reads"]
                        - before, len(syncs)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reads, syncs = got[1]
    assert len(set(out[3].tolist())) >= 2      # rows stopped apart
    assert reads == syncs > 0


# what the libraries may not do inside a batched sweep: MAGMA's kernels
# (torch's batched cholesky_solve, and solve_triangular of more than 8
# matrices wider than 512), and device allocations past the first sweep;
# beside them the calls that can wait for the device, counted
MAGMA_MARKS = ("magma", "dtrsv_")
SWEEP_CALLS = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize",
               "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpyAsync")


def sweep_library_calls(g, rows=26, max_iter=12, seed=5, takes=4):
    """One batch of ``rows`` rows (``_rows``' spread) of ``g``'s model,
    ``elbo_fit_batch`` from the heuristic start to ``max_iter`` sweeps,
    traced by ``torch.profiler`` after the same batch ran untraced (so the
    caching allocator holds the batch's blocks).  Returns the number of
    traced ``gprn.sweep`` spans, the MAGMA kernels of the trace (names with
    one of ``MAGMA_MARKS``), and for each of ``SWEEP_CALLS`` the calls
    inside the first sweep and inside the later ones.  A trace without
    device records is taken again, up to ``takes`` times."""
    from torch.profiler import ProfilerActivity, profile
    eng, data = g.engine, g._data()
    thetas = g._tensor(_rows(g, rows=rows, seed=seed))
    mu0, var0 = eng.init_mu_var(thetas, data[1])
    eng.elbo_fit_batch(thetas, *data, mu0, var0, max_iter)
    torch.cuda.synchronize()
    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.elbo_fit_batch(thetas, *data, mu0, var0, max_iter)
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        kernels = [e.name() for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert kernels, "the profiler recorded no device event"
    # the host's spans (the profiler mirrors each on the device's timeline)
    sweeps = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name() == "gprn.sweep"
                    and e.device_type() == torch.autograd.DeviceType.CPU)
    out = {"sweeps": len(sweeps), "kernels": len(kernels),
           "magma_kernels": sum(any(m in k for m in MAGMA_MARKS)
                                for k in kernels)}
    for name in SWEEP_CALLS:
        inside = [sum(s <= e.start_ns() < t for e in events
                      if e.name() == name) for s, t in sweeps]
        out[name] = (inside[0], sum(inside[1:])) if inside else (0, 0)
    # what each copy after the first sweep was (the device's record of the
    # call) and the innermost operator that made it
    cpu = torch.autograd.DeviceType.CPU
    device = {e.correlation_id(): e.name() for e in events
              if e.device_type() != cpu}
    ops = [e for e in events if e.device_type() == cpu
           and not e.name().startswith(("cuda", "gprn."))]
    kinds = {}
    for e in events:
        if e.name() != "cudaMemcpyAsync" or not any(
                s <= e.start_ns() < t for s, t in sweeps[1:]):
            continue
        around = [o for o in ops if o.start_ns() <= e.start_ns()
                  <= o.start_ns() + o.duration_ns()]
        op = min(around, key=lambda o: o.duration_ns()).name() \
            if around else "?"
        key = f"{device.get(e.correlation_id(), '?')} in {op}"
        kinds[key] = kinds.get(key, 0) + 1
    out["copies"] = kinds
    return out


@pytest.mark.cuda
def test_search_batch_calls_no_library_solver(cuda):
    """One batch of ``rv3-2node.search26``'s shape (the flagship, q = 2,
    26 rows, N = 1000, float64) under ``torch.profiler``: no MAGMA kernel,
    and no ``cudaMalloc`` / ``cudaFree`` inside a ``gprn.sweep`` after the
    first.  Prints the counts (``-s``), the syncs inside the sweeps
    among them."""
    got = sweep_library_calls(_model(cuda, N=1000))
    print(f"\nsearch26-shaped batch: {got}")
    assert got["sweeps"] > 1 and got["kernels"] > 0
    assert got["magma_kernels"] == 0
    assert got["cudaMalloc"][1] == got["cudaFree"][1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_restarts", [1, 2])
def test_optimize_device_on_card_matches_cpu(n_restarts, cuda):
    out = {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        out[str(device)] = g.optimize_device(n_sweeps=3, max_iter=10,
                                             n_restarts=n_restarts)
    got, ref = out["cuda"], out["cpu"]
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-8)
    assert (got["nit"], got["nfev"]) == (ref["nit"], ref["nfev"])
    assert abs(got["elbo"] - ref["elbo"]) <= 1e-9 * abs(ref["elbo"])


@pytest.mark.cuda
def test_samplers_on_card(cuda):
    """The host loop with scipy priors gives the CPU's chain; the device
    chain draws on the card and gives finite log-probabilities; the
    evidence batch equals the CPU's."""
    from scipy import stats

    from gpyrn_tpu_torch.inference import priors as tpri
    from gpyrn_tpu_torch.inference.evidence import batch_elbo
    chains, elbos = {}, {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        priors = {n: stats.lognorm(s=0.3, scale=v)
                  for n, v in g.parameters_dict.items()}
        chains[str(device)] = g.mcmc(priors, p0=g.get_parameters(), niter=2,
                                     elbo_max_iter=30, seed=1)
        elbos[str(device)] = batch_elbo(g, _rows(g, 3), max_iter=30)
    np.testing.assert_allclose(chains["cuda"].chain, chains["cpu"].chain,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(chains["cuda"].log_prob,
                               chains["cpu"].log_prob, rtol=1e-8)
    np.testing.assert_allclose(elbos["cuda"], elbos["cpu"], rtol=1e-9)
    g = _headline_small(cuda)
    priors = {n: tpri.LogNormal(np.log(v), 0.3)
              for n, v in g.parameters_dict.items()}
    res = g.mcmc(priors, p0=g.get_parameters(), niter=3, elbo_max_iter=30,
                 seed=1, check_every=2)
    assert res.chain.shape == (3, 26, 13)
    assert np.all(np.isfinite(res.log_prob)) and 0 <= res.acceptance <= 1


@pytest.mark.cuda
def test_batched_backward_launches_per_row_and_structure(cuda):
    """The backward of a (W, S, N, N) lattice launches B1′ W·S times, and
    the θ-batched ELBO's gradient W·4 times (headline structures)."""
    t = torch.tensor(_times(64), device=cuda)
    structures = [("QP",)] + [("SE",)] * 3
    rng = np.random.default_rng(2)
    W = 3
    params = [torch.tensor(np.asarray(p) * np.exp(0.1 * rng.standard_normal(
        (W, len(p)))), device=cuda, requires_grad=True)
        for p in [(1.0, 30.0, 20.0, 0.7)] + [(1.0, 30.0)] * 3]
    K = tlin.kernel_matrix_rows(structures, params, t)
    before = ck.LAUNCHES["kernel_matrix_grad"]
    torch.autograd.grad(K.sum(), params)
    assert ck.LAUNCHES["kernel_matrix_grad"] - before == W * len(structures)
    g = _headline_small(cuda)
    eng, data = g.engine, g._data()
    thetas = g._tensor(_rows(g, W)).requires_grad_(True)
    mu0, var0 = eng.init_mu_var(thetas.detach(), data[1])
    before = ck.LAUNCHES["kernel_matrix_grad"]
    with torch.enable_grad():
        elbo = eng.elbo_fixed_batch(thetas, *data, mu0, var0, 3)
        torch.autograd.grad(elbo.sum(), thetas)
    assert ck.LAUNCHES["kernel_matrix_grad"] - before == 4 * W


@pytest.mark.cuda
def test_hmc_log_posterior_gradient_on_card_matches_cpu(cuda):
    """The HMC log-posterior of 3 chains and its gradient on the card
    equal the CPU's: values rel 1e-10, gradients 1e-9 of max |g|."""
    from gpyrn_tpu_torch.inference import hmc as thmc
    from gpyrn_tpu_torch.inference import priors as tpri
    out = {}
    for device in (cuda, "cpu"):
        g = _headline_small(device)
        g.ELBOcalc()
        names = list(g.parameters_dict)
        priors = [tpri.LogNormal(np.log(v), 0.3)
                  for v in g.parameters_dict.values()]
        _, vg = thmc._log_posterior(g, priors, np.arange(len(names)), 3)
        z = g._tensor(np.log(g.get_parameters())[None, :] + 0.01 *
                      np.random.default_rng(4).standard_normal((3, 13)))
        out[str(device)] = [a.cpu() for a in vg(z)]
    (v, gr), (v_c, g_c) = out["cuda"], out["cpu"]
    torch.testing.assert_close(v, v_c, rtol=1e-10, atol=0)
    assert float((gr - g_c).abs().max() / g_c.abs().max()) <= 1e-9


@pytest.mark.cuda
def test_lean_sweeps_launch_one_build_per_gp_and_match_cpu(cuda):
    """The lean engines on the card: B1 once per GP for an updates-only
    sweep and for an ELBO sweep, twice for a weight GP at q > 1 (the
    raw-flatten pairing's second pass); the ELBO and state equal the
    CPU's (rel 1e-10, state 1e-9)."""
    from chip_smoke import flagship_problem
    for make, n_gp, n_builds in ((_headline_small, 4, 4),
                                 (lambda d: flagship_problem(gt, N=80,
                                                             device=d),
                                  8, 2 + 2 * 6)):
        out = {}
        for device in (cuda, "cpu"):
            g = make(device)
            eng, theta, data = g.engine, g._theta(), g._data()
            mu0, var0 = eng.init_mu_var(theta, data[1])
            before = ck.LAUNCHES["kernel_matrix"]
            mu, var, _, _ = eng.fit_state_lean(theta, *data, mu0, var0, 2,
                                               0.0)
            updates = ck.LAUNCHES["kernel_matrix"] - before
            before = ck.LAUNCHES["kernel_matrix"]
            elbo, mu, var = eng.elbo_refine_lean(theta, *data, mu0, var0, 1)
            full = ck.LAUNCHES["kernel_matrix"] - before
            out[str(device)] = (float(elbo), mu.cpu(), updates, full)
        e, mu, updates, full = out["cuda"]
        e_c, mu_c, _, _ = out["cpu"]
        assert (updates, full) == (2 * n_gp, n_builds)
        assert abs(e - e_c) <= 1e-10 * abs(e_c)
        assert float((mu - mu_c).abs().max() / (1 + mu_c.abs().max())) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matvec_on_card_matches_cpu(cuda, dtype):
    """ops/iterative.kernel_matvec (B1's product entry) on the card equals
    the CPU's (the plain version, ragged last chunk): 1e-12 of max |y| in
    float64, 1e-5 in float32."""
    t = np.sort(np.random.default_rng(5).uniform(0, 100, 3001))
    v = np.random.default_rng(6).standard_normal((3001, 2))
    pars = (1.0, 30.0, 20.0, 0.7)
    ys = [ti.kernel_matvec(("QP",), torch.tensor(pars, dtype=dtype,
                                                 device=d),
                           torch.tensor(t, dtype=dtype, device=d),
                           torch.tensor(v, dtype=dtype, device=d),
                           nugget=1e-2, chunk=1024).cpu()
          for d in (cuda, "cpu")]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((ys[0] - ys[1]).abs().max()) <= tol * float(
        ys[1].abs().max())


@pytest.mark.cuda
def test_batched_solve_past_magmas_limit(cuda):
    """Above BATCHED_SOLVE_MAX_N the engine's solves take each matrix of
    a batch alone (MAGMA's batched potrs fails there): a batch of two at
    N=7000 equals two single solves."""
    from gpyrn_tpu_torch.models import gprn as tg
    N = 7000
    assert N > tg.BATCHED_SOLVE_MAX_N
    t = torch.tensor(np.sort(np.random.default_rng(7).uniform(0, 100, N)),
                     dtype=torch.float64, device=cuda)
    K = tlin.kernel_matrix_stack([("SE",), ("M52",)],
                                 [torch.tensor(p, dtype=torch.float64)
                                  for p in ((1.0, 3.0), (1.0, 2.0))], t)
    L = torch.linalg.cholesky(K + 0.1 * torch.eye(N, dtype=K.dtype,
                                                  device=cuda))
    b = torch.ones((2, N), dtype=torch.float64, device=cuda)
    x = tg._cho_solve(L, b)
    for i in range(2):
        torch.testing.assert_close(
            x[i], torch.cholesky_solve(b[i][:, None], L[i])[:, 0],
            rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_custom_op_equals_the_stack_kernel(dtype, cuda):
    """``gpyrn_torch::kernel_matrix_stack`` (the exported program's B1)
    launches B1 as ``kernel_matrix_stack_cuda`` does: the same bits, one
    launch per matrix; and it agrees with the plain version to B1's
    tolerances (rtol, atol of max |ref|)."""
    structures = [("QP",), ("SE",), ("+", ("SE",), ("M32",))]
    pars = [(1.1, 20.0, 13.0, 0.6), (1.2, 8.0), (1.0, 8.0, 0.5, 3.0)]
    t = torch.tensor(_times(1000), dtype=dtype, device=cuda)
    params = [torch.tensor(p, dtype=dtype, device=cuda) for p in pars]
    for mult in (tlin.F32_JITTER_MULT, 0.0):
        before = ck.LAUNCHES["kernel_matrix"]
        got = ck.kernel_matrix_stack_op(structures, params, t, 1e-6, mult)
        assert ck.LAUNCHES["kernel_matrix"] == before + 3
        ref = ck.kernel_matrix_stack_cuda(structures, params, t, 1e-6, mult)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        plain = ck.kernel_matrix_stack_ref(structures, params, t, 1e-6, mult)
        rtol, atol = ((1e-12, 1e-14) if dtype == torch.float64
                      else (2e-6, 1e-6))
        assert bool(((got - plain).abs() <= atol * plain.abs().amax()
                     + rtol * plain.abs()).all())


@pytest.mark.cuda
def test_artifact_exported_on_card_equals_predict(cuda, tmp_path):
    """An artifact exported on the card serves there: B1 launches in every
    request (one per matrix of the lattice), and the outputs equal the
    in-process predict."""
    from gpyrn_tpu_torch import serving
    g = _headline_small(cuda)
    g.ELBOcalc()
    path = str(tmp_path / "predict.pt2")
    assert g.export_predict(path) > 0
    serve = serving.load_predict(path)
    assert serve.device.type == "cuda"
    for n in (1, 64, 300):
        tstar = np.linspace(-20.0, 120.0, n)
        before = ck.LAUNCHES["kernel_matrix"]
        out = serve(tstar)
        assert ck.LAUNCHES["kernel_matrix"] == before + 4
        mean, var, (npred, wpred) = g._Prediction(tstar=tstar, separate=True)
        for got, ref in zip(out, (mean, var, npred, wpred)):
            torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


# B1's slab entry: a single leaf, a pair, a composite (the interpreter);
# N=300 padded to 384, the first 96-row slab and the ragged last one
SLAB_CASES = [CASES[1], CASES[4], CASES[6]]
SLAB_N, SLAB_PAD, SLAB_ROWS = 300, 384, 96


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("structure,pars", SLAB_CASES)
def test_slab_entry_equals_b1_rows_and_twin(structure, pars, dtype, cuda):
    """Inside the N × N matrix the slab equals the same rows of B1's full
    matrix bit for bit (jitter 1e-6 on the diagonal); identity in the
    padding; the plain version at B1's tolerances."""
    rtol, atol = (1e-12, 1e-14) if dtype == torch.float64 else (2e-6, 1e-6)
    t = torch.tensor(_times(SLAB_N), dtype=dtype, device=cuda)
    p = torch.tensor(pars, dtype=dtype, device=cuda)
    jit = torch.tensor(1e-6, dtype=dtype, device=cuda)
    full = ck.kernel_matrix_cuda(structure, p, t, 1e-6, 0.0)
    k0 = abs(float(tk.evaluate(structure, p, r=torch.zeros(
        (), dtype=dtype, device=cuda))))
    eye = torch.eye(SLAB_PAD, dtype=dtype, device=cuda)
    for r0 in (0, SLAB_PAD - SLAB_ROWS):
        before = ck.LAUNCHES["kernel_matrix"]
        got = ck.kernel_matrix_slab_cuda(structure, p, t, SLAB_PAD, r0,
                                         SLAB_ROWS, jit)
        assert ck.LAUNCHES["kernel_matrix"] == before + 1
        torch.cuda.synchronize()
        nv = max(0, min(SLAB_ROWS, SLAB_N - r0))
        assert torch.equal(got[:nv, :SLAB_N], full[r0:r0 + nv])
        rows = eye[r0:r0 + SLAB_ROWS]
        assert torch.equal(got[:, SLAB_N:], rows[:, SLAB_N:])
        assert torch.equal(got[nv:], rows[nv:])
        ref = ck.kernel_matrix_slab_ref(structure, p, t, SLAB_PAD, r0,
                                        SLAB_ROWS, jit)
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol * k0)


@pytest.mark.cuda
def test_panel_refine_on_one_nccl_rank_equals_lean(cuda):
    """The panel engine on a one-rank NCCL mesh, its slabs from B1's slab
    entry, against the lean engine: ELBO relative 1e-9, state 1e-8."""
    from gpyrn_tpu_torch.parallel.mesh import spawn
    from tests.torch_parallel_jobs import nccl_panel_job
    (out,) = spawn(nccl_panel_job, 1, "nccl", "cuda", timeout=300.0)
    (e_l, mu_l, var_l), (e_p, mu_p, var_p) = out["lean"], out["panel"]
    assert out["backend"] == "nccl" and out["launches"] > 0
    assert abs(float(e_p) - float(e_l)) <= 1e-9 * abs(float(e_l))
    for a, b in ((mu_p, mu_l), (var_p, var_l)):
        assert np.max(np.abs(a - b)) <= 1e-8 * (1 + np.max(np.abs(b)))


# B1's product entry: a single leaf, a pair, a composite (the interpreter);
# N around the tiles (32), the register path's rows (128) and steps (256),
# 4097 with several column groups; m = 1 and 8 (the register path's two
# instances), then the tiled path: MATVEC_CAP + 1, 64 (one whole column
# tile), 257 (a ragged column tile, V not in 16-byte groups)
MATVEC_CASES = [CASES[0], CASES[1], CASES[4], CASES[6]]
MATVEC_NS = (1, 33, 300, 1000, 4097)
MATVEC_COLS = (1, 8, ck.MATVEC_CAP + 1, 64, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("structure,pars", MATVEC_CASES)
def test_product_entry_matches_twin(structure, pars, dtype, cuda):
    """The product entry against its plain version, 1e-12 (float64) or
    1e-5 (float32) of max |y| (the sums run in another order); one launch
    a call; a second call gives the same bits; the rows of a slab from
    row 0 and of the ragged last one equal the whole product's bit for
    bit."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    p = torch.tensor(pars, dtype=dtype, device=cuda)
    for N in MATVEC_NS:
        t = torch.tensor(_times(N), dtype=dtype, device=cuda)
        rng = np.random.default_rng(N)
        for m in MATVEC_COLS:
            v = torch.tensor(rng.standard_normal((N, m)), dtype=dtype,
                             device=cuda)
            before = ck.LAUNCHES["kernel_matvec"]
            y = ck.kernel_matvec_cuda(structure, p, t, v, 0.3)
            assert ck.LAUNCHES["kernel_matvec"] == before + 1
            ref = ck.kernel_matvec_ref(structure, p, t, v, 0.3)
            torch.cuda.synchronize()
            assert y.shape == (N, m)
            assert float((y - ref).abs().max()) <= tol * float(
                ref.abs().max()), (N, m)
            assert torch.equal(y, ck.kernel_matvec_cuda(structure, p, t, v,
                                                        0.3))
            rows = max(1, N // 3)
            for r0 in (0, N - rows):
                assert torch.equal(ck.kernel_matvec_cuda(
                    structure, p, t, v, 0.3, r0, rows), y[r0:r0 + rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_product_entry_many_column_tiles(dtype, cuda):
    """The tiled path over ten column tiles, the last ragged: the plain
    version's values, 1e-12 (float64) or 1e-5 (float32) of max |y|; a
    slab's rows bit for bit."""
    N, m = 300, 9 * ck.MATVEC_TILE_COLS[dtype] + 5
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    p = torch.tensor(CASES[1][1], dtype=dtype, device=cuda)
    t = torch.tensor(_times(N), dtype=dtype, device=cuda)
    v = torch.tensor(np.random.default_rng(8).standard_normal((N, m)),
                     dtype=dtype, device=cuda)
    y = ck.kernel_matvec_cuda(("QP",), p, t, v, 0.3)
    ref = ck.kernel_matvec_ref(("QP",), p, t, v, 0.3)
    torch.cuda.synchronize()
    assert float((y - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(ck.kernel_matvec_cuda(("QP",), p, t, v, 0.3, 100, 77),
                       y[100:177])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, ck.MATVEC_CAP + 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_slab_matvec_rows_equal_kernel_matvec_rows(dtype, m, cuda):
    """One rank's rows of the sharded CG's product (``slab_matvec``) equal
    the same rows of ``kernel_matvec``'s bit for bit, on the register path
    (m = 2) and the tiled path (m above the cap)."""
    from gpyrn_tpu_torch.parallel.iterative_sharded import slab_matvec
    N = 5000
    t = torch.tensor(_times(N), dtype=dtype, device=cuda)
    p = torch.tensor(CASES[1][1], dtype=dtype, device=cuda)
    x = torch.tensor(np.random.default_rng(2).standard_normal((N, m)),
                     dtype=dtype, device=cuda)
    whole = ti.kernel_matvec(("QP",), p, t, x)
    for r0, n_rows in ((0, 1250), (3750, 1250), (1234, 777)):
        assert torch.equal(slab_matvec(("QP",), p, t, x, r0, n_rows),
                           whole[r0:r0 + n_rows])


@pytest.mark.cuda
def test_cg_and_prediction_launch_the_product_entry(cuda):
    """``cg_solve`` on ``kernel_matvec`` launches the product entry once
    per iteration; ``predict_iterative`` launches it."""
    from gpyrn_tpu_torch.models.iterative import predict_iterative
    N = 500
    t = torch.tensor(_times(N), dtype=torch.float64, device=cuda)
    p = torch.tensor(CASES[1][1], dtype=torch.float64, device=cuda)
    b = torch.tensor(np.random.default_rng(3).standard_normal(N),
                     dtype=torch.float64, device=cuda)
    before = ck.LAUNCHES["kernel_matvec"]
    x, it = ti.cg_solve(lambda v: ti.kernel_matvec(("QP",), p, t, v,
                                                   nugget=0.1), b,
                        tol=1e-8, maxiter=200)
    assert it > 0 and ck.LAUNCHES["kernel_matvec"] - before == it
    g = _headline_small(cuda)
    g.ELBOcalc()
    before = ck.LAUNCHES["kernel_matvec"]
    _, mean, std, _ = predict_iterative(g, nn=50)
    assert ck.LAUNCHES["kernel_matvec"] > before
    assert bool(torch.isfinite(torch.as_tensor(mean)).all())
