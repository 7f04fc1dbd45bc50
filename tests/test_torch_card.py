"""gpyrn_tpu_torch on the card: the CUDA kernel-matrix kernel against its
plain twin, and the main path on the card against the same on the CPU.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports no jax, so the card's machine runs it
without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""
import numpy as np
import pytest
import torch

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
    for N in (1, 3, 31, 33, 255, 257, 1000):
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


@pytest.mark.cuda
def test_kernel_has_no_backward(cuda):
    t = torch.tensor(_times(20), dtype=torch.float64, device=cuda)
    p = torch.tensor([1.2, 8.0], dtype=torch.float64, device=cuda,
                     requires_grad=True)
    K = ck.kernel_matrix_cuda(("SE",), p, t, 1e-6, 4.0)
    with pytest.raises(NotImplementedError):
        K.sum().backward()


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
