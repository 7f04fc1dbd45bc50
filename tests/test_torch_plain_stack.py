"""``kernel_matrix_stack`` of gpyrn_tpu_torch with the exact nugget
(``jitter_mult=0``): the lattice of the updates-only fits.

Against the port's own per-matrix ``kernel_matrix_plain`` (equal to the
bit: the same operations) and against
``gpyrn_tpu.ops.linalg.kernel_matrix_plain`` (float64: rtol 1e-12 with
atol 1e-12·k(0); float32: rtol 2e-6 with atol 1e-6·k(0), since the two
runtimes' float32 transcendentals may differ by an ulp or two), for a
list the CUDA kernel supports (one buffer on the card, the plain version
here) and a list that holds WhiteNoise and a non-stationary kernel (built
matrix by matrix)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpyrn_tpu.ops import linalg as jlin
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.ops import linalg as tlin

SUPPORTED = [(("QP",), (1.0, 30.0, 20.0, 0.7)),
             (("SE",), (1.05, 30.0)),
             (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0))]
MIXED = SUPPORTED[:2] + [(("+", ("SE",), ("WN",)), (1.1, 10.0, 0.1)),
                         (("LIN",), (0.3, 0.01))]
N = 40


def _times():
    return np.sort(np.random.default_rng(7).uniform(0, 100, N))


@pytest.mark.parametrize("cases", [SUPPORTED, MIXED],
                         ids=["supported", "with-unsupported"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_exact_nugget_stack(cases, dtype):
    structures = [s for s, _ in cases]
    assert all(map(ck.cuda_supported, structures)) == (cases is SUPPORTED)
    t = torch.tensor(_times(), dtype=dtype)
    params = [torch.tensor(p, dtype=dtype) for _, p in cases]
    K = tlin.kernel_matrix_stack(structures, params, t, tlin.TRAIN_NUGGET,
                                 jitter_mult=0.0)
    assert K.shape == (len(cases), N, N) and K.dtype == dtype
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    rtol, atol = (1e-12, 1e-12) if dtype == torch.float64 else (2e-6, 1e-6)
    for b, (s, p) in enumerate(cases):
        one = tlin.kernel_matrix_plain(s, params[b], t, tlin.TRAIN_NUGGET)
        assert torch.equal(K[b], one)
        ref = np.asarray(jlin.kernel_matrix_plain(
            s, jnp.asarray(p, dtype=jdtype),
            jnp.asarray(_times(), dtype=jdtype), jlin.TRAIN_NUGGET))
        assert ref.dtype == K[b].numpy().dtype
        np.testing.assert_allclose(K[b].numpy(), ref, rtol=rtol,
                                   atol=atol * np.abs(ref).max())
    # the exact nugget, and not the trace-scaled jitter, sits on the
    # diagonal: in float32 the two differ at this size
    if dtype == torch.float32:
        scaled = tlin.kernel_matrix_stack(structures, params, t,
                                          tlin.TRAIN_NUGGET)
        assert not torch.equal(scaled, K)


def test_default_is_the_scaled_jitter_and_other_multipliers_raise():
    t = torch.tensor(_times())
    structures = [s for s, _ in SUPPORTED]
    params = [torch.tensor(p, dtype=torch.float64) for _, p in SUPPORTED]
    K = tlin.kernel_matrix_stack(structures, params, t)
    for b, s in enumerate(structures):
        assert torch.equal(K[b], tlin.kernel_matrix(s, params[b], t))
    with pytest.raises(ValueError, match="jitter_mult"):
        tlin.kernel_matrix_stack(structures, params, t, jitter_mult=2.0)
