"""Matrix-free kernel linear algebra: CG and Lanczos.

Port of :mod:`gpyrn_tpu.ops.iterative`.  Every operation goes through
kernel matvecs that evaluate K on the fly (O(N²) work per matvec), so
nothing N×N is ever held:

* :func:`kernel_matvec`: (K + nugget·I) @ V, on the card by B1's product
  entry (``cuda_kernels.kernel_matvec_cuda``: each element of K evaluated
  in registers, never stored) for every structure B1 takes; elsewhere,
  and for the non-stationary structures, in row chunks of K
  (``cuda_kernels.kernel_matvec_ref``, O(N·chunk) memory);
* :func:`cg_solve`: preconditioned conjugate gradients over a batch of
  right-hand sides (Jacobi, or any SPD apply such as
  :func:`split_precond` around a :func:`pivoted_cholesky` factor), with
  residual replacement and the achieved true residual on request;
* :func:`lanczos`, :func:`lanczos_vectors`, :func:`slq_logdet` (stochastic
  Lanczos quadrature) and :func:`msqrt_apply` (K^(1/2) v);
* :func:`cg_refined`: iterative refinement of a float32 CG solve against a
  float64 residual (the card has FP64 in hardware, so the residual is
  :func:`kernel_matvec` in float64; the JAX package's double-single
  ``df64_kernel_matvec`` is not ported).

The JAX package fuses each loop into ``lax.while_loop`` / ``fori_loop``;
here a loop is a Python loop of device operations.  ``cg_solve`` reads one
boolean per iteration (its stopping test), with the JAX package's
iteration count; the residual refresh is a test of the iteration count on
the host and reads nothing.  ``pivoted_cholesky`` and the Lanczos loops
read nothing: the pivot is an ``argmax`` gathered on the device.  Where
the JAX package pads the last row chunk with dummy points (a static shape
for ``lax.scan``), the last chunk here is just shorter.

Random probes (``slq_logdet``) come from a ``torch.Generator`` on the
device, or are given (``probes=``): the JAX package's ``jax.random``
draws cannot be reproduced.
"""
from __future__ import annotations

from typing import Optional

import torch

from gpyrn_tpu_torch.ops import cuda_kernels as _ck
from gpyrn_tpu_torch.ops import kernels as _k

__all__ = ["kernel_matvec", "cg_solve", "slq_logdet", "lanczos",
           "lanczos_vectors", "cg_refined", "kernel_diag",
           "pivoted_cholesky", "woodbury_apply", "split_precond",
           "msqrt_apply"]


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def matvec_route(structure, device) -> str:
    """Where :func:`kernel_matvec` computes on ``device``: ``"kernel"``
    (B1's product entry) on a CUDA device for a structure B1 takes, else
    ``"plain"`` (row chunks of K).  Chosen by structure and device only."""
    device = torch.device(device)
    return ("kernel" if device.type == "cuda" and _ck.cuda_supported(
        structure) else "plain")


def kernel_matvec(structure, params, t, v, nugget=0.0, chunk: int = 2048,
                  r0: int = 0, n_rows: Optional[int] = None):
    """y = (K(t,t) + nugget·I) @ v without materializing K.

    ``v`` is (N,) or (N, m), on ``t``'s device and in its dtype; ``nugget``
    a number or a 0-d tensor.  With ``r0`` / ``n_rows``, only those rows
    of y (the rows of one rank's slab).  On the card a structure B1 takes
    runs B1's product entry (no gradient); any other structure, and every
    one on the CPU, rebuilds K in ``chunk``-row blocks (O(N·chunk) live
    memory), the last one ragged (:func:`matvec_route`)."""
    params = _as(params, t)
    v = _as(v, t)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    if matvec_route(structure, t.device) == "kernel":
        y = _ck.kernel_matvec_cuda(structure, params.contiguous(),
                                   t.contiguous(), v.contiguous(), nugget,
                                   r0, n_rows)
    else:
        y = _ck.kernel_matvec_ref(structure, params, t, v, nugget, chunk,
                                  r0, n_rows)
    return y[:, 0] if squeeze else y


def cg_solve(matvec, b, tol: float = 1e-8, maxiter: int = 1000,
             precond_diag: Optional[torch.Tensor] = None, x0=None,
             precond_apply=None, refresh_every: int = 0,
             return_relres: bool = False):
    """Solve A x = b by preconditioned conjugate gradients.

    ``matvec`` maps (N, m) -> (N, m) (the columns are independent
    systems); ``b`` is (N,) or (N, m).  Per-column α/β, shared matvecs.
    ``x0`` warm-starts.  The preconditioner is Jacobi (``precond_diag``,
    divides by it) or an SPD apply ``precond_apply(r) = M⁻¹ r``.  A column
    whose curvature or rz is non-positive or not finite keeps its x and
    restarts its direction at z.  ``refresh_every=k`` replaces the
    recursive residual by the true b − A x every k iterations (residual
    replacement; the direction continues through the recurrence).
    Returns ``(x, n_iters)``, and with ``return_relres`` also the achieved
    true relative residual, the max over the columns (one more matvec), as
    a 0-d tensor.  The stopping test reads one boolean per iteration."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    Minv = None if precond_diag is None else 1.0 / precond_diag[:, None]

    def apply_M(r):
        if precond_apply is not None:
            return precond_apply(r)
        return r * Minv if Minv is not None else r

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = _as(x0, b)
        if x.ndim == 1:
            x = x[:, None]
        r = b - matvec(x)
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    bnorm = torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    refresh = int(refresh_every) if refresh_every else 0
    it = 0
    while it < maxiter and bool(torch.max(
            torch.linalg.vector_norm(r, dim=0) / bnorm) > tol):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=0)
        ok = (pAp > 0) & torch.isfinite(pAp) & (rz > 0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp,
                                                 torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = torch.where(ok[None, :], x + alpha[None, :] * p, x)
        r = torch.where(ok[None, :], r - alpha[None, :] * Ap, r)
        it += 1
        if refresh > 0 and it % refresh == 0:
            r = b - matvec(x)
        z = apply_M(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(ok & (rz_new > 0) & torch.isfinite(rz_new),
                           rz_new / torch.where(rz > 0, rz,
                                                torch.ones_like(rz)),
                           torch.zeros_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
    x_out = x[:, 0] if squeeze else x
    if return_relres:
        relres = torch.max(torch.linalg.vector_norm(b - matvec(x), dim=0)
                           / bnorm)
        return x_out, it, relres
    return x_out, it


def kernel_diag(structure, params, t, nugget=0.0):
    """diag(K(t,t)) + nugget without materializing K (O(N))."""
    params = _as(params, t)
    z = torch.zeros_like(t)
    if _k.is_nonstationary(structure):
        d = _k.evaluate(structure, params, r=z, t1=t, t2=t)
    else:
        d = _k.evaluate(structure, params, r=z)
    return torch.broadcast_to(d, t.shape) + nugget


def _kernel_column(structure, params, t, tj, j, nugget):
    """K(t, t[j]) + nugget·e_j for one pivot (``tj``, ``j`` 0-d device
    tensors)."""
    if _k.is_nonstationary(structure):
        col = _k.evaluate(structure, params, r=t - tj, t1=t,
                          t2=torch.broadcast_to(tj, t.shape))
    else:
        col = _k.evaluate(structure, params, r=t - tj)
    return col + nugget * (torch.arange(t.shape[0], device=t.device)
                           == j).to(t.dtype)


def pivoted_cholesky(structure, params, t, rank: int, nugget=0.0):
    """Greedy pivoted (partial) Cholesky: K + nugget·I ≈ U Uᵀ, U (N, m).

    Each step takes the largest remaining diagonal residual, evaluates one
    kernel column there and deflates; an exhausted rank (residual ≤ 0)
    gives a zero column.  The pivot stays on the device (``argmax`` and
    gathers, no host read).  Returns ``(U, remaining diagonal)``."""
    params = _as(params, t)
    N = t.shape[0]
    diag_r = kernel_diag(structure, params, t, nugget)
    U = torch.zeros((N, rank), dtype=t.dtype, device=t.device)
    for i in range(rank):
        j = torch.argmax(diag_r).reshape(1)
        col = _kernel_column(structure, params, t, t.index_select(0, j)[0],
                             j[0], nugget)
        col = col - U @ U.index_select(0, j)[0]
        dj = diag_r.index_select(0, j)[0]
        ok = dj > 0
        inv = torch.where(ok, torch.rsqrt(torch.clamp(dj, min=1e-30)),
                          torch.zeros_like(dj))
        l_col = col * inv
        U[:, i] = l_col
        diag_r = torch.clamp(diag_r - l_col * l_col, min=0.0)
    return U, diag_r


def woodbury_apply(U, a, r):
    """(U Uᵀ + diag(a))⁻¹ r by Woodbury (a > 0; r (N,) or (N, k)):
    M⁻¹ r = r/a − (1/a)·U·C⁻¹·Uᵀ(r/a), C = I + Uᵀ diag(1/a) U."""
    a_r = a[:, None] if r.ndim == 2 else a
    ra = r / a_r
    Ua = U / a[:, None]
    C = torch.eye(U.shape[1], dtype=U.dtype, device=U.device) + U.T @ Ua
    return ra - Ua @ torch.linalg.solve(C, U.T @ ra)


def split_precond(U, h):
    """The SPD-safe CG preconditioner apply for M = U Uᵀ + diag(h):
    ``precond(r) = E (Eᵀ r) = M⁻¹ r`` with the symmetric root
    E = diag(h)^(−1/2) (I + Ũ Ũᵀ)^(−1/2), Ũ = diag(h)^(−1/2) U.  Each
    root apply cancels only by √λmax, so the computed apply stays
    positive definite in float32 where the one-shot Woodbury difference
    turns indefinite.  (I + Ũ Ũᵀ)^(−1/2) comes from an m×m
    eigendecomposition, with a series at λ → 0.  Takes (N,) or (N, k)."""
    sqrt_h = torch.sqrt(h)[:, None]
    Ut = U / sqrt_h
    lam, Qe = torch.linalg.eigh(Ut.T @ Ut)
    lam = torch.clamp(lam, min=0.0)
    w = torch.where(lam > 1e-6,
                    (1.0 - 1.0 / torch.sqrt(1.0 + lam))
                    / torch.clamp(lam, min=1e-30),
                    0.5 - 0.375 * lam)[:, None]      # series at λ → 0
    Uq = Ut @ Qe

    def root_apply(v):                  # (I + Ũ Ũᵀ)^(−1/2) v
        return v - Uq @ (w * (Uq.T @ v))

    def precond(r):
        r2 = r[:, None] if r.ndim == 1 else r
        out = root_apply(root_apply(r2 / sqrt_h)) / sqrt_h
        return out[:, 0] if r.ndim == 1 else out

    return precond


def lanczos_vectors(matvec, v0, n_steps: int):
    """Lanczos with the basis kept and fully re-orthogonalized (two
    Gram-Schmidt passes per step): ``(Q, alphas, betas)`` with Q
    (n_steps, N) orthonormal and tridiag(alphas, betas) = Q A Qᵀ.  On
    Krylov exhaustion (beta ≈ 0) the remaining steps give identity
    diagonal entries and zero basis rows."""
    scale = torch.linalg.vector_norm(v0)
    v0 = v0 / scale
    N = v0.shape[0]
    Q = torch.zeros((n_steps, N), dtype=v0.dtype, device=v0.device)
    Q[0] = v0
    alphas = torch.zeros(n_steps, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros_like(alphas)
    one, zero = alphas.new_ones(()), alphas.new_zeros(())
    floor = 1e-7 * torch.clamp(scale, min=1.0)
    dead = torch.zeros((), dtype=torch.bool, device=v0.device)
    for i in range(n_steps):
        v = Q[i].clone()
        w = matvec(v)
        alpha = torch.dot(w, v)
        # two passes against the whole stored basis (the rows beyond i
        # are zero and project to nothing)
        for _ in range(2):
            w = w - Q.T @ (Q @ w)
        beta = torch.linalg.vector_norm(w)
        exhausted = dead | (beta < floor)
        alphas[i] = torch.where(dead, one, alpha)
        betas[i] = torch.where(exhausted, zero, beta)
        if i + 1 < n_steps:
            Q[i + 1] = torch.where(exhausted, torch.zeros_like(w),
                                   w / torch.clamp(beta, min=1e-30))
        dead = exhausted
    return Q, alphas, betas


def lanczos(matvec, v0, n_steps: int):
    """Lanczos tridiagonalization without re-orthogonalization (as for
    SLQ): ``(alphas, betas)`` of the n_steps×n_steps T from probe v0."""
    v = v0 / torch.linalg.vector_norm(v0)
    v_prev = torch.zeros_like(v)
    beta_prev = v.new_zeros(())
    alphas, betas = [], []
    for _ in range(n_steps):
        w = matvec(v) - beta_prev * v_prev
        alpha = torch.dot(w, v)
        w = w - alpha * v
        beta = torch.linalg.vector_norm(w)
        v_next = torch.where(beta > 1e-30,
                             w / torch.clamp(beta, min=1e-30),
                             torch.zeros_like(w))
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v, beta_prev = v, v_next, beta
    return torch.stack(alphas), torch.stack(betas)


def _tridiag(alphas, betas):
    return (torch.diag(alphas) + torch.diag(betas[:-1], 1)
            + torch.diag(betas[:-1], -1))


def slq_logdet(matvec, n, n_probes: int = 16, n_steps: int = 25,
               seed: int = 0, dtype=torch.float32, device="cuda",
               probes=None):
    """Stochastic Lanczos quadrature estimate of log det A for SPD A:
    n · mean over Rademacher probes z of Σᵢ τ₁ᵢ² log λᵢ, the Lanczos
    tridiagonal's eigenpairs per probe.  The probes (n_probes, n) are
    ``probes`` when given, else drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    if probes is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        bits = torch.randint(0, 2, (n_probes, n), generator=gen,
                             device=device)
        probes = (2 * bits - 1).to(dtype)
    else:
        probes = torch.as_tensor(probes, dtype=dtype, device=device)
    vals = []
    for z in probes:
        alphas, betas = lanczos(matvec, z, n_steps)
        lam, U = torch.linalg.eigh(_tridiag(alphas, betas))
        lam = torch.clamp(lam, min=1e-30)
        vals.append(torch.sum(U[0, :] ** 2 * torch.log(lam)))
    return n * torch.mean(torch.stack(vals))


def cg_refined(matvec_f32, residual_matvec, b, n_refine: int = 3,
               tol: float = 1e-6, inner_tol: float = 1e-5,
               maxiter: int = 500, precond_diag=None, precond_apply=None):
    """Mixed-precision iterative refinement around float32 CG.

    Solves A x = b by repeating r ← b − A x (``residual_matvec``, a
    float64 matvec, e.g. :func:`kernel_matvec` on float64 tensors plus the
    diagonal terms), δ ← CG_f32(A, r), x ← x + δ, with x accumulated in
    float64 on ``b``'s device.  Each pass multiplies the error by the
    inner solver's relative accuracy.  Returns ``(x, final relative
    residual)``, x a float64 tensor and the residual a float."""
    b64 = torch.as_tensor(b, dtype=torch.float64)

    def inner(rhs):
        delta, _ = cg_solve(matvec_f32, rhs.to(torch.float32),
                            tol=inner_tol, maxiter=maxiter,
                            precond_diag=precond_diag,
                            precond_apply=precond_apply)
        return delta.to(torch.float64)

    x = inner(b64)
    bnorm = max(float(torch.linalg.vector_norm(b64)), 1e-30)
    for _ in range(n_refine):
        r = b64 - residual_matvec(x)
        if float(torch.linalg.vector_norm(r)) / bnorm < tol:
            break
        x = x + inner(r)
    r = b64 - residual_matvec(x)
    return x, float(torch.linalg.vector_norm(r)) / bnorm


def msqrt_apply(matvec, v, n_steps: int = 64):
    """A^(1/2) v by Lanczos: ‖v‖ · Qᵀ (U √Λ Uᵀ e₁) with T = Q A Qᵀ =
    U Λ Uᵀ from :func:`lanczos_vectors`; exact once the Krylov space is
    exhausted.  k matvecs and O(k·N) memory."""
    Q, al, be = lanczos_vectors(matvec, v, n_steps)
    lam, U = torch.linalg.eigh(_tridiag(al, be))
    lam = torch.clamp(lam, min=0.0)
    w = U @ (torch.sqrt(lam) * U[0])
    return torch.linalg.vector_norm(v) * (w @ Q)
