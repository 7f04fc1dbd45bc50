"""Blocked Cholesky and triangular-inverse diagonal of the sweep.

Port of :mod:`gpyrn_tpu.ops.blocked`.  The coordinate-ascent sweep needs,
per GP, ``diag(A⁻¹)`` for A = K + D⁻¹ (chol L): through

    diag Σ      = d − d² · diag(A⁻¹)          (Σ = K − K A⁻¹ K, d = D⁻¹ diag)
    tr(A⁻¹ D⁻¹) = Σⱼ dⱼ (A⁻¹)ⱼⱼ

every Σ diagnostic of the ELBO reduces to diag(A⁻¹), the column norms² of
L⁻¹.  The factorization is left-looking and blocked; the O(N³) panel
updates and the strip-by-strip inversion of L are batched matrix
products, and only the T×T diagonal blocks go to ``cholesky_ex`` /
``solve_triangular``.  The JAX package leaves these to XLA; here they are
torch.linalg / matmul calls on the blocks.  Nothing is written in place:
the factor is assembled from its column strips and L⁻¹ from its row
strips with ``torch.cat``, so autograd differentiates through every
strip (the gradient path, ``Engine.elbo_value_and_grad``, runs through
here at every sweep).

The dense sweep keeps L⁻¹ (:func:`blocked_chol_inverse`) and applies A⁻¹
as two batched products, A⁻¹b = L⁻ᵀ(L⁻¹b), and the prior factors' inverses
come from the same strip inversion (:func:`tri_inverse`): so no N×N
triangular solve runs in a sweep, which torch would hand to MAGMA for a
batch of more than 8 matrices wider than 512.  The lean engines keep only
L and diag(A⁻¹) (:func:`blocked_chol_diag_ainv`).

A failed factorization gives NaN, as ``jnp.linalg.cholesky`` does: the
diagonal blocks are factored with ``cholesky_ex`` and the batch entries
whose ``info`` is positive are overwritten with NaN on the device, with
no host synchronisation.
"""
from __future__ import annotations

import torch

__all__ = ["blocked_cholesky", "diag_Ainv", "blocked_chol_diag_ainv",
           "blocked_chol_inverse", "tri_inverse", "cholesky_nan",
           "DEFAULT_BLOCK"]

DEFAULT_BLOCK = 512


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _block_size(N: int, block: int) -> int:
    # at most ~16 strips
    T = min(block, _round_up(N, 128))
    while N > 16 * T:
        T *= 2
    return T


def cholesky_nan(A):
    """Lower Cholesky factor of a batch; where the factorization fails,
    a lower triangle of NaN (``jnp.linalg.cholesky`` semantics).  Never
    raises, never synchronises with the host."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def _tri_inv(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _pad_identity(A, Npad: int):
    """A (B, N, N) batch padded to (B, Npad, Npad) with an identity tail
    block, out of place."""
    N = A.shape[-1]
    A = torch.nn.functional.pad(A, (0, Npad - N, 0, Npad - N))
    tail = torch.cat([torch.zeros(N, dtype=A.dtype, device=A.device),
                      torch.ones(Npad - N, dtype=A.dtype, device=A.device)])
    return A + torch.diag(tail)


def blocked_cholesky(A, block: int = DEFAULT_BLOCK):
    """Left-looking blocked Cholesky of an SPD batch (B, N, N) →
    ``(L, Linv_d)``: the (identity-padded) lower factor and the
    (B, nb, T, T) inverses of its diagonal blocks."""
    B, N, _ = A.shape
    T = _block_size(N, block)
    Npad = _round_up(N, T)
    nb = Npad // T
    if Npad != N:
        A = _pad_identity(A, Npad)

    cols = []        # cols[k]: column strip k of L from row k·T down
    linvs = []
    for i in range(nb):
        a = i * T
        if i:
            # rows a: of L left of column a, from the finished strips
            left = torch.cat([c[:, a - k * T:] for k, c in enumerate(cols)],
                             dim=2)                       # (B, Npad-a, a)
            top = left[:, :T]                             # (B, T, a)
            Aii = A[:, a:a + T, a:a + T] - top @ top.transpose(1, 2)
            Ari = A[:, a + T:, a:a + T] - left[:, T:] @ top.transpose(1, 2)
        else:
            Aii = A[:, :T, :T]
            Ari = A[:, T:, :T]
        Lii = cholesky_nan(Aii)
        Linv = _tri_inv(Lii)
        linvs.append(Linv)
        if i + 1 < nb:
            Lii = torch.cat([Lii, Ari @ Linv.transpose(1, 2)],   # Ari Lii⁻ᵀ
                            dim=1)
        cols.append(Lii)
    L = torch.cat([torch.nn.functional.pad(c, (0, 0, k * T, 0))
                   for k, c in enumerate(cols)], dim=2)
    return L, torch.stack(linvs, dim=1)


def _strip_inverse(L, Linv_d, block: int):
    """X = L⁻¹ of a batch of lower factors padded to a block multiple
    (identity tail), row strip by row strip: ``X_i = Linv_ii @ [−L_i,:a @
    X_:a,:a │ I]``, one matrix product per strip.  ``Linv_d`` holds the
    (B, nb, T, T) inverses of L's diagonal blocks, or None to form them."""
    B, Npad, _ = L.shape
    T = _block_size(Npad, block)
    if Npad % T:
        raise ValueError(f"padded N {Npad} not a multiple of block {T}")
    nb = Npad // T
    if Linv_d is None:
        Ld = torch.stack([L[:, i * T:(i + 1) * T, i * T:(i + 1) * T]
                          for i in range(nb)], dim=1)
        Linv_d = _tri_inv(Ld)

    X = Linv_d[:, 0]                    # X[:, :a, :a], grown strip by strip
    for i in range(1, nb):
        a = i * T
        Linv = Linv_d[:, i]
        S = L[:, a:a + T, :a] @ X
        row = torch.cat([-(Linv @ S), Linv], dim=2)       # (B, T, a + T)
        X = torch.cat([torch.nn.functional.pad(X, (0, T)), row], dim=1)
    return X


def diag_Ainv(L, Linv_d=None, block: int = DEFAULT_BLOCK,
              n_valid: int | None = None):
    """``diag(A⁻¹)`` for ``A = L Lᵀ``: column norms² of ``L⁻¹``, formed
    strip by strip (:func:`_strip_inverse`) and dropped.  ``L`` must be
    padded to a block multiple (identity tail, see
    :func:`blocked_cholesky`); ``n_valid`` slices the logical N back out."""
    X = _strip_inverse(L, Linv_d, block)
    acc = torch.sum(X * X, dim=1)
    n = L.shape[-1] if n_valid is None else n_valid
    return acc[:, :n]


def blocked_chol_diag_ainv(A, block: int = DEFAULT_BLOCK):
    """``(L, diag(A⁻¹))`` of an SPD batch (B, N, N); L is (B, N, N), the
    padding sliced off.  The lean engines' call: L⁻¹ is not kept."""
    N = A.shape[-1]
    Lp, Linv_d = blocked_cholesky(A, block=block)
    d = diag_Ainv(Lp, Linv_d=Linv_d, block=block, n_valid=N)
    return Lp[:, :N, :N], d


def blocked_chol_inverse(A, block: int = DEFAULT_BLOCK):
    """``(log diag L, L⁻¹, diag(A⁻¹))`` of an SPD batch (B, N, N) with
    A = L Lᵀ: the dense sweep's call, which applies A⁻¹ as
    X = L⁻¹ twice, A⁻¹b = Xᵀ(X b), and needs of L only its log-determinant.
    L⁻¹ is (B, N, N), the leading block of the padded inverse (a view
    into it); L itself is not kept."""
    N = A.shape[-1]
    Lp, Linv_d = blocked_cholesky(A, block=block)
    X = _strip_inverse(Lp, Linv_d, block)
    logdiag = torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1)[:, :N])
    return logdiag, X[:, :N, :N], torch.sum(X * X, dim=1)[:, :N]


def tri_inverse(L, block: int = DEFAULT_BLOCK):
    """L⁻¹ of a batch (B, N, N) of lower factors, by the strip inversion
    of :func:`_strip_inverse` on L padded with an identity tail: batched
    products and T×T triangular inverses only (T ≤ ``block``), never an
    N×N triangular solve.  (B, N, N), a view into the padded inverse."""
    N = L.shape[-1]
    Npad = _round_up(N, _block_size(N, block))
    Lp = _pad_identity(L, Npad) if Npad != N else L
    return _strip_inverse(Lp, None, block)[:, :N, :N]
