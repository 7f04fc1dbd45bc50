"""Panel-sharded dense linear algebra over the N axis.

Port of :mod:`gpyrn_tpu.parallel.panel`.  The N×N matrices are split over
the ranks of one mesh axis as contiguous **row slabs** of ``Nl = Np/D``
rows, so that more ranks raise the N ceiling instead of only batching the
(q × p) lattice.  The factorization is the classic right-looking blocked
Cholesky; the solves and the GPRN sweep's Σ-free diag/trace pass stream
block row by block row.  Per block step k (B rows) the owner of block k
sends its B-row piece (``broadcast``), block column k of a factor is
joined from every rank (``all_gather``), and the O(N³/D) work is each
rank's (Nl × B)·(B × Np) product on its own rows.

Every function is called collectively by the ranks of ``axis``
(:class:`gpyrn_tpu_torch.parallel.mesh.Axis`) with its local slab and the
replicated small arrays, in the same order on every rank, and returns
replicated results (or the rank's slab of a matrix).

Padding convention (the JAX package's): ``Np = ceil(N / (D·B))·D·B``;
padded rows and columns of every matrix are identity, padded vector
entries 0, and every operation keeps that, so padded lanes never reach
real ones.  Where the JAX package masks full-width updates (XLA needs
static shapes), these eager loops slice: a trailing update touches only
the rows and columns past block k, about half the operations, and the
factor overwrites a copy of the matrix in place.  Results agree with the
JAX package's to rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpyrn_tpu_torch.ops.blocked import cholesky_nan
from gpyrn_tpu_torch.parallel.mesh import Axis, all_gather, all_reduce, \
    broadcast

__all__ = [
    "PanelDims", "panel_dims", "pad_vector", "slab_rows",
    "panel_cholesky_local", "panel_logdet_half_local",
    "panel_solve_local", "panel_solve_t_local", "panel_cho_solve_local",
    "panel_matvec_local", "panel_diag_trace_local",
    "panel_tri_inv_local", "panel_fro_cross_local", "gather_vector",
]

DEFAULT_BLOCK = 256


class PanelDims(NamedTuple):
    """Geometry of a panel-sharded N×N problem.

    N:   true matrix dimension
    Np:  padded dimension (multiple of D·B)
    D:   ranks along the panel axis
    Nl:  rows per rank (= Np/D)
    B:   block size
    nb:  number of block columns (= Np/B)
    bpd: blocks per rank (= Nl/B)
    """
    N: int
    Np: int
    D: int
    Nl: int
    B: int
    nb: int
    bpd: int


def panel_dims(N: int, n_devices: int, block: int = DEFAULT_BLOCK
               ) -> PanelDims:
    B = min(block, max(8, 1 << (max(N // max(n_devices, 1), 1) - 1)
                       .bit_length()))
    step = n_devices * B
    Np = math.ceil(N / step) * step
    Nl = Np // n_devices
    return PanelDims(N=N, Np=Np, D=n_devices, Nl=Nl, B=B,
                     nb=Np // B, bpd=Nl // B)


def pad_vector(v, dims: PanelDims, value=0.0):
    """Pad a (…, N) tensor to (…, Np) with ``value``."""
    return torch.nn.functional.pad(v, (0, dims.Np - dims.N), value=value)


def slab_rows(dims: PanelDims, axis: Axis):
    """The first global row of this rank's slab, and the number of its
    rows that are real (< N)."""
    r0 = axis.rank * dims.Nl
    return r0, max(0, min(dims.Nl, dims.N - r0))


def gather_vector(x_local, axis: Axis):
    """The per-rank (Nl, …) pieces joined into the full (Np, …)."""
    return all_gather(x_local, axis)


def _owner(dims: PanelDims, k: int):
    """(owning rank, local row offset) of block row k."""
    return k // dims.bpd, (k % dims.bpd) * dims.B


def _local_from(dims: PanelDims, axis: Axis, row: int) -> int:
    """The first local row whose global row is >= ``row`` (0..Nl)."""
    return min(max(row - axis.rank * dims.Nl, 0), dims.Nl)


def _solve_lower(L, X):
    return torch.linalg.solve_triangular(L, X, upper=False)


def panel_cholesky_local(A_local, dims: PanelDims, axis: Axis):
    """Distributed blocked Cholesky of a row-slab-sharded SPD matrix.

    ``A_local``: this rank's (Nl, Np) slab of A (padding: identity).
    Returns its (Nl, Np) slab of the lower factor L (a new tensor).  A
    diagonal block that does not factor gives NaN from there on
    (``jnp.linalg.cholesky``'s semantics), never an exception: every rank
    must reach every collective."""
    B = dims.B
    W = A_local.clone()
    for k in range(dims.nb):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        Dblk = (W[off:off + B, c0:c1].clone() if axis.rank == owner
                else W.new_empty((B, B)))
        Lkk = cholesky_nan(broadcast(Dblk, owner, axis))
        # rows at or past block k: C = W[:, k] · L_kk⁻ᵀ (the diagonal
        # block's rows come out as L_kk itself, its upper triangle set to
        # 0 exactly); rows above it are 0
        lo = _local_from(dims, axis, c0)
        col = W[:, c0:c1]
        col[lo:] = _solve_lower(Lkk, col[lo:].T).T
        col[:lo] = 0.0
        if axis.rank == owner:
            col[off:off + B] = torch.tril(col[off:off + B])
        P = all_gather(col, axis)                              # (Np, B)
        hi = _local_from(dims, axis, c1)
        if hi < dims.Nl:
            W[hi:, c1:] -= col[hi:] @ P[c1:].T
    return W


def panel_logdet_half_local(L_local, dims: PanelDims, axis: Axis):
    """Σ log diag(L) over the true N rows (replicated 0-d tensor):
    ``logdet(A) = 2 · panel_logdet_half_local(panel_cholesky(A))``."""
    r0, nv = slab_rows(dims, axis)
    return all_reduce(torch.sum(torch.log(L_local.diagonal(r0)[:nv])), axis)


def panel_matvec_local(K_local, v, dims: PanelDims, axis: Axis):
    """K @ v for a row slab K and a replicated (Np,) v → replicated."""
    return all_gather(K_local @ v, axis)


def panel_solve_local(L_local, b, dims: PanelDims, axis: Axis):
    """Forward substitution L x = b (replicated (Np,) b → replicated x).

    Each rank keeps the partial sums s = L_local[:, :kB] x[:kB] of its
    rows; per block step the owner sends one (B, B+1) tile (its diagonal
    block ‖ its partial sums) and every rank solves the B×B triangle."""
    B = dims.B
    x = torch.zeros_like(b)
    s = b.new_zeros(dims.Nl)
    for k in range(dims.nb):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        tile = (torch.cat([L_local[off:off + B, c0:c1],
                           s[off:off + B, None]], 1)
                if axis.rank == owner else b.new_empty((B, B + 1)))
        broadcast(tile, owner, axis)
        xk = _solve_lower(tile[:, :B], (b[c0:c1] - tile[:, B])[:, None])[:, 0]
        x[c0:c1] = xk
        s += L_local[:, c0:c1] @ xk
    return x


def panel_solve_t_local(L_local, b, dims: PanelDims, axis: Axis):
    """Back substitution Lᵀ x = b (replicated (Np,) b → replicated x).

    Each solved block adds its correction Lᵀ[:, r_k]·x_k to the owner's
    accumulator; per step one (B, B+1) sum (the owner's diagonal block ‖
    every rank's accumulated corrections of the block)."""
    B = dims.B
    x = torch.zeros_like(b)
    s = b.new_zeros(dims.Np)
    for k in reversed(range(dims.nb)):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        tile = b.new_zeros((B, B + 1))
        if axis.rank == owner:
            tile[:, :B] = L_local[off:off + B, c0:c1]
        tile[:, B] = s[c0:c1]
        tile = all_reduce(tile, axis)
        xk = torch.linalg.solve_triangular(
            tile[:, :B].T, (b[c0:c1] - tile[:, B])[:, None], upper=True)[:, 0]
        x[c0:c1] = xk
        if axis.rank == owner:
            s[:c0] += L_local[off:off + B, :c0].T @ xk
    return x


def panel_cho_solve_local(L_local, b, dims: PanelDims, axis: Axis):
    """A⁻¹ b from the panel factor: Lᵀ \\ (L \\ b)."""
    return panel_solve_t_local(
        L_local, panel_solve_local(L_local, b, dims, axis), dims, axis)


def panel_diag_trace_local(L_local, K_local, dims: PanelDims, axis: Axis):
    """The GPRN sweep's Σ-free diag/trace pass, panel-distributed.

    Given the panel factor L of A = K + D⁻¹ and the slab of K, streams the
    wide solve X = L⁻¹K block row by block row and reduces

        qn_j = Σᵢ X²ᵢⱼ             (→ diag Σ = diag K − qn)
        cn_j = Σᵢ (Lᵀ − X)²ᵢⱼ      (→ tr(K⁻¹Σ) = Σⱼ Dⱼⱼ cn_j,
                                     via L⁻¹D⁻¹ = Lᵀ − X exactly)

    never holding more than the slab of the running update.  Per step one
    (Np, B) gather of L's block column (its rows k are L_kk) and one
    (B, Np) broadcast of the owner's block row of K − S.

    Returns ``(dS, cn)``: replicated (Np,), ``dS = diag K − qn``; padded
    lanes come out exactly 0."""
    B = dims.B
    S = torch.zeros_like(K_local)
    qn = K_local.new_zeros(dims.Np)
    cn = K_local.new_zeros(dims.Np)
    for k in range(dims.nb):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        Lcol = L_local[:, c0:c1]
        Lcol_full = all_gather(Lcol, axis)                    # (Np, B)
        rhs = (K_local[off:off + B] - S[off:off + B]
               if axis.rank == owner else K_local.new_empty((B, dims.Np)))
        Xk = _solve_lower(Lcol_full[c0:c1], broadcast(rhs, owner, axis))
        qn += torch.sum(Xk * Xk, dim=0)
        M = Lcol_full.T - Xk
        cn += torch.sum(M * M, dim=0)
        hi = _local_from(dims, axis, c1)
        S[hi:] += Lcol[hi:] @ Xk
    r0, _ = slab_rows(dims, axis)
    diagK = all_gather(K_local.diagonal(r0), axis)
    return diagK - qn, cn


def panel_tri_inv_local(L_local, dims: PanelDims, axis: Axis):
    """Distributed triangular inversion: the row slab of ``G = L⁻¹``.

    Streams the forward substitution ``L X = I`` block row by block row;
    block row k of L⁻¹ is zero right of column (k+1)B, so each step works
    on those columns only.  The owner of each block row keeps it, so G has
    L's row-slab layout.

    Returns ``(G_local, diag_inv)``: the (Nl, Np) slab of L⁻¹ and the
    replicated (Np,) ``diag((L Lᵀ)⁻¹)`` = column norms² of L⁻¹ (padded
    lanes exactly 1)."""
    B = dims.B
    S = torch.zeros_like(L_local)
    G = torch.zeros_like(L_local)
    qn = L_local.new_zeros(dims.Np)
    for k in range(dims.nb):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        tile = (torch.cat([L_local[off:off + B, c0:c1],
                           S[off:off + B, :c1]], 1)
                if axis.rank == owner else L_local.new_empty((B, B + c1)))
        broadcast(tile, owner, axis)
        rhs = -tile[:, B:]
        rhs[:, c0:c1] += torch.eye(B, dtype=rhs.dtype, device=rhs.device)
        Xk = _solve_lower(tile[:, :B], rhs)                   # (B, c1)
        qn[:c1] += torch.sum(Xk * Xk, dim=0)
        if axis.rank == owner:
            G[off:off + B, :c1] = Xk
        hi = _local_from(dims, axis, c1)
        S[hi:, :c1] += L_local[hi:, c0:c1] @ Xk
    return G, qn


def panel_fro_cross_local(LA_local, G_local, dscale, dims: PanelDims,
                          axis: Axis):
    """``‖L_A⁻¹ · diag(dscale) · Gᵀ‖²_F``: the q > 1 cross-trace Frobenius
    norm (W = L_{A_k}⁻¹ D_k⁻¹ L_j⁻ᵀ), panel-distributed.

    ``LA_local`` is the slab of the panel factor L_A, ``G_local`` the slab
    of G = L_j⁻¹ (:func:`panel_tri_inv_local`), ``dscale`` a replicated
    (Np,) diagonal (padded lanes 0).  Streams the wide solve
    Z = L_A⁻¹ diag(dscale) Gᵀ block row by block row: block row k of the
    right-hand side is one gathered column strip of G scaled, the owner
    sends its diagonal block of L_A and its rows of the running update,
    and only Σ Z² is kept.

    Returns the replicated 0-d ``Σ Z²``."""
    B, Np = dims.B, dims.Np
    S = torch.zeros_like(LA_local)
    frob = LA_local.new_zeros(())
    for k in range(dims.nb):
        owner, off = _owner(dims, k)
        c0, c1 = k * B, (k + 1) * B
        strip = all_gather(G_local[:, c0:c1], axis)           # (Np, B)
        tile = (torch.cat([LA_local[off:off + B, c0:c1],
                           S[off:off + B]], 1)
                if axis.rank == owner else LA_local.new_empty((B, B + Np)))
        broadcast(tile, owner, axis)
        Wk = strip.T * dscale[c0:c1, None]                     # (B, Np)
        Zk = _solve_lower(tile[:, :B], Wk - tile[:, B:])
        frob = frob + torch.sum(Zk * Zk)
        hi = _local_from(dims, axis, c1)
        S[hi:] += LA_local[hi:, c0:c1] @ Zk
    return frob
