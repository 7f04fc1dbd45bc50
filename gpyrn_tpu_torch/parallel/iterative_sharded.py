"""Distributed matrix-free CG: the kernel matvec's rows split over a mesh.

Port of :mod:`gpyrn_tpu.parallel.iterative_sharded`.  The single-device
matrix-free path (:mod:`gpyrn_tpu_torch.ops.iterative`) evaluates K on the
fly, O(N²) work per matvec; here each rank of one mesh axis computes only
its N/D rows of the product (:func:`slab_matvec`: ``kernel_matvec`` with
the rank's rows, B1's product entry on the card), so every matvec's work
divides by the axis size while the CG vectors stay replicated; a row sums
as it does in the whole product (the kernel splits the columns by N
alone).  The gather of the slab products is the one collective per
matvec; every reduction of the solve runs on replicated data, so all ranks
take the same steps and stop together.  The solve is
:func:`gpyrn_tpu_torch.ops.iterative.cg_solve` itself, fed the
distributed matvec.

Padding: N is padded to a multiple of the axis size with dummy rows whose
equations are the identity (unit diagonal, zero right-hand side, the
matvec's coupling masked on both sides), so any kernel, the non-decaying
ones too (Periodic, Constant), is handled exactly.
"""
from __future__ import annotations

import torch

from gpyrn_tpu_torch.ops.iterative import (cg_solve, kernel_diag,
                                           kernel_matvec, pivoted_cholesky,
                                           split_precond)
from gpyrn_tpu_torch.ops.linalg import TRAIN_NUGGET
from gpyrn_tpu_torch.parallel.mesh import DP_AXIS, all_gather, mesh_axis

__all__ = ["cg_solve_sharded", "slab_matvec", "gathered_matvec"]


def slab_matvec(structure, params, t, x, r0, n_rows, chunk: int = 1024):
    """Rows [r0, r0 + n_rows) of K(t, t) @ x for x (N, k): one rank's rows
    of a kernel matvec (``kernel_matvec`` with those rows and no nugget;
    ``chunk`` shapes only the plain path's row blocks)."""
    return kernel_matvec(structure, params, t, x, nugget=0.0, chunk=chunk,
                         r0=r0, n_rows=n_rows)


def gathered_matvec(structure, params, t, x, r0, n_rows, axis,
                    chunk: int = 1024):
    """K(t, t) @ x for x (N, k) over the ranks of ``axis`` (an
    :class:`~gpyrn_tpu_torch.parallel.mesh.Axis`): each rank multiplies its
    rows [r0, r0 + n_rows) (:func:`slab_matvec`) and every rank gets them
    all."""
    return all_gather(slab_matvec(structure, params, t, x, r0, n_rows,
                                  chunk), axis)


def cg_solve_sharded(structure, params, t, b, mesh, d_add=None,
                     nugget=0.0, tol: float = 1e-6, maxiter: int = 200,
                     chunk: int = 1024, axis_name: str = DP_AXIS,
                     jacobi: bool = True, precond_rank: int = 0,
                     refresh_every: int = 0, return_relres: bool = False):
    """Solve (K(t,t) + nugget·I + diag(d_add)) x = b over the mesh.

    :func:`gpyrn_tpu_torch.ops.iterative.cg_solve`'s contract with the
    kernel matvec's rows split over ``mesh``'s ``axis_name`` axis; called
    collectively by the ranks of the axis with the same arguments (tensors
    on the rank's device).  ``b`` is (N,) or (N, k).  Preconditioning:
    Jacobi by default, or with ``precond_rank > 0`` the rank-m
    pivoted-Cholesky split-form preconditioner (``split_precond``), built
    on every rank from the replicated inputs.  ``refresh_every`` and
    ``return_relres`` as in ``cg_solve``.  Returns ``(x, n_iters)``, x a
    tensor like ``b`` on every rank, and with ``return_relres`` also the
    achieved true relative residual as a float."""
    axis = mesh_axis(mesh, axis_name)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    N = t.shape[0]
    Np = -(-N // axis.size) * axis.size
    Nl, pad = Np // axis.size, Np - N
    params = torch.as_tensor(params, dtype=t.dtype, device=t.device)
    t_full = torch.cat([t, (t[-1] + 1e6).expand(pad)])
    b_full = torch.nn.functional.pad(b, (0, 0, 0, pad))
    m_full = torch.cat([t.new_ones(N), t.new_zeros(pad)])
    d = t.new_zeros(N) if d_add is None else d_add
    d_full = torch.nn.functional.pad(d, (0, pad)) + (1.0 - m_full)

    def mv(P):
        # pad coupling masked on both sides: pad columns never contribute,
        # pad rows reduce to the unit diagonal
        return gathered_matvec(structure, params, t_full,
                               P * m_full[:, None], axis.rank * Nl, Nl,
                               axis, chunk) \
            * m_full[:, None] + (nugget * m_full + d_full)[:, None] * P

    if int(precond_rank) > 0:
        U, diag_res = pivoted_cholesky(structure, params, t,
                                       int(precond_rank), nugget=0.0)
        # h: what M must match beyond U Uᵀ (the pivoting's remaining
        # diagonal, the nugget, d_add), floored at TRAIN_NUGGET so that
        # h > 0 with nugget=0 and no d_add; pad rows: zero U rows and a
        # unit h, so M's pad block is the identity
        h = torch.clamp(diag_res + nugget + d, min=TRAIN_NUGGET)
        precond = split_precond(
            torch.nn.functional.pad(U, (0, 0, 0, pad)),
            torch.nn.functional.pad(h, (0, pad), value=1.0))
    elif jacobi:
        dK = kernel_diag(structure, params, t_full)
        Minv = m_full / (dK * m_full + nugget * m_full + d_full) \
            + (1.0 - m_full)

        def precond(r):
            return r * Minv[:, None]
    else:
        def precond(r):
            return r
    x, it, relres = cg_solve(mv, b_full, tol=tol, maxiter=maxiter,
                             precond_apply=precond,
                             refresh_every=refresh_every,
                             return_relres=True)
    x = x[:N, 0] if squeeze else x[:N]
    if return_relres:
        return x, it, float(relres)
    return x, it
