"""GPRN mean-field variational inference — engine on torch tensors.

Port of the engine of :mod:`gpyrn_tpu.models.gprn`: the closed-form
coordinate-ascent sweep (eqs. 16–19 of Nguyen & Bonilla 2013) batched over
the q-node and (q × p)-weight lattice, the three ELBO terms, the reference
stopping rule, the converged-state fits on the exact-nugget matrices
(``fit_state``, and ``fit_state_stall`` with its merit-stall rule: the
float32 bulk of the mixed-precision fit), the fixed-count sweeps and
their gradient, the posterior predictive, and the lean engines
(``*_lean``: the same fits with each GP's kernel matrix rebuilt inside its
own update, one GP's buffers alive at a time).  The JAX package fuses each
fit into one ``lax.while_loop``; here it is an eager Python loop whose
only host synchronisation is the stopping test, once per sweep (once per
chunk in ``fit_state_stall``).  The fixed-count sweeps are a plain loop
(the JAX package's masked power-of-two sweep bucketing is a compile-count
device of XLA and is not ported), differentiated by autograd.

A batch of hyperparameter vectors θ (W, n_parameters) is a leading
dimension of every tensor of the sweep, where the JAX package maps the
single-θ functions with ``jax.vmap``: the lattice of all rows is one
``kernel_matrix_rows`` call, the factorizations one stack, and
``elbo_fit_batch`` / ``elbo_fixed_batch`` run the same sweep code as the
single-θ entry points (which call it with no batch dimension).
``torch.func.vmap`` is not used: it cannot trace the kernel's ctypes
launch or the fit's data-dependent loop.

Numerical-parity notes (the JAX package's, ``gpyrn_tpu/models/gprn.py:16-33``):

* training nugget 1e-6, prediction nugget 1.25e-12;
* the expected-log-prior accumulates ``sumSigmaF`` *cumulatively* over
  nodes — node j's trace term includes Σ_{k≤j} Σ_f^{(k)};
* the expected-log-prior reinterprets the (p,q,N) weight means as (q,p,N)
  with a raw reshape, not a transpose;
* the expected-log-likelihood's quadratic term uses the *raw* data, not
  the mean-subtracted vector handed to the sweep;
* the ELBO is divided by q;
* convergence: relative std of the last three ELBO values < 1e-3, first
  checked after sweep 4;
* the heuristic mu/var initialisation uses only the first p weight
  amplitudes and flattens (q,p,N)-ordered weight means into the engine's
  (p,q,N) layout with a raw reshape.

Every function takes tensors on one device and computes in their dtype.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops import means as means_mod
from gpyrn_tpu_torch.ops.linalg import (F32_JITTER_MULT, PREDICT_NUGGET,
                                        TRAIN_NUGGET, cross_kernel_matrix,
                                        kernel_diag, kernel_matrix,
                                        kernel_matrix_plain,
                                        kernel_matrix_rows,
                                        kernel_matrix_stack)
from gpyrn_tpu_torch.utils import profiling as _profiling

__all__ = [
    "GPRNSpec", "spec_from_components", "pack_parameters",
    "unpack_parameters", "Engine", "make_engine",
]

LOG_2PI = math.log(2 * math.pi)

# Engine.elbo_fit_batch's counters: batched sweeps, and calls that wait for
# the device (``utils/profiling.py``'s ``gprn.batch.*``)
BATCH_COUNTS = _profiling.counters("gprn.batch", ("sweeps", "host_reads"))
# the dense sweep's applications of a factor's inverse (node update, weight
# update, prior term, each node pair's cross trace; an updates-only sweep
# has the first two): products with a triangular inverse, never a library
# solve
SWEEP_COUNTS = _profiling.counters("gprn.sweep", ("inverse_solves",))


class GPRNSpec(NamedTuple):
    """Static description of a GPRN model (hashable).

    node_structs:   q kernel structure trees
    weight_structs: q·p kernel structure trees, node-major ([j*p + i])
    mean_structs:   p mean structure trees (None = zero mean)
    n_node_pars / n_weight_pars / n_mean_pars: trainable parameter counts
    """
    q: int
    p: int
    N: int
    node_structs: Tuple
    weight_structs: Tuple
    mean_structs: Tuple
    n_node_pars: Tuple[int, ...]
    n_weight_pars: Tuple[int, ...]
    n_mean_pars: Tuple[int, ...]

    @property
    def n_parameters(self) -> int:
        return (sum(self.n_node_pars) + sum(self.n_weight_pars) +
                sum(self.n_mean_pars) + self.p)

    @property
    def d(self) -> int:
        return self.N * self.q * (self.p + 1)


def spec_from_components(nodes, weights, means, N: int) -> GPRNSpec:
    """Build a spec from kernel/mean objects."""
    q = len(nodes)
    p = len(weights) // q
    mean_structs = tuple(None if m is None or isinstance(m, (int, float))
                         else m.structure for m in means)
    n_mean = tuple(0 if s is None else means_mod.n_params(s)
                   for s in mean_structs)
    return GPRNSpec(
        q=q, p=p, N=int(N),
        node_structs=tuple(n.structure for n in nodes),
        weight_structs=tuple(w.structure for w in weights),
        mean_structs=mean_structs,
        n_node_pars=tuple(n.pars.size for n in nodes),
        n_weight_pars=tuple(w.pars.size for w in weights),
        n_mean_pars=n_mean,
    )


def pack_parameters(nodes, weights, means, jitters) -> np.ndarray:
    """Flatten all trainable parameters in reference order
    nodes → weights → means → jitters."""
    chunks = [np.atleast_1d(np.asarray(k.pars, dtype=float))
              for k in list(nodes) + list(weights)]
    for m in means:
        if m is not None and not isinstance(m, (int, float)):
            chunks.append(np.atleast_1d(np.asarray(m.pars, dtype=float)))
    chunks.append(np.atleast_1d(np.asarray(jitters, dtype=float)))
    return np.concatenate(chunks)


def unpack_parameters(spec: GPRNSpec, theta):
    """Split a parameter tensor (..., n_parameters) along its last axis
    into per-component slices (node params, weight params, mean params,
    jitters), each keeping the leading batch dimensions."""
    pos = 0
    node_p = []
    for n in spec.n_node_pars:
        node_p.append(theta[..., pos:pos + n])
        pos += n
    weight_p = []
    for n in spec.n_weight_pars:
        weight_p.append(theta[..., pos:pos + n])
        pos += n
    mean_p = []
    for n in spec.n_mean_pars:
        mean_p.append(theta[..., pos:pos + n])
        pos += n
    jitters = theta[..., pos:pos + spec.p]
    return node_p, weight_p, mean_p, jitters


# torch solves a batch of more than one matrix on the card with MAGMA's
# batched potrs, which stops with "invalid argument" from N=7000 on and is
# the slower of the two at N=5000 (an H100, torch 2.11, chip_smoke.py
# phase 25(b): batches of 3 ran at N=6000 and failed at 7000; a dense
# sweep took 0.140 s against 0.091 s); above this N each matrix of a batch
# is solved alone, through cuSOLVER's potrs
BATCHED_SOLVE_MAX_N = 4096


def _cho_solve_mat(L, B):
    """Solve (L Lᵀ) X = B for a batch of lower factors and right-hand-side
    matrices (..., N, k)."""
    lead = L.shape[:-2]
    if not (L.is_cuda and L.shape[-1] > BATCHED_SOLVE_MAX_N
            and lead.numel() > 1):
        return torch.cholesky_solve(B, L)
    Lf = L.reshape(-1, *L.shape[-2:])
    Bf = B.expand(*lead, *B.shape[-2:]).reshape(-1, *B.shape[-2:])
    return torch.stack([torch.cholesky_solve(b, l)
                        for l, b in zip(Lf, Bf)]).reshape(*lead,
                                                          *B.shape[-2:])


def _cho_solve(L, b):
    """Solve (L Lᵀ) x = b for a batch of lower factors and vectors."""
    return _cho_solve_mat(L, b.unsqueeze(-1)).squeeze(-1)


def _tri_apply(X, b):
    """X b for a batch of matrices (..., N, N) and vectors (..., N): one
    batched product."""
    return torch.matmul(X, b.unsqueeze(-1)).squeeze(-1)


def _inv_apply(X, b):
    """A⁻¹ b = Xᵀ(X b) for A = L Lᵀ, given X = L⁻¹: two batched
    products."""
    return torch.matmul(X.transpose(-2, -1),
                        _tri_apply(X, b).unsqueeze(-1)).squeeze(-1)


def _refined(K, d, X, b):
    """A⁻¹ b for A = K + diag(d) given X = L⁻¹: :func:`_inv_apply` and one
    step of iterative refinement, x += Xᵀ X (b − A x).  An explicit
    inverse applied alone rounds like ‖A⁻¹‖‖b‖ and not like ‖A⁻¹ b‖ (at
    the fixed point of an ill-conditioned fit its sweep moved the state by
    1.3 times the triangular solves' 1e-12); the step brings it back to
    them, for a product with K and two with X."""
    x = _inv_apply(X, b)
    return x + _inv_apply(
        X, b - torch.einsum("...ij,...j->...i", K, x) - d * x)


class _Solve(torch.autograd.Function):
    """x = A⁻¹ b for A = K + diag(d), a batch of SPD matrices (..., N, N)
    and vectors (..., N), by :func:`_refined` with X = L⁻¹ of A's factor,
    and differentiated as the solve it is: ḡ = A⁻¹ g (:func:`_refined`
    again) for b, −ḡ xᵀ for K, −ḡ ⊙ x for d, nothing for X.  So the
    gradient reaches K and d without passing back through X's strip
    inversion and the factorization (through them, the implicit
    gradient's adjoint solve stalled above its 1e-10 at q = 1)."""

    @staticmethod
    def forward(ctx, K, d, X, b):
        x = _refined(K, d, X, b)
        ctx.save_for_backward(K, d, X, x)
        return x

    @staticmethod
    def backward(ctx, g):
        K, d, X, x = ctx.saved_tensors
        g_b = _refined(K, d, X, g)
        g_K = (-g_b.unsqueeze(-1) * x.unsqueeze(-2)
               if ctx.needs_input_grad[0] else None)
        return g_K, -g_b * x, None, g_b


def _on_stack(fn, A):
    """``fn`` of a (B, N, N) stack applied to A of shape (..., N, N): the
    leading dimensions are flattened into one stack and restored on every
    output."""
    lead = A.shape[:-2]
    return tuple(o.reshape(*lead, *o.shape[1:])
                 for o in fn(A.reshape(-1, *A.shape[-2:])))


def _rel_std3_stop(hist):
    """The reference stopping rule on the last three ELBO values (the last
    axis of ``hist``): relative std < 1e-3, and not exactly 0."""
    crit = torch.abs(torch.std(hist, dim=-1, correction=0) /
                     torch.mean(hist, dim=-1))
    return (crit < 1e-3) & (crit != 0)


class Engine:
    """Fit and prediction functions for one model structure.

    ``core_maps`` optionally carries per-kernel (trainable → core)
    parameter maps for kernels with static extras (QuasiHarmonicPeriodic):
    a pair (node maps, weight maps) of tuples of callables or None.

    ``lattice_axis`` optionally names a mesh axis over which the (q × p)
    weight lattice is split: the dense paths' weight kernel matrices and
    their factorizations (the prior Cholesky of ``_prepare`` and its
    inverse, the A = K + D⁻¹ factorizations and their inverses of every
    sweep) are built by each rank of the axis for its contiguous share of
    the weight GPs and gathered, under autograd too.  Such an engine is called collectively by the ranks of the mesh
    set by :func:`gpyrn_tpu_torch.parallel.use_mesh` (the JAX package's
    ``jax.set_mesh``).  A lattice that does not divide over the axis stays
    whole on every rank."""

    def __init__(self, spec: GPRNSpec, core_maps: Optional[Tuple] = None,
                 lattice_axis: Optional[str] = None):
        self.spec = spec
        self.node_maps, self.weight_maps = (
            core_maps if core_maps is not None else (None, None))
        self.lattice_axis = lattice_axis

    def _lat_axis(self):
        """The mesh axis that splits the weight lattice, or None when the
        engine is unsharded, the axis has one rank, or q·p does not divide
        over it."""
        if self.lattice_axis is None:
            return None
        from gpyrn_tpu_torch.parallel.mesh import current_mesh, mesh_axis
        mesh = current_mesh()
        if mesh is None:
            raise ValueError(f"the engine's lattice_axis is "
                             f"{self.lattice_axis!r}: call it inside "
                             f"gpyrn_tpu_torch.parallel.use_mesh(mesh)")
        axis = mesh_axis(mesh, self.lattice_axis)
        qp = self.spec.q * self.spec.p
        return axis if axis.size > 1 and qp % axis.size == 0 else None

    def _weight_map(self, fn, X):
        """``fn`` of the stack X (..., q·p, N, N) of weight matrices, each
        output with the lattice at X's dimension -3.  Lattice-sharded,
        each rank applies ``fn`` to its contiguous share and the outputs
        are gathered; the gradient of X collects every share's part."""
        axis = self._lat_axis()
        if axis is None:
            return fn(X)
        from gpyrn_tpu_torch.parallel.mesh import gather_grad, reduce_grad
        dim = X.ndim - 3
        n = X.shape[dim] // axis.size
        outs = fn(reduce_grad(X, axis).narrow(dim, axis.rank * n, n))
        return tuple(gather_grad(o, axis, dim) for o in outs)

    # ---- model-building helpers -------------------------------------------

    @staticmethod
    def _core(params_list, maps):
        """Each component's core parameters from its trainable slice
        (..., n); a map, written for one parameter vector, runs row by
        row."""
        if maps is None:
            return params_list
        return [pp if m is None else torch.stack(
                    [m(r) for r in pp.reshape(-1, pp.shape[-1])]
                ).reshape(*pp.shape[:-1], -1)
                for m, pp in zip(maps, params_list)]

    def _lattice(self, theta, t, jitter_mult=F32_JITTER_MULT):
        """The (..., q·(1+p), N, N) prior lattice of every row of ``theta``
        (..., n_parameters), nodes then weights per row: the components'
        parameters sliced once for all rows, and one ``kernel_matrix_rows``
        call, so on the card B1 writes every matrix into one buffer, its
        parameters rows of ``theta`` (no host read)."""
        spec = self.spec
        batch = theta.shape[:-1]
        theta = theta.reshape(-1, theta.shape[-1])
        node_p, weight_p, _, _ = unpack_parameters(spec, theta)
        weight_structs, weight_maps = spec.weight_structs, self.weight_maps
        axis = self._lat_axis()
        if axis is not None:
            # the rank's share of the weight GPs, built beside the nodes
            from gpyrn_tpu_torch.parallel.mesh import gather_grad, \
                reduce_grad
            n = len(weight_structs) // axis.size
            share = slice(axis.rank * n, (axis.rank + 1) * n)
            weight_structs = weight_structs[share]
            if weight_maps is not None:
                weight_maps = weight_maps[share]
            _, weight_p, _, _ = unpack_parameters(spec,
                                                  reduce_grad(theta, axis))
            weight_p = weight_p[share]
        K = kernel_matrix_rows(spec.node_structs + weight_structs,
                               self._core(node_p, self.node_maps) +
                               self._core(weight_p, weight_maps),
                               t, TRAIN_NUGGET, jitter_mult=jitter_mult)
        if axis is not None:
            q = spec.q
            K = torch.cat([K[:, :q], gather_grad(K[:, q:], axis, 1)], dim=1)
        return K.reshape(*batch, *K.shape[1:])

    def _mean_values(self, theta, t):
        """The (..., p, n_t) mean functions of every row of ``theta``: each
        output's mean evaluated once, over all rows together (a θ batch's
        Keplerian runs its Newton steps once, not once per row)."""
        batch, p = theta.shape[:-1], self.spec.p
        if all(s is None for s in self.spec.mean_structs):
            return torch.zeros((*batch, p, t.shape[0]), dtype=t.dtype,
                               device=t.device)
        _, _, mean_p, _ = unpack_parameters(
            self.spec, theta.reshape(-1, theta.shape[-1]))
        rows = mean_p[0].shape[0]
        out = torch.stack([
            torch.zeros((rows, t.shape[0]), dtype=t.dtype, device=t.device)
            if s is None else means_mod.evaluate(s, mp, t)
            for s, mp in zip(self.spec.mean_structs, mean_p)], dim=1)
        return out.reshape(*batch, p, t.shape[0])

    # ---- heuristic initialisation -----------------------------------------

    def init_mu_var(self, theta, y):
        """(mu, var) starting state of the reference heuristic, (..., d)
        for ``theta`` of shape (..., n_parameters)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        batch = theta.shape[:-1]
        node_p, weight_p, _, jitters = unpack_parameters(self.spec, theta)
        a1 = torch.stack([pp[..., 0] for pp in node_p], dim=-1)   # (..., q)
        a2 = torch.stack([pp[..., 0] for pp in weight_p[:p]],
                         dim=-1)                                # first p only
        ay = torch.abs(y)                                      # (p, N)
        # mean1[j] = mean_i sqrt(|y_i| a1_j / a2_i) sign(y_i)
        m1 = torch.sqrt(ay * a1[..., :, None, None] /
                        a2[..., None, :, None]) * torch.sign(y)  # (...,q,p,N)
        mean1 = torch.mean(m1, dim=-2)                         # (..., q, N)
        # mean2[j,i] = sqrt(|y_i| a2_i / a1_j)
        mean2 = torch.sqrt(ay * a2[..., None, :, None] /
                           a1[..., :, None, None])             # (...,q,p,N)
        var1 = torch.mean(jitters, dim=-1)[..., None, None].expand(
            *batch, q, N)
        var2 = jitters[..., None, :, None].expand(*batch, q, p, N)
        mu = torch.cat([mean1.reshape(*batch, -1),
                        mean2.reshape(*batch, -1)], dim=-1)
        var = torch.cat([var1.reshape(*batch, -1),
                         var2.reshape(*batch, -1)], dim=-1)
        return mu, var

    # ---- one coordinate-ascent sweep + ELBO (ELBOaux) ----------------------
    #
    # Every function below takes optional leading batch dimensions (one
    # per row of a θ batch) in front of the shapes its docstring gives;
    # the single-θ engine calls them with none.

    def _u_split(self, u):
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        batch = u.shape[:-1]
        muF = u[..., :q * N].reshape(*batch, q, N)
        muW = u[..., q * N:].reshape(*batch, p, q, N)
        return muF, muW

    @staticmethod
    def _u_join(muF, muW):
        """The flat (..., d) vector of node and weight blocks."""
        batch = muF.shape[:-2]
        return torch.cat([muF.reshape(*batch, -1), muW.reshape(*batch, -1)],
                         dim=-1)

    @staticmethod
    def _diag_sigma(d_add, dAinv, Kdiag):
        """diag Σ = d − d²·diag(A⁻¹) for Σ = K − K A⁻¹ K, A = K + diag(d),
        clamped to Σ's PSD-order envelopes Σ ⪯ diag(d), Σ ⪯ K."""
        d_sig = d_add - d_add * d_add * dAinv
        # maximum / minimum, not clamp: at a tie they split the gradient
        # in half between the two sides, as JAX's clip does
        tiny = d_sig.new_full((), torch.finfo(d_sig.dtype).tiny)
        return torch.minimum(torch.maximum(d_sig, tiny),
                             torch.minimum(Kdiag, d_add))

    def _sigma_apply(self, X, K, rhs, d_add, dAinv):
        """(Σ @ rhs, diag Σ) for Σ = K − K A⁻¹ K given X = L⁻¹, L the chol
        of A = K + diag(d_add), and diag(A⁻¹)."""
        Krhs = torch.einsum("...ij,...j->...i", K, rhs)
        t1 = _Solve.apply(K, d_add, X, Krhs)
        SWEEP_COUNTS["inverse_solves"] += 1
        sig_rhs = Krhs - torch.einsum("...ij,...j->...i", K, t1)
        d_sig = self._diag_sigma(d_add, dAinv,
                                 torch.diagonal(K, dim1=-2, dim2=-1))
        return sig_rhs, d_sig

    @staticmethod
    def _node_stats(y_c, variance, muF, muW, varW):
        """``(dv, pred)`` of the node update (eqs. 16-17): the precision
        the data add to each node, (q,N), and its information vector,
        (q,N)."""
        var_w = variance[..., :, None, :]                        # (p,1,N)
        dv = torch.sum((muW * muW + varW) / var_w, dim=-3)       # (q,N)
        total = torch.einsum("...pqn,...qn->...pn", muW, muF)
        resid = (y_c[..., None, :, :] - total[..., None, :, :] +
                 muW.transpose(-3, -2) * muF[..., :, None, :])   # (q,p,N)
        pred = torch.einsum("...qpn,...pqn->...qn", resid, muW / var_w)
        return dv, pred

    def _weight_stats(self, y_c, variance, muW, mu_f, dSf):
        """``(ratio, pred2)`` of the weight update (eqs. 18-19) from the
        new node state and the old weights, flat over the lattice
        (q·p,N) [index j·p+i]: the diagonal added to each weight's K and
        its right-hand side."""
        qp, N = self.spec.q * self.spec.p, self.spec.N
        batch = mu_f.shape[:-2]
        dv2 = mu_f * mu_f + dSf                                  # (q,N)
        ratio = (variance[..., None, :, :] /
                 dv2[..., :, None, :]).reshape(*batch, qp, N)
        total2 = torch.einsum("...pqn,...qn->...pn", muW, mu_f)
        resid2 = (y_c[..., None, :, :] - total2[..., None, :, :] +
                  muW.transpose(-3, -2) * mu_f[..., :, None, :])  # (q,p,N)
        pred2 = (resid2 * mu_f[..., :, None, :] /
                 variance[..., None, :, :]).reshape(*batch, qp, N)
        return ratio, pred2

    def _updates(self, Kf, Kw_flat, y_c, variance, muF, varF, muW, varW):
        """The coordinate-ascent updates (eqs. 16-19), Σ-free:

            μ          = K r − K A⁻¹ (K r)
            diag Σ     = d − d²·diag(A⁻¹),  d = diag(D⁻¹)

        A⁻¹ is applied through X = L⁻¹ of A's blocked factor
        (``ops/blocked.py::blocked_chol_inverse``), of which only log diag L
        is kept.  Returns the new ``(mu_f, dSf, mu_w, dSw_qp)`` and the
        factors the ELBO terms reuse, ``(dv, inv_dv, logdiag_f, Xaf,
        dAinv_f, ratio, logdiag_w, dAinv_w)``: log diag L and L⁻¹ of the
        node factors, log diag L of the weights'.  Shapes: Kf (q,N,N),
        Kw_flat (q·p,N,N) [index j·p+i], y_c (p,N), variance (p,N),
        muF/varF (q,N), muW/varW (p,q,N)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        batch = muF.shape[:-2]

        # -- node update (eqs. 16-17) --
        dv, pred = self._node_stats(y_c, variance, muF, muW, varW)
        inv_dv = 1.0 / dv
        Af = Kf + torch.diag_embed(inv_dv)
        logdiag_f, Xaf, dAinv_f = _on_stack(_blocked.blocked_chol_inverse,
                                            Af)
        mu_f, dSf = self._sigma_apply(Xaf, Kf, pred, inv_dv, dAinv_f)

        # -- weight update (eqs. 18-19); uses NEW mu_f, OLD muW --
        ratio, pred2 = self._weight_stats(y_c, variance, muW, mu_f, dSf)
        Aw = Kw_flat + torch.diag_embed(ratio)
        logdiag_w, Xaw, dAinv_w = self._weight_map(
            lambda A: _on_stack(_blocked.blocked_chol_inverse, A), Aw)
        mu_w_flat, dSw = self._sigma_apply(Xaw, Kw_flat, pred2, ratio,
                                           dAinv_w)
        mu_w = mu_w_flat.reshape(*batch, q, p, N).transpose(-3, -2)  # (p,q,N)
        dSw_qp = dSw.reshape(*batch, q, p, N)
        return (mu_f, dSf, mu_w, dSw_qp,
                (dv, inv_dv, logdiag_f, Xaf, dAinv_f, ratio, logdiag_w,
                 dAinv_w))

    def _sweep_updates(self, Kf, Kw_flat, y_c, variance, muF, varF, muW,
                       varW):
        """The updates alone, no ELBO terms (no Cholesky of K or Σ):
        ``(muF, varF, muW, varW)`` of the next sweep."""
        mu_f, dSf, mu_w, dSw_qp, _ = self._updates(
            Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        return mu_f, dSf, mu_w, dSw_qp.transpose(-3, -2)

    def _sweep(self, Kf, Kw_flat, Linv_all, y_c, y_raw, variance, muF, varF,
               muW, varW):
        """One ELBOaux step: the updates, then the ELBO at the new state,
        Σ-free (Σ = K − K A⁻¹ K, A = K + D⁻¹, is never formed):

            log det Σ  = log det K − log det A − log det D
            tr(K⁻¹ Σ)  = tr(A⁻¹ D⁻¹) = Σⱼ dⱼ (A⁻¹)ⱼⱼ

        Every inverse is applied as a product with a triangular inverse:
        A⁻¹ through the updates' L_A⁻¹, μᵀK⁻¹μ as ‖L_K⁻¹ μ‖², the cross
        traces' L_Ak⁻¹ D_k⁻¹ L_j⁻ᵀ as L_Ak⁻¹ times (L_j⁻¹ D_k⁻¹)ᵀ.  Shapes as
        :meth:`_updates`, plus Linv_all (q·(1+p),N,N) the inverses of the
        prior factors (nodes then weights), y_raw (p,N) (the data: no
        batch dimensions)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        qp = q * p
        batch = muF.shape[:-2]
        mu_f, dSf, mu_w, dSw_qp, factors = self._updates(
            Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        (dv, inv_dv, logdiag_f, Xaf, dAinv_f, ratio, logdiag_w,
         dAinv_w) = factors

        # -- entropy: ½ Σ log det Σ by the determinant identity --
        # ½ log det K = −Σ log diag(L_K⁻¹) (the inverse's diagonal is
        # 1 / diag L_K)
        half_ldK = -torch.sum(torch.log(torch.diagonal(
            Linv_all, dim1=-2, dim2=-1)), dim=-1)                # (q·(1+p),)
        ldA_f = 2.0 * torch.sum(logdiag_f, dim=-1)               # (q,)
        ldA_w = 2.0 * torch.sum(logdiag_w, dim=-1)               # (q·p,)
        ldD_f = torch.sum(torch.log(dv), dim=-1)                 # (q,)
        ldD_w = -torch.sum(torch.log(ratio), dim=-1)             # (q·p,)
        ldSig = (2.0 * half_ldK
                 - torch.cat([ldA_f, ldA_w], dim=-1)
                 - torch.cat([ldD_f, ldD_w], dim=-1))
        ent = 0.5 * torch.sum(ldSig, dim=-1) \
            + 0.5 * q * (p + 1) * N * (1 + LOG_2PI)

        # -- expected log prior: μᵀK⁻¹μ = ‖L_K⁻¹ μ‖², one product --
        # reference quirk: the (p,q,N) weight means enter the prior as a
        # RAW flatten to (q·p, N)
        muW_prior = mu_w.reshape(*batch, qp, N)
        mu_all = torch.cat([mu_f, muW_prior], dim=-2)            # (q(1+p),N)
        white = _tri_apply(Linv_all, mu_all)
        SWEEP_COUNTS["inverse_solves"] += 1
        muKmu_all = torch.einsum("...an,...an->...a", white, white)
        tr_f_same = torch.sum(inv_dv * dAinv_f, dim=-1)          # (q,)
        tr_w = torch.sum(ratio * dAinv_w, dim=-1)                # (q·p,)
        # reference quirk: node j's trace term uses the CUMULATIVE sum of
        # sigma_f over nodes <= j.  Cross terms tr(K_j⁻¹ Σ_k), k < j, via
        # Woodbury Σ_k = D_k⁻¹ − D_k⁻¹ A_k⁻¹ D_k⁻¹:
        #   tr(K_j⁻¹ Σ_k) = Σₙ diag(K_j⁻¹)ₙ/dvₖₙ − ‖L_Ak⁻¹ D_k⁻¹ L_j⁻ᵀ‖²
        tr_f_rows = [tr_f_same[..., j] for j in range(q)]
        if q > 1:
            Linv_nodes = Linv_all[..., :q, :, :]
            diag_Kinv = torch.sum(Linv_nodes * Linv_nodes, dim=-2)  # (q,N)
            for j in range(1, q):
                for k in range(j):
                    term1 = torch.sum(diag_Kinv[..., j, :] * inv_dv[..., k, :],
                                      dim=-1)
                    T = Linv_nodes[..., j, :, :] * \
                        inv_dv[..., k, None, :]                  # (N,N)
                    W = torch.matmul(Xaf[..., k, :, :], T.transpose(-2, -1))
                    SWEEP_COUNTS["inverse_solves"] += 1
                    tr_f_rows[j] = tr_f_rows[j] + term1 - \
                        torch.sum(W * W, dim=(-2, -1))
        tr_f = torch.stack(tr_f_rows, dim=-1)
        tr_all = torch.cat([tr_f, tr_w], dim=-1)
        logp = torch.sum(-half_ldK - 0.5 * (muKmu_all + tr_all), dim=-1) \
            - 0.5 * N * q * (p + 1) * LOG_2PI

        # -- expected log likelihood (raw-y quirk) --
        logl = -0.5 * torch.sum(torch.log(2 * math.pi * variance),
                                dim=(-2, -1))
        omega_nu = torch.einsum("...pqn,...qn->...pn", mu_w, mu_f)
        res = y_raw - omega_nu
        logl = logl - 0.5 * torch.sum(res * res / variance, dim=(-2, -1))
        quad = (dSf[..., :, None, :] * (mu_w.transpose(-3, -2) ** 2) +
                dSw_qp * (mu_f[..., :, None, :] ** 2) +
                dSf[..., :, None, :] * dSw_qp) / variance[..., None, :, :]
        logl = logl - 0.5 * torch.sum(quad, dim=(-3, -2, -1))

        elbo = (logl + logp + ent) / q
        return elbo, mu_f, dSf, mu_w, dSw_qp.transpose(-3, -2)

    # ---- fit --------------------------------------------------------------

    def _prepare(self, theta, t, y, yerr2):
        """The per-θ constants of the sweeps: ``(Kf, Kw_flat, Linv_all,
        y_c, y, variance)``, all but the data ``y`` with the leading batch
        dimensions of ``theta``; ``Linv_all`` holds the inverses of the
        prior lattice's Cholesky factors (the prior term, the log
        determinants and, at q > 1, the nodes' cross traces)."""
        q = self.spec.q
        K_all = self._lattice(theta, t)
        _, _, _, jitters = unpack_parameters(self.spec, theta)

        def prior_inverse(K):
            # ONE batched Cholesky, then its inverse by strip inversion
            return _on_stack(lambda K: (_blocked.tri_inverse(
                _blocked.cholesky_nan(K)),), K)

        # the whole q·(1+p) prior lattice (the weights' split over the
        # lattice axis, when there is one)
        if self._lat_axis() is None:
            (Linv_all,) = prior_inverse(K_all)
        else:
            (Lw,) = self._weight_map(prior_inverse, K_all[..., q:, :, :])
            Linv_all = torch.cat([prior_inverse(K_all[..., :q, :, :])[0],
                                  Lw], dim=-3)
        m = self._mean_values(theta, t)
        y_c = y - m
        variance = jitters[..., :, None] ** 2 + yerr2
        return (K_all[..., :q, :, :], K_all[..., q:, :, :], Linv_all, y_c,
                y, variance)

    def sweep_once(self, theta, t, y, yerr2, mu0, var0):
        """Single ELBOaux step: ``(elbo, mu, var)``."""
        prepared = self._prepare(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        elbo, mu_f, varf, mu_w, varw = self._sweep(*prepared, muF, varF,
                                                   muW, varW)
        return elbo, self._u_join(mu_f, mu_w), self._u_join(varf, varw)

    def elbo_fit(self, theta, t, y, yerr2, mu0, var0, max_iter=10000):
        """Coordinate ascent until the relative std of the last three
        ELBO values is below 1e-3 (checked from sweep 4 on) or
        ``max_iter`` sweeps.  Returns ``(elbo, mu, var, n_iter,
        converged, trace)`` with ``trace`` the per-sweep ELBO values."""
        prepared = self._prepare(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        dtype, device = muF.dtype, muF.device
        elbo = torch.zeros((), dtype=dtype, device=device)
        hist = torch.full((3,), float("inf"), dtype=dtype, device=device)
        trace = []
        it, done = 0, False
        while not done and it < max_iter:
            elbo, muF, varF, muW, varW = self._sweep(*prepared, muF, varF,
                                                     muW, varW)
            hist = torch.cat([hist[1:], elbo.reshape(1)])
            trace.append(elbo)
            it += 1
            if it > 3:
                done = bool(_rel_std3_stop(hist))
        trace = torch.stack(trace) if trace else \
            torch.zeros(0, dtype=dtype, device=device)
        return (elbo, self._u_join(muF, muW), self._u_join(varF, varW), it,
                done, trace)

    # ---- a batch of hyperparameter vectors --------------------------------

    @staticmethod
    def _rows(theta, x):
        """``x`` of shape (d,) broadcast to one copy per row of ``theta``
        (W, n_parameters); (W, d) passes as it is."""
        return x.expand(theta.shape[0], x.shape[-1]) if x.ndim == 1 else x

    def elbo_fit_batch(self, theta, t, y, yerr2, mu0, var0, max_iter=10000):
        """:meth:`elbo_fit` of every row of ``theta`` (W, n_parameters)
        from its row of ``mu0`` / ``var0`` (W, d), in one pass: the JAX
        package's ``vmap(elbo_fit)``.  Each row applies the rel-std(3) rule
        on its own, and a row that stopped keeps its state, its ELBO and
        its sweep count; a row whose ELBO is not finite sweeps on to
        ``max_iter``.  Only the rows still running are swept: when rows
        stop, the constants and states of the others are gathered.  One
        boolean per row comes to the host per sweep (from sweep 4 on).
        Returns ``(elbo (W,), mu (W, d), var (W, d), n_iter (W,),
        converged (W,))``.

        Recorded (``utils/profiling.py``): the span ``gprn.fit_batch``
        around the call, with what the counters rose by, and inside it
        ``gprn.prepare``, each sweep's ``gprn.sweep`` (its launches) and
        ``gprn.stop`` (the ELBO history and the stop test's read), and
        ``gprn.gather`` (the rows written out and the running rows
        gathered); the counters ``gprn.batch.sweeps`` and
        ``gprn.batch.host_reads``, each call of the loop's own that waits
        for the device: a copy to or from the host, and a boolean-mask
        index (its ``nonzero``).  The syncs of the libraries inside a
        sweep are not counted."""
        with _profiling.span("gprn.fit_batch", counts=True):
            return self._fit_batch(theta, t, y, yerr2, mu0, var0, max_iter)

    def _fit_batch(self, theta, t, y, yerr2, mu0, var0, max_iter):
        W = theta.shape[0]
        with _profiling.span("gprn.prepare"):
            prepared = list(self._prepare(theta, t, y, yerr2))
        muF, muW = self._u_split(self._rows(theta, mu0))
        varF, varW = self._u_split(self._rows(theta, var0))
        state = [muF, varF, muW, varW]
        dtype, device = muF.dtype, muF.device
        elbo_out = torch.zeros(W, dtype=dtype, device=device)
        mu_out = self._u_join(muF, muW).clone()
        var_out = self._u_join(varF, varW).clone()
        n_iter = np.zeros(W, dtype=np.int64)
        converged = np.zeros(W, dtype=bool)
        hist = torch.full((W, 3), float("inf"), dtype=dtype, device=device)
        rows = np.arange(W)                 # the original index of each row
        elbo, it = None, 0

        def put(a):
            """A host array on the device: a host read."""
            BATCH_COUNTS["host_reads"] += 1
            return torch.as_tensor(a, device=device)

        def take(x, mask):
            """x[mask], a boolean mask on the device: a host read."""
            BATCH_COUNTS["host_reads"] += 1
            return x[mask]

        def finish(sel):
            """Write the rows ``sel`` (a mask over the running rows) out."""
            where, mask = put(rows[sel]), put(sel)
            elbo_out[where] = take(elbo, mask)
            mu_out[where] = self._u_join(take(state[0], mask),
                                         take(state[2], mask))
            var_out[where] = self._u_join(take(state[1], mask),
                                          take(state[3], mask))
            n_iter[rows[sel]] = it

        while rows.size and it < max_iter:
            with _profiling.span("gprn.sweep"):
                elbo, *state = self._sweep(*prepared, *state)
            BATCH_COUNTS["sweeps"] += 1
            it += 1
            with _profiling.span("gprn.stop"):
                hist = torch.cat([hist[:, 1:], elbo[:, None]], dim=1)
                if it > 3:
                    done = _rel_std3_stop(hist).cpu().numpy()
                    BATCH_COUNTS["host_reads"] += 1
            if it <= 3 or not done.any():
                continue
            with _profiling.span("gprn.gather"):
                finish(done)
                converged[rows[done]] = True
                keep = put(~done)
                rows = rows[~done]
                # the data (prepared[4]) has no row axis
                prepared = [x if i == 4 else take(x, keep)
                            for i, x in enumerate(prepared)]
                state = [take(s, keep) for s in state]
                hist, elbo = take(hist, keep), take(elbo, keep)
        with _profiling.span("gprn.gather"):
            if rows.size and elbo is not None:
                finish(np.ones(rows.size, dtype=bool))
            return elbo_out, mu_out, var_out, put(n_iter), put(converged)

    def elbo_fixed_batch(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """:meth:`elbo_fixed` of every row of ``theta`` (W, n_parameters),
        as (W,): the JAX package's ``elbo_fixed.static`` under ``vmap``.
        ``mu0`` / ``var0`` are one state (d,) for every row, or one per row
        (W, d)."""
        elbo, *_ = self._static_sweeps(theta, t, y, yerr2,
                                       self._rows(theta, mu0),
                                       self._rows(theta, var0), n_sweeps)
        return elbo

    # ---- converged-state fits (updates-only, exact nugget) ----------------

    def _plain_matrices(self, theta, t):
        """``(Kf, Kw_flat)`` with the fixed training nugget alone (no
        float32 trace scaling): the matrices of the updates-only fits,
        whose (K + D⁻¹) solves are float32-safe by D⁻¹, so that a float32
        fit converges to the true model's fixed point."""
        K = self._lattice(theta, t, jitter_mult=0.0)
        q = self.spec.q
        return K[..., :q, :, :], K[..., q:, :, :]

    @staticmethod
    def _state_delta(mu_f, mu_w, muF, muW):
        """max |Δμ| / (1 + max |μ|) of one sweep, a 0-d tensor."""
        scale = 1.0 + torch.maximum(mu_f.abs().max(), mu_w.abs().max())
        return torch.maximum((mu_f - muF).abs().max(),
                             (mu_w - muW).abs().max()) / scale

    def fit_state(self, theta, t, y, yerr2, mu0, var0, max_iter, tol):
        """Iterate the updates-only sweep on the exact-nugget matrices
        until the variational means stand still,
        max |Δμ| / (1 + max |μ|) < ``tol``, or ``max_iter`` sweeps.
        Returns ``(mu, var, n_iter, converged)``.  One boolean comes to
        the host per sweep."""
        Kf, Kw_flat = self._plain_matrices(theta, t)
        _, _, _, jitters = unpack_parameters(self.spec, theta)
        y_c = y - self._mean_values(theta, t)
        variance = jitters[:, None] ** 2 + yerr2
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        tol = torch.as_tensor(tol, dtype=muF.dtype, device=muF.device)
        it, done = 0, False
        while not done and it < max_iter:
            mu_f, varF, mu_w, varW = self._sweep_updates(
                Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
            done = bool(self._state_delta(mu_f, mu_w, muF, muW) < tol)
            muF, muW = mu_f, mu_w
            it += 1
        return self._u_join(muF, muW), self._u_join(varF, varW), it, done

    def _merit_stall_loop(self, block_fn, mu0, var0, max_iter, tol,
                          stall_tol, patience, block, info=None):
        """The loop of the merit-stall fit: ``block``-sweep chunks of the
        updates-only map, each scored by the ELBO its last sweep
        evaluates.  Stops when the state stands still (``fit_state``'s
        rule on the chunk's last sweep) or the merit stalls: ``patience``
        chunks in a row that fail to beat ``best + stall_tol·|best|`` (in
        float32 the state wobbles at the rounding floor forever, so the
        state rule alone often never fires).  A non-finite merit never
        improves.  Returns the best-merit state on a stall and the current
        state on the state rule, or when no merit was ever finite.  The
        merit, its threshold and the counters stay on the device in the
        state's dtype; one boolean comes to the host per chunk.  ``info``,
        when a dict, receives ``blocks``, ``nonfinite_merits``,
        ``best_merit`` and ``stalled``."""
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        cur = (muF, varF, muW, varW)
        dt, dev = muF.dtype, muF.device
        tol = torch.as_tensor(tol, dtype=dt, device=dev)
        stall_tol = torch.as_tensor(stall_tol, dtype=dt, device=dev)
        neg_inf = torch.full((), -math.inf, dtype=dt, device=dev)
        bE, best = neg_inf, cur
        delta = torch.full((), math.inf, dtype=dt, device=dev)
        stall = torch.zeros((), dtype=torch.int32, device=dev)
        nonfinite = torch.zeros((), dtype=torch.int32, device=dev)
        it, done = 0, False
        while not done and it < max_iter:
            e, *cur, delta = block_fn(*cur)
            # -inf best (no finite merit yet): any finite e improves
            thresh = torch.where(torch.isfinite(bE),
                                 bE + stall_tol * torch.abs(bE), neg_inf)
            improved = torch.isfinite(e) & (e > thresh)
            bE = torch.where(improved, e, bE)
            best = tuple(torch.where(improved, c, b)
                         for c, b in zip(cur, best))
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
            nonfinite = nonfinite + (~torch.isfinite(e)).to(torch.int32)
            it += block
            done = bool((delta < tol) | (stall >= patience))
        # state rule (or a merit that never went finite): the current
        # state is the most converged; on a stall the best-merit one
        take_cur = (delta < tol) | ~torch.isfinite(bE)
        muF, varF, muW, varW = (torch.where(take_cur, c, b)
                                for c, b in zip(cur, best))
        if info is not None:
            info.update(blocks=it // block,
                        nonfinite_merits=int(nonfinite),
                        best_merit=float(bE),
                        stalled=bool(done and not bool(delta < tol)))
        return self._u_join(muF, muW), self._u_join(varF, varW), it, done

    def fit_state_stall(self, theta, t, y, yerr2, mu0, var0, max_iter, tol,
                        block, stall_tol, patience, info=None):
        """:meth:`fit_state` with the merit-stall stopping rule: chunks of
        ``block − 1`` updates-only sweeps and one full :meth:`_sweep`, all
        on the exact-nugget matrices (the update map is ``fit_state``'s);
        only the ELBO's prior terms use the jittered prior factors of
        :meth:`_prepare`, which is what keeps them finite in float32.
        Returns ``(mu, var, n_iter, converged)``; ``n_iter`` counts whole
        chunks, so up to ``block − 1`` sweeps may run past ``max_iter``."""
        block = int(block)
        _, _, Linv_all, y_c, y_raw, variance = self._prepare(theta, t, y,
                                                             yerr2)
        Kf_p, Kw_p = self._plain_matrices(theta, t)

        def block_fn(muF, varF, muW, varW):
            for _ in range(block - 1):
                muF, varF, muW, varW = self._sweep_updates(
                    Kf_p, Kw_p, y_c, variance, muF, varF, muW, varW)
            e, mu_f, varf, mu_w, varw = self._sweep(
                Kf_p, Kw_p, Linv_all, y_c, y_raw, variance, muF, varF, muW,
                varW)
            return (e, mu_f, varf, mu_w, varw,
                    self._state_delta(mu_f, mu_w, muF, muW))

        return self._merit_stall_loop(block_fn, mu0, var0, max_iter, tol,
                                      stall_tol, patience, block, info)

    # ---- the lean engines: each GP's K rebuilt inside its own update -------
    #
    # The dense engine holds the whole q·(1+p) lattice of N×N matrices and
    # its factors; the lean engines visit the GPs one at a time, building
    # K (B1 on the card), factoring and solving inside the GP's update and
    # dropping all of it before the next GP's build.  Peak memory is one
    # GP's few N² buffers whatever q·p is; the work per sweep is the
    # dense sweep's plus one K build per GP (and, on the ELBO path, one
    # Cholesky of K).  Single θ only, no batch dimensions.

    def _gp_update_lean(self, structure, cp, t, d_add, pred,
                        builder=kernel_matrix_plain):
        """One GP's coordinate update, K rebuilt: ``(Σ pred, diag Σ)`` for
        Σ = K − K A⁻¹ K, A = K + diag(d_add).  ``builder`` is the exact-
        nugget ``kernel_matrix_plain`` on the updates-only path and the
        ELBO path's ``kernel_matrix`` when ``elbo_refine_lean`` drives it.
        A is built out of place: K itself goes on into ``K @ pred`` and
        the clamp's diag K."""
        K = builder(structure, cp, t, TRAIN_NUGGET)
        A = K.clone()
        A.diagonal().add_(d_add)
        L, dAinv = _blocked.blocked_chol_diag_ainv(A[None])
        del A
        Krhs = K @ pred
        t1 = _cho_solve(L[0], Krhs)
        sig_rhs = Krhs - K @ t1
        return sig_rhs, self._diag_sigma(d_add, dAinv[0], torch.diagonal(K))

    def _lean_cores(self, theta):
        node_p, weight_p, _, _ = unpack_parameters(self.spec, theta)
        return (self._core(node_p, self.node_maps),
                self._core(weight_p, self.weight_maps))

    def _sweep_updates_lean(self, theta, t, y_c, variance, muF, varF, muW,
                            varW, builder=kernel_matrix_plain):
        """:meth:`_sweep_updates` with the GPs visited one at a time and
        each K rebuilt in its update (:meth:`_gp_update_lean`)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        node_c, weight_c = self._lean_cores(theta)
        dv, pred = self._node_stats(y_c, variance, muF, muW, varW)
        rows = [self._gp_update_lean(s, node_c[j], t, 1.0 / dv[j], pred[j],
                                     builder)
                for j, s in enumerate(self.spec.node_structs)]
        mu_f = torch.stack([r[0] for r in rows])
        dSf = torch.stack([r[1] for r in rows])

        ratio, pred2 = self._weight_stats(y_c, variance, muW, mu_f, dSf)
        rows = [self._gp_update_lean(s, weight_c[a], t, ratio[a], pred2[a],
                                     builder)
                for a, s in enumerate(self.spec.weight_structs)]
        mu_w = torch.stack([r[0] for r in rows]).reshape(q, p, N) \
            .transpose(0, 1)
        dSw = torch.stack([r[1] for r in rows]).reshape(q, p, N)
        return mu_f, dSf, mu_w, dSw.transpose(0, 1)

    def _gp_free(self, structure, cp, t, c_diag, pred_vec, keep_factors):
        """One GP's update and its ELBO ingredients, Σ-free, K from the
        ELBO path's ``kernel_matrix``: ``(mu, diag Σ, tr(A⁻¹D⁻¹), ½ log
        det K, log det A, μᵀK⁻¹μ)``, and with ``keep_factors`` the chol of
        A and L_K⁻¹ (a node's, for the cross traces at q > 1)."""
        K = kernel_matrix(structure, cp, t, TRAIN_NUGGET)
        L_K = _blocked.cholesky_nan(K)
        ldK_half = torch.sum(torch.log(torch.diagonal(L_K)))
        A = K.clone()
        A.diagonal().add_(c_diag)
        L_Ab, dAinv = _blocked.blocked_chol_diag_ainv(A[None])
        del A
        L_A, dAinv = L_Ab[0], dAinv[0]
        ldA = 2.0 * torch.sum(torch.log(torch.diagonal(L_A)))
        Krhs = K @ pred_vec
        mu = Krhs - K @ _cho_solve(L_A, Krhs)
        dS = self._diag_sigma(c_diag, dAinv, torch.diagonal(K))
        del K
        tr_same = torch.sum(c_diag * dAinv)
        # μᵀK⁻¹μ with the post-update mean: the right pairing for nodes
        # always and for weights at q == 1 (the raw (p,q,N) flatten is the
        # identity there); q > 1 weights are paired again afterwards
        muKmu = torch.dot(mu, _cho_solve(L_K, mu))
        out = (mu, dS, tr_same, ldK_half, ldA, muKmu)
        if keep_factors:
            eye = torch.eye(L_K.shape[-1], dtype=L_K.dtype,
                            device=L_K.device)
            out += (L_A, torch.linalg.solve_triangular(L_K, eye,
                                                       upper=False))
        return out

    def _gp_muKmu(self, structure, cp, t, mvec):
        """μᵀK⁻¹μ of one GP, K rebuilt (the ELBO path's builder)."""
        L_K = _blocked.cholesky_nan(kernel_matrix(structure, cp, t,
                                                  TRAIN_NUGGET))
        return torch.dot(mvec, _cho_solve(L_K, mvec))

    def _sweep_free_lean(self, theta, t, y_c, y_raw, variance, muF, varF,
                         muW, varW):
        """One ELBOaux step with the GPs visited one at a time: the lean
        counterpart of :meth:`_sweep`, the same determinant and trace
        identities, each GP's K, prior Cholesky and update factor alive
        only inside its own update.  Returns ``(elbo, mu_f, varf, mu_w,
        varw)``."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        qp = q * p
        node_c, weight_c = self._lean_cores(theta)

        def stack(rows, k):
            return torch.stack([r[k] for r in rows])

        # -- node stage --
        dv, pred = self._node_stats(y_c, variance, muF, muW, varW)
        inv_dv = 1.0 / dv
        node_out = [self._gp_free(s, node_c[j], t, inv_dv[j], pred[j],
                                  q > 1)
                    for j, s in enumerate(self.spec.node_structs)]
        mu_f, dSf = stack(node_out, 0), stack(node_out, 1)

        # -- weight stage (fresh mu_f, pre-sweep muW) --
        ratio, pred2 = self._weight_stats(y_c, variance, muW, mu_f, dSf)
        weight_out = [self._gp_free(s, weight_c[a], t, ratio[a], pred2[a],
                                    False)
                      for a, s in enumerate(self.spec.weight_structs)]
        mu_w = stack(weight_out, 0).reshape(q, p, N).transpose(0, 1)
        dSw_qp = stack(weight_out, 1).reshape(q, p, N)
        muKmu_w = stack(weight_out, 5)
        if q > 1:
            # reference quirk: the weight means enter the prior RAW-
            # flattened (p,q,N) → (q·p,N), row a paired with weight GP a's
            # kernel: a second rebuild pass pairs them so
            muW_prior = mu_w.reshape(qp, N)
            muKmu_w = torch.stack([
                self._gp_muKmu(s, weight_c[a], t, muW_prior[a])
                for a, s in enumerate(self.spec.weight_structs)])

        # -- entropy: ½ Σ log det Σ by the determinant identity --
        ldD_f = torch.sum(torch.log(dv), dim=-1)
        ldD_w = -torch.sum(torch.log(ratio), dim=-1)
        ldKh = torch.cat([stack(node_out, 3), stack(weight_out, 3)])
        ldSig = (2.0 * ldKh
                 - torch.cat([stack(node_out, 4), stack(weight_out, 4)])
                 - torch.cat([ldD_f, ldD_w]))
        ent = 0.5 * torch.sum(ldSig) + 0.5 * q * (p + 1) * N * (1 + LOG_2PI)

        # -- expected log prior, with the cumulative cross traces --
        tr_f_rows = [node_out[j][2] for j in range(q)]
        if q > 1:
            Linv_nodes = stack(node_out, 7)
            diag_Kinv = torch.sum(Linv_nodes * Linv_nodes, dim=-2)
            for j in range(1, q):
                for k in range(j):
                    term1 = torch.sum(diag_Kinv[j] * inv_dv[k])
                    T = Linv_nodes[j] * inv_dv[k][None, :]
                    W = torch.linalg.solve_triangular(
                        node_out[k][6], T.transpose(-2, -1), upper=False)
                    tr_f_rows[j] = tr_f_rows[j] + term1 - torch.sum(W * W)
        tr_all = torch.cat([torch.stack(tr_f_rows), stack(weight_out, 2)])
        muKmu_all = torch.cat([stack(node_out, 5), muKmu_w])
        logp = torch.sum(-ldKh - 0.5 * (muKmu_all + tr_all)) \
            - 0.5 * N * q * (p + 1) * LOG_2PI

        # -- expected log likelihood (raw-y quirk) --
        logl = -0.5 * torch.sum(torch.log(2 * math.pi * variance))
        omega_nu = torch.einsum("pqn,qn->pn", mu_w, mu_f)
        res = y_raw - omega_nu
        logl = logl - 0.5 * torch.sum(res * res / variance)
        quad = (dSf[:, None, :] * (mu_w.transpose(0, 1) ** 2) +
                dSw_qp * (mu_f[:, None, :] ** 2) +
                dSf[:, None, :] * dSw_qp) / variance[None, :, :]
        logl = logl - 0.5 * torch.sum(quad)

        elbo = (logl + logp + ent) / q
        return elbo, mu_f, dSf, mu_w, dSw_qp.transpose(0, 1)

    def _prepare_lean(self, theta, t, y, yerr2):
        """``(y_c, y_raw, variance)``: the lean engines' per-θ constants
        (no kernel matrix)."""
        _, _, _, jitters = unpack_parameters(self.spec, theta)
        y_c = y - self._mean_values(theta, t)
        return y_c, y, jitters[:, None] ** 2 + yerr2

    def elbo_fit_lean(self, theta, t, y, yerr2, mu0, var0, max_iter=10000):
        """:meth:`elbo_fit` (the reference stopping rule and the ELBO
        trace) with the lean sweep: the reference-semantics fit at N in
        the tens of thousands.  One boolean comes to the host per sweep
        from sweep 4 on."""
        y_c, y_raw, variance = self._prepare_lean(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        dtype, device = muF.dtype, muF.device
        elbo = torch.zeros((), dtype=dtype, device=device)
        hist = torch.full((3,), float("inf"), dtype=dtype, device=device)
        trace = []
        it, done = 0, False
        while not done and it < max_iter:
            elbo, muF, varF, muW, varW = self._sweep_free_lean(
                theta, t, y_c, y_raw, variance, muF, varF, muW, varW)
            hist = torch.cat([hist[1:], elbo.reshape(1)])
            trace.append(elbo)
            it += 1
            if it > 3:
                done = bool(_rel_std3_stop(hist))
        trace = torch.stack(trace) if trace else \
            torch.zeros(0, dtype=dtype, device=device)
        return (elbo, self._u_join(muF, muW), self._u_join(varF, varW), it,
                done, trace)

    def elbo_refine_lean(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, mu, var)`` after exactly ``n_sweeps`` lean sweeps: the
        first n−1 updates-only (one factorization per GP) on the ELBO
        path's builder, then one full :meth:`_sweep_free_lean`, the same
        trajectory as n full sweeps."""
        n_sweeps = int(n_sweeps)
        if n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1 (an unswept ELBO is "
                             "undefined)")
        y_c, y_raw, variance = self._prepare_lean(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        for _ in range(n_sweeps - 1):
            muF, varF, muW, varW = self._sweep_updates_lean(
                theta, t, y_c, variance, muF, varF, muW, varW,
                builder=kernel_matrix)
        elbo, muF, varF, muW, varW = self._sweep_free_lean(
            theta, t, y_c, y_raw, variance, muF, varF, muW, varW)
        return elbo, self._u_join(muF, muW), self._u_join(varF, varW)

    def fit_state_lean(self, theta, t, y, yerr2, mu0, var0, max_iter, tol):
        """:meth:`fit_state` with the lean updates (exact-nugget builds):
        ``(mu, var, n_iter, converged)``, one boolean to the host per
        sweep."""
        y_c, _, variance = self._prepare_lean(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        tol = torch.as_tensor(tol, dtype=muF.dtype, device=muF.device)
        it, done = 0, False
        while not done and it < max_iter:
            mu_f, varF, mu_w, varW = self._sweep_updates_lean(
                theta, t, y_c, variance, muF, varF, muW, varW)
            done = bool(self._state_delta(mu_f, mu_w, muF, muW) < tol)
            muF, muW = mu_f, mu_w
            it += 1
        return self._u_join(muF, muW), self._u_join(varF, varW), it, done

    def fit_state_stall_lean(self, theta, t, y, yerr2, mu0, var0, max_iter,
                             tol, block, stall_tol, patience, info=None):
        """:meth:`fit_state_stall` with the lean sweeps: chunks of
        ``block − 1`` lean updates (exact-nugget builds) and one
        :meth:`_sweep_free_lean` (the ELBO path's builder) as the merit
        sweep, through :meth:`_merit_stall_loop`."""
        block = int(block)
        y_c, y_raw, variance = self._prepare_lean(theta, t, y, yerr2)

        def block_fn(muF, varF, muW, varW):
            for _ in range(block - 1):
                muF, varF, muW, varW = self._sweep_updates_lean(
                    theta, t, y_c, variance, muF, varF, muW, varW)
            e, mu_f, varf, mu_w, varw = self._sweep_free_lean(
                theta, t, y_c, y_raw, variance, muF, varF, muW, varW)
            return (e, mu_f, varf, mu_w, varw,
                    self._state_delta(mu_f, mu_w, muF, muW))

        return self._merit_stall_loop(block_fn, mu0, var0, max_iter, tol,
                                      stall_tol, patience, block, info)

    # ---- fixed sweep counts and the gradient ------------------------------

    def _static_sweeps(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``n_sweeps`` sweeps from (mu0, var0): n−1 updates-only sweeps,
        then one full :meth:`_sweep` whose ELBO is the result.  Returns
        ``(elbo, muF, varF, muW, varW)``, with the leading batch dimensions
        of ``theta`` (the states have them too)."""
        n_sweeps = int(n_sweeps)
        if n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1 (an unswept ELBO is "
                             "undefined)")
        prepared = self._prepare(theta, t, y, yerr2)
        Kf, Kw_flat, _, y_c, _, variance = prepared
        batch = theta.shape[:-1]
        muF, muW = self._u_split(mu0.reshape(*batch, -1))
        varF, varW = self._u_split(var0.reshape(*batch, -1))
        for _ in range(n_sweeps - 1):
            muF, varF, muW, varW = self._sweep_updates(
                Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        return self._sweep(*prepared, muF, varF, muW, varW)

    def elbo_fixed(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """The ELBO after exactly ``n_sweeps`` sweeps from (mu0, var0):
        a deterministic function of ``theta``, differentiable by
        autograd."""
        elbo, *_ = self._static_sweeps(theta, t, y, yerr2, mu0, var0,
                                       n_sweeps)
        return elbo

    def elbo_refine(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, mu, var)`` after exactly ``n_sweeps`` sweeps."""
        elbo, muF, varF, muW, varW = self._static_sweeps(
            theta, t, y, yerr2, mu0, var0, n_sweeps)
        return elbo, self._u_join(muF, muW), self._u_join(varF, varW)

    def elbo_value_and_grad(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, d elbo / d theta)`` of :meth:`elbo_fixed`, by autograd
        through the ``n_sweeps`` unrolled sweeps (the starting state and
        the data are constants), in the tensors' dtype."""
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            elbo = self.elbo_fixed(theta, t, y, yerr2, mu0, var0, n_sweeps)
            (grad,) = torch.autograd.grad(elbo, theta)
        return elbo.detach(), grad

    # ---- posterior predictive ---------------------------------------------

    def predict(self, theta, t, y, yerr2, mu, var, tstar):
        """Batched GP conditionals over the whole q·(1+p) lattice:
        ``(means (n*, p), vars (n*, p), node_pred (q, n*),
        weight_pred (q·p, n*))``."""
        spec = self.spec
        q, p = spec.q, spec.p
        node_p, weight_p, _, jitters = unpack_parameters(spec, theta)
        node_c = self._core(node_p, self.node_maps)
        weight_c = self._core(weight_p, self.weight_maps)
        muF, muW = self._u_split(mu.reshape(-1))
        varF, varW = self._u_split(var.reshape(-1))
        tstar = torch.atleast_1d(tstar)
        m_star = self._mean_values(theta, tstar)                 # (p, n*)

        structs = list(spec.node_structs) + list(spec.weight_structs)
        all_params = list(node_c) + list(weight_c)
        # reference weight-lattice order in prediction is (i·q + j)
        m_rows = torch.cat([
            muF, muW.permute(1, 0, 2).reshape(q * p, -1)])       # (B, N)
        v_rows = torch.cat([
            varF, varW.permute(1, 0, 2).reshape(q * p, -1)])

        K_all = kernel_matrix_stack(structs, all_params, t, PREDICT_NUGGET)
        Ks_all = torch.stack([cross_kernel_matrix(s, cp, tstar, t)
                              for s, cp in zip(structs, all_params)])
        Kss_diag = torch.stack([kernel_diag(s, cp, tstar, PREDICT_NUGGET)
                                for s, cp in zip(structs, all_params)])

        L = _blocked.cholesky_nan(K_all + torch.diag_embed(v_rows))
        sol = _cho_solve(L, m_rows)
        means = torch.einsum("bsk,bk->bs", Ks_all, sol)          # (B, n*)
        inner = _cho_solve_mat(L, Ks_all.transpose(1, 2))      # (B, N, n*)
        vars_ = Kss_diag - torch.einsum("bsk,bks->bs", Ks_all, inner)

        n_pred, n_var = means[:q], vars_[:q]                     # (q, n*)
        w_pred = means[q:].reshape(q, p, -1)
        w_var = vars_[q:].reshape(q, p, -1)

        jitt2 = jitters ** 2
        # the reference adds jitt² once per node — reproduced exactly
        mean_out = m_star.T + torch.einsum("qn,qpn->np", n_pred, w_pred)
        var_out = torch.einsum(
            "qpn->np",
            w_pred ** 2 * n_var[:, None, :] +
            w_var * (n_var[:, None, :] + n_pred[:, None, :] ** 2)) \
            + q * jitt2[None, :]
        return mean_out, var_out, n_pred, w_pred.reshape(q * p, -1)


@functools.lru_cache(maxsize=128)
def make_engine(spec: GPRNSpec, core_maps: Optional[Tuple] = None,
                lattice_axis: Optional[str] = None) -> Engine:
    """The engine of a model structure (the JAX package's factory): an
    :class:`Engine` holds only its spec, maps and axis, so one engine per
    key is shared.  ``core_maps`` must be hashable (a tuple of tuples of
    callables or None)."""
    return Engine(spec, core_maps, lattice_axis)
