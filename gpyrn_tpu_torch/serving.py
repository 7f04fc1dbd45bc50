"""Ahead-of-time export of the fitted GPRN posterior predictive.

Port of :mod:`gpyrn_tpu.serving` on ``torch.export``.  ``export_predict``
traces the engine's posterior predictive (``models/gprn.py``
``Engine.predict``) into an ``ExportedProgram`` with the training inputs
and the fitted variational state baked in as constants: θ, t, y, yerr²,
μ and var, O(N·q·(p+1)) numbers.  Every request runs the whole predictive,
the kernel matrices included: on the card, B1 launches inside each served
call (the custom operator ``gpyrn_torch::kernel_matrix_stack`` of
:mod:`gpyrn_tpu_torch.ops.cuda_kernels`).  Neither the N × N matrices nor
their factors are stored, which at N = 20,000 would be gigabytes.

The number of prediction points is a symbolic dimension by default
(``torch.export.Dim``), so one artifact serves requests of any size;
``n_star=`` pins it.

Where it differs from the JAX package:

* an artifact runs on the device it was exported on (``device=``, the
  model's device by default, in place of JAX's ``platforms=``): export on
  the card to serve on the card.  A CUDA artifact does not load where
  there is no card;
* a serving process needs torch and this package's operator module (it
  loads ``ops/cuda_kernels.py``, ``ops/kernels.py`` and ``ops/_build.py``,
  never the shell or the engine), and on the card the CUDA kernels, which
  it builds from ``csrc/kernel_matrix.cu`` with nvcc at first use.  The
  JAX artifact needed jax alone;
* ``ServingPredictor`` returns tensors on the artifact's device, as the
  port's ``predict`` does, where the JAX package returns numpy arrays.

Typical flow::

    gprn.ELBOcalc(...)                     # fit
    gprn.export_predict("predict.pt2")     # on the device it will serve on
    ...
    serve = serving.load_predict("predict.pt2")   # serving process
    mean, var = serve(tstar)[:2]
"""
from __future__ import annotations

import io
import os
import warnings

import numpy as np
import torch

# registers the operator the exported program calls
from gpyrn_tpu_torch.ops import cuda_kernels as _ck  # noqa: F401

__all__ = ["export_predict", "save_predict", "load_predict",
           "ServingPredictor"]

# the request size of the trace when it is symbolic (any size serves)
_EXAMPLE_N = 16


class _Predictive(torch.nn.Module):
    """``forward(tstar) -> (mean (n*, p), var (n*, p), node_pred (q, n*),
    weight_pred (q·p, n*))`` of one fitted model, its inputs and state
    held as buffers."""

    def __init__(self, engine, **state):
        super().__init__()
        self._engine = engine
        for name, value in state.items():
            self.register_buffer(name, value)

    def forward(self, tstar):
        return self._engine.predict(self.theta, self.t, self.y, self.yerr2,
                                    self.mu, self.var, tstar)


def _predictive(gprn, dtype, device):
    if gprn._mu is None or gprn._var is None:
        raise ValueError(
            "export_predict needs a fitted variational state — run "
            "ELBOcalc (or load a checkpoint) before exporting")

    def const(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=device, dtype=dtype).clone()
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=dtype,
                               device=device)

    t, y, yerr2 = gprn._data()
    return _Predictive(gprn.engine, theta=const(gprn._theta()), t=const(t),
                       y=const(y), yerr2=const(yerr2),
                       mu=const(gprn._mu).reshape(-1),
                       var=const(gprn._var).reshape(-1))


def export_predict(gprn, device=None, n_star=None, dtype=None):
    """Trace the fitted posterior predictive into a
    ``torch.export.ExportedProgram``.

    Parameters
    ----------
    gprn : meanfield.inference
        A fitted model (``ELBOcalc`` ran, or a checkpoint was loaded).
    device : torch device, optional
        Where the program runs (its constants live there).  Default: the
        model's device.
    n_star : int, optional
        Concrete number of prediction points.  Default: a symbolic
        dimension ``n`` — the artifact accepts any size.
    dtype : torch dtype, optional
        Compute dtype of the program (the training inputs and the state
        are cast once at export).  Default: the model's (float64).
    """
    dtype = gprn.dtype if dtype is None else dtype
    device = gprn.device if device is None else torch.device(device)
    module = _predictive(gprn, dtype, device)
    n = _EXAMPLE_N if n_star is None else int(n_star)
    lo, hi = float(np.min(gprn.time)), float(np.max(gprn.time))
    example = torch.linspace(lo, hi, n, dtype=dtype, device=device)
    shapes = None if n_star is not None else (
        {0: torch.export.Dim("n")},)
    return torch.export.export(module, (example,), dynamic_shapes=shapes,
                               strict=False)


def save_predict(gprn, path, **kw):
    """``export_predict`` then write the artifact to the file ``path``.
    Returns the byte count written."""
    torch.export.save(export_predict(gprn, **kw), path)
    return os.path.getsize(path)


def _user_input(program):
    """The fake tensor of the program's one user input (the request)."""
    name = program.graph_signature.user_inputs[0]
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name == name:
            return node.meta["val"]
    raise ValueError("the exported program has no request input")


class ServingPredictor:
    """Callable wrapper around a loaded predictive artifact.

    ``__call__(tstar)`` returns ``(mean (n*, p), var (n*, p),
    node_preds (q, n*), weight_preds (q*p, n*))`` — the tuple of the
    engine's ``predict``, as tensors on the artifact's device.

    Dtype: requests are cast to the dtype the artifact was exported with
    (``.dtype``).  Feeding float64 times to a float32 artifact therefore
    narrows them — a one-time ``UserWarning`` flags it."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()
        request = _user_input(program)
        self._dtype, self._device = request.dtype, request.device
        self._warned_downcast = False

    @property
    def dtype(self) -> torch.dtype:
        """The request dtype the artifact was exported with."""
        return self._dtype

    @property
    def device(self) -> torch.device:
        """The device the artifact runs on."""
        return self._device

    def __call__(self, tstar):
        if not isinstance(tstar, torch.Tensor):
            tstar = torch.as_tensor(np.ascontiguousarray(tstar))
        if (not self._warned_downcast and tstar.is_floating_point()
                and tstar.element_size() > self._dtype.itemsize):
            warnings.warn(
                f"request dtype {tstar.dtype} narrowed to the artifact's "
                f"{self._dtype} (exported dtype wins)", stacklevel=2)
            self._warned_downcast = True
        tstar = tstar.to(device=self._device, dtype=self._dtype)
        return tuple(self._module(torch.atleast_1d(tstar).contiguous()))


def load_predict(path_or_bytes):
    """Load an artifact written by ``save_predict`` into a
    :class:`ServingPredictor`.  Loads the operator module of this package,
    never the shell or the engine."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    return ServingPredictor(torch.export.load(path_or_bytes))
