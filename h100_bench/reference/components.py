"""The reference's model components, one file each, found by the
package's class name: ``kernels/<Name>.py`` and ``means/<Name>.py`` under
``HERE``, this module's folder (a kernel and a mean may share a name, as
``Linear`` does).  The reference's model and the data's added signals both
read them there.

A kernel file defines ``N_PARAMETERS`` and ``value(p, t1, t2)``: the
covariance (W, N, M) between the times t1 (N,) and t2 (M,) of each row of
parameters p (W, n), written from the two time vectors so that a
non-stationary kernel can be written too.  It sets ``NUGGET = False``
where the package adds no nugget to the kernel's training covariance
(``ops/linalg.kernel_matrix`` for HarmonicPeriodic, QuasiHarmonicPeriodic
and Polynomial as the whole structure); every other kernel, a sum or
product too, gets max(1e-6, 4 eps tr K).  A mean file defines
``N_PARAMETERS`` and ``value(p, t)``: (W, N) at the times t (N,).

A configuration's kernel entry is ``{"kernel": <Name>, "pars": [...]}`` or
``{"kernel": "Sum" | "Multiplication", "of": [<entry>, <entry>]}``, nested
to any depth; a composite's parameters are its parts', left first, as the
package's ``Sum.pars`` is ``r_[k1.pars, k2.pars]``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
COMBINE = {"Sum": torch.add, "Multiplication": torch.mul}


def load(kind, name):
    """The component file ``HERE/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_reference_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Kernel:
    """A kernel entry of a configuration: one component file, or the sum
    or product of two entries."""

    def __init__(self, entry):
        name = entry["kernel"]
        if "of" in entry:
            if name not in COMBINE or len(entry["of"]) != 2:
                raise ValueError(f"a composite kernel is one of "
                                 f"{sorted(COMBINE)} of two entries, got "
                                 f"{name!r} of {len(entry['of'])}")
            self.parts = [Kernel(e) for e in entry["of"]]
            self.n_parameters = sum(k.n_parameters for k in self.parts)
            self.nugget = True
        else:
            self.parts = None
            self.module = load("kernels", name)
            self.n_parameters = int(self.module.N_PARAMETERS)
            self.nugget = bool(getattr(self.module, "NUGGET", True))
        self.name = name

    def value(self, p, t1, t2):
        """(W, N, M) for parameters p (W, n_parameters)."""
        if self.parts is None:
            return self.module.value(p, t1, t2)
        a, b = self.parts
        n = a.n_parameters
        return COMBINE[self.name](a.value(p[:, :n], t1, t2),
                                  b.value(p[:, n:], t1, t2))


class Mean:
    """A mean entry of a configuration: one component file."""

    def __init__(self, entry):
        self.module = load("means", entry["mean"])
        self.n_parameters = int(self.module.N_PARAMETERS)

    def value(self, p, t):
        """(W, N) for parameters p (W, n_parameters)."""
        return self.module.value(p, t)
