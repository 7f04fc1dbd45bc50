"""Utilities of gpyrn_tpu_torch: ``astro`` (Keplerian curves and
statistics helpers), ``profiling`` (a trace context and a stage timer) and
``plots`` (matplotlib figures; matplotlib is imported inside its
functions, so import the module on demand:
``from gpyrn_tpu_torch.utils import plots``)."""
from gpyrn_tpu_torch.utils import astro  # noqa: F401
from gpyrn_tpu_torch.utils import profiling  # noqa: F401
