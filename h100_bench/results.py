"""What a window's fits return, as the comparison reads it."""
from __future__ import annotations

from typing import NamedTuple


class Fits(NamedTuple):
    """The fits of one batch of rows: ELBO (R,), mu and var (R, d) and the
    sweep count (R,), as tensors (on any device)."""
    elbo: object
    mu: object
    var: object
    n_iter: object
