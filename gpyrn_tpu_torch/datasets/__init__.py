"""Bundled datasets.

Port of :mod:`gpyrn_tpu.datasets`, with its own copy of
``Solar_observations.txt``: the multi-output solar RV and activity
dataset, 497 observations × 13 columns (BJD, RV, RHK, S, BIS, FWHM,
Contrast, each with its error).  The loaders return numpy arrays, which
``inference(q, time, *data, device=...)`` takes as they are.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["solar_observations", "load_solar", "SOLAR_COLUMNS"]

_HERE = os.path.dirname(os.path.abspath(__file__))

SOLAR_COLUMNS = ("BJD", "RV", "RVerr", "RHK", "RHKerr", "S", "Serr",
                 "BIS", "BISerr", "FWHM", "FWHMerr", "Contrast",
                 "Contrasterr")


def solar_observations() -> Dict[str, np.ndarray]:
    """Load the bundled solar dataset as a dict of named columns."""
    path = os.path.join(_HERE, "Solar_observations.txt")
    data = np.loadtxt(path, skiprows=1)
    return {name: data[:, i] for i, name in enumerate(SOLAR_COLUMNS)}


def load_solar(outputs: Sequence[str] = ("RV", "FWHM"),
               subtract_mean: bool = True,
               ) -> Tuple[np.ndarray, list]:
    """Return ``(time, [y1, y1err, y2, y2err, ...])`` ready to splat into
    ``inference(q, time, *data)`` for the requested output columns.

    Times are shifted to start at zero; outputs are mean-subtracted by
    default (the GPRN models residual activity signals)."""
    d = solar_observations()
    time = d["BJD"] - d["BJD"][0]
    data = []
    for name in outputs:
        y = d[name].copy()
        if subtract_mean:
            y = y - y.mean()
        data += [y, d[name + "err"]]
    return time, data
