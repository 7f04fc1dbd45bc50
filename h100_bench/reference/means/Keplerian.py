"""Keplerian(P, K, e, w, Tp): the radial velocity of a Keplerian orbit,
K (cos(w + nu) + e cos w), of period P, semi-amplitude K, eccentricity e,
argument of periastron w and time of periastron Tp.  The eccentric
anomaly E solves Kepler's equation E - e sin E = 2 pi (t - Tp) / P by
Newton's method from Danby's start, M + 0.85 e sign(sin M), and the true
anomaly is nu = 2 atan2(sqrt(1 + e) sin(E / 2), sqrt(1 - e) cos(E / 2))."""
import math

import torch

N_PARAMETERS = 5
# Newton's steps: quadratic convergence from Danby's start takes fewer
# than ten for e <= 0.9; the rest change nothing
STEPS = 30


def value(p, t):
    P, K, e, w, Tp = (p[:, i, None] for i in range(5))
    M = 2 * math.pi * (t[None, :] - Tp) / P
    E = M + 0.85 * e * torch.sign(torch.sin(M))
    for _ in range(STEPS):
        E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    nu = 2 * torch.atan2(torch.sqrt(1 + e) * torch.sin(E / 2),
                         torch.sqrt(1 - e) * torch.cos(E / 2))
    return K * (torch.cos(w + nu) + e * torch.cos(w))
