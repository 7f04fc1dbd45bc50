"""QuasiPeriodic(theta, ell_e, P, ell_p):
theta^2 exp(-2 sin^2(pi |r| / P) / ell_p^2 - r^2 / (2 ell_e^2))."""
import math

import torch

N_PARAMETERS = 4


def value(p, t1, t2):
    r = t1[:, None] - t2[None, :]
    theta, le, P, lp = (p[:, i, None, None] for i in range(4))
    return theta ** 2 * torch.exp(
        -2 * torch.sin(math.pi * torch.abs(r) / P) ** 2 / lp ** 2
        - r ** 2 / (2 * le ** 2))
