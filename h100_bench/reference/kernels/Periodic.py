"""Periodic(theta, P, ell): theta^2 exp(-2 sin^2(pi |r| / P) / ell^2)."""
import math

import torch

N_PARAMETERS = 3


def value(p, t1, t2):
    r = t1[:, None] - t2[None, :]
    theta, P, ell = (p[:, i, None, None] for i in range(3))
    return theta ** 2 * torch.exp(
        -2 * torch.sin(math.pi * torch.abs(r) / P) ** 2 / ell ** 2)
