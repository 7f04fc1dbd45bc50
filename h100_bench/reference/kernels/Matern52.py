"""Matern52(theta, ell): theta^2 (1 + a + a^2 / 3) exp(-a),
a = sqrt(5) |r| / ell."""
import math

import torch

N_PARAMETERS = 2


def value(p, t1, t2):
    r = t1[:, None] - t2[None, :]
    theta, ell = p[:, 0, None, None], p[:, 1, None, None]
    a = math.sqrt(5.0) * torch.abs(r) / ell
    return theta ** 2 * (1 + a + a ** 2 / 3) * torch.exp(-a)
