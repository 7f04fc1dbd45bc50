"""SquaredExponential(theta, ell): theta^2 exp(-r^2 / (2 ell^2))."""
import torch

N_PARAMETERS = 2


def value(p, t1, t2):
    r = t1[:, None] - t2[None, :]
    return p[:, 0, None, None] ** 2 * torch.exp(
        -0.5 * r ** 2 / p[:, 1, None, None] ** 2)
