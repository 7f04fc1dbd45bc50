"""Polynomial(theta, a, b, c): (a t1 t2 + b)^c, theta unused (as in the
package).  The package adds no nugget to it as the whole structure."""
N_PARAMETERS = 4
NUGGET = False


def value(p, t1, t2):
    a, b, c = (p[:, i, None, None] for i in range(1, 4))
    return (a * t1[None, :, None] * t2[None, None, :] + b) ** c
