"""Linear(c): (t1 - c)(t2 - c), a non-stationary kernel."""
N_PARAMETERS = 1


def value(p, t1, t2):
    c = p[:, 0, None, None]
    return (t1[None, :, None] - c) * (t2[None, None, :] - c)
