"""HELR iteration: logistic regression on encrypted data (Han et al.,
AAAI 2019), one gradient step: the inner product of x and w by a
rotation tree, a cubic sigmoid approximation c1 s + c3 s^3, and the
update w + sigma(s) x. `rot_steps` sets the rotation tree."""

CONSTS = ("c1", "c3")
N_INPUTS = 2


def make(rot_steps=(1, 2, 4, 8)):
    def helr_iter(x, w, consts=None):
        s = x * w
        for k in rot_steps:
            s = s + s.rotate(k)
        a = s * consts["c1"]
        b = s * s
        c = b * s
        return w + (a + c * consts["c3"]) * x
    return helr_iter, N_INPUTS, CONSTS
