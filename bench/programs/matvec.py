"""Encrypted matrix-vector product by the diagonal method (Halevi and
Shoup): y = sum_i rotate(x, i) * diag_i over `dim` diagonals. One
rotation per nonzero diagonal as written; the compiler factors them
baby-step giant-step."""

N_INPUTS = 1


def make(dim=16):
    def matvec(x, consts=None):
        acc = x * consts["d0"]
        for i in range(1, dim):
            acc = acc + x.rotate(i) * consts[f"d{i}"]
        return acc
    return matvec, N_INPUTS, tuple(f"d{i}" for i in range(dim))
