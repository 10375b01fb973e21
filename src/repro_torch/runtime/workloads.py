"""Synthetic FHE workload zoo shared by the serving CLI and benchmarks.

One definition per program family; depth/width knobs parameterize the
variants so the CLI smoke and the fig16 sweep can't drift apart.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def make_helr_iter(rot_steps: Sequence[int] = (1, 2, 4, 8)):
    """HELR-style logistic-regression iteration (the paper's deep
    workload family): rotation tree for the inner product + cubic
    sigmoid approximation. `rot_steps` sets the tree depth."""
    def helr_iter(x, w, consts=None):
        s = x * w
        for k in rot_steps:
            s = s + s.rotate(k)
        a = s * consts["c1"]
        b = s * s
        c = b * s
        return w + (a + c * consts["c3"]) * x
    return helr_iter


HELR_CONSTS: Tuple[str, ...] = ("c1", "c3")


def lola_infer(x, consts=None):
    """LoLa-style shallow inference: two plaintext-weight layers with a
    square activation."""
    h = x * consts["w1"]
    h = h + h.rotate(1)
    h = h * h
    return h * consts["w2"]


LOLA_CONSTS: Tuple[str, ...] = ("w1", "w2")


def make_matvec(dim: int = 16):
    """Encrypted matrix-vector product by the diagonal method:
    y = sum_i rotate(x, i) * diag_i  (Halevi-Shoup). One rotation — a
    full keyswitch — per nonzero diagonal, which is exactly the pattern
    the compiler's BSGS rotation pass factors down to ~2*sqrt(dim)
    rotations and its lazy-rescale pass collapses to one rescale per
    giant step. `dim` is the number of diagonals (the matrix bandwidth),
    not the slot count."""
    def matvec(x, consts=None):
        acc = x * consts["d0"]
        for i in range(1, dim):
            acc = acc + x.rotate(i) * consts[f"d{i}"]
        return acc
    return matvec


def matvec_consts(dim: int = 16) -> Tuple[str, ...]:
    return tuple(f"d{i}" for i in range(dim))


def make_poly_eval(degree: int = 12):
    """Horner-style polynomial ladder of multiplicative depth `degree`:
    acc = x*p_d; acc = acc*x + p_i for i = d-1..0. Every iteration burns
    a level, so any degree beyond the serving start level exhausts the
    modulus chain — the workload that exercises the compiler's automatic
    bootstrap insertion (without it, registration dies in
    `infer_levels`)."""
    def poly(x, consts=None):
        acc = x * consts[f"p{degree}"]
        for i in range(degree - 1, -1, -1):
            acc = acc * x
            acc = acc + consts[f"p{i}"]
        return acc
    return poly


def poly_consts(degree: int = 12) -> Tuple[str, ...]:
    return tuple(f"p{i}" for i in range(degree + 1))
