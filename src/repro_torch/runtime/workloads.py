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


def conv_weight_name(conv: str, d: int, ky: int, kx: int) -> str:
    """The named diagonal of tap (ky, kx) (0..2 each, the kernel's row and
    column) of channel offset d in convolution `conv`."""
    return f"{conv}.w{d}.{ky}{kx}"


def make_resnet20_stage(blocks: int = 3, channels: int = 16, hw: int = 32):
    """The first stage of ResNet-20 for CIFAR-10 (He et al., CVPR 2016,
    section 4.2, n = 3): `blocks` residual blocks over `channels` maps of
    hw x hw, each z = h2(conv2(h1(conv1(x))) + x), a conv a 3x3
    convolution with its batch norm folded in and h a per-channel
    degree-2 polynomial activation, h(y) = a y^2 + b y + e (AESPA).

    Packing (channel-major, Lee et al., ICML 2022): pixel (i, j) of
    channel c at slot c hw^2 + hw i + j, the channels x hw^2 values
    written twice, so that a rotation by d hw^2 brings channel (c + d) mod
    channels to channel c. A conv is written as users write it: the sum
    over d < channels and dy, dx in {-1, 0, 1} of rotate(x, d hw^2 + hw dy
    + dx) times a named diagonal, plus the folded bias, one rotation a
    term (144 at 16 channels); the compiler's rotation pass factors the
    rotations. runtime/conv_pack.py packs real weights, batch norms and
    activations into the names `resnet20_consts` lists."""
    stride = hw * hw

    def conv(x, consts, name):
        acc = None
        for d in range(channels):
            for ky in range(3):
                for kx in range(3):
                    step = d * stride + hw * (ky - 1) + (kx - 1)
                    r = x if step == 0 else x.rotate(step)
                    t = r * consts[conv_weight_name(name, d, ky, kx)]
                    acc = t if acc is None else acc + t
        return acc + consts[f"{name}.bias"]

    def act(y, consts, name):
        return ((y * y) * consts[f"{name}.a"] + y * consts[f"{name}.b"]
                + consts[f"{name}.e"])

    def stage(x, consts=None):
        for k in range(blocks):
            h = act(conv(x, consts, f"b{k}.c1"), consts, f"b{k}.h1")
            x = act(conv(h, consts, f"b{k}.c2") + x, consts, f"b{k}.h2")
        return x
    return stage


def resnet20_consts(blocks: int = 3, channels: int = 16) -> Tuple[str, ...]:
    names = []
    for k in range(blocks):
        for j in (1, 2):
            conv = f"b{k}.c{j}"
            names += [conv_weight_name(conv, d, ky, kx)
                      for d in range(channels) for ky in range(3)
                      for kx in range(3)]
            names.append(f"{conv}.bias")
            names += [f"b{k}.h{j}.{c}" for c in "abe"]
    return tuple(names)
