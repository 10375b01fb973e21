"""The engine's elementwise kernels (kernels/elementwise.py: the HMul
tensor product, the keyswitch combine, HAdd/HSub) against the library
ops they replace.

On the CPU: each plain version against ``core/ops.tensor``,
``torch.stack`` of ``core/modarith.addmod`` and ``addmod`` / ``submod``,
on random residues, on the edge values 0 and q - 1, under the 32-bit
primes 3221225473 and 4293918721 and on strided views; the wrappers'
operand checks; and the engine's kernel route bit-equal to its library
route for hmul, rotate, hadd and hsub.

On a card (``-m cuda``, skipped without one): each kernel ``torch.equal``
to the same library ops at the serve's shape (B = 8, N = 65536) at
levels 20 and 13, on contiguous operands and on the engine's views (a
limb slice of a deeper ciphertext, the rotated ciphertext's b
component), and one launch a call on its counter.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler.engine import CkksEngine  # noqa: E402
from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core import ops as hops  # noqa: E402
from repro_torch.core.params import paper_params_bootstrap  # noqa: E402
from repro_torch.core.params import test_params as small_params  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import elementwise as kew  # noqa: E402

# the 32-bit primes (F2): sums of two residues pass 2^32
WIDE = (3221225473, 4293918721)
SMALL = (1073479681, 1072496641, 268369921) + WIDE


def residues(primes, shape, seed, edges=False, device="cpu"):
    """(*shape[:-2], l, N) int64 residues, row j below primes[j]; with
    `edges` the first coefficients of every row hold 0 and q - 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]
    x = torch.randint(0, 1 << 62, shape, generator=g, device=device) % q
    if edges:
        x[..., 0] = 0
        x[..., 1] = q[:, 0] - 1
        x[..., 2] = q[:, 0] - 1
        x[..., 3] = 1
    return x


def lib_tensor(primes, d0, d1):
    """core/ops.tensor over the basis `primes`."""
    ctx = types.SimpleNamespace(q_all=torch.tensor(
        primes, dtype=torch.int64, device=d0.device))
    return hops.tensor(ctx, d0, d1, len(primes) - 1)


def lib_combine(primes, x0, x1, e0, e1):
    q = torch.tensor(primes, dtype=torch.int64, device=x0.device)[:, None]
    second = e1 if x1 is None else ma.addmod(x1, e1, q)
    return torch.stack([ma.addmod(x0, e0, q), second], dim=1)


def lib_addsub(primes, a, b, sub):
    q = torch.tensor(primes, dtype=torch.int64, device=a.device)[:, None]
    return (ma.submod if sub else ma.addmod)(a, b, q)


def operands(primes, b, n, layout, seed, device="cpu"):
    """Two (b, 2, l, n) ciphertexts: contiguous, or limb slices of
    deeper ones (the engine's _mod_switch) with a different depth each."""
    l = len(primes)
    if layout == "view":
        deep = list(primes) + [65537, 40961]
        d0 = residues(deep, (b, 2, l + 2, n), seed, True, device)[:, :, :l]
        d1 = residues(deep[:-1], (b, 2, l + 1, n), seed + 1, True,
                      device)[:, :, :l]
        return d0, d1
    return (residues(primes, (b, 2, l, n), seed, layout == "edges",
                     device),
            residues(primes, (b, 2, l, n), seed + 1, layout == "edges",
                     device))


# ---------------------------------------------------------------------------
# plain versions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["random", "edges", "view"])
def test_tensor_plain_equal_library(layout):
    d0, d1 = operands(SMALL, 3, 64, layout, seed=1)
    if layout == "view":
        assert not d0.is_contiguous()
    before = kew.TENSOR.launches
    got = kew.tensor(d0, d1, kew.basis(SMALL, "cpu"))
    want = lib_tensor(SMALL, d0, d1)
    for g, w in zip(got, want):
        assert g.shape == (3, len(SMALL), 64) and torch.equal(g, w)
    assert kew.TENSOR.launches == before      # the CPU launches nothing


@pytest.mark.parametrize("kind", ["hmul", "rotate"])
def test_combine_plain_equal_library(kind):
    l = len(SMALL)
    d, _ = operands(SMALL, 3, 64, "view", seed=2)
    e = residues(SMALL, (6, l, 64), seed=3, edges=True)
    e0, e1 = e[:3], e[3:]
    x1 = None if kind == "rotate" else d[:, 1]
    got = kew.combine(d[:, 0], x1, e0, e1, kew.basis(SMALL, "cpu").q32)
    assert got.is_contiguous()
    assert torch.equal(got, lib_combine(SMALL, d[:, 0], x1, e0, e1))


@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("layout", ["edges", "view"])
def test_addsub_plain_equal_library(sub, layout):
    a, b = operands(SMALL, 2, 64, layout, seed=4)
    got = kew.addsub(a, b, kew.basis(SMALL, "cpu").q32, sub)
    assert got.is_contiguous()
    assert torch.equal(got, lib_addsub(SMALL, a, b, sub))


def test_tensor_plain_full_width_edges():
    """Every pair of the values 0, 1, q - 2, q - 1 under each 32-bit
    prime: the Montgomery products' largest intermediates."""
    vals = torch.tensor([[0, 1, q - 2, q - 1] for q in WIDE])
    x = vals.repeat_interleave(4, dim=1)[None, None]       # (1, 1, 2, 16)
    y = vals.repeat(1, 4)[None, None]
    d0 = torch.cat([x, y], 1)
    d1 = torch.cat([y, x], 1)
    got = kew.tensor(d0, d1, kew.basis(WIDE, "cpu"))
    for g, w in zip(got, lib_tensor(WIDE, d0, d1)):
        assert torch.equal(g, w)


def test_wrappers_check_operands():
    bs = kew.basis(SMALL, "cpu")
    d0, d1 = operands(SMALL, 2, 64, "random", seed=5)
    with pytest.raises(TypeError, match="dtype"):
        kew.tensor(d0.to(torch.int32), d1, bs)
    with pytest.raises(ValueError, match="not contiguous rows"):
        kew.tensor(d0.transpose(2, 3).contiguous().transpose(2, 3), d1, bs)
    with pytest.raises(ValueError, match="shape"):
        kew.tensor(d0, d1[:, :, :-1], bs)
    with pytest.raises(ValueError, match=r"contiguous \(4,\)"):
        kew.tensor(d0[:, :, :4], d1[:, :, :4], bs)
    with pytest.raises(TypeError, match="torch.int32"):
        kew.addsub(d0, d1, bs.q32.to(torch.int64), False)
    with pytest.raises(ValueError, match="shape"):
        kew.combine(d0[:, 0], d0[:, 1], d1[:1, 0], d1[:, 1], bs.q32)
    with pytest.raises(ValueError, match="not contiguous rows"):
        kew.addsub(d0[..., ::2], d1[..., ::2], bs.q32, True)


# ---------------------------------------------------------------------------
# the engine's kernel route against its library route (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    eng = CkksEngine(small_params(log_n=8, n_levels=6, dnum=2), seed=5,
                     device="cpu")
    rng = np.random.default_rng(7)
    s = eng.params.slots
    x = eng.encrypt_batch(rng.uniform(-0.5, 0.5, (2, s)), 6)
    y = eng.encrypt_batch(rng.uniform(-0.5, 0.5, (2, s)), 5)
    return eng, x, y


OPS = {
    "hmul": lambda e, x, y: e._hmul(x, x, lazy=False),
    "hmul_across_levels": lambda e, x, y: e._hmul(x, y, lazy=True),
    "rotate": lambda e, x, y: e._galois(x, e.ctx.rotation_element(3)),
    "conjugate": lambda e, x, y: e._galois(y, e.ctx.conj_element),
    "hadd": lambda e, x, y: e._addsub("hadd", x, y),
    "hsub": lambda e, x, y: e._addsub("hsub", y, x),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_engine_kernel_route_equal_library_route(engine, op):
    eng, x, y = engine
    outs = []
    for use_kernels in (False, True):
        eng.use_kernels = use_kernels
        try:
            outs.append(OPS[op](eng, x, y))
        finally:
            eng.use_kernels = False
    lib, kern = outs
    assert (kern.level, kern.scale) == (lib.level, lib.scale)
    assert torch.equal(kern.data, lib.data)


# ---------------------------------------------------------------------------
# the kernels on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def serve_basis(level):
    """The serve's Q primes at `level` with the two 32-bit primes among
    them (the last two limbs)."""
    qs = [m.value for m in paper_params_bootstrap().q_moduli[:level + 1]]
    return tuple(qs[:-2]) + WIDE


def counted(info, fn):
    before = info.launches
    out = fn()
    assert info.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["edges", "view"])
@pytest.mark.parametrize("level", [20, 13])
def test_tensor_kernel_equal_library(cuda, level, layout):
    primes = serve_basis(level)
    d0, d1 = operands(primes, 8, 65536, layout, seed=level, device=cuda)
    bs = kew.basis(primes, cuda)
    got = counted(kew.TENSOR, lambda: kew.tensor(d0, d1, bs))
    want = lib_tensor(primes, d0, d1)
    for g, w, p in zip(got, want, kew.tensor_plain(d0, d1, bs)):
        assert torch.equal(g, w) and torch.equal(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hmul", "rotate"])
@pytest.mark.parametrize("level", [20, 13])
def test_combine_kernel_equal_library(cuda, level, kind):
    primes = serve_basis(level)
    l = len(primes)
    if kind == "rotate":
        # rot[:, 0] of the gathered (B, 2, l, N) ciphertext
        rot = residues(primes, (8, 2, l, 65536), 1, True, cuda)
        x0, x1 = rot[:, 0], None
    else:
        t = residues(primes, (3, 8, l, 65536), 2, True, cuda)
        x0, x1 = t[0], t[1]
    e = residues(primes, (16, l, 65536), 3, True, cuda)
    e0, e1 = e[:8], e[8:]
    q32 = kew.basis(primes, cuda).q32
    got = counted(kew.COMBINE, lambda: kew.combine(x0, x1, e0, e1, q32))
    assert torch.equal(got, lib_combine(primes, x0, x1, e0, e1))


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("layout", ["edges", "view"])
@pytest.mark.parametrize("level", [20, 13])
def test_addsub_kernel_equal_library(cuda, level, layout, sub):
    primes = serve_basis(level)
    a, b = operands(primes, 8, 65536, layout, seed=level + 5, device=cuda)
    q32 = kew.basis(primes, cuda).q32
    got = counted(kew.ADDSUB, lambda: kew.addsub(a, b, q32, sub))
    assert torch.equal(got, lib_addsub(primes, a, b, sub))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 777])
def test_kernels_unaligned_rows(cuda, n):
    """An odd N (8-byte accesses) and an operand at an odd word offset:
    the kernels' narrow path gives the same results."""
    primes = SMALL
    l = len(primes)
    full = residues(primes, (3, 2, l, n), 6, True, cuda)
    buf = torch.empty(full.numel() + 1, dtype=torch.int64, device=cuda)
    buf[1:] = full.flatten()
    d0 = buf[1:].view(full.shape)            # rows start 8 bytes in
    assert d0.data_ptr() % 16 == 8
    d1 = residues(primes, (3, 2, l, n), 7, True, cuda)
    bs = kew.basis(primes, cuda)
    for g, w in zip(kew.tensor(d0, d1, bs), lib_tensor(primes, d0, d1)):
        assert torch.equal(g, w)
    assert torch.equal(kew.addsub(d0, d1, bs.q32, True),
                       lib_addsub(primes, d0, d1, True))
    assert torch.equal(
        kew.combine(d0[:, 0], d0[:, 1], d1[:, 0], d1[:, 1], bs.q32),
        lib_combine(primes, d0[:, 0], d0[:, 1], d1[:, 0], d1[:, 1]))


@pytest.mark.cuda
def test_engine_kernel_route_on_card(cuda):
    """hmul, rotate, hadd and hsub on the card's kernel route: equal to
    the library route, one tensor and one combine launch a hmul, one
    combine a rotation, one addsub an add."""
    eng = CkksEngine(small_params(log_n=10, n_levels=6, dnum=2), seed=5,
                     device=cuda)
    rng = np.random.default_rng(7)
    s = eng.params.slots
    x = eng.encrypt_batch(rng.uniform(-0.5, 0.5, (8, s)), 6)
    y = eng.encrypt_batch(rng.uniform(-0.5, 0.5, (8, s)), 5)
    grew = {}
    for op in sorted(OPS):
        lib = OPS[op](eng, x, y)
        eng.use_kernels = True
        before = {k: v.launches for k, v in common.KERNELS.items()}
        try:
            kern = OPS[op](eng, x, y)
        finally:
            eng.use_kernels = False
        # a kernel module imported on first use registers its counter
        grew[op] = {k: v.launches - before.get(k, 0)
                    for k, v in common.KERNELS.items()
                    if v.launches != before.get(k, 0)}
        assert torch.equal(kern.data, lib.data), op
    for op in ("hmul", "hmul_across_levels"):
        assert grew[op]["tensor"] == 1 and grew[op]["combine"] == 1
    for op in ("rotate", "conjugate"):
        assert grew[op]["combine"] == 1 and "tensor" not in grew[op]
    for op in ("hadd", "hsub"):
        assert grew[op] == {"addsub": 1}
