"""The plain reference that decides `correct`: NumPy and plain PyTorch.

It imports nothing of the program under test and takes none of its
tables. From the configuration's numbers it derives the RNS prime chain
(a frozen copy of the parameter set's prime search), and from the secret
key's coefficients, which the harness draws from the seed and hands to
both sides, it decrypts a ciphertext the program produced:

    m = c0 + c1 * s      evaluation domain, s evaluated directly at the
                         odd powers of each prime's 2N-th root of unity
    m(X)                 an inverse NTT written out radix 2
    lift                 mixed-radix (Garner) digits over every limb; a
                         coefficient of a sound ciphertext is small, so
                         its digits past the third are all 0 or all
                         q_i - 1 (a negative value); any other is counted
                         as a bad coefficient
    slots                the canonical embedding at zeta^(5^j), an FFT

Residues are below 2^32. The transforms and the lift run as plain int64
PyTorch on the device they are given, a product of two residues split in
16-bit halves; the prime search and the tables are host Python.

`evaluate` runs a program's source on slot vectors with NumPy: `+` and
`*` elementwise, `rotate(k)` a roll of the slot vector by -k.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

U64 = np.uint64

# ---------------------------------------------------------------------------
# the prime chain (frozen copy of the parameter set's prime search)
# ---------------------------------------------------------------------------

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime_factors(n: int) -> List[int]:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def root_2n(p: int, two_n: int) -> int:
    """psi = g^((p-1)/2N) for the smallest generator g of Z_p^*."""
    fs = _prime_factors(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in fs):
            return pow(g, (p - 1) // two_n, p)
    raise ValueError(f"no generator mod {p}")


def _ntt_primes(bits: int, log_n: int, count: int, exclude) -> List[int]:
    """Solinas primes 2^b - 2^s + 1 = 1 mod 2N for b = bits, bits - 1,
    bits + 1 (largest s first), then generic primes = 1 mod 2N below
    2^bits, descending."""
    two_n = 1 << (log_n + 1)
    excl = set(exclude)
    out: List[int] = []
    for b in (bits, bits - 1, bits + 1):
        for s in range(b - 1, log_n, -1):
            p = (1 << b) - (1 << s) + 1
            if is_prime(p) and p not in excl and len(out) < count:
                out.append(p)
                excl.add(p)
    p = ((1 << bits) - 1) // two_n * two_n + 1
    while len(out) < count and p > (1 << (bits - 1)):
        if p not in excl and is_prime(p):
            out.append(p)
            excl.add(p)
        p -= two_n
    if len(out) < count:
        raise ValueError(f"not enough {bits}-bit primes for log N {log_n}")
    return out


def prime_chain(ckks: Dict) -> Tuple[List[int], List[int]]:
    """(Q primes q_0..q_L, special primes) of a configuration's `ckks`."""
    log_n, levels, dnum = ckks["log_n"], ckks["n_levels"], ckks["dnum"]
    q0 = _ntt_primes(ckks["first_mod_bits"], log_n, 1, ())
    qs = _ntt_primes(ckks["scale_mod_bits"], log_n, levels, q0)
    alpha = -(-(levels + 1) // dnum)
    ps = _ntt_primes(ckks["special_mod_bits"], log_n, alpha, q0 + qs)
    return q0 + qs, ps


# ---------------------------------------------------------------------------
# modular arithmetic on int64 tensors (residues < 2^32)
# ---------------------------------------------------------------------------

def _mul(a, b, q):
    """a * b mod q for 0 <= a, b < q < 2^32 in int64: b split in 16-bit
    halves, so no intermediate reaches 2^49."""
    return ((a * (b >> 16)) % q * 65536 + a * (b & 0xFFFF)) % q


def _powers(base: int, p: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] mod p (host, uint64: p < 2^32)."""
    out = np.ones(n, dtype=U64)
    size, step = 1, base % p
    while size < n:
        out[size:2 * size] = out[:size] * U64(step) % U64(p)
        size *= 2
        step = step * step % p
    return out


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    i = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def _t(x: np.ndarray, device):
    import torch
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(
        device)


def secret_eval(s: np.ndarray, primes: Sequence[int], device="cpu"):
    """(L, N) evaluations of the sparse secret s(X) at psi_l^(2 brv(i)+1),
    the evaluation order of the program's forward NTT: index i holds the
    value at the odd exponent 2 brv(i) + 1."""
    import torch
    n = s.shape[-1]
    pos = np.flatnonzero(s)
    e = _t((pos[:, None] * (2 * _bitrev(n) + 1)[None, :]) % (2 * n),
           device)                                          # (h, N)
    sign = _t(s[pos], device)[:, None]
    out = []
    for p in primes:
        pw = _t(_powers(root_2n(p, 2 * n), p, 2 * n), device)
        out.append(torch.remainder((pw[e] * sign).sum(0), p))
    return torch.stack(out)


def inverse_ntt(a, primes: Sequence[int]):
    """(L, R, N) int64 evaluations in the program's order -> coefficients.
    a[l, r, brv(k)] = m(psi^(2k+1)) = DFT_(psi^2)(m_j psi^j)[k], so a
    decimation-in-time pass over the bit-reversed input gives the
    inverse DFT in natural order; then times N^-1 psi^-j."""
    import torch
    nl, rows, n = a.shape
    dev = a.device
    q = _t(np.array(primes), dev)[:, None, None, None]
    inv_tw, post = [], []
    for p in primes:
        psi = root_2n(p, 2 * n)
        inv_tw.append(_powers(pow(psi * psi % p, -1, p), p, n))
        post.append(_powers(pow(psi, -1, p), p, n) * U64(pow(n, -1, p))
                    % U64(p))
    inv_tw = _t(np.stack(inv_tw), dev)                      # (L, N)
    x = a
    size = 2
    while size <= n:
        half = size // 2
        x = x.reshape(nl, rows, n // size, size)
        tw = inv_tw[:, ::n // size][:, :half][:, None, None, :]
        u = x[..., :half]
        v = _mul(x[..., half:], tw, q)
        x = torch.cat([(u + v) % q, (u - v) % q], dim=-1)
        size *= 2
    x = x.reshape(nl, rows, n)
    return _mul(x, _t(np.stack(post), dev)[:, None, :], q[..., 0])


def lift(coeffs, primes: Sequence[int]) -> Tuple[np.ndarray, int]:
    """(L, R, N) residues -> (R, N) float64 centred values on the host and
    the count of coefficients that do not lift to a value below the
    product of the first three primes (mixed radix over every limb)."""
    import torch
    nl = len(primes)
    digits = []
    for i in range(nl):
        qi = primes[i]
        t = coeffs[i]
        for j in range(i):
            inv = pow(primes[j] % qi, -1, qi)
            t = (t - digits[j]) % qi * inv % qi
        digits.append(t)
    k = min(3, nl)
    bad = 0
    if nl > k:
        zero = torch.ones_like(digits[0], dtype=torch.bool)
        full = torch.ones_like(zero)
        for i in range(k, nl):
            zero &= digits[i] == 0
            full &= digits[i] == primes[i] - 1
        neg = full
        bad = int((~(zero | full)).sum().item())
    val = torch.zeros(coeffs.shape[1:], dtype=torch.float64,
                      device=coeffs.device)
    cval = torch.zeros_like(val)
    radix = 1.0
    for i in range(k):
        val += digits[i].double() * radix
        cval += (primes[i] - 1 - digits[i]).double() * radix
        radix *= primes[i]
    if nl <= k:
        neg = val > radix / 2
    return torch.where(neg, -(cval + 1.0), val).cpu().numpy(), bad


def decode(coeffs: np.ndarray, scale: float) -> np.ndarray:
    """(R, N) real coefficients -> (R, N/2) slots: slot j = m(zeta^(5^j))
    / scale with zeta = exp(i pi / N)."""
    n = coeffs.shape[-1]
    zeta = np.exp(1j * np.pi * np.arange(n) / n)
    vals = np.fft.ifft(coeffs * zeta, axis=-1) * n    # at zeta^(2m+1)
    e = _powers(5, 2 * n, n // 2).astype(np.int64)
    return vals[..., (e - 1) // 2] / scale


def decrypt(ct: np.ndarray, scale: float, s_ev, primes: Sequence[int]
            ) -> Tuple[np.ndarray, int]:
    """ct: (B, 2, l+1, N) residues in the program's evaluation order;
    s_ev: `secret_eval` over at least l + 1 primes, on the device to
    compute on. Returns ((B, N/2) slots, number of bad coefficients)."""
    b, _, nl, n = ct.shape
    primes = list(primes)[:nl]
    dev = s_ev.device
    q = _t(np.array(primes), dev)[:, None, None]
    c = _t(ct, dev).movedim(2, 0)                        # (L, B, 2, N)
    m = (c[:, :, 0] + _mul(c[:, :, 1], s_ev[:nl, None, :], q)) % q
    vals, bad = lift(inverse_ntt(m, primes), primes)
    return decode(vals, scale), bad


# ---------------------------------------------------------------------------
# the program's source on slot vectors
# ---------------------------------------------------------------------------

class Slots:
    """A slot vector standing where the program expects a ciphertext or
    a named constant."""

    def __init__(self, v: np.ndarray):
        self.v = v

    def __add__(self, o: "Slots") -> "Slots":
        return Slots(self.v + o.v)

    def __sub__(self, o: "Slots") -> "Slots":
        return Slots(self.v - o.v)

    def __mul__(self, o: "Slots") -> "Slots":
        return Slots(self.v * o.v)

    def rotate(self, k: int) -> "Slots":
        return Slots(np.roll(self.v, -k, axis=-1))

    def conjugate(self) -> "Slots":
        return Slots(np.conj(self.v))

    def rescale(self) -> "Slots":
        return self

    def bootstrap(self) -> "Slots":
        return self


def evaluate(fn: Callable, inputs: Sequence[np.ndarray],
             consts: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """The program's outputs on (B, slots) inputs, in float64."""
    args = [Slots(np.asarray(x, dtype=np.complex128)) for x in inputs]
    kw = {"consts": {k: Slots(np.asarray(v)) for k, v in consts.items()}} \
        if consts else {}
    out = fn(*args, **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.v for o in outs]
