"""CKKS parameter sets and NTT/Montgomery-friendly prime generation.

The paper (§IV-B) selects moduli of the form ``2^b ± 2^s1 ± ... ± 1`` with
low Hamming weight h so the NMU's digit-serial multiplier issues only h
additions. We implement the same moduli-selection policy: the prime search
prefers Solinas-form primes ``2^b - 2^s + 1`` (h=3) that are NTT-friendly
(``p ≡ 1 mod 2N``), and falls back to general NTT-friendly primes (which
then use Montgomery/Barrett reduction).

Everything here is host-side Python-int math (keygen/precompute time); no
JAX arrays.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# primality / roots of unity (host side, python ints)
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


def _factorize(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            if not fs or fs[-1] != d:
                fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def find_primitive_root(p: int) -> int:
    """Smallest generator of Z_p^*."""
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no generator for {p}")


def find_2nth_root(p: int, two_n: int) -> int:
    """A primitive 2N-th root of unity psi mod p (psi^N == -1)."""
    assert (p - 1) % two_n == 0, f"{p} not NTT-friendly for 2N={two_n}"
    g = find_primitive_root(p)
    psi = pow(g, (p - 1) // two_n, p)
    n = two_n // 2
    assert pow(psi, n, p) == p - 1, "psi^N != -1"
    return psi


# ---------------------------------------------------------------------------
# prime search
# ---------------------------------------------------------------------------

def solinas_candidates(bits: int, log_two_n: int) -> List[Tuple[int, int, int]]:
    """Solinas primes 2^b - 2^s + 1 ≡ 1 (mod 2N): needs s >= log(2N).

    Returns list of (p, b, s), largest s (fastest fold) first.
    """
    out = []
    for s in range(bits - 1, log_two_n - 1, -1):
        p = (1 << bits) - (1 << s) + 1
        if is_prime(p):
            out.append((p, bits, s))
    return out


def generic_ntt_primes(bits: int, two_n: int, count: int,
                       exclude: Sequence[int] = ()) -> List[int]:
    """Primes ≡ 1 (mod 2N) just below 2^bits, descending."""
    out: List[int] = []
    p = ((1 << bits) - 1) // two_n * two_n + 1
    excl = set(exclude)
    while len(out) < count and p > (1 << (bits - 1)):
        if p not in excl and is_prime(p):
            out.append(p)
        p -= two_n
    if len(out) < count:
        raise ValueError(f"not enough {bits}-bit NTT primes for 2N={two_n}")
    return out


@dataclasses.dataclass(frozen=True)
class Modulus:
    """One RNS modulus with its reduction metadata."""
    value: int
    solinas: Optional[Tuple[int, int]] = None  # (b, s) if 2^b - 2^s + 1

    @property
    def is_solinas(self) -> bool:
        return self.solinas is not None

    @property
    def hamming_weight(self) -> int:
        # popcount of the modulus (the paper's h; Solinas primes have h=3-ish)
        return bin(self.value).count("1")


def find_ntt_primes(bits: int, log_n: int, count: int,
                    prefer_solinas: bool = True,
                    exclude: Sequence[int] = ()) -> List[Modulus]:
    """Find `count` NTT-friendly primes of ~`bits` bits for ring degree 2^log_n.

    Solinas-form primes are preferred (paper §IV-B); distinct-bit-width
    neighbours (bits±1) are probed for extra Solinas hits before falling back
    to generic primes.
    """
    two_n = 1 << (log_n + 1)
    excl = set(exclude)
    out: List[Modulus] = []
    if prefer_solinas:
        for b in (bits, bits - 1, bits + 1):
            for p, bb, ss in solinas_candidates(b, log_n + 1):
                if p not in excl and len(out) < count:
                    out.append(Modulus(p, (bb, ss)))
                    excl.add(p)
    if len(out) < count:
        for p in generic_ntt_primes(bits, two_n, count - len(out), tuple(excl)):
            out.append(Modulus(p))
            excl.add(p)
    return out[:count]


# ---------------------------------------------------------------------------
# parameter sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CkksParams:
    """Full-RNS CKKS parameters.

    word32 mode: all moduli < 2^31 (DESIGN.md §2). The modulus chain is
    [q0 (first), q1..qL (scale primes)] plus `n_special` special primes P
    for key switching, grouped into `dnum` digits.
    """
    log_n: int
    log_scale: int
    n_levels: int                     # L: number of rescalings available
    dnum: int = 1
    first_mod_bits: int = 31
    scale_mod_bits: Optional[int] = None   # default: log_scale
    special_mod_bits: int = 31
    prefer_solinas: bool = True
    error_std: float = 3.2
    hamming_weight_sk: int = 64            # secret key density

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def slots(self) -> int:
        return self.n // 2

    @property
    def n_q_moduli(self) -> int:
        return self.n_levels + 1

    @property
    def alpha(self) -> int:
        """Digit size: primes per key-switching digit."""
        return -(-self.n_q_moduli // self.dnum)

    @property
    def n_special(self) -> int:
        return self.alpha

    @functools.cached_property
    def moduli(self) -> Tuple[Modulus, ...]:
        """[q0, q1..qL] then [p0..p_{k-1}] special primes."""
        sbits = self.scale_mod_bits or self.log_scale
        q0 = find_ntt_primes(self.first_mod_bits, self.log_n, 1,
                             self.prefer_solinas)
        used = [q0[0].value]
        qs = find_ntt_primes(sbits, self.log_n, self.n_levels,
                             self.prefer_solinas, exclude=used)
        used += [m.value for m in qs]
        ps = find_ntt_primes(self.special_mod_bits, self.log_n, self.n_special,
                             self.prefer_solinas, exclude=used)
        return tuple(q0 + qs + ps)

    @property
    def q_moduli(self) -> Tuple[Modulus, ...]:
        return self.moduli[: self.n_q_moduli]

    @property
    def p_moduli(self) -> Tuple[Modulus, ...]:
        return self.moduli[self.n_q_moduli:]

    def digit_indices(self, level: int) -> List[List[int]]:
        """Key-switch digit grouping of q-indices at `level` (L'=level+1 primes)."""
        n_active = level + 1
        return [list(range(d * self.alpha, min((d + 1) * self.alpha, n_active)))
                for d in range(self.dnum)
                if d * self.alpha < n_active]


# Presets -------------------------------------------------------------------

def test_params(log_n: int = 10, n_levels: int = 4, dnum: int = 2,
                log_scale: int = 26) -> CkksParams:
    """Small parameters for CPU tests (NOT secure)."""
    return CkksParams(log_n=log_n, log_scale=log_scale, n_levels=n_levels,
                      dnum=dnum, first_mod_bits=30, scale_mod_bits=log_scale,
                      special_mod_bits=30)


def paper_params_bootstrap() -> CkksParams:
    """The paper's deep-workload setting (§V-C): logN=16, L=23, dnum=4.

    The paper uses 40–61-bit RNS limbs in 64-bit words; in word32 mode the
    same logQ budget is met with more, narrower limbs (DESIGN.md §2).
    logPQ here ≈ (24·28 + 31) + 7·30 ≈ 913 bits vs paper's 1556 with wide
    limbs — the *structure* (L, dnum, N) is what the pipeline exercises.
    """
    return CkksParams(log_n=16, log_scale=28, n_levels=23, dnum=4,
                      first_mod_bits=31, scale_mod_bits=28,
                      special_mod_bits=31)


def paper_params_lola() -> CkksParams:
    """The paper's shallow-workload setting (§V-C): logN=14, L=4/6."""
    return CkksParams(log_n=14, log_scale=26, n_levels=6, dnum=1,
                      first_mod_bits=30, scale_mod_bits=26,
                      special_mod_bits=30)
