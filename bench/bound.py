"""The least time an FHE op can take on one H100: its op bound.

bound = max(bytes / HBM bandwidth, modular products / integer peak),
counted from the op's kind, batch and levels alone, so it does not move
when the program splits or fuses the op's kernels differently.

Bytes: every residue is 4 bytes (primes are below 2^32), whatever width
the program stores. Each input is read once and each output written
once; a key-switching op also reads its evaluation key at its level once
a batch (the digits that level needs x 2 x (l + 1 + k) limbs x N), a
plaintext op its plaintext once a batch.

Modular products, each counted as one 32-bit integer multiply, by the
hybrid keyswitch as the paper describes it: the INTT and NTT butterflies
(N/2 log N a limb), the BConv products, the key multiply-accumulate,
ModDown's products and its times P^-1, the tensor product's three
products (Karatsuba's count, the fewest) and the rescale's transforms
and times q_l^-1. Additions, the automorphism's permutation and the
scalings a transform can fold are not counted, so the bound stays under
any implementation's time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

RESIDUE_BYTES = 4

# One H100 SXM5: HBM3 at 3.35 TB/s (NVIDIA H100 data sheet). The integer
# peak: 64 results of 32-bit integer multiply a clock per SM at compute
# capability 9.0 (CUDA C Programming Guide, "Arithmetic Instructions",
# throughput of native arithmetic instructions) x 132 SMs x the 1980 MHz
# maximum boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_CLOCK_PER_SM = 64
SMS = 132
SM_CLOCK_HZ = 1.98e9
INT_MUL_PER_S = INT32_MUL_PER_CLOCK_PER_SM * SMS * SM_CLOCK_HZ


def transform(n: int) -> int:
    """Products of one length-n (i)NTT: n/2 log2 n butterflies."""
    return n // 2 * (n.bit_length() - 1)


def digits(level: int, alpha: int) -> List[int]:
    """Limbs of each key-switching digit at `level` (l + 1 Q limbs)."""
    nl = level + 1
    return [min(alpha, nl - d) for d in range(0, nl, alpha)]


def keyswitch_products(n: int, level: int, k: int, alpha: int) -> int:
    """Hybrid keyswitch of one (l + 1)-limb polynomial into two."""
    nl = level + 1
    out = nl * transform(n)                        # ModUp's INTT
    for a in digits(level, alpha):
        ext = nl - a + k                           # limbs the digit lacks
        out += a * ext * n                         # BConv
        out += ext * transform(n)                  # NTT of them
        out += 2 * (nl + k) * n                    # key MAC, 2 components
    out += 2 * k * transform(n)                    # ModDown: INTT of P
    out += 2 * k * nl * n                          # BConv P -> Q
    out += 2 * nl * transform(n)                   # NTT
    out += 2 * nl * n                              # times P^-1
    return out


def rescale_products(n: int, level: int) -> int:
    """Rescale of a two-component ciphertext from `level`."""
    return 2 * (transform(n) + level * transform(n) + level * n)


def key_bytes(n: int, level: int, k: int, alpha: int) -> int:
    return len(digits(level, alpha)) * 2 * (level + 1 + k) * n \
        * RESIDUE_BYTES


def ct_bytes(n: int, level: int) -> int:
    return 2 * (level + 1) * n * RESIDUE_BYTES


def op_work(kind: str, n: int, batch: int, levels_in: List[int],
            level_out: int, k: int, alpha: int, moves: bool = True
            ) -> Optional[Tuple[int, int]]:
    """(modular products, bytes) of one op over a batch; None for a kind
    that has no bound here. `moves` is False for a rotation by 0."""
    if kind in ("input", "const") or not moves:
        return 0, 0
    lin = min(levels_in)
    if kind in ("hadd", "hsub"):
        return 0, batch * 3 * ct_bytes(n, level_out)
    if kind == "padd":
        return 0, (batch * 2 * ct_bytes(n, level_out)
                   + (level_out + 1) * n * RESIDUE_BYTES)
    rescaled = rescale_products(n, lin) if level_out < lin else 0
    if kind == "pmul":
        return (batch * (2 * (lin + 1) * n + rescaled),
                batch * (ct_bytes(n, lin) + ct_bytes(n, level_out))
                + (lin + 1) * n * RESIDUE_BYTES)
    if kind == "hmul":
        prods = 3 * (lin + 1) * n + keyswitch_products(n, lin, k, alpha)
        return (batch * (prods + rescaled),
                batch * (2 * ct_bytes(n, lin) + ct_bytes(n, level_out))
                + key_bytes(n, lin, k, alpha))
    if kind in ("rotate", "conjugate"):
        return (batch * keyswitch_products(n, lin, k, alpha),
                batch * 2 * ct_bytes(n, lin) + key_bytes(n, lin, k, alpha))
    if kind == "rescale":
        return (batch * rescale_products(n, lin),
                batch * (ct_bytes(n, lin) + ct_bytes(n, level_out)))
    return None


def seconds(products: int, nbytes: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, products / INT_MUL_PER_S)


def trace_bounds(trace, n: int, batch: int, k: int, alpha: int,
                 slots: int) -> Dict[int, Tuple[str, float]]:
    """op index -> (kind, bound seconds) of every compute op of a
    compiled trace, whose ops carry their output levels."""
    out: Dict[int, Tuple[str, float]] = {}
    for op in trace.ops:
        if op.kind in ("input", "const"):
            continue
        moves = not (op.kind == "rotate" and op.meta["step"] % slots == 0)
        work = op_work(op.kind, n, batch,
                       [trace.ops[a].level for a in op.args], op.level, k,
                       alpha, moves)
        if work is None:
            raise ValueError(f"no op bound for kind {op.kind!r}")
        out[op.idx] = (op.kind, seconds(*work))
    return out
