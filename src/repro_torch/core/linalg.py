"""Homomorphic linear algebra: BSGS matrix-vector, hoisted rotations,
polynomial evaluation (power-basis and Chebyshev), op for op the
reference's `repro/core/linalg.py`.

These are the building blocks of the paper's workloads (§V-B): LOLA layers,
HELR iterations, sorting comparators, and bootstrapping's CoefToSlot /
SlotToCoef / EvalMod. Every keyswitch goes through the library route of
`core/ops` (`mod_up`, `_mod_down`, `_apply_galois`), as in the reference;
the float work (diagonals, Chebyshev coefficients, encoding) is numpy on
the host and the ciphertext arithmetic runs on the context's device.

*Hoisting*: a rotation's dominant cost is the ModUp (digit decomposition)
of the `a` component; for k rotations of the same ciphertext, decompose
once and permute the raised digits per rotation (automorphism commutes
with ModUp limb-wise). `use_hoisting=False` re-runs ModUp per rotation,
as FHEmem itself does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core import ops as hops
from repro_torch.core.ciphertext import Ciphertext, KeySwitchKey, Plaintext
from repro_torch.core.context import CkksContext


# ---------------------------------------------------------------------------
# hoisted rotations
# ---------------------------------------------------------------------------

def hoisted_rotations(ctx: CkksContext, ct: Ciphertext,
                      steps: Sequence[int],
                      gks: Dict[int, KeySwitchKey]) -> Dict[int, Ciphertext]:
    """Rotate `ct` by every step in `steps`, sharing one digit decomposition.

    ModUp(sigma_k(a)) == sigma_k(ModUp(a)) because the automorphism acts
    coefficient-wise (a signed permutation) and BConv is coefficient-wise.
    """
    level = ct.level
    idx_q = ctx.q_idx(level)
    idx_p = ctx.p_idx()
    target = idx_q + idx_p
    tix = ctx.index(target)
    q_t = ctx.q_all[tix][:, None]
    q = ctx.q_all[: ct.n_limbs][:, None]
    digits = ctx.params.digit_indices(level)
    a = ct.data[..., 1, :, :]
    # hoist: raise all digits of `a` once
    raised = [hops.mod_up(ctx, a[..., ctx.index(J), :], J, target)
              for J in digits]
    out: Dict[int, Ciphertext] = {}
    for step in steps:
        if step % (ctx.n // 2) == 0:
            out[step] = ct
            continue
        elt = ctx.rotation_element(step)
        perm = ctx.eval_perm(elt)
        ksk_sel = gks[elt].data[:, :, tix]
        acc0 = acc1 = None
        for d in range(len(digits)):
            r_rot = raised[d][..., perm]
            p0 = ma.mulmod(r_rot, ksk_sel[d, 0], q_t)
            p1 = ma.mulmod(r_rot, ksk_sel[d, 1], q_t)
            # acc starts at zero in the reference: addmod(0, p) == p
            acc0 = p0 if acc0 is None else ma.addmod(acc0, p0, q_t)
            acc1 = p1 if acc1 is None else ma.addmod(acc1, p1, q_t)
        e0 = hops._mod_down(ctx, acc0, idx_q, idx_p)
        e1 = hops._mod_down(ctx, acc1, idx_q, idx_p)
        b_rot = ct.data[..., 0, :, :][..., perm]
        out[step] = Ciphertext(
            torch.stack([ma.addmod(b_rot, e0, q), e1], dim=-3),
            level, ct.scale)
    return out


# ---------------------------------------------------------------------------
# BSGS homomorphic matrix-vector multiply (diagonal method)
# ---------------------------------------------------------------------------

def matrix_diagonals(mat: np.ndarray) -> Dict[int, np.ndarray]:
    """Generalized diagonals of a (s x s) matrix: diag_d[j] = M[j, (j+d) % s].
    Zero diagonals are dropped."""
    s = mat.shape[0]
    out = {}
    for d in range(s):
        dg = np.array([mat[j, (j + d) % s] for j in range(s)])
        if np.abs(dg).max() > 1e-12:
            out[d] = dg
    return out


def bsgs_split(diag_idx: Sequence[int], s: int) -> Tuple[int, int]:
    """Pick (baby, giant) sizes: bs*gs >= s, bs ~ sqrt(#diags)."""
    n_d = max(len(diag_idx), 1)
    bs = 1 << max(0, math.ceil(math.log2(max(1.0, math.sqrt(n_d)))))
    gs = math.ceil(s / bs)
    return bs, gs


def required_rotation_steps(diags: Dict[int, np.ndarray], s: int) -> List[int]:
    bs, gs = bsgs_split(list(diags), s)
    steps = set()
    for j in range(bs):
        steps.add(j)
    for i in range(gs):
        steps.add(bs * i)
    steps.discard(0)
    return sorted(steps)


def matvec_bsgs(ctx: CkksContext, ct: Ciphertext, diags: Dict[int, np.ndarray],
                gks: Dict[int, KeySwitchKey], encoder,
                use_hoisting: bool = True,
                scale: Optional[float] = None) -> Ciphertext:
    """out = M @ v for M given by generalized diagonals.

    BSGS: M v = sum_i rot( sum_j pdiag[bs*i + j] (pre-rotated by -bs*i) * rot(v, j), bs*i )
    Baby rotations are hoisted. Consumes one level (the pmul).
    """
    s = ctx.n // 2
    scale = scale or ct.scale
    bs, gs = bsgs_split(list(diags), s)
    baby_steps = [j for j in range(bs)
                  if any((bs * i + j) % s in diags for i in range(gs))]
    if use_hoisting:
        rots = hoisted_rotations(ctx, ct, baby_steps, gks)
    else:
        rots = {j: (ct if j == 0 else
                    hops.rotate(ctx, ct, j, gks[ctx.rotation_element(j)]))
                for j in baby_steps}
    out: Optional[Ciphertext] = None
    for i in range(gs):
        inner: Optional[Ciphertext] = None
        for j in range(bs):
            d = (bs * i + j) % s
            if d not in diags:
                continue
            # pre-rotate the diagonal by -bs*i so the outer rotation aligns it
            pd = np.roll(diags[d], bs * i)
            pt = Plaintext(encoder.encode(pd, scale, ct.level),
                           ct.level, scale)
            term = hops.pmul(ctx, rots[j], pt, do_rescale=False)
            inner = term if inner is None else hops.hadd(ctx, inner, term)
        if inner is None:
            continue
        if bs * i % s != 0:
            elt = ctx.rotation_element(bs * i)
            inner = hops._apply_galois(ctx, inner, elt, gks[elt])
        out = inner if out is None else hops.hadd(ctx, out, inner)
    assert out is not None, "matrix had no nonzero diagonals"
    return hops.rescale(ctx, out)


def matvec_keys_needed(ctx: CkksContext, diags: Dict[int, np.ndarray]) -> List[int]:
    """Galois elements needed by matvec_bsgs for this diagonal set."""
    s = ctx.n // 2
    bs, gs = bsgs_split(list(diags), s)
    elts = set()
    for j in range(bs):
        if any((bs * i + j) % s in diags for i in range(gs)) and j % s:
            elts.add(ctx.rotation_element(j))
    for i in range(gs):
        if (bs * i) % s:
            elts.add(ctx.rotation_element(bs * i))
    return sorted(elts)


# ---------------------------------------------------------------------------
# polynomial evaluation
# ---------------------------------------------------------------------------

def _const_pt(ctx, encoder, value: complex, level: int, scale: float) -> Plaintext:
    v = np.full(ctx.n // 2, value, dtype=np.complex128)
    return Plaintext(encoder.encode(v, scale, level), level, scale)


def add_const(ctx, encoder, ct: Ciphertext, c: complex) -> Ciphertext:
    pt = _const_pt(ctx, encoder, c, ct.level, ct.scale)
    return hops.padd(ctx, ct, pt)


def mul_const(ctx, encoder, ct: Ciphertext, c: complex) -> Ciphertext:
    """Multiply by a scalar (costs one level)."""
    pt = _const_pt(ctx, encoder, c, ct.level, 2.0 ** ctx.params.log_scale)
    return hops.pmul(ctx, ct, pt)


def adjust_to(ctx, encoder, ct: Ciphertext, level: int,
              scale: float) -> Ciphertext:
    """Bring ct to exactly (level, scale) via a unit pmul with an exactly
    chosen plaintext scale (costs one of the levels being dropped anyway).
    Requires ct.level > level."""
    assert ct.level > level, "adjust_to needs at least one spare level"
    ct = hops.mod_switch_to_level(ct, level + 1)
    q_drop = ctx.primes[level + 1]
    pt_scale = scale * q_drop / ct.scale
    pt = _const_pt(ctx, encoder, 1.0, ct.level, pt_scale)
    out = hops.pmul(ctx, ct, pt)                   # rescale -> level
    out.scale = scale                              # exact by construction
    return out


def _linear_combination(ctx, encoder, terms: Dict[int, Ciphertext],
                        coeffs: Dict[int, complex]) -> Ciphertext:
    """sum coeffs[i]*terms[i] with exact per-term scale equalization."""
    min_level = min(t.level for t in terms.values()) - 1
    q_drop = ctx.primes[min_level + 1]
    out: Optional[Ciphertext] = None
    target_scale = None
    for i, c in coeffs.items():
        if abs(c) < 1e-15:
            continue
        base = hops.mod_switch_to_level(terms[i], min_level + 1)
        if target_scale is None:
            target_scale = base.scale * (2.0 ** ctx.params.log_scale) / q_drop
        pt_scale = target_scale * q_drop / base.scale
        pt = _const_pt(ctx, encoder, c, base.level, pt_scale)
        term = hops.pmul(ctx, base, pt)
        term.scale = target_scale                  # exact by construction
        out = term if out is None else hops.hadd(ctx, out, term)
    assert out is not None
    return out


def poly_eval_power_basis(ctx: CkksContext, ct: Ciphertext,
                          coeffs: Sequence[float], rk: KeySwitchKey,
                          encoder) -> Ciphertext:
    """Evaluate sum_i coeffs[i] x^i (low degree; Horner-free BSGS-lite).

    Builds the power basis x^1..x^deg with log-depth squarings, multiplies
    each by its coefficient and sums. Adequate for the small comparator /
    activation polynomials (deg <= ~8); EvalMod uses the Chebyshev path.
    """
    deg = len(coeffs) - 1
    assert deg >= 1
    powers: Dict[int, Ciphertext] = {1: ct}
    # binary power tree
    d = 1
    while 2 * d <= deg:
        powers[2 * d] = hops.hsquare(ctx, powers[d], rk)
        d *= 2
    for i in range(2, deg + 1):
        if i in powers:
            continue
        lo = 1 << (i.bit_length() - 1)
        powers[i] = hops.hmul(ctx, powers[lo], powers[i - lo], rk)
    out = _linear_combination(ctx, encoder, powers,
                              {i: coeffs[i] for i in range(1, deg + 1)})
    if abs(coeffs[0]) > 1e-15:
        out = add_const(ctx, encoder, out, coeffs[0])
    return out


def chebyshev_coeffs(fn, degree: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [a, b]."""
    k = np.arange(degree + 1)
    x = np.cos(np.pi * (k + 0.5) / (degree + 1))
    y = fn((b - a) / 2 * x + (a + b) / 2)
    T = np.cos(np.outer(np.arange(degree + 1), np.pi * (k + 0.5) / (degree + 1)))
    c = 2.0 / (degree + 1) * T @ y
    c[0] /= 2
    return c


def poly_eval_chebyshev(ctx: CkksContext, ct: Ciphertext,
                        cheb_coeffs: Sequence[float], rk: KeySwitchKey,
                        encoder) -> Ciphertext:
    """Evaluate sum c_i T_i(x) for x in [-1,1] (x = the ct's slots).

    Iterative Clenshaw-free scheme: build T_1..T_deg via
    T_{m+n} = 2 T_m T_n - T_{|m-n|} using a power-of-two ladder, then a
    linear combination. Depth ~ ceil(log2 deg) + 1.
    """
    deg = len(cheb_coeffs) - 1
    ts: Dict[int, Ciphertext] = {1: ct}
    d = 1
    while 2 * d <= deg:
        t2 = hops.hsquare(ctx, ts[d], rk)          # T_{2d} = 2 T_d^2 - 1
        t2 = hops.hadd(ctx, t2, t2)
        ts[2 * d] = add_const(ctx, encoder, t2, -1.0)
        d *= 2
    for i in range(2, deg + 1):
        if i in ts:
            continue
        lo = 1 << (i.bit_length() - 1)
        hi = i - lo
        prod = hops.hmul(ctx, ts[lo], ts[hi], rk)  # T_{lo+hi} = 2 T_lo T_hi - T_{lo-hi}
        prod = hops.hadd(ctx, prod, prod)
        if ts[lo - hi].level > prod.level:
            tdiff = adjust_to(ctx, encoder, ts[lo - hi], prod.level, prod.scale)
        else:  # same level: scales match structurally (same rescale path)
            tdiff = ts[lo - hi].copy()
            tdiff.scale = prod.scale
        ts[i] = hops.hsub(ctx, prod, tdiff)
    out = _linear_combination(ctx, encoder, ts,
                              {i: cheb_coeffs[i] for i in range(1, deg + 1)})
    if abs(cheb_coeffs[0]) > 1e-15:
        out = add_const(ctx, encoder, out, cheb_coeffs[0])
    return out
