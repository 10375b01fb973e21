"""Homomorphic ciphertext algebra: HAdd/HSub/HMul/HRot/Rescale/KeySwitch.

The library route, op for op the reference's `repro/core/ops.py`: HMul =
tensor product + relinearization (generalized dnum key switching: ModUp
per digit via BConv, evk multiply-accumulate, ModDown) + rescale;
rotation = NTT-domain automorphism permutation + key switch with the
Galois key. `key_switch` here is also the on-card yardstick the fused
keyswitch kernels (kernels/keyswitch.py) are held to.

The keyswitch, rescale and what calls them take a `Basis`: which limbs
of the RNS basis they work on, and the steps that need limbs held
elsewhere. The default `WHOLE` is the whole basis on one device;
`fhe_dist.limb_ops.LimbShard` is one rank's block of it, and runs the
same code with its BConv, rescale and re-blocking across ranks.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core import modarith as ma
from repro_torch.core import rns
from repro_torch.core.ciphertext import Ciphertext, KeySwitchKey, Plaintext
from repro_torch.core.context import CkksContext


# ---------------------------------------------------------------------------
# the limbs held
# ---------------------------------------------------------------------------

class Basis:
    """The whole RNS basis on one device. A subclass that holds a block
    of it overrides each method; a ciphertext's `data` then holds its
    block, while `level` and `scale` are the whole ciphertext's."""

    def q_range(self, level: int) -> range:
        """The Q limbs held at `level`."""
        return range(level + 1)

    def own(self, ctx: CkksContext, idx: Sequence[int]) -> List[int]:
        """The limbs held of the basis `idx`: Q_l, P, or Q_l ∪ P."""
        return list(idx)

    def bconv(self, ctx: CkksContext, v: torch.Tensor, src: Sequence[int],
              dst: Sequence[int]) -> torch.Tensor:
        """BConv between two parts of one basis Q_l ∪ P: v holds the limbs
        of src held here (coefficient domain); returns those of dst."""
        return rns.bconv(v, ctx.bconv_tables(src, dst))

    def last_limb(self, ctx: CkksContext, data: torch.Tensor, level: int
                  ) -> torch.Tensor:
        """Limb `level` of the Q limbs held at `level`, coefficient
        domain."""
        return ctx.intt(data[..., level:level + 1, :], [level])

    def regroup(self, t: torch.Tensor, n_old: int, n_new: int
                ) -> torch.Tensor:
        """The limbs held of the first n_new of n_old, from `t`: those
        held of n_old that are among the first n_new."""
        return t

    def key(self, ksk: KeySwitchKey, tix: torch.Tensor) -> torch.Tensor:
        """The key's limbs `tix`, held here."""
        return ksk.data[:, :, tix]


WHOLE = Basis()


def _primes(ctx: CkksContext, r: range) -> torch.Tensor:
    return ctx.q_all[r.start:r.stop][:, None]


# ---------------------------------------------------------------------------
# level / scale alignment
# ---------------------------------------------------------------------------

def mod_switch_to_level(ct: Ciphertext, level: int, basis: Basis = WHOLE
                        ) -> Ciphertext:
    """Drop limbs (valid modulus reduction); scale unchanged."""
    assert level <= ct.level
    if level == ct.level:
        return ct
    r = basis.q_range(ct.level)
    keep = max(0, min(r.stop, level + 1) - r.start)
    return Ciphertext(basis.regroup(ct.data[..., :keep, :], ct.level + 1,
                                    level + 1), level, ct.scale)


def _align(ct0: Ciphertext, ct1: Ciphertext, basis: Basis = WHOLE
           ) -> Tuple[Ciphertext, Ciphertext]:
    lvl = min(ct0.level, ct1.level)
    return (mod_switch_to_level(ct0, lvl, basis),
            mod_switch_to_level(ct1, lvl, basis))


# ---------------------------------------------------------------------------
# additive ops
# ---------------------------------------------------------------------------

def hadd(ctx: CkksContext, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
    ct0, ct1 = _align(ct0, ct1)
    assert abs(ct0.scale / ct1.scale - 1.0) < 1e-6, "scale mismatch in hadd"
    q = ctx.q_all[: ct0.n_limbs]
    return Ciphertext(ma.addmod(ct0.data, ct1.data, q[:, None]),
                      ct0.level, ct0.scale)


def hsub(ctx: CkksContext, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
    ct0, ct1 = _align(ct0, ct1)
    assert abs(ct0.scale / ct1.scale - 1.0) < 1e-6, "scale mismatch in hsub"
    q = ctx.q_all[: ct0.n_limbs]
    return Ciphertext(ma.submod(ct0.data, ct1.data, q[:, None]),
                      ct0.level, ct0.scale)


def hneg(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    q = ctx.q_all[: ct.n_limbs]
    return Ciphertext(ma.negmod(ct.data, q[:, None]), ct.level, ct.scale)


def padd(ctx: CkksContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    assert pt.level >= ct.level
    assert abs(ct.scale / pt.scale - 1.0) < 1e-6, "scale mismatch in padd"
    q = ctx.q_all[: ct.n_limbs]
    b = ma.addmod(ct.data[..., 0, :, :], pt.data[: ct.n_limbs], q[:, None])
    return Ciphertext(torch.stack([b, ct.data[..., 1, :, :]], dim=-3),
                      ct.level, ct.scale)


# ---------------------------------------------------------------------------
# multiplicative ops
# ---------------------------------------------------------------------------

def pmul(ctx: CkksContext, ct: Ciphertext, pt: Plaintext,
         do_rescale: bool = True) -> Ciphertext:
    """Ciphertext x plaintext."""
    assert pt.level >= ct.level
    q = ctx.q_all[: ct.n_limbs]
    data = ma.mulmod(ct.data, pt.data[: ct.n_limbs], q[:, None])
    out = Ciphertext(data, ct.level, ct.scale * pt.scale)
    return rescale(ctx, out) if do_rescale else out


def pmul_scalar_int(ctx: CkksContext, ct: Ciphertext, c: int) -> Ciphertext:
    """Multiply by a small exact integer (no scale change)."""
    q = ctx.q_all[: ct.n_limbs]
    cv = ctx._t([c % ctx.primes[i] for i in range(ct.n_limbs)])
    return Ciphertext(ma.mulmod(ct.data, cv[:, None], q[:, None]),
                      ct.level, ct.scale)


def tensor(ctx: CkksContext, d0: torch.Tensor, d1: torch.Tensor, level: int,
           basis: Basis = WHOLE
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tensor product of two (..., 2, level+1, N) ciphertexts:
    (b0 b1, a0 b1 + a1 b0, a0 a1)."""
    q = _primes(ctx, basis.q_range(level))
    b0, a0 = d0[..., 0, :, :], d0[..., 1, :, :]
    b1, a1 = d1[..., 0, :, :], d1[..., 1, :, :]
    t0 = ma.mulmod(b0, b1, q)
    t1 = ma.addmod(ma.mulmod(a0, b1, q), ma.mulmod(a1, b0, q), q)
    return t0, t1, ma.mulmod(a0, a1, q)


def hmul(ctx: CkksContext, ct0: Ciphertext, ct1: Ciphertext,
         relin_key: KeySwitchKey, do_rescale: bool = True,
         basis: Basis = WHOLE) -> Ciphertext:
    """Homomorphic multiply: tensor + relinearize (+ rescale)."""
    ct0, ct1 = _align(ct0, ct1, basis)
    q = _primes(ctx, basis.q_range(ct0.level))
    d0, d1, d2 = tensor(ctx, ct0.data, ct1.data, ct0.level, basis)
    e0, e1 = key_switch(ctx, d2, ct0.level, relin_key, basis)
    data = torch.stack([ma.addmod(d0, e0, q), ma.addmod(d1, e1, q)], dim=-3)
    out = Ciphertext(data, ct0.level, ct0.scale * ct1.scale)
    return rescale(ctx, out, basis) if do_rescale else out


def hsquare(ctx: CkksContext, ct: Ciphertext, relin_key: KeySwitchKey,
            do_rescale: bool = True, basis: Basis = WHOLE) -> Ciphertext:
    q = _primes(ctx, basis.q_range(ct.level))
    b, a = ct.data[..., 0, :, :], ct.data[..., 1, :, :]
    d0 = ma.mulmod(b, b, q)
    ab = ma.mulmod(a, b, q)
    d1 = ma.addmod(ab, ab, q)
    d2 = ma.mulmod(a, a, q)
    e0, e1 = key_switch(ctx, d2, ct.level, relin_key, basis)
    data = torch.stack([ma.addmod(d0, e0, q), ma.addmod(d1, e1, q)], dim=-3)
    out = Ciphertext(data, ct.level, ct.scale * ct.scale)
    return rescale(ctx, out, basis) if do_rescale else out


# ---------------------------------------------------------------------------
# rescale (divide-and-round by the last prime)
# ---------------------------------------------------------------------------

def rescale(ctx: CkksContext, ct: Ciphertext, basis: Basis = WHOLE
            ) -> Ciphertext:
    """Works on one ciphertext (2, L, N) or a batch (..., 2, L, N)."""
    assert ct.level >= 1, "no levels left to rescale"
    lvl = ct.level
    held = basis.q_range(lvl)
    rem = range(held.start, min(held.stop, lvl))
    q_rem = _primes(ctx, rem)
    # last limb -> coefficient domain
    c_last = basis.last_limb(ctx, ct.data, lvl)
    # broadcast into each remaining modulus (floor-divide variant)
    t_ntt = ctx.ntt(c_last % q_rem, rem)
    diff = ma.submod(ct.data[..., :len(rem), :], t_ntt, q_rem)
    out = ma.mulmod(diff, ctx.qlast_inv(lvl)[rem.start:rem.stop][:, None],
                    q_rem)
    return Ciphertext(basis.regroup(out, lvl + 1, lvl), lvl - 1,
                      ct.scale / ctx.q_primes[lvl])


# ---------------------------------------------------------------------------
# key switching (generalized dnum digits, Han–Ki)
# ---------------------------------------------------------------------------

def mod_up(ctx: CkksContext, dig_ntt: torch.Tensor, dig_idx: List[int],
           target_idx: List[int], basis: Basis = WHOLE) -> torch.Tensor:
    """ModUp one digit from its own basis to the target basis (NTT in/out):
    digit limbs are copied, the rest come from iNTT -> BConv -> NTT."""
    own = basis.own(ctx, target_idx)
    own_dig = [i for i in own if i in dig_idx]
    own_other = [i for i in own if i not in dig_idx]
    dig_coeff = ctx.intt(dig_ntt, own_dig)
    conv = basis.bconv(ctx, dig_coeff, dig_idx,
                       [i for i in target_idx if i not in dig_idx])
    conv_ntt = ctx.ntt(conv, own_other)
    pos = {g: i for i, g in enumerate(own)}
    out = dig_ntt.new_zeros(dig_ntt.shape[:-2] + (len(own), ctx.n))
    out[..., ctx.index([pos[g] for g in own_dig]), :] = dig_ntt
    out[..., ctx.index([pos[g] for g in own_other]), :] = conv_ntt
    return out


def key_switch(ctx: CkksContext, d2: torch.Tensor, level: int,
               ksk: KeySwitchKey, basis: Basis = WHOLE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch d2 ((..., level+1, N) limbs, NTT) to the key encrypted in
    ksk. Returns (delta_b, delta_a) at `level` (Q basis only), already
    ModDown'ed (divided by P). Leading dimensions are a batch."""
    idx_q = ctx.q_idx(level)
    idx_p = ctx.p_idx()
    target = idx_q + idx_p
    tix = ctx.index(basis.own(ctx, target))
    q_t = ctx.q_all[tix][:, None]
    held = basis.q_range(level)
    acc0 = acc1 = None
    ksk_sel = basis.key(ksk, tix)                 # (dnum, 2, T, N)
    for d, J in enumerate(ctx.params.digit_indices(level)):
        rows = ctx.index([g - held.start for g in held if g in J])
        raised = mod_up(ctx, d2[..., rows, :], J, target, basis)
        p0 = ma.mulmod(raised, ksk_sel[d, 0], q_t)
        p1 = ma.mulmod(raised, ksk_sel[d, 1], q_t)
        # acc starts at zero in the reference: addmod(0, p) == p
        acc0 = p0 if acc0 is None else ma.addmod(acc0, p0, q_t)
        acc1 = p1 if acc1 is None else ma.addmod(acc1, p1, q_t)
    return (_mod_down(ctx, acc0, idx_q, idx_p, basis),
            _mod_down(ctx, acc1, idx_q, idx_p, basis))


def _mod_down(ctx: CkksContext, a: torch.Tensor, idx_q: List[int],
              idx_p: List[int], basis: Basis = WHOLE) -> torch.Tensor:
    """(a_Q - BConv_{P->Q}(a_P)) * P^{-1} over Q. a: (..., |Q|+|P|, N)."""
    own_q = basis.q_range(len(idx_q) - 1)
    nq = len(own_q)
    p_coeff = ctx.intt(a[..., nq:, :], basis.own(ctx, idx_p))
    conv = basis.bconv(ctx, p_coeff, idx_p, idx_q)
    conv_ntt = ctx.ntt(conv, own_q)
    return rns.mod_down_coeff(a[..., :nq, :], conv_ntt,
                              ctx.p_inv_mod_q[own_q.start:own_q.stop],
                              ctx.q_all[own_q.start:own_q.stop])


# ---------------------------------------------------------------------------
# rotation / conjugation
# ---------------------------------------------------------------------------

def _apply_galois(ctx: CkksContext, ct: Ciphertext, elt: int,
                  gk: KeySwitchKey, basis: Basis = WHOLE) -> Ciphertext:
    q = _primes(ctx, basis.q_range(ct.level))
    rot = ct.data[..., ctx.eval_perm(elt)]
    b_rot, a_rot = rot[..., 0, :, :], rot[..., 1, :, :]
    e0, e1 = key_switch(ctx, a_rot, ct.level, gk, basis)
    return Ciphertext(torch.stack([ma.addmod(b_rot, e0, q), e1], dim=-3),
                      ct.level, ct.scale)


def rotate(ctx: CkksContext, ct: Ciphertext, step: int,
           gk: KeySwitchKey, basis: Basis = WHOLE) -> Ciphertext:
    """Rotate packed slots by `step` (slot i of output = slot i+step)."""
    return _apply_galois(ctx, ct, ctx.rotation_element(step), gk, basis)


def conjugate(ctx: CkksContext, ct: Ciphertext,
              gk: KeySwitchKey) -> Ciphertext:
    return _apply_galois(ctx, ct, ctx.conj_element, gk)


def rotate_coeff_domain(ctx: CkksContext, ct: Ciphertext, step: int,
                        gk: KeySwitchKey) -> Ciphertext:
    """Rotation with the automorphism applied in the coefficient domain
    (iNTT -> signed gather -> NTT), then key switch. Numerically identical
    to `rotate`."""
    from repro_torch.core import ntt as nttm
    elt = ctx.rotation_element(step)
    idx = ctx.q_idx(ct.level)
    q = ctx.q_all[: ct.n_limbs][:, None]
    src, neg = nttm.coeff_perm(elt, ctx.n)
    coeff = ctx.intt(ct.data, idx)
    gathered = coeff[..., torch.from_numpy(src).to(ctx.device)]
    rotated = torch.where(torch.from_numpy(neg).to(ctx.device),
                          ma.negmod(gathered, q), gathered)
    data = ctx.ntt(rotated, idx)
    e0, e1 = key_switch(ctx, data[..., 1, :, :], ct.level, gk)
    return Ciphertext(torch.stack([ma.addmod(data[..., 0, :, :], e0, q), e1],
                                  dim=-3), ct.level, ct.scale)
