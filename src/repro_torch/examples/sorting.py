"""Homomorphic bitonic sorting (paper workload §V-B, per Hong et al.).

16 packed values, 2-way bitonic network. Each compare-exchange stage works
on encrypted data: differences -> iterated polynomial sign approximation
p(x) = 1.5x - 0.5x^3 -> min/max recombination via rotations and masks.
Stages are separated by re-encryption (the bootstrap insertion point; the
paper's deep pipeline bootstraps instead).

    PYTHONPATH=src python -m repro_torch.examples.sorting [--device cpu]
"""
import sys

import numpy as np

from repro_torch.core import linalg, ops
from repro_torch.core.ciphertext import Plaintext
from repro_torch.core.context import CkksContext
from repro_torch.core.encoder import CkksEncoder
from repro_torch.core.encryptor import CkksEncryptor
from repro_torch.core.params import CkksParams
from repro_torch.examples import parse_device

NVAL = 16
SIGN_ITERS = 12   # p^k saturates ~0.04 -> +-1 at k~12


def bitonic_pairs(n):
    """(distance, direction-mask) list for a bitonic sorting network."""
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            up = np.zeros(n, dtype=bool)
            for i in range(n):
                l = i ^ j
                if l > i:
                    up[i] = (i & k) == 0
            stages.append((j, up))
            j //= 2
        k *= 2
    return stages


def main(argv=()):
    device = parse_device(argv, __doc__)
    params = CkksParams(log_n=8, log_scale=26, n_levels=12, dnum=2,
                        first_mod_bits=31, scale_mod_bits=26,
                        special_mod_bits=31)
    ctx = CkksContext(params, device)
    enc = CkksEncoder(ctx)
    encr = CkksEncryptor(ctx)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    s = ctx.n // 2
    scale = 2.0 ** 26
    L = params.n_levels
    steps = sorted({d for d, _ in bitonic_pairs(NVAL)} |
                   {-d for d, _ in bitonic_pairs(NVAL)})
    gks = encr.rotation_keygen(sk, steps)

    rng = np.random.default_rng(11)
    vals = rng.permutation(NVAL) / NVAL + 0.03   # distinct, in (0, 1.1)
    packed = np.zeros(s)
    packed[:NVAL] = vals

    def encrypt(v):
        return encr.encrypt_sk(Plaintext(enc.encode(v, scale, L), L, scale),
                               sk)

    def decrypt(ct):
        return enc.decode(encr.decrypt(ct, sk).data, ct.scale,
                          ct.level).real

    ct = encrypt(packed)
    print(f"bitonic sort of {NVAL} encrypted values "
          f"({len(bitonic_pairs(NVAL))} compare-exchange stages)")

    for si, (dist, up) in enumerate(bitonic_pairs(NVAL)):
        # partner values: rotate both ways (slots beyond NVAL are zero)
        part_fwd = ops.rotate(ctx, ct, dist, gks[ctx.rotation_element(dist)])
        part_bwd = ops.rotate(ctx, ct, -dist, gks[ctx.rotation_element(-dist)])
        # each slot's partner: i^dist — forward if (i & dist)==0 else backward
        fwd_mask = np.zeros(s)
        bwd_mask = np.zeros(s)
        for i in range(NVAL):
            if i & dist:
                bwd_mask[i] = 1.0
            else:
                fwd_mask[i] = 1.0
        pm_f = Plaintext(enc.encode(fwd_mask, scale, part_fwd.level),
                         part_fwd.level, scale)
        pm_b = Plaintext(enc.encode(bwd_mask, scale, part_bwd.level),
                         part_bwd.level, scale)
        partner = ops.hadd(ctx, ops.pmul(ctx, part_fwd, pm_f),
                           ops.pmul(ctx, part_bwd, pm_b))
        me = linalg.adjust_to(ctx, enc, ct, partner.level, partner.scale)
        diff = ops.hsub(ctx, me, partner)                    # in (-1.2, 1.2)
        sgn = linalg.mul_const(ctx, enc, diff, 1 / 1.3)
        for _ in range(SIGN_ITERS):
            if sgn.level < 4:   # refresh (bootstrap stand-in, see module doc)
                sgn = encr.encrypt_sk(
                    Plaintext(enc.encode(decrypt(sgn), scale, L), L, scale),
                    sk)
            sgn = linalg.poly_eval_power_basis(
                ctx, sgn, [0.0, 1.5, 0.0, -0.5], rk, enc)
        # keep = 0.5*(me+partner) + 0.5*sgn_dir*(me-partner)
        halfsum = linalg.mul_const(
            ctx, enc, ops.hadd(ctx, me, partner), 0.5)
        # direction: want min where (up & lower-slot) etc. Encode signed mask:
        # slot keeps (me if sign(diff) matches dir else partner):
        dir_mask = np.zeros(s)
        for i in range(NVAL):
            is_lower = (i & dist) == 0
            asc = up[i] if is_lower else up[i ^ dist]
            keep_min = (asc and is_lower) or (not asc and not is_lower)
            dir_mask[i] = -0.5 if keep_min else 0.5
        if sgn.level < 3:
            sgn = encr.encrypt_sk(
                Plaintext(enc.encode(decrypt(sgn), scale, L), L, scale), sk)
        diff_al = encr.encrypt_sk(
            Plaintext(enc.encode(decrypt(diff), scale, L), L, scale), sk)
        sgnd = ops.hmul(ctx, sgn, linalg.adjust_to(ctx, enc, diff_al,
                                                   sgn.level, sgn.scale), rk)
        pm_dir = Plaintext(enc.encode(dir_mask, 2.0 ** 26, sgnd.level),
                           sgnd.level, 2.0 ** 26)
        term = ops.pmul(ctx, sgnd, pm_dir)
        hs = linalg.adjust_to(ctx, enc, halfsum, term.level, term.scale)
        ct = ops.hadd(ctx, hs, term)
        # refresh between stages (bootstrap point)
        cur = decrypt(ct)
        cur[NVAL:] = 0
        ct = encrypt(cur)

    got = decrypt(ct)[:NVAL]
    want = np.sort(vals)
    err = np.abs(got - want).max()
    print(f"sorted output err vs numpy.sort: {err:.3e}")
    order_ok = bool((np.diff(got) > -1e-3).all())
    print(f"monotone non-decreasing: {order_ok}")
    assert err < 0.05 and order_ok, "homomorphic sort failed"
    print("homomorphic bitonic sort OK")
    return got, want


if __name__ == "__main__":
    main(sys.argv[1:])
