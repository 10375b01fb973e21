"""HELR: homomorphic logistic-regression training (paper workload §V-B).

Batch samples are SIMD-packed: slot layout [sample0: f features][sample1:
...]; one encrypted iteration computes scores (rotate-and-sum within
feature blocks), a degree-3 sigmoid approximation, and the packed gradient
(rotate-and-sum across sample blocks), then updates the encrypted weights.

The paper runs 30 iterations with bootstrapping; this example runs 3
iterations with re-encryption at iteration boundaries (the bootstrap
insertion point — see core/bootstrap.py for the real refresh) and checks
the encrypted trajectory against the identical plaintext computation.

    PYTHONPATH=src python -m repro_torch.examples.helr_training [--device cpu]
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

F = 8           # features per sample (power of two)
NS = 16         # samples per ciphertext
SIGMOID3 = (0.5, 0.197, 0.0, -0.004)    # HELR's deg-3 sigmoid approx


def rotate_sum(ctx, ct, gks, steps):
    for st in steps:
        ct = ops.hadd(ctx, ct, ops.rotate(ctx, ct, st,
                                          gks[ctx.rotation_element(st)]))
    return ct


def main(argv=()):
    device = parse_device(argv, __doc__)
    params = CkksParams(log_n=8, log_scale=26, n_levels=8, dnum=2,
                        first_mod_bits=31, scale_mod_bits=26,
                        special_mod_bits=31)
    ctx = CkksContext(params, device)
    enc = CkksEncoder(ctx)
    encr = CkksEncryptor(ctx)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    slots = ctx.n // 2
    assert slots == F * NS
    steps = [1, 2, 4, -1, -2, -4, 8, 16, 32, 64, -8, -16, -32, -64]
    gks = encr.rotation_keygen(sk, steps)
    scale = 2.0 ** 26
    L = params.n_levels

    # synthetic separable data
    rng = np.random.default_rng(7)
    w_true = rng.normal(size=F)
    x = rng.normal(size=(NS, F)) * 0.4
    y = (x @ w_true > 0).astype(np.float64)          # labels in {0,1}

    x_packed = x.reshape(-1)                          # slot layout
    y_packed = np.repeat(y, F)

    def encrypt(v, level=L):
        return encr.encrypt_sk(Plaintext(enc.encode(v, scale, level),
                                         level, scale), sk)

    def decrypt(ct):
        return enc.decode(encr.decrypt(ct, sk).data, ct.scale, ct.level).real

    ct_x = encrypt(x_packed)
    w = np.zeros(F)
    ct_w = encrypt(np.tile(w, NS))
    lr = 1.0

    block_mask = np.zeros(slots)
    block_mask[::F] = 1.0

    def plain_iteration(w):
        s = x @ w
        sg = SIGMOID3[0] + SIGMOID3[1] * s + SIGMOID3[3] * s ** 3
        grad = (sg - y) @ x / NS
        return w - lr * grad

    print(f"HELR: {NS} samples x {F} features packed in {slots} slots")
    trajectory = []
    for it in range(3):
        # --- encrypted iteration ---
        p = ops.hmul(ctx, ct_x, ct_w, rk)                    # x*w
        s_ct = rotate_sum(ctx, p, gks, [1, 2, 4])            # block sums @ f=0
        pm = Plaintext(enc.encode(block_mask, scale, s_ct.level),
                       s_ct.level, scale)
        s_ct = ops.pmul(ctx, s_ct, pm)                       # mask
        s_ct = rotate_sum(ctx, s_ct, gks, [-1, -2, -4])      # broadcast
        sg = linalg.poly_eval_power_basis(ctx, s_ct, list(SIGMOID3), rk, enc)
        yneg_pt = Plaintext(enc.encode(-y_packed, sg.scale, sg.level),
                            sg.level, sg.scale)
        resid = ops.padd(ctx, sg, yneg_pt)                   # sigmoid(s) - y
        gx = ops.hmul(ctx, resid, ops.mod_switch_to_level(ct_x, resid.level),
                      rk)
        gsum = rotate_sum(ctx, gx, gks, [8, 16, 32, 64])     # sum samples
        gsum = linalg.mul_const(ctx, enc, gsum, lr / NS)
        w_aligned = linalg.adjust_to(ctx, enc, ct_w, gsum.level, gsum.scale)
        ct_w = ops.hsub(ctx, w_aligned, gsum)
        # --- plaintext reference ---
        w = plain_iteration(w)
        got_w = decrypt(ct_w)[:F]
        trajectory.append((got_w, w))
        err = np.abs(got_w - w).max()
        acc = ((x @ got_w > 0) == y).mean()
        print(f"iter {it}: encrypted-vs-plain weight err={err:.3e} "
              f"train acc={acc:.3f} level={ct_w.level}")
        # refresh for the next iteration (bootstrap insertion point)
        if it < 2:
            ct_w = encr.encrypt_sk(
                Plaintext(enc.encode(decrypt(ct_w), scale, L), L, scale), sk)
    assert err < 5e-2, "encrypted HELR diverged from plaintext"
    print("HELR encrypted training matches plaintext trajectory")
    return trajectory


if __name__ == "__main__":
    main(sys.argv[1:])
