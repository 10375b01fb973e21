"""Quickstart: CKKS basics with the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import sys

import numpy as np

from repro_torch.core import ops
from repro_torch.core.ciphertext import Plaintext
from repro_torch.core.context import CkksContext
from repro_torch.core.encoder import CkksEncoder
from repro_torch.core.encryptor import CkksEncryptor
from repro_torch.core.params import CkksParams
from repro_torch.examples import parse_device


def main(argv=()):
    device = parse_device(argv, __doc__)
    # small, CPU-friendly (NOT a secure parameter set — demo sizing)
    params = CkksParams(log_n=10, log_scale=26, n_levels=4, dnum=2,
                        first_mod_bits=30, scale_mod_bits=26,
                        special_mod_bits=30)
    ctx = CkksContext(params, device)
    enc = CkksEncoder(ctx)
    encr = CkksEncryptor(ctx)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    gk = encr.rotation_keygen(sk, [1])

    scale = 2.0 ** 26
    L = params.n_levels
    slots = ctx.n // 2
    rng = np.random.default_rng(0)
    v1 = rng.normal(size=slots) * 0.5
    v2 = rng.normal(size=slots) * 0.5

    def encrypt(v):
        return encr.encrypt_sk(
            Plaintext(enc.encode(v, scale, L), L, scale), sk)

    def decrypt(ct):
        return enc.decode(encr.decrypt(ct, sk).data, ct.scale, ct.level).real

    ct1, ct2 = encrypt(v1), encrypt(v2)
    print(f"ring degree N=2^{params.log_n}, {slots} packed slots, "
          f"L={L} levels, dnum={params.dnum}")
    print(f"moduli (bits): {[m.value.bit_length() for m in params.moduli]}")
    print(f"Montgomery-friendly (Solinas) moduli: "
          f"{sum(m.is_solinas for m in params.moduli)}/{len(params.moduli)}")

    out = {}
    add = ops.hadd(ctx, ct1, ct2)
    out["add"] = (decrypt(add), v1 + v2)
    print(f"HAdd error:   {np.abs(out['add'][0] - out['add'][1]).max():.2e}")

    mul = ops.hmul(ctx, ct1, ct2, rk)
    out["mul"] = (decrypt(mul), v1 * v2)
    print(f"HMul error:   {np.abs(out['mul'][0] - out['mul'][1]).max():.2e} "
          f"(level {ct1.level} -> {mul.level})")

    rot = ops.rotate(ctx, ct1, 1, gk[ctx.rotation_element(1)])
    out["rotate"] = (decrypt(rot), np.roll(v1, -1))
    print(f"Rotate error: "
          f"{np.abs(out['rotate'][0] - out['rotate'][1]).max():.2e}")

    sq = ops.hsquare(ctx, mul, rk)
    out["square"] = (decrypt(sq), (v1 * v2) ** 2)
    print(f"HSquare error (depth 2): "
          f"{np.abs(out['square'][0] - out['square'][1]).max():.2e}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
