"""LOLA-MNIST: encrypted shallow-network inference (paper workload §V-B).

Network (LOLA-style): x(64) -> dense(64->32) -> square activation ->
dense(32->10) -> argmax. Weights are plaintext (server-side model), the
input image is encrypted; dense layers run as BSGS diagonal matvecs with
hoisted rotations, activation is a ciphertext square.

Synthetic 8x8 "digit" data from a fixed teacher so accuracy is meaningful;
the correctness claim (paper's) is encrypted outputs == plaintext outputs.

    PYTHONPATH=src python -m repro_torch.examples.lola_mnist [--device cpu]
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

DIN, DH, DOUT = 64, 32, 10


def main(argv=()):
    device = parse_device(argv, __doc__)
    params = CkksParams(log_n=8, log_scale=26, n_levels=5, dnum=2,
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
    rng = np.random.default_rng(3)

    # model weights (plaintext, server side)
    w1 = rng.normal(size=(DH, DIN)) / np.sqrt(DIN)
    w2 = rng.normal(size=(DOUT, DH)) / np.sqrt(DH)

    # embed as s x s matrices acting on the packed slot vector
    m1 = np.zeros((s, s))
    m1[:DH, :DIN] = w1
    m2 = np.zeros((s, s))
    m2[:DOUT, :DH] = w2
    d1 = linalg.matrix_diagonals(m1)
    d2 = linalg.matrix_diagonals(m2)
    elts = sorted(set(linalg.matvec_keys_needed(ctx, d1) +
                      linalg.matvec_keys_needed(ctx, d2)))
    gks = encr.galois_keygen(sk, elts)
    print(f"LOLA: {DIN}->{DH}(square)->{DOUT}; "
          f"{len(d1)}+{len(d2)} matrix diagonals, {len(elts)} galois keys")

    def plain_forward(x):
        h = (w1 @ x) ** 2
        return w2 @ h

    n_match = 0
    n_img = 4
    outputs = []
    for i in range(n_img):
        proto = rng.normal(size=DIN) * 0.2
        x = proto + 0.08 * rng.normal(size=DIN)
        x_packed = np.zeros(s)
        x_packed[:DIN] = x
        ct = encr.encrypt_sk(
            Plaintext(enc.encode(x_packed, scale, L), L, scale), sk)
        h = linalg.matvec_bsgs(ctx, ct, d1, gks, enc)
        h = ops.hsquare(ctx, h, rk)
        out = linalg.matvec_bsgs(ctx, h, d2, gks, enc)
        got = enc.decode(encr.decrypt(out, sk).data, out.scale,
                         out.level).real[:DOUT]
        want = plain_forward(x)
        outputs.append((got, want))
        err = np.abs(got - want).max()
        match = int(np.argmax(got) == np.argmax(want))
        n_match += match
        print(f"img {i}: encrypted-vs-plain logit err={err:.3e} "
              f"argmax match={bool(match)} level={out.level}")
    assert n_match == n_img, "encrypted inference disagreed with plaintext"
    print(f"LOLA encrypted inference: {n_match}/{n_img} argmax agreement")
    return outputs


if __name__ == "__main__":
    main(sys.argv[1:])
