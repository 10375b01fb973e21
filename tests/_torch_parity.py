"""Shared helpers of the deep-workload parity tests: one CKKS stack of
each package (the JAX reference and the PyTorch port on the CPU) built
from the same parameters and seed, so that drawing keys and encrypting in
the same order on both sides gives bit-equal material."""
import numpy as np
import torch

from repro.core.ciphertext import Plaintext as JPt
from repro.core.context import CkksContext as JCtx
from repro.core.encoder import CkksEncoder as JEncoder
from repro.core.encryptor import CkksEncryptor as JEnc
from repro_torch.core.ciphertext import Plaintext as TPt
from repro_torch.core.context import CkksContext as TCtx
from repro_torch.core.encoder import CkksEncoder as TEncoder
from repro_torch.core.encryptor import CkksEncryptor as TEnc


def as_np(x) -> np.ndarray:
    """Either package's residues as int64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def eq(a, b):
    np.testing.assert_array_equal(as_np(a), as_np(b))


def eq_ct(jct, tct):
    """Reference and port ciphertexts: limbs bit-equal, same bookkeeping."""
    assert (jct.level, jct.scale) == (tct.level, tct.scale)
    eq(jct.data, tct.data)


def eq_keys(jkeys, tkeys):
    assert sorted(jkeys) == sorted(tkeys)
    for k in jkeys:
        eq(jkeys[k].data, tkeys[k].data)


class Pair:
    """The reference's stack (`j*`) and the port's on the CPU (`t*`),
    same parameters, same encryptor seed, secret key drawn on both."""

    def __init__(self, jparams, tparams, seed):
        self.jctx = JCtx(jparams)
        self.tctx = TCtx(tparams, "cpu")
        self.jcode = JEncoder(self.jctx)
        self.tcode = TEncoder(self.tctx)
        self.jenc = JEnc(self.jctx, seed=seed)
        self.tenc = TEnc(self.tctx, seed=seed)
        self.jsk = self.jenc.keygen()
        self.tsk = self.tenc.keygen()

    def encrypt(self, v, scale, level):
        """The same slots encrypted on both sides (one draw each)."""
        jct = self.jenc.encrypt_sk(
            JPt(self.jcode.encode(v, scale, level), level, scale), self.jsk)
        tct = self.tenc.encrypt_sk(
            TPt(self.tcode.encode(v, scale, level), level, scale), self.tsk)
        return jct, tct

    def decode(self, tct) -> np.ndarray:
        """The port's decrypt and decode of one ciphertext."""
        return self.tcode.decode(self.tenc.decrypt(tct, self.tsk).data,
                                 tct.scale, tct.level)
