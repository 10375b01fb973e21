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


# ---------------------------------------------------------------------------
# the port's twin of tests/_obs_scenario.py: the same parameters, memory
# model, workloads and arrival stream, built from repro_torch
# ---------------------------------------------------------------------------

def obs_executor(backend="analytic", cache_mb: int = 64, max_batch: int = 4):
    """tests/_obs_scenario.build_executor on the port (analytic or pim
    backend: neither touches a torch device)."""
    from repro_torch.compiler import PassConfig
    from repro_torch.core.params import test_params
    from repro_torch.core.pipeline import MemoryModel
    from repro_torch.runtime import (BatchPolicy, KeyCache,
                                     PipelinedExecutor)
    from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                               lola_infer, make_helr_iter,
                                               make_matvec, matvec_consts)
    params = test_params(log_n=10, n_levels=8, dnum=2)
    mem = MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20)
    start = 7
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=max_batch,
                         max_wait_s=2e-3)
    kc = (KeyCache(cache_mb * 2 ** 20, load_bw=mem.load_bw)
          if cache_mb else None)
    ex = PipelinedExecutor(params, mem, backend=backend, policy=policy,
                           key_cache=kc,
                           pass_config=PassConfig(start_level=start))
    ex.register("helr", make_helr_iter(), 2, const_names=HELR_CONSTS,
                start_level=start)
    ex.register("lola", lola_infer, 1, const_names=LOLA_CONSTS,
                start_level=start)
    ex.register("matvec16", make_matvec(16), 1,
                const_names=matvec_consts(16), start_level=start)
    return ex


def obs_arrivals(ex, n_requests: int = 48, rate_rps: float = 3000.0,
                 seed: int = 11, deadline_s: float = 0.05,
                 max_slots: int = 64):
    """tests/_obs_scenario.make_arrivals on the port's Request."""
    from repro_torch.runtime import Request
    rng = np.random.default_rng(seed)
    names = sorted(ex.workloads)
    out, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        out.append(Request(
            ex.next_request_id(), tenant=f"tenant{i % 3}",
            workload=names[i % len(names)], arrival_s=t,
            slots_needed=int(rng.integers(1, max_slots + 1)),
            deadline_s=t + deadline_s if i % 3 else None))
    return out
