"""Full-RNS CKKS on torch tensors: the algorithmic substrate of the port.

Mirrors `repro.core`. All ciphertext arithmetic is exact integer math on
int64 tensors (moduli < 2^31); keys and noise come from numpy generators
seeded exactly as the reference seeds them.
"""
from repro_torch.core.params import CkksParams, find_ntt_primes  # noqa: F401
