"""PyTorch/CUDA port of the `repro` FHE stack (full-RNS CKKS serving).

The package mirrors `repro`'s layout module for module and is checked
against it bit for bit by the `tests/test_torch_*.py` suites. It imports
torch, numpy and the standard library only: never jax, never `repro`.

Residues are int64 tensors holding values below 2^31, so products of two
reduced values stay below 2^62 and plain ``(a * b) % q`` is exact. The
hand-written CUDA kernels under ``csrc/`` read these tensors and do their
own 32-bit Montgomery arithmetic.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a CUDA device and without that request they raise.
"""
