"""PyTorch/CUDA port of the `repro` FHE stack (full-RNS CKKS serving).

The package mirrors `repro`'s layout module for module and is checked
against it bit for bit by the `tests/test_torch_*.py` suites. It imports
torch, numpy and the standard library only: never jax, never `repro`.

Residues are int64 tensors holding values below 2^32 (paper parameters
draw the 32-bit prime 3221225473), so a product of two can pass 2^63:
``core/modarith.mulmod`` splits one operand into 16-bit halves to stay
exact. The hand-written CUDA kernels under ``csrc/`` read these tensors
and do their own 32-bit Montgomery arithmetic with 64-bit sums.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a CUDA device and without that request they raise.
"""
