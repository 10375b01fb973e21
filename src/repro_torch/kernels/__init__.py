"""Hand-written CUDA kernels (sm_90a), each beside its plain PyTorch
version: one for every Pallas kernel of `repro/kernels/`.

* ``keyswitch`` — K1 ``intt_scale``, K2 ``bconv_ntt_mulacc``, K3
  ``moddown``, the 4-launch ``FusedKeySwitch`` built from them, and the
  dispatch-per-stage ``keyswitch_staged`` (K4-K6 + library NTTs);
* ``modmul``    — K4 ``modmul_mont`` and K5 ``mulacc_mont`` (wrapped by
  ``ops.modmul`` / ``ops.mulacc``);
* ``bconv``     — K6 ``bconv_mont``, eager and lazy (``ops.bconv``);
* ``ntt``       — K7 ``ntt_col`` + ``ntt_row``, the four-step NTT
  (``ops.NttKernel``);
* ``elementwise`` — the engine's tensor product, keyswitch combine and
  HAdd/HSub, one launch each (the reference's XLA fusions);
* ``ref``       — exact oracles of K4-K7;
* ``build``     — nvcc + ctypes loader for ``repro_torch/csrc``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (building the library at first use) or raises.
"""
