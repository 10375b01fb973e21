"""Hand-written CUDA kernels (sm_90a) for the encrypted-serving main path,
each beside its plain PyTorch version.

* ``keyswitch`` — K1 ``intt_scale``, K2 ``bconv_ntt_mulacc``, K3
  ``moddown`` and the 4-launch ``FusedKeySwitch`` built from them;
* ``modmul``    — K4 ``modmul_mont`` (wrapped by ``ops.modmul``);
* ``build``     — nvcc + ctypes loader for ``repro_torch/csrc``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (building the library at first use) or raises.
"""
