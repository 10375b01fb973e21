"""Benchmarks of the PyTorch/CUDA port, counterparts of `benchmarks/`.

Run from the repository root, e.g.
``PYTHONPATH=src python -m repro_torch.benchmarks.fig14_kernels --smoke``.
Records go to ``build/repro_torch/results/`` (not committed).
"""
