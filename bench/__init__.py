"""Benchmark of the PyTorch and CUDA port (`repro_torch`): encrypted
batches through `CkksEngine.run_ops` at the paper's parameters, checked
against a plain reference. Entry: bench/run.py; cells: BENCHMARK.json."""
