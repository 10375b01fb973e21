"""Fig. 1 counterpart of the port: off-chip bandwidth required against
on-chip NTT throughput for a key-switching operation, from the analytic
op/footprint model (core/trace.py), the analysis that motivates PIM in
the paper. The same scenario, rows and numbers as
``benchmarks/fig1_bandwidth.py``.

Scenario (paper §I, L=30-ish deep params): an accelerator with K NTT units
(each one butterfly/cycle @ 1GHz) processing HMul+KSO back to back; data
loaded per op under three locality scenarios: evk only / evk+1 operand /
evk+2 operands. Analytic: places no tensor.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_bandwidth

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig1_bandwidth.jsonl``.
"""
from __future__ import annotations

import argparse
import math
import sys

from repro_torch.benchmarks.common import HOST, emit, write_records
from repro_torch.core.params import paper_params_bootstrap
from repro_torch.core.trace import FheOp, ct_bytes, evk_bytes, op_cost


def main(argv=()) -> list:
    argparse.ArgumentParser(description=__doc__).parse_args(list(argv))
    params = paper_params_bootstrap()
    level = params.n_levels
    n = params.n
    hmul = op_cost(params, FheOp(0, "hmul", (0, 1), level=level - 1))
    # NTT butterflies for the op: ntts * (N/2 log2 N)
    butterflies = hmul.ntts * (n // 2) * math.log2(n)
    records = []
    for k_ntt in (1024, 2048, 16384, 65536):
        t_compute = butterflies / (k_ntt * 1e9)        # seconds per HMul+KSO
        for scen, bytes_needed in (
                ("evk_only", evk_bytes(params)),
                ("evk+1op", evk_bytes(params) + ct_bytes(params, level - 1)),
                ("evk+2op",
                 evk_bytes(params) + 2 * ct_bytes(params, level - 1)),
        ):
            bw = bytes_needed / t_compute
            emit(records, f"fig1_bw_req_{k_ntt}ntt_{scen}", t_compute * 1e6,
                 f"{bw/1e12:.2f}TB/s")
    write_records("fig1_bandwidth.jsonl", records, HOST)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
