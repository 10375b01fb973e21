"""Fig. 13 counterpart of the port: latency breakdown of HMul+KSO into
its primitive phases (NTT/iNTT, BConv, elementwise modmul, evk MACs),
measured on one device and compared against the analytic op-count model
of core/trace.py. The same parameters, seed and rows as
``benchmarks/fig13_breakdown.py``; the reference's uint64 residues are
the port's int64 ones (the same values).

NTT, iNTT, ``mulmod`` and BConv run over the full basis at log N 12
through the library route (``core/{ntt,modarith,rns}.py``, torch ops; no
hand-written kernel); times are medians of device-synchronised wall
clocks.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig13_breakdown \\
        [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig13_breakdown.jsonl``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, timeit, write_records
from repro_torch.core import modarith as ma
from repro_torch.core import rns
from repro_torch.core.context import CkksContext, resolve_device
from repro_torch.core.params import CkksParams
from repro_torch.core.trace import keyswitch_cost


def main(argv=()) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the residue arithmetic runs (cuda, the "
                         "default, raises without a CUDA device)")
    dev = resolve_device(ap.parse_args(list(argv)).device)
    params = CkksParams(log_n=12, log_scale=28, n_levels=12, dnum=4,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    ctx = CkksContext(params, dev)
    L = params.n_levels
    idx_q = ctx.q_idx(L)
    idx_p = ctx.p_idx()
    rng = np.random.default_rng(0)
    qs = np.asarray(ctx.q_primes, dtype=np.uint64)[: L + 1]
    a = torch.from_numpy((rng.integers(0, 2 ** 30, size=(L + 1, ctx.n),
                                       dtype=np.uint64) % qs[:, None]
                          ).astype(np.int64)).to(dev)

    t_ntt = timeit(lambda: ctx.ntt(a, idx_q), device=dev)
    t_intt = timeit(lambda: ctx.intt(a, idx_q), device=dev)
    t_mul = timeit(lambda: ma.mulmod(a, a, ctx.q_all[: L + 1][:, None]),
                   device=dev)
    tabs = ctx.bconv_tables(idx_q[: params.alpha], idx_p)
    t_bconv = timeit(lambda: rns.bconv(a[: params.alpha], tabs), device=dev)

    records = []
    emit(records, "fig13_ntt_full_basis", t_ntt * 1e6,
         f"N=2^{params.log_n},L={L+1}")
    emit(records, "fig13_intt_full_basis", t_intt * 1e6)
    emit(records, "fig13_modmul_full_basis", t_mul * 1e6)
    emit(records, "fig13_bconv_digit", t_bconv * 1e6,
         f"alpha={params.alpha}->k={params.n_special}")

    # analytic phase split of one KSO at top level
    c = keyswitch_cost(params, L - 1)
    per_ntt = t_ntt / (L + 1)
    per_mul_row = t_mul / (L + 1)
    est_ntt = c.ntts * per_ntt
    est_mul = (c.modmuls + c.ks_modmuls) * per_mul_row
    emit(records, "fig13_kso_est_ntt_phase", est_ntt * 1e6,
         f"{c.ntts} NTT passes ({100*est_ntt/(est_ntt+est_mul):.0f}%)")
    emit(records, "fig13_kso_est_mul_phase", est_mul * 1e6,
         f"{c.modmuls}+{c.ks_modmuls}ks modmul rows "
         f"({100*est_mul/(est_ntt+est_mul):.0f}%)")
    write_records("fig13_breakdown.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
