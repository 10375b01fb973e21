"""Fig. 15 counterpart of the port: the paper's three optimizations, each
ablated. The same sections, parameters, seeds and rows as
``benchmarks/fig15_ablations.py``.

 (1) Montgomery-friendly (Solinas) moduli vs generic Barrett: measured
     modmul time (``core/modarith.py``'s ``mulmod_solinas`` and
     ``mulmod_barrett``, torch ops on the device) + the paper's own
     metric (addition steps: hamming weight h vs full n-bit serial adds).
 (2) Inter-bank network: chain (ring/ppermute) vs channel bus (all-gather)
     BConv: structural bytes-on-slowest-link per output limb (analytic).
 (3) Load-save pipeline vs naive coarse pipeline: per-input latency on a
     HELR-iteration trace at paper scale (§IV-F model, analytic).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig15_ablations \\
        [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig15_ablations.jsonl``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, timeit, write_records
from repro_torch.core import modarith as ma
from repro_torch.core import pipeline as pl
from repro_torch.core import trace as tr
from repro_torch.core.context import resolve_device
from repro_torch.core.params import CkksParams, find_ntt_primes


def ablate_moduli(records, dev):
    log_n = 12
    n = 1 << log_n
    sol = find_ntt_primes(30, log_n, 1, prefer_solinas=True)[0]
    gen = find_ntt_primes(30, log_n, 1, prefer_solinas=False)[0]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, min(sol.value, gen.value),
                                      size=(8, n), dtype=np.uint64
                                      ).astype(np.int64)).to(dev)
    bb, ss = sol.solinas
    q_sol = torch.tensor(sol.value, device=dev)
    t_sol = timeit(lambda: ma.mulmod_solinas(a, a, q_sol, bb, ss),
                   device=dev)
    q_gen = torch.tensor(gen.value, device=dev)
    mu = torch.tensor(ma.barrett_mu(gen.value), device=dev)
    t_bar = timeit(lambda: ma.mulmod_barrett(a, a, q_gen, mu), device=dev)
    emit(records, "fig15_moduli_solinas", t_sol * 1e6,
         f"h={sol.hamming_weight}: {30}b mult = {sol.hamming_weight} adds "
         f"(paper Base0->Base1)")
    emit(records, "fig15_moduli_barrett_generic", t_bar * 1e6,
         f"h={gen.hamming_weight}: {30} serial adds on the NMU")
    emit(records, "fig15_moduli_nmu_add_ratio", 0.0,
         f"{30 / sol.hamming_weight:.1f}x fewer NMU addition steps")


def ablate_interconnect(records):
    """Bytes crossing the bottleneck link per BConv, chain vs bus.

    Bus (all-gather on shared channel IO): every device's S_l limbs
    serialize over one bus -> S*N*8 bytes on the shared link.
    Chain (ring): each neighbor link carries (n-1)/n * S_l*N*8 bytes in
    parallel -> per-link bytes smaller by ~n_banks, and overlapped.
    """
    params = CkksParams(log_n=16, log_scale=28, n_levels=23, dnum=4,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    n_banks = 16
    s_total = params.n_q_moduli
    bytes_total = s_total * params.n * 8
    bus = bytes_total
    chain_per_link = (n_banks - 1) / n_banks * bytes_total / n_banks
    emit(records, "fig15_interconnect_bus_bytes", 0.0,
         f"{bus/2**20:.1f}MiB on shared channel IO")
    emit(records, "fig15_interconnect_chain_bytes_per_link", 0.0,
         f"{chain_per_link/2**20:.1f}MiB per neighbor link "
         f"({bus/chain_per_link:.1f}x less on bottleneck)")


def ablate_pipeline(records):
    def helr_iter(x, w, consts=None):
        s = x * w
        for k in (1, 2, 4, 8, 16, 32, 64, 128):
            s = s + s.rotate(k)
        a = s * consts["c1"]
        b = s * s
        c = b * s
        g = (a + c * consts["c3"]) * x
        return w + g

    t = tr.trace_program(helr_iter, 2, const_names=("c1", "c3"))
    tr.infer_levels(t, start_level=20)
    params = CkksParams(log_n=16, log_scale=28, n_levels=23, dnum=4,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    mem = pl.MemoryModel(n_partitions=16, partition_bytes=96 * 2 ** 20,
                         load_bw=64e9, modmul_throughput=8e12,
                         transfer_bw=256e9)
    sched = pl.generate_load_save_pipeline(t, params, mem)
    naive = pl.generate_naive_pipeline(t, params, mem)
    b = 32
    t_ls = sched.bottleneck_latency(b)
    t_nv = naive.bottleneck_latency(b)
    emit(records, "fig15_pipeline_load_save", t_ls * 1e6,
         f"{len(sched.stages)} stages, {len(sched.rounds)} rounds")
    emit(records, "fig15_pipeline_naive", t_nv * 1e6,
         f"reload-per-op={naive.reload_per_op}")
    emit(records, "fig15_pipeline_speedup", 0.0,
         f"{t_nv/t_ls:.2f}x (paper: 1.15-3.59x across configs)")


def main(argv=()) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the moduli ablation's products run (cuda, "
                         "the default, raises without a CUDA device)")
    dev = resolve_device(ap.parse_args(list(argv)).device)
    records = []
    ablate_moduli(records, dev)
    ablate_interconnect(records)
    ablate_pipeline(records)
    write_records("fig15_ablations.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
