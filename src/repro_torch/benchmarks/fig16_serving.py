"""Fig. 16 counterpart of the port (online serving): offered load vs
sustained throughput with the key cache on/off. The same setting, seeds,
loads and rows as ``benchmarks/fig16_serving.py``.

This sweep drives the repro_torch.runtime serving stack (multi-tenant
Poisson arrivals → slot batcher → load-save pipeline) on the analytic
MemoryModel backend at near-paper scale. The key cache keeps stage
constants (evk, rotation keys, plaintext weights) resident ACROSS
batches; disabling it reverts to the paper's per-round constant
streaming, so the gap between the two curves is precisely the
constant-movement tax on sustained serving throughput (the load-save
insight, §IV-F, extended to a request stream). Analytic: places no
tensor; times are the serve's virtual clock.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig16_serving

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig16_serving.jsonl``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.benchmarks.common import HOST, emit, write_records
from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import MemoryModel
from repro_torch.runtime import (BatchPolicy, KeyCache, PipelinedExecutor,
                                 Request)
from repro_torch.runtime.workloads import HELR_CONSTS, make_helr_iter

helr_iter = make_helr_iter(rot_steps=(1, 2, 4, 8, 16, 32, 64, 128))


def _make_executor(cache_on: bool):
    # near-paper deep setting, narrowed to keep the mapper fast
    params = CkksParams(log_n=15, log_scale=28, n_levels=15, dnum=3,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    mem = MemoryModel(n_partitions=16, partition_bytes=96 * 2 ** 20,
                      load_bw=64e9, modmul_throughput=8e12,
                      transfer_bw=256e9)
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=8,
                         max_wait_s=1e-3)
    ex = PipelinedExecutor(params, mem, policy=policy)
    ex.register("helr", helr_iter, 2, const_names=HELR_CONSTS,
                start_level=12)
    if cache_on:
        sched = ex.compile_cache.get_schedule(
            ex.workloads["helr"].trace, params, mem)
        working_set = sum(st.const_bytes for st in sched.stages)
        ex.key_cache = KeyCache(2 * working_set, load_bw=mem.load_bw,
                                metrics=ex.metrics)
    return ex


def _arrivals(ex, n_requests: int, rate_rps: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    slots = ex.policy.slots_per_ct
    out, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        out.append(Request(ex.queue.next_request_id(),
                           tenant=f"tenant{i % 4}", workload="helr",
                           arrival_s=t,
                           slots_needed=int(rng.integers(slots // 8,
                                                         slots // 2))))
    return out


def _sustained(cache_on: bool, rate_rps: float, n_requests: int = 160):
    ex = _make_executor(cache_on)
    m = ex.serve(_arrivals(ex, n_requests, rate_rps))
    n_hops = len(ex.workloads["helr"].trace.compute_ops())
    cts = m.count("ciphertexts_batched")
    hops_per_s = n_hops * cts / m.elapsed_s if m.elapsed_s else 0.0
    return m.throughput_rps(), m.request_latency.p99, \
        m.hit_rate("keycache"), hops_per_s


def main(argv=()) -> list:
    argparse.ArgumentParser(description=__doc__).parse_args(list(argv))
    records = []
    # saturation capacity probe: all requests offered at once
    cap_off = _sustained(False, rate_rps=1e9)[0]
    for mult in (0.25, 0.5, 1.0, 2.0, 4.0):
        offered = mult * cap_off
        t_off, p99_off, _, hops_off = _sustained(False, offered)
        t_on, p99_on, hit, hops_on = _sustained(True, offered)
        emit(records, f"fig16_load{mult:g}x_cache_off", p99_off * 1e6,
             f"{t_off:.1f}req/s {hops_off:.0f}hops/s "
             f"@offered {offered:.1f}req/s")
        emit(records, f"fig16_load{mult:g}x_cache_on", p99_on * 1e6,
             f"{t_on:.1f}req/s {hops_on:.0f}hops/s hit={hit*100:.0f}% "
             f"speedup={t_on/t_off:.2f}x")
    write_records("fig16_serving.jsonl", records, HOST)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
