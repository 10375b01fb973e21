"""Fig. 12 counterpart of the port: FHE primitive and workload throughput
across parameter sets (the paper compares FHEmem configs against
SHARP/CraterLake on deep and shallow workloads; here the port's
primitive times on one device, and workload-level numbers from the §IV-F
pipeline estimator). The same sections, parameters, seeds and rows as
``benchmarks/fig12_workloads.py``.

hadd, pmul, hmul with KSO (relinearise and rescale) and rotate run
through ``core.ops``, the library route (torch ops; no hand-written
kernel), at the shallow and deep parameter sets; times are medians of
device-synchronised wall clocks. The pipeline estimate is analytic.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig12_workloads \\
        [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig12_workloads.jsonl``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.benchmarks.common import emit, timeit, write_records
from repro_torch.core import ops
from repro_torch.core import pipeline as pl
from repro_torch.core import trace as tr
from repro_torch.core.ciphertext import Plaintext
from repro_torch.core.context import CkksContext, resolve_device
from repro_torch.core.encoder import CkksEncoder
from repro_torch.core.encryptor import CkksEncryptor
from repro_torch.core.params import CkksParams


def bench_param_set(records, tag, params, dev):
    ctx = CkksContext(params, dev)
    enc = CkksEncoder(ctx)
    encr = CkksEncryptor(ctx)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    gk = encr.rotation_keygen(sk, [1])
    rng = np.random.default_rng(0)
    s = ctx.n // 2
    scale = 2.0 ** params.log_scale
    L = params.n_levels
    v = rng.normal(size=s) * 0.3
    ct1 = encr.encrypt_sk(Plaintext(enc.encode(v, scale, L), L, scale), sk)
    ct2 = encr.encrypt_sk(Plaintext(enc.encode(v, scale, L), L, scale), sk)

    emit(records, f"fig12_{tag}_hadd", 1e6 * timeit(
        lambda: ops.hadd(ctx, ct1, ct2), device=dev),
        f"N=2^{params.log_n},L={L}")
    emit(records, f"fig12_{tag}_pmul", 1e6 * timeit(
        lambda: ops.pmul(ctx, ct1, Plaintext(ct2.data[0], L, scale)),
        device=dev))
    emit(records, f"fig12_{tag}_hmul_kso", 1e6 * timeit(
        lambda: ops.hmul(ctx, ct1, ct2, rk), device=dev),
        "incl. relin+rescale")
    emit(records, f"fig12_{tag}_rotate", 1e6 * timeit(
        lambda: ops.rotate(ctx, ct1, 1, gk[ctx.rotation_element(1)]),
        device=dev))


def bench_pipeline_estimates(records):
    """Workload-level (HELR iteration / bootstrapping CtS) per-input latency
    from the load-save pipeline model at paper scale."""
    def helr_iter(x, w, consts=None):
        sc = x * w
        for k in (1, 2, 4, 8, 16, 32, 64, 128):
            sc = sc + sc.rotate(k)
        a = sc * consts["c1"]
        b = sc * sc
        c = b * sc
        g = (a + c * consts["c3"]) * x
        return w + g

    t = tr.trace_program(helr_iter, 2, const_names=("c1", "c3"))
    params = CkksParams(log_n=16, log_scale=28, n_levels=23, dnum=4,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    tr.infer_levels(t, start_level=20)
    mem = pl.MemoryModel(n_partitions=32, partition_bytes=512 * 2 ** 20,
                         load_bw=64e9, modmul_throughput=8e12,
                         transfer_bw=256e9)
    sched = pl.generate_load_save_pipeline(t, params, mem)
    lat = sched.bottleneck_latency(32)
    emit(records, "fig12_helr_iter_pipeline", lat * 1e6,
         f"paper-scale N=2^16 L=23 dnum=4, {len(sched.stages)} stages")


def main(argv=()) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ciphertext arithmetic runs (cuda, the "
                         "default, raises without a CUDA device)")
    dev = resolve_device(ap.parse_args(list(argv)).device)
    records = []
    bench_param_set(records, "shallow", CkksParams(
        log_n=11, log_scale=26, n_levels=6, dnum=1, first_mod_bits=30,
        scale_mod_bits=26, special_mod_bits=30), dev)
    bench_param_set(records, "deep", CkksParams(
        log_n=12, log_scale=28, n_levels=12, dnum=4, first_mod_bits=31,
        scale_mod_bits=28, special_mod_bits=31), dev)
    bench_pipeline_estimates(records)
    write_records("fig12_workloads.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
