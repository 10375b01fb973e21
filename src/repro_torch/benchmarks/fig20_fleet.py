"""Fig. 20 counterpart of the port (fleet-scale serving): offered load vs p99
latency and goodput at 1/4/16 devices, plus a routing-policy ablation.

Drives the repro_torch.fleet subsystem — N simulated devices, each wrapping
its own analytic backend + key cache, behind admission-time routing and
an SLO-aware scheduler with continuous slot batching — on a mixed
four-workload Poisson stream with per-request deadlines. Goodput
(deadline-met completions/s) is the y-axis that matters for SLO
serving: past a single device's saturation point, throughput flattens
but goodput collapses as queue delay eats the deadline budget; adding
devices moves the collapse point out by the fleet factor.

The routing ablation fixes 4 devices and sizes each key cache to hold
only ~1.5 workloads' stage constants, then compares placement
policies on the same arrival stream: ``round_robin`` splatters every
workload across every device (all caches thrash), while
``cache_affinity`` parks each workload where its constants are already
resident — the serving-time analogue of the paper's load-save insight
(§IV-F) that constant movement, not compute, bounds throughput.

Two in-benchmark gates (the fig20 acceptance criteria):
* goodput at 4 devices >= 2.5x the 1-device goodput at the highest
  common offered load;
* cache_affinity goodput >= round_robin goodput in the ablation.

The same settings, seeds, records and gates as
``benchmarks/fig20_fleet.py``. Analytic devices on a virtual clock:
places no tensor.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig20_fleet [--smoke]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract) and rewrites ``build/repro_torch/results/fig20_fleet.jsonl``
for report.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.benchmarks.common import HOST, row, write_records
from repro_torch.compiler import PassConfig
from repro_torch.core.params import test_params
from repro_torch.core.pipeline import MemoryModel
from repro_torch.fleet import FleetScheduler
from repro_torch.runtime.batcher import BatchPolicy
from repro_torch.runtime.compile_cache import CompileCache
from repro_torch.runtime.queue import Request
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)



def _workloads(smoke: bool):
    dim = 8 if smoke else 16
    deg = 6 if smoke else 8
    rots = (1, 2, 4) if smoke else (1, 2, 4, 8, 16, 32)
    return {
        "helr": (make_helr_iter(rots), 2, HELR_CONSTS),
        "lola": (lola_infer, 1, LOLA_CONSTS),
        "matvec": (make_matvec(dim), 1, matvec_consts(dim)),
        "poly": (make_poly_eval(deg), 1, poly_consts(deg)),
    }


def _setting(smoke: bool):
    if smoke:
        params = test_params(log_n=10, n_levels=8, dnum=2)
        mem = MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20)
        return params, mem, 7, 3000
    params = test_params(log_n=12, n_levels=10, dnum=2)
    mem = MemoryModel(n_partitions=8, partition_bytes=32 * 2 ** 20)
    return params, mem, 9, 3000


def _build_fleet(params, mem, start_level, *, n_devices, router,
                 cache_bytes, smoke, continuous=True,
                 preload_keys=True) -> FleetScheduler:
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=8,
                         max_wait_s=1e-3)
    fleet = FleetScheduler(
        params, mem, n_devices=n_devices, backend="analytic",
        router=router, policy=policy, cache_bytes=cache_bytes,
        pass_config=PassConfig(start_level=start_level, bsgs_min_terms=4),
        continuous_batching=continuous,
        # bounded percentile memory: sweeps run O(10k) requests per
        # point; 4096 exact-below/reservoir-above samples keeps p99
        # honest while capping the accumulators (satellite of fig21)
        latency_reservoir=4096)
    for name, (fn, n_in, consts) in _workloads(smoke).items():
        fleet.register(name, fn, n_in, const_names=consts,
                       start_level=start_level)
    fleet.warmup(preload_keys=preload_keys)
    return fleet


def _arrivals(fleet, n_requests, rate_rps, deadline_s, seed=0):
    rng = np.random.default_rng(seed)
    names = list(fleet.workloads)
    slots = fleet.policy.slots_per_ct
    out, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        # workload drawn at random, not cycled: a deterministic
        # workload cycle aliases with the round-robin device cycle
        # (workload k always lands on device k), which would hand the
        # baseline router perfect affinity by accident
        out.append(Request(
            fleet.next_request_id(), tenant=f"tenant{i % 4}",
            workload=names[int(rng.integers(len(names)))], arrival_s=t,
            slots_needed=int(rng.integers(slots // 8, slots // 2)),
            deadline_s=t + deadline_s if deadline_s > 0 else None))
    return out


def _working_set_bytes(params, mem, start_level, smoke):
    """Mean per-workload stage-constant footprint (the ablation's
    cache-sizing unit)."""
    cc = CompileCache()
    cfg = PassConfig(start_level=start_level, bsgs_min_terms=4)
    from repro_torch.core.trace import trace_program
    sizes = []
    for name, (fn, n_in, consts) in _workloads(smoke).items():
        trace = trace_program(fn, n_in, const_names=consts)
        sched = cc.get_schedule(trace, params, mem, pass_config=cfg)
        sizes.append(sum(st.const_bytes for st in sched.stages))
    return sum(sizes) / len(sizes)


def _point(fleet, n_requests, rate_rps, deadline_s, seed=0):
    m = fleet.serve(_arrivals(fleet, n_requests, rate_rps, deadline_s,
                              seed=seed))
    occ = m.device_occupancy()
    return {
        "offered_rps": rate_rps,
        "throughput_rps": m.throughput_rps(),
        "goodput_rps": m.goodput_rps(),
        "p50_s": m.request_latency.p50,
        "p99_s": m.request_latency.p99,
        "queue_delay_p99_s": m.queue_delay.p99,
        "service_p99_s": m.service_time.p99,
        "routing_hit_rate": m.hit_rate("routing"),
        "keycache_hit_rate": m.hit_rate("keycache"),
        "preemptions": m.count("preemptions"),
        "refills": m.count("continuous_refills"),
        "deadline_misses": m.count("deadline_misses"),
        "mean_device_occupancy":
            sum(occ.values()) / len(occ) if occ else 0.0,
    }


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small ring + fewer points, fast CI check")
    args = ap.parse_args(list(argv))

    params, mem, start_level, n_req = _setting(args.smoke)
    big_cache = 1 << 30            # effectively unbounded for the sweep
    device_counts = (1, 4) if args.smoke else (1, 4, 16)
    mults = (0.5, 4.0) if args.smoke else (0.5, 1.0, 2.0, 4.0)

    # capacity probe: one device, everything offered at once, no
    # deadlines. Capacity is completions per BUSY second (elapsed
    # includes max-wait idle gaps between batches, which would
    # under-read it) — the sweep's load axis is in units of this
    probe = _build_fleet(params, mem, start_level, n_devices=1,
                         router="round_robin", cache_bytes=big_cache,
                         smoke=args.smoke)
    pm = probe.serve(_arrivals(probe, n_req, 1e9, 0.0))
    cap1 = pm.count("requests_completed") / pm.device_busy_s[0]
    # deadline budget: batch formation (max-wait) plus a few batch
    # services of slack — comfortable at low load, hopeless once a
    # saturated device's queue delay stacks past it
    deadline_s = 2 * probe.policy.max_wait_s + 4 * pm.batch_service.mean

    records = []
    sweep = {}
    for n_dev in device_counts:
        for mult in mults:
            offered = mult * cap1
            fleet = _build_fleet(params, mem, start_level,
                                 n_devices=n_dev, router="least_loaded",
                                 cache_bytes=big_cache, smoke=args.smoke)
            # bigger fleets need longer streams to reach steady state,
            # capped so the 16-device points stay tractable
            pt = _point(fleet, n_req * min(4, max(1, n_dev // 2)),
                        offered, deadline_s)
            sweep[(n_dev, mult)] = pt
            records.append(dict(pt, figure="sweep", devices=n_dev,
                                load_mult=mult, router="least_loaded",
                                smoke=bool(args.smoke)))
            row(f"fig20_load{mult:g}x_dev{n_dev}", pt["p99_s"] * 1e6,
                f"goodput={pt['goodput_rps']:.1f}req/s "
                f"thru={pt['throughput_rps']:.1f}req/s "
                f"qd99={pt['queue_delay_p99_s']*1e3:.2f}ms "
                f"occ={pt['mean_device_occupancy']*100:.0f}%")

    top = max(mults)
    g1 = sweep[(1, top)]["goodput_rps"]
    g4 = sweep[(4, top)]["goodput_rps"]
    assert g4 >= 2.5 * g1, (
        f"fleet scaling gate: 4-device goodput {g4:.1f} req/s is below "
        f"2.5x the 1-device goodput {g1:.1f} req/s at {top:g}x load")

    # routing ablation: 4 devices, each cache holds ~1.5 workloads'
    # constants (so placement decides whether anything stays resident),
    # cold caches at serve start (warmup compiles only)
    small_cache = int(1.5 * _working_set_bytes(params, mem, start_level,
                                               args.smoke))
    # constant streaming 8x slower than the sweep's memory point, so a
    # thrashing cache costs real capacity, not just tail latency — the
    # regime the load-save analysis says fleet serving actually lives in
    abl_mem = dataclasses.replace(mem, load_bw=mem.load_bw / 8)
    abl_probe = _build_fleet(params, abl_mem, start_level, n_devices=1,
                             router="round_robin", cache_bytes=big_cache,
                             smoke=args.smoke)
    am = abl_probe.serve(_arrivals(abl_probe, n_req // 4, 1e9, 0.0))
    cap_abl = am.count("requests_completed") / am.device_busy_s[0]
    dl_abl = 2 * abl_probe.policy.max_wait_s + 4 * am.batch_service.mean
    ablation = {}
    for policy in ("round_robin", "least_loaded", "cache_affinity"):
        fleet = _build_fleet(params, abl_mem, start_level, n_devices=4,
                             router=policy, cache_bytes=small_cache,
                             smoke=args.smoke, preload_keys=False)
        pt = _point(fleet, n_req * 2, 3.0 * cap_abl, dl_abl)
        ablation[policy] = pt
        records.append(dict(pt, figure="ablation", devices=4,
                            load_mult=3.0, router=policy,
                            smoke=bool(args.smoke)))
        row(f"fig20_router_{policy}", pt["p99_s"] * 1e6,
            f"goodput={pt['goodput_rps']:.1f}req/s "
            f"routing_hit={pt['routing_hit_rate']*100:.0f}% "
            f"keycache_hit={pt['keycache_hit_rate']*100:.0f}%")

    assert ablation["cache_affinity"]["goodput_rps"] >= \
        ablation["round_robin"]["goodput_rps"], (
        "routing gate: cache_affinity goodput "
        f"{ablation['cache_affinity']['goodput_rps']:.1f} req/s below "
        f"round_robin {ablation['round_robin']['goodput_rps']:.1f} req/s")

    write_records("fig20_fleet.jsonl", records, HOST)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
