#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds; any failure raises and exits
non-zero:

1. build  — compile the CUDA kernels K1-K7 from src/repro_torch/csrc
   (one nvcc per source, all started together);
2. kernels — each kernel against its plain PyTorch version at its
   path's shapes: K1-K4 as the serve path gives them
   (paper_params_bootstrap, level 20, batch 8, plus level 13 with a
   ragged tail digit); K5 mulacc over the T = 27 target rows and at
   fig14's T = 14 rows of N = 1024, K6 bconv (eager and lazy) at S = 6 ->
   D = 21 and S = 3 -> D = 24 with the 32-bit prime among the
   destinations and at fig14's S = 6 -> D = 4, N = 1024, each timed,
   with its launch line; K5 and K6 also at a ragged N;
   K7 ntt_col + ntt_row at N = 2^16, R = C = 256, at a 30-bit prime and
   at 3221225473, and at fig14's N = 2^12, R = C = 64, each timed.
   torch.equal, then the device time of kernel and plain version (20
   back-to-back calls between CUDA events, a sleep kernel holding the
   device while the host enqueues them), the host's time to enqueue one
   call, the kernel's bound, and a one-call library yardstick where one
   exists; times at a path's other
   shapes go under the "shapes" key of the kernel's row; K1 at both of
   its launch shapes (stage A over the Q limbs, C1 over the special
   limbs), each its own row; for K1-K3 (cluster kernels), K6 and K7 also
   the launch's grid, cluster size, threads, shared memory,
   cudaOccupancyMaxActiveClusters (blocks resident at once for K6 and
   K7), registers and local memory, as the built library reports them;
3. keyswitch — the 4-launch fused keyswitch against the library
   core/ops.key_switch, relin and Galois key, bit-equal, 4 dispatches
   per apply, its time per call at B = 8, and its device time split
   into the steps FusedKeySwitch.steps lists (the cast in, K1, K2,
   K1 (C1), K3, the cast out);
4. staged — the dispatch-per-stage keyswitch (K4-K6 + library NTTs) at
   level 20, relin and Galois key: bit-equal to the fused and the
   library keyswitch, 7 * 4 + 10 = 38 dispatches, K4-K6 launched;
5. fig14  — repro_torch.benchmarks.fig14_kernels at its default sizes on
   the card: its >= 4x dispatch assertion and oracle checks hold, and
   K4-K7 launched;
6. serve  — the port's serve_fhe main path (--backend ciphertext
   --use-kernels --device cuda, paper parameters from start level 20,
   8 requests over helr/lola/matvec/poly): every workload's accuracy OK
   and K1-K4 launched;
7. fleet  — serve_fhe on a fleet of FLEET_DEVICES = 2 ciphertext devices
   (--fleet 2 --router least_loaded, the serve phase's other flags), each
   device with its own engine, keys and kernel tables on the one card:
   every workload's accuracy OK, each device with at least one batch and
   busy time, K1-K4 launched (launches per device printed), the devices'
   relin keys torch.equal, every batch padded to --max-batch, the trace
   valid with one track per device, the OpenMetrics text parsed;
8. pim    — serve_fhe --backend pim --pim-preset fhemem --fleet 4
   --router least_loaded --continuous-batching --preempt --requests 200,
   payloads encrypted on the card: 200 requests completed, trace and
   metrics valid, no kernel launched; and the reference's anchor, the
   flat preset's PimBackend within 1 % of AnalyticBackend on every
   workload's schedule at paper parameters;
9. linalg — core/linalg at full width (paper_params_bootstrap, one
   ciphertext at level 20): matvec_bsgs over a banded 16-diagonal matrix
   with and without hoisting (6 Galois keys), a degree-31 Chebyshev
   series and HELR's degree-3 sigmoid, each decrypt within the engine's
   tolerance of numpy on the plaintext, each call's time and the keygen
   time printed;
10. bootstrap — core/bootstrap at tests/test_bootstrap.py's parameters on
   the ring 2^BOOT_LOG_N = 2^9 (log N 16 is out of reach of the
   reference's dense n x n embedding inverse, and above 2^9 its error
   passes the test's bound): a level-0 ciphertext refreshed to level >= 2
   with max error < 0.05, the setup and each stage timed;
11. card against CPU — one matvec_bsgs (both modes, log N 8) and one
   bootstrap (log N 7) on the card and on the CPU from the same seeds:
   torch.equal. The CPU tests hold the CPU route to the JAX package.

The deep workloads (9-11) keyswitch through the library route, as the
reference does, and launch no kernel: their counts must stay 0, as must
the pim path's. Launch counts are set to 0 just before each of the
staged, fig14, serve, fleet, pim, linalg and bootstrap paths and read
just after. The fleet and pim phases write their trace and metrics
files under build/repro_torch/chip_smoke/ and keep the event log in
memory. Then a JSON line of per-kernel numbers (all ten kernel rows,
launches per path), the card's name and power limit from nvidia-smi, and
the final status line.
Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3
# bandwidth, and float32 outside the tensor cores, the only non-tensor
# rate the data sheet gives; Hopper's 32-bit integer multiply rate is at
# most this, so the operation bound is a lower bound on the time.
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
# Operations counted per modular primitive: a Montgomery product is three
# 32-bit multiplies (a*b, m = lo*qinv, m*q); an add/sub mod q is one.
MONT, ADD = 3, 1

LEVEL = 20          # serve_fhe's start level at paper parameters
LOW_LEVEL = 13      # 14 limbs -> digits of 6, 6, 2: a ragged tail
BATCH = 8           # serve_fhe --max-batch
REPS = 20
# SM cycles a second, for the sleep that holds the device while the host
# enqueues timed launches (H100 SXM boost clock, 1.98 GHz)
SLEEP_CYCLES_PER_S = 1.98e9
RAGGED = 36         # N - 36 columns: not a multiple of any block
FIG14_BCONV_N = 1024  # fig14's BConv columns (benchmarks/fig14_kernels.py)
FIG14_NTT_LOG_N = 12  # fig14's four-step NTT: N = 4096, R = C = 64
FIG14_KEYSWITCH = dict(log_n=10, n_levels=8, dnum=2, log_scale=26)
Q32 = 3221225473    # paper_params_bootstrap's 32-bit special prime
LINALG_DIAGS = 16   # the linalg phase's banded matrix: diagonals 0..15
CHEB_DEGREE = 31    # EvalMod's default Chebyshev degree (BootstrapConfig)
SIGMOID3 = (0.5, 0.197, 0.0, -0.004)    # HELR's degree-3 sigmoid
# the bootstrap phase's ring: the largest at which tests/test_bootstrap.py's
# parameters keep its 0.05 error bound (benchmarks/bootstrap_ring.py)
BOOT_LOG_N = 9
BOOT_SMALL_LOG_N = 7  # tests/test_bootstrap.py's ring, card against CPU

FLEET_DEVICES = 2   # the fleet phase's ciphertext devices on one card
PIM_DEVICES = 4     # the pim phase's simulated FHEmem devices
PIM_REQUESTS = 200
OUT_DIR = os.path.join(ROOT, "build", "repro_torch", "chip_smoke")

# kernels each driven path must launch, and the path whose count is a
# kernel's `launches` in the JSON line
SERVE_KERNELS = ("intt_scale", "bconv_ntt_mulacc", "intt_scale(C1)",
                 "moddown", "modmul")
STAGED_KERNELS = ("modmul", "mulacc", "bconv")
FIG14_KERNELS = ("modmul", "mulacc", "bconv", "bconv_lazy", "ntt_col",
                 "ntt_row")
ORDER = SERVE_KERNELS + FIG14_KERNELS[1:]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[phase] {self.name}: ok in "
                  f"{time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def device_ms(torch, fn, reps: int = REPS):
    """Device time of one call of fn: the mean of `reps` back-to-back
    calls between two CUDA events, with a sleep kernel holding the device
    while the host enqueues them, so the host's time per call (Python,
    operand checks, the launch itself) is not timed when the sleep covers
    it. Returns (device ms, host ms to enqueue one call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.0, 2 * reps * once) * SLEEP_CYCLES_PER_S))
    s.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = (time.perf_counter() - t0) / reps
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps, host_s * 1e3


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median time of one call of fn between CUDA events recorded just
    before and after it: device time plus any gap while the host
    enqueues the call's launches (what a caller of one keyswitch waits)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def ntt_ops(n: int) -> int:
    """One length-n NTT: n/2 log n butterflies of a product and an
    add and a sub."""
    return n // 2 * (n.bit_length() - 1) * (MONT + 2 * ADD)


def banded_diagonals(s, n_diag, rng):
    """The generalized diagonals 0..n_diag-1 of a banded s x s matrix,
    as matvec_bsgs takes them (never a dense s x s matrix)."""
    return {d: 0.1 * (rng.normal(size=s) + 1j * rng.normal(size=s))
            for d in range(n_diag)}


def banded_matvec(diags, v):
    """M @ v in numpy from M's generalized diagonals."""
    return sum(dg * np.roll(v, -d) for d, dg in diags.items())


def small_matvec(dev):
    """One matvec_bsgs (hoisted and not) at the CPU tests' size
    (tests/test_torch_linalg.py's parameters) on `dev`, from fixed seeds."""
    from repro_torch.benchmarks.common import CkksStack
    from repro_torch.core import linalg
    from repro_torch.core.params import test_params
    params = test_params(log_n=8, n_levels=4, dnum=2, log_scale=26)
    st = CkksStack(params, dev, seed=7)
    rng = np.random.default_rng(1234)
    diags = banded_diagonals(params.slots, 6, rng)
    gks = st.encr.galois_keygen(st.sk,
                                linalg.matvec_keys_needed(st.ctx, diags))
    ct = st.encrypt(rng.normal(size=params.slots), 2.0 ** 26,
                    params.n_levels)
    return [linalg.matvec_bsgs(st.ctx, ct, diags, gks, st.enc,
                               use_hoisting=h) for h in (True, False)]


def linalg_phase(dev, params, level):
    """matvec_bsgs (hoisted and not), a degree-31 Chebyshev series and
    HELR's degree-3 sigmoid on one ciphertext at `level`, each decrypt
    held to the engine's tolerance of the numpy result."""
    from repro_torch.benchmarks.common import CkksStack, synced
    from repro_torch.compiler.engine import decrypt_tolerance
    from repro_torch.core import linalg
    tol = decrypt_tolerance(params)
    s = params.slots
    scale = 2.0 ** params.log_scale
    rng = np.random.default_rng(5)
    st = CkksStack(params, dev, seed=17)
    ctx = st.ctx
    diags = banded_diagonals(s, LINALG_DIAGS, rng)
    # the keys this call uses: baby steps d % bs, giant steps d - d % bs
    # (matvec_keys_needed, as in the reference, asks for every giant step
    # whether or not its group holds a diagonal: 8191 keys here)
    bs, _ = linalg.bsgs_split(list(diags), s)
    steps = sorted(({d % bs for d in diags} | {d - d % bs for d in diags})
                   - {0})
    elts = sorted(ctx.rotation_element(j) for j in steps)
    (gks, rk), t_key = synced(lambda: (st.encr.galois_keygen(st.sk, elts),
                                       st.encr.relin_keygen(st.sk)),
                              device=dev)
    print(f"  keygen: {len(gks)} Galois keys (rotations by {steps}) and "
          f"the relin key, {t_key:.3f} s; "
          f"{sum(k.data.numel() for k in gks.values()) * 8 / 2 ** 20:.0f} "
          f"MiB of Galois keys", flush=True)
    v = 0.5 * (rng.normal(size=s) + 1j * rng.normal(size=s))
    x = rng.uniform(-1, 1, size=s)
    ct_v = st.encrypt(v, scale, level)
    ct_x = st.encrypt(x, scale, level)
    want = banded_matvec(diags, v)
    got = {}
    for hoist in (True, False):
        out, secs = synced(linalg.matvec_bsgs, ctx, ct_v, diags, gks, st.enc,
                           hoist, device=dev)
        got[hoist] = st.decrypt(out)
        err = float(np.abs(got[hoist] - want).max())
        print(f"  matvec_bsgs ({LINALG_DIAGS} diagonals, "
              f"use_hoisting={hoist}): {secs:.3f} s, level {level} -> "
              f"{out.level}, max |err| {err:.3e} (tolerance {tol:.3e})",
              flush=True)
        if not err < tol:
            raise AssertionError(f"matvec_bsgs (hoisting {hoist}) error "
                                 f"{err} over {tol}")
    print(f"  hoisted against unhoisted decrypts: max |diff| "
          f"{np.abs(got[True] - got[False]).max():.3e}", flush=True)
    cheb = linalg.chebyshev_coeffs(lambda t: np.sin(2 * np.pi * t),
                                   CHEB_DEGREE)
    for name, call, coeffs, plain in (
            (f"poly_eval_chebyshev (degree {CHEB_DEGREE})",
             linalg.poly_eval_chebyshev, cheb,
             np.polynomial.chebyshev.chebval(x, cheb)),
            ("poly_eval_power_basis (degree 3, HELR's sigmoid)",
             linalg.poly_eval_power_basis, list(SIGMOID3),
             np.polynomial.polynomial.polyval(x, SIGMOID3))):
        out, secs = synced(call, ctx, ct_x, coeffs, rk, st.enc, device=dev)
        err = float(np.abs(st.decrypt(out).real - plain).max())
        print(f"  {name}: {secs:.3f} s, level {level} -> {out.level}, "
              f"max |err| {err:.3e} (tolerance {tol:.3e})", flush=True)
        if not err < tol:
            raise AssertionError(f"{name} error {err} over {tol}")


def fleet_phase(torch, dev, smoke=False):
    """serve_fhe's ciphertext fleet of FLEET_DEVICES devices on `dev`
    (--smoke: the CPU rehearsal's size). Returns the path's launch counts;
    raises if a check fails. The fleet is freed before it returns."""
    from repro_torch.kernels import common
    from repro_torch.launch import serve_fhe
    from repro_torch.obs import parse_openmetrics, validate_file
    from repro_torch.runtime.ciphertext_backend import CiphertextBackend
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, "fleet.json")
    prom = os.path.join(OUT_DIR, "fleet.prom")
    args = serve_fhe.parse_args(
        ["--backend", "ciphertext", "--use-kernels", "--device", dev.type,
         "--fleet", str(FLEET_DEVICES), "--router", "least_loaded",
         "--requests", "8", "--deadline-ms", "0", "--cache-mb", "4096",
         "--trace-out", trace, "--metrics-out", prom, "--log-json"]
        + (["--smoke"] if smoke else []))
    # launches of each device's batches (warmup included), read around
    # the backend's execute; the counts themselves move only in the
    # kernel wrappers
    by_backend = collections.defaultdict(collections.Counter)
    execute = CiphertextBackend.execute

    def counted(self, *a, **kw):
        before = {k: v.launches for k, v in common.KERNELS.items()}
        try:
            return execute(self, *a, **kw)
        finally:
            for k, v in common.KERNELS.items():
                by_backend[id(self)][k] += v.launches - before.get(k, 0)

    log = io.StringIO()
    if dev.type == "cuda":
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    CiphertextBackend.execute = counted
    try:
        res = serve_fhe.serve(args, log_stream=log)
    finally:
        CiphertextBackend.execute = execute
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v.launches for k, v in common.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    fleet, m = res.executor, res.executor.metrics
    served = sorted(m.decrypt_error)
    if res.accuracy_ok is not True or served != sorted(serve_fhe.WORKLOADS):
        raise AssertionError(f"fleet accuracy {res.accuracy_ok}, "
                             f"workloads served {served}")
    if m.count("requests_completed") != 8:
        raise AssertionError(f"fleet completed "
                             f"{m.count('requests_completed')} of 8")
    batches = collections.Counter(
        s.track for s in m.tracer.store.spans if s.name.startswith("batch:"))
    keys = [d.backend.engine.rk.data for d in fleet.devices]
    for d in fleet.devices:
        track = f"device:{d.device_id}"
        if batches[track] < 1 or not m.device_busy_s[d.device_id] > 0:
            raise AssertionError(f"{track}: {batches[track]} batches, busy "
                                 f"{m.device_busy_s[d.device_id]} s")
        if d.backend.pad_batch_to != args.max_batch:
            raise AssertionError(f"{track} pads to {d.backend.pad_batch_to}"
                                 f", not --max-batch {args.max_batch}")
        if not torch.equal(keys[0], d.backend.engine.rk.data):
            raise AssertionError(f"{track}'s relin key differs from "
                                 f"device:0's")
        print(f"  {track}: {batches[track]} batches, busy "
              f"{m.device_busy_s[d.device_id]:.2f} s, launches "
              f"{ {k: by_backend[id(d.backend)][k] for k in SERVE_KERNELS} }",
              flush=True)
    errors = validate_file(trace)
    with open(trace) as f:
        obj = json.load(f)
    tracks = sorted(e["args"]["name"] for e in obj["traceEvents"]
                    if e["ph"] == "M" and e["name"] == "thread_name"
                    and e["pid"] == 1)
    if errors or tracks != [str(i) for i in range(FLEET_DEVICES)]:
        raise AssertionError(f"fleet trace: {errors}, device tracks "
                             f"{tracks}")
    with open(prom) as f:
        samples, errors = parse_openmetrics(f.read())
    if errors or not samples:
        raise AssertionError(f"fleet metrics: {errors}")
    n_events = len(log.getvalue().splitlines())
    del fleet, keys, d
    print(f"fleet: {FLEET_DEVICES} devices, relin keys torch.equal, "
          f"batches padded to {args.max_batch}, trace "
          f"{len(obj['traceEvents'])} events, {len(samples)} OpenMetrics "
          f"samples, {n_events} event-log lines", flush=True)
    print(f"fleet: warmup {res.warmup_s:.2f} s, p50 latency "
          f"{m.request_latency.p50 * 1e3:.1f} ms, throughput "
          f"{m.throughput_rps():.3f} req/s, "
          f"{m.count('requests_completed')} requests completed in "
          f"{sum(batches.values())} batches, peak device memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    del res, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        print(f"fleet: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
              f"allocated after the fleet is freed, "
              f"{mem_before / 2 ** 30:.2f} GiB before it was built",
              flush=True)
    return launches


def pim_phase(dev, smoke=False):
    """serve_fhe --backend pim on a fleet of PIM_DEVICES, payloads
    encrypted on `dev`, then the flat preset's anchor against the
    analytic backend at the same parameters."""
    from repro_torch.launch import serve_fhe
    from repro_torch.obs import parse_openmetrics, validate_file
    from repro_torch.pim import PimBackend, memory_model
    from repro_torch.runtime.batcher import Batch
    from repro_torch.runtime.executor import AnalyticBackend
    from repro_torch.runtime.metrics import MetricsRegistry
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, "pim.json")
    prom = os.path.join(OUT_DIR, "pim.prom")
    args = serve_fhe.parse_args(
        ["--backend", "pim", "--pim-preset", "fhemem", "--fleet",
         str(PIM_DEVICES), "--router", "least_loaded",
         "--continuous-batching", "--preempt", "--requests",
         str(PIM_REQUESTS), "--device", dev.type, "--trace-out", trace,
         "--metrics-out", prom, "--log-json"]
        + (["--smoke"] if smoke else []))
    log = io.StringIO()
    t0 = time.perf_counter()
    res = serve_fhe.serve(args, log_stream=log)
    wall = time.perf_counter() - t0
    m = res.executor.metrics
    on = {r.payload.data.device.type for r in res.arrivals}
    if on != {dev.type}:
        raise AssertionError(f"pim payloads encrypted on {on}")
    done = m.count("requests_completed")
    if done != args.requests:
        raise AssertionError(f"pim completed {done} of {args.requests}")
    with open(prom) as f:
        samples, errors = parse_openmetrics(f.read())
    errors += validate_file(trace)
    if errors or not samples:
        raise AssertionError(f"pim trace/metrics: {errors}")
    print(f"pim: {done} requests on {PIM_DEVICES} devices in {wall:.2f} s "
          f"(payloads encrypted on {dev.type}), virtual p50 "
          f"{m.request_latency.p50 * 1e3:.3f} ms, throughput "
          f"{m.throughput_rps():.1f} req/s, {m.count('preemptions')} "
          f"preemptions, {len(res.executor.metrics.tracer.store)} spans, "
          f"{len(samples)} OpenMetrics samples, "
          f"{len(log.getvalue().splitlines())} event-log lines", flush=True)
    # the flat preset's hardware model bills like the analytic cost model
    mem = memory_model("flat")
    ex = serve_fhe.build_executor(
        res.executor.params, mem, backend_name="pim", max_batch=8,
        max_wait_s=2e-3, cache_bytes=0, start_level=20 if not smoke else 7,
        device=dev)
    worst = 0.0
    for name, w in ex.workloads.items():
        sched = ex.compile_cache.get_schedule(
            w.trace, ex.params, ex.mem, ex.mapper, pass_config=ex.pass_config)
        for b in (1, 8):
            t_pim, t_an = (backend.execute(
                sched, Batch(name, [], [[] for _ in range(b)], 0.0),
                key_cache=None, metrics=MetricsRegistry(mem.n_partitions),
                workload=name)
                for backend in (PimBackend(preset="flat"),
                                AnalyticBackend(mem)))
            rel = abs(t_pim - t_an) / t_an
            worst = max(worst, rel)
            if not rel <= 0.01:
                raise AssertionError(f"pim flat {name} b={b}: {t_pim} s "
                                     f"against analytic {t_an} s")
    print(f"pim: flat preset within {worst:.3e} (relative) of the analytic "
          f"backend on {sorted(ex.workloads)} at b = 1 and 8", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script measures the port on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import modarith as ma
    from repro_torch.core import ops as hops
    from repro_torch.core.context import CkksContext
    from repro_torch.core.encryptor import CkksEncryptor
    from repro_torch.benchmarks import bootstrap_ring, fig14_kernels
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.core.params import (find_2nth_root, find_ntt_primes,
                                         paper_params_bootstrap, test_params)
    from repro_torch.kernels import bconv as bc
    from repro_torch.kernels import build, common
    from repro_torch.kernels import keyswitch as ks
    from repro_torch.kernels import modmul as mm
    from repro_torch.kernels import ntt as kntt
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve_fhe

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    with Phase("build"):
        secs = build.build()
        print(f"nvcc build of {', '.join(build.SOURCES)}: {secs:.2f} s")
        for src in build.SOURCES:
            for line in build.ptxas_report(src).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")

    params = paper_params_bootstrap()
    rows = {}
    launch = {}         # K1-K3, ntt_col: launch shape at level 20

    with Phase("kernels"):
        ctx = CkksContext(params, dev)
        enc = CkksEncryptor(ctx, seed=7)
        sk = enc.keygen()
        rk = enc.relin_keygen(sk)
        fks = ks.FusedKeySwitch(ctx)
        n = ctx.n
        rng = np.random.default_rng(0)

        def rand_d2(level):
            cols = [rng.integers(0, ctx.primes[j], size=(BATCH, n))
                    for j in range(level + 1)]
            return torch.from_numpy(np.stack(cols, 1)).to(dev)

        def compare(name, kernel, plain):
            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            pairs = (zip(out_k, out_p) if isinstance(out_k, tuple)
                     else [(out_k, out_p)])
            err = 0
            for a, b in pairs:
                if not torch.equal(a, b):
                    diff = common.u32(a) - common.u32(b)
                    err = max(err, int(diff.abs().max()))
            if err:
                raise AssertionError(f"{name}: kernel differs from its "
                                     f"plain version, max |err| {err}")
            return out_k, err

        def measure(name, err, kern, plain, nb, nops, lib=None):
            info = common.KERNELS[name]
            b_ms, b_by = bound(nb, nops)
            ms, host_ms = device_ms(torch, kern)
            rows[name] = {
                "name": name, "route": "cuda", "source": info.source,
                "replaces": info.replaces, "launches": 0,
                "max_abs_err": err, "ms": ms,
                "plain_ms": device_ms(torch, plain)[0], "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": device_ms(torch, lib)[0] if lib else None,
                "bytes": nb, "ops": nops, "host_ms": host_ms}
            if name in launch:
                rows[name]["launch"] = launch[name]
            r = rows[name]
            print(f"  {name:<17} {ms:.4f} ms (plain "
                  f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
                  f"{b_by}, {nb / 1e6:.1f} MB, {nops / 1e9:.3f} Gop"
                  + (f", library {r['library_ms']:.4f} ms" if lib
                     else "") + f"; host {host_ms:.4f} ms a call)",
                  flush=True)

        def measure_shape(name, key, kern, plain, nb, nops):
            """A kernel's times at another shape its paths launch it at,
            under the "shapes" key of its row."""
            ms, host_ms = device_ms(torch, kern)
            b_ms, b_by = bound(nb, nops)
            shape = rows[name].setdefault("shapes", {})[key] = {
                "ms": ms, "host_ms": host_ms,
                "plain_ms": device_ms(torch, plain)[0], "bound_ms": b_ms,
                "bound_by": b_by}
            print(f"  {name:<17} {ms:.4f} ms at {key} (plain "
                  f"{shape['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by}; host {host_ms:.4f} ms a call)", flush=True)

        def print_launch(name, info, what):
            blocks = info["grid_x"] * info["grid_y"] * info["grid_z"]
            print(f"  {name} launch ({what}): grid ({info['grid_x']}, "
                  f"{info['grid_y']}) of {info['threads']} threads, "
                  f"{info['smem_bytes']} B dynamic shared memory, "
                  f"{info['max_active_clusters']} blocks resident at once "
                  f"({blocks / info['max_active_clusters']:.2f} waves), "
                  f"{info['registers']} registers, {info['local_bytes']} B "
                  f"local memory a thread", flush=True)

        for level in (LEVEL, LOW_LEVEL):
            t = fks._tables(level)
            l, n_p, d_n = level + 1, t.n_p, t.n_digits
            t_n = l + n_p
            ksk_m = fks.ksk_mont("relin", level, rk.data)
            d2 = rand_d2(level).to(torch.int32)
            a1 = (d2, 0, l, t.q_irp_m, t.q_q32, t.q_qi32, t.q_scale_m)
            v, e1 = compare(f"intt_scale@{level}",
                            lambda: ks.intt_scale(*a1),
                            lambda: ks.intt_scale_plain(*a1))
            a2 = (v, t.w_m, t.rp_m, t.t_q32, t.t_qi32, ksk_m, t.alpha)
            acc, e2 = compare(f"bconv_ntt_mulacc@{level}",
                              lambda: ks.bconv_ntt_mulacc(*a2),
                              lambda: ks.bconv_ntt_mulacc_plain(*a2))
            g = acc.reshape(2 * BATCH, t_n, n)
            a1c = (g, l, n_p, t.p_irp_m, t.p_q32, t.p_qi32, t.p_scale_m)
            vp, e1c = compare(f"intt_scale(C1)@{level}",
                              lambda: ks.intt_scale(
                                  *a1c, counter=ks.INTT_SCALE_C1),
                              lambda: ks.intt_scale_plain(*a1c))
            a3 = (g, vp, t.wpq_m, t.rp_m, t.t_q32, t.t_qi32, t.pinv_m)
            _, e3 = compare(f"moddown@{level}",
                            lambda: ks.moddown(*a3),
                            lambda: ks.moddown_plain(*a3))
            for name, dims in (("intt_scale", (BATCH, l, l)),
                               ("bconv_ntt_mulacc", (BATCH, l, t_n, d_n,
                                                     t.alpha)),
                               ("intt_scale(C1)", (2 * BATCH, t_n, n_p)),
                               ("moddown", (2 * BATCH, l, t_n, n_p))):
                info = ks.launch_info(name.split("(")[0], n, *dims)
                if level == LEVEL:
                    launch[name] = info
                blocks = info["grid_x"] * info["grid_y"] * info["grid_z"]
                waves = blocks / (info["cluster"]
                                  * info["max_active_clusters"])
                print(f"  {name}@{level} launch: grid ({info['grid_x']}, "
                      f"{info['grid_y']}, {info['grid_z']}) in clusters of "
                      f"{info['cluster']}, {info['threads']} threads, "
                      f"{info['smem_bytes']} B dynamic shared memory, "
                      f"cudaOccupancyMaxActiveClusters "
                      f"{info['max_active_clusters']} ({waves:.2f} waves), "
                      f"{info['registers']} registers, "
                      f"{info['local_bytes']} B local memory a thread",
                      flush=True)
            # K4 as _pmul_kernel drives it: (B, 2, l) rows, one plaintext
            ct = torch.stack([rand_d2(level), rand_d2(level)], 1)
            a = ct.reshape(2 * BATCH * l, n)
            pt = rand_d2(level)[0]
            q64, q32, qinv, rm = kops._mont_consts(
                tuple(ctx.primes[:l]), str(dev))
            b_mont = ma.mulmod(pt, rm[:, None], q64[:, None]).to(
                torch.int32)
            a4 = (a, b_mont, q32, qinv)
            _, e4 = compare(f"modmul@{level}",
                            lambda: mm.modmul_mont(*a4),
                            lambda: mm.modmul_mont_plain(*a4))
            print(f"level {level}: K1-K4 torch.equal to their plain "
                  f"versions ({d_n} digits, tail of "
                  f"{l - (d_n - 1) * t.alpha})", flush=True)
            if level != LEVEL:
                continue
            B, D, al = BATCH, d_n, t.alpha
            # bytes each function must move: inputs read once, outputs
            # written once (u32 = 4 bytes; K4's a and out are int64)
            k1_bytes = 4 * (B * l * n * 2 + l * n + 3 * l)
            k1_ops = B * l * (ntt_ops(n) + n * MONT)
            k1c_bytes = 4 * (2 * B * n_p * n * 2 + n_p * n + 3 * n_p)
            k1c_ops = 2 * B * n_p * (ntt_ops(n) + n * MONT)
            k2_bytes = 4 * (B * l * n + D * al * t_n + t_n * n
                            + D * 2 * t_n * n + 2 * B * t_n * n + 2 * t_n)
            k2_ops = B * t_n * (l * n * (MONT + ADD) + D * ntt_ops(n)
                                + D * 2 * n * MONT + (D - 1) * 2 * n * ADD)
            k3_bytes = 4 * (2 * B * l * n + 2 * B * n_p * n + n_p * l
                            + l * n + 2 * B * l * n + 3 * l)
            k3_ops = 2 * B * l * (n_p * n * (MONT + ADD) + ntt_ops(n)
                                  + n * (ADD + MONT))
            k4_bytes = 8 * a.numel() + 4 * b_mont.numel() + 8 * a.numel()
            k4_ops = a.numel() * MONT
            specs = [
                ("intt_scale", e1, lambda: ks.intt_scale(*a1),
                 lambda: ks.intt_scale_plain(*a1), k1_bytes, k1_ops, None),
                ("bconv_ntt_mulacc", e2, lambda: ks.bconv_ntt_mulacc(*a2),
                 lambda: ks.bconv_ntt_mulacc_plain(*a2), k2_bytes, k2_ops,
                 None),
                ("intt_scale(C1)", e1c, lambda: ks.intt_scale(
                    *a1c, counter=ks.INTT_SCALE_C1),
                 lambda: ks.intt_scale_plain(*a1c), k1c_bytes, k1c_ops,
                 None),
                ("moddown", e3, lambda: ks.moddown(*a3),
                 lambda: ks.moddown_plain(*a3), k3_bytes, k3_ops, None),
                ("modmul", e4, lambda: mm.modmul_mont(*a4),
                 lambda: mm.modmul_mont_plain(*a4), k4_bytes, k4_ops,
                 lambda: torch.remainder(
                     ct.reshape(2 * BATCH, l, n) * pt,
                     q64[:, None])),
            ]
            for spec in specs:
                measure(*spec)

        # K5-K7 at this slice's full-width shapes: the staged keyswitch's
        # target basis at level 20 (T = 27 rows, the 32-bit prime in P)
        print(f"level {LEVEL} target basis: K5-K7", flush=True)
        l = LEVEL + 1
        target = list(range(l)) + ctx.p_idx()
        t_primes = [ctx.primes[i] for i in target]
        t_n = len(target)
        if Q32 not in ctx.p_primes:
            raise AssertionError(f"{Q32} is not a special prime here")

        def rand_rows(primes, cols):
            return torch.from_numpy(np.stack([
                rng.integers(0, p, size=cols) for p in primes])).to(dev)

        q64t, q32t, qit, rmt = kops._mont_consts(tuple(t_primes), str(dev))
        for cols in (n - RAGGED, n):
            a5, b5, c5 = (rand_rows(t_primes, cols) for _ in range(3))
            b5m = ma.mulmod(b5, rmt[:, None], q64t[:, None]).to(torch.int32)
            a5s = (a5, b5m, c5, q32t, qit)
            _, e5 = compare(f"mulacc@N={cols}",
                            lambda: mm.mulacc_mont(*a5s),
                            lambda: mm.mulacc_mont_plain(*a5s))
        measure("mulacc", e5, lambda: mm.mulacc_mont(*a5s),
                lambda: mm.mulacc_mont_plain(*a5s),
                28 * t_n * n + 8 * t_n, t_n * n * (MONT + ADD),
                # wraps int64 on the 32-bit limb: a time yardstick only
                lambda: torch.remainder(a5 * b5 + c5, q64t[:, None]))
        # fig14's K5 launches: the staged keyswitch's target basis at its
        # parameters (logN = 10, level 8: T = 14 rows of N = 1024)
        p14 = test_params(**FIG14_KEYSWITCH)
        t14 = [m.value for m in
               p14.q_moduli[:p14.n_levels + 1] + p14.p_moduli]
        n5 = p14.n
        q64f, q32f, qif, rmf = kops._mont_consts(tuple(t14), str(dev))
        a5f, b5f, c5f = (rand_rows(t14, n5) for _ in range(3))
        b5fm = ma.mulmod(b5f, rmf[:, None], q64f[:, None]).to(torch.int32)
        a5fs = (a5f, b5fm, c5f, q32f, qif)
        compare(f"mulacc@T={len(t14)},N={n5}", lambda: mm.mulacc_mont(*a5fs),
                lambda: mm.mulacc_mont_plain(*a5fs))
        measure_shape("mulacc", f"T={len(t14)},N={n5}",
                      lambda: mm.mulacc_mont(*a5fs),
                      lambda: mm.mulacc_mont_plain(*a5fs),
                      28 * len(t14) * n5 + 8 * len(t14),
                      len(t14) * n5 * (MONT + ADD))

        digits = params.digit_indices(LEVEL)
        k6 = {}         # (S, D, N) -> K6's operands at that shape
        for dig, cols in ((digits[-1], n - RAGGED), (digits[-1], n),
                          (digits[0], n - RAGGED), (digits[0], n)):
            other = [i for i in target if i not in dig]
            tabs = ctx.bconv_tables(dig, other)
            k6[(len(dig), len(other), cols)] = (
                rand_rows([ctx.primes[i] for i in dig], cols), tabs.w_mont,
                tabs.dst_q32, tabs.dst_qinv32)
        # fig14's shape: 6 sources of 28 bits -> 4 destinations of 30 bits
        src14 = [m.value for m in find_ntt_primes(28, 10, 6)]
        dst14 = [m.value for m in find_ntt_primes(30, 10, 4)]
        p64, p32, pinv, rm = kops._mont_consts(tuple(dst14), str(dev))
        w14 = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, 6))).to(dev)
        k6[(6, 4, FIG14_BCONV_N)] = (
            rand_rows(src14, FIG14_BCONV_N),
            ma.mulmod(w14 % p64[:, None], rm[:, None], p64[:, None]).to(
                torch.int32), p32, pinv)
        errs = {False: 0, True: 0}
        for (s6, d6, cols), a6 in k6.items():
            for lazy in (False, True):
                _, err = compare(
                    f"bconv(lazy={lazy})@S={s6},D={d6},N={cols}",
                    lambda: bc.bconv_mont(*a6, lazy=lazy),
                    lambda: bc.bconv_plain(*a6, lazy))
                errs[lazy] = max(errs[lazy], err)
            if cols == n - RAGGED:
                continue
            info = bc.launch_info(s6, d6, cols)
            if (s6, d6) == (6, 21):
                launch["bconv"] = launch["bconv_lazy"] = info
            print_launch("bconv", info, f"S={s6}, D={d6}, N={cols}")

        def k6_cost(s6, d6, cols):
            return (8 * (s6 + d6) * cols + 4 * d6 * s6 + 8 * d6,
                    s6 * d6 * cols * (MONT + ADD))

        for lazy, name in ((False, "bconv"), (True, "bconv_lazy")):
            a6 = k6[(6, 21, n)]
            measure(name, errs[lazy], lambda: bc.bconv_mont(*a6, lazy=lazy),
                    lambda: bc.bconv_plain(*a6, lazy), *k6_cost(6, 21, n))
            for key in ((3, 24, n), (6, 4, FIG14_BCONV_N)):
                a6 = k6[key]
                measure_shape(name, "S={},D={},N={}".format(*key),
                              lambda: bc.bconv_mont(*a6, lazy=lazy),
                              lambda: bc.bconv_plain(*a6, lazy),
                              *k6_cost(*key))

        def col_cost(n7, r7, c7):
            return 8 * n7 + 4 * n7 + 4 * r7 + 8, c7 * ntt_ops(r7)

        def row_cost(n7, r7, c7):
            return 4 * n7 + 4 * n7 + 4 * c7 + 8 * n7 + 8, (
                n7 * MONT + r7 * ntt_ops(c7))

        def k7_operands(q7, log_n7):
            kern7 = kops.NttKernel(q7, find_2nth_root(q7, 2 << log_n7),
                                   log_n7, log_n7 // 2)
            kt = kern7.tables(dev)
            a7 = torch.from_numpy(rng.integers(0, q7, size=1 << log_n7)).to(
                dev)
            y7, e7c = compare(f"ntt_col@q={q7},N={1 << log_n7}",
                              lambda: kntt.ntt_col(a7, kt, 128),
                              lambda: kntt.ntt_col_plain(a7, kt))
            _, e7r = compare(f"ntt_row@q={q7},N={1 << log_n7}",
                             lambda: kntt.ntt_row(y7, kt, 8),
                             lambda: kntt.ntt_row_plain(y7, kt))
            return kt, a7, y7, e7c, e7r

        log_r = ctx.log_n // 2
        r7, c7 = 1 << log_r, n >> log_r
        for q7 in (Q32, find_ntt_primes(30, ctx.log_n, 1)[0].value):
            kt, a7, y7, e7c, e7r = k7_operands(q7, ctx.log_n)
        # fig14's four-step NTT: N = 2^12, R = C = 64, its 30-bit prime
        kt14, a14, y14, _, _ = k7_operands(
            find_ntt_primes(30, FIG14_NTT_LOG_N, 1)[0].value, FIG14_NTT_LOG_N)
        launch["ntt_col"] = kntt.launch_info(log_r, c7)
        launch["ntt_row"] = kntt.row_launch_info(ctx.log_n - log_r, r7)
        print_launch("ntt_col", launch["ntt_col"], f"R=C={r7}")
        print_launch("ntt_row", launch["ntt_row"], f"R=C={r7}")
        n14, r14 = 1 << FIG14_NTT_LOG_N, kt14.tabs.r
        c14 = n14 // r14
        measure("ntt_col", e7c, lambda: kntt.ntt_col(a7, kt, 128),
                lambda: kntt.ntt_col_plain(a7, kt), *col_cost(n, r7, c7))
        measure_shape("ntt_col", f"N={n14},R=C={r14}",
                      lambda: kntt.ntt_col(a14, kt14, 128),
                      lambda: kntt.ntt_col_plain(a14, kt14),
                      *col_cost(n14, r14, c14))
        measure("ntt_row", e7r, lambda: kntt.ntt_row(y7, kt, 8),
                lambda: kntt.ntt_row_plain(y7, kt), *row_cost(n, r7, c7))
        measure_shape("ntt_row", f"N={n14},R=C={r14}",
                      lambda: kntt.ntt_row(y14, kt14, 8),
                      lambda: kntt.ntt_row_plain(y14, kt14),
                      *row_cost(n14, r14, c14))
        print(f"K5 (T={t_n}; T={len(t14)} at N={n5}), K6 (S=6->D=21, "
              f"S=3->D=24, S=6->D=4 at N={FIG14_BCONV_N}, eager and lazy) "
              f"and K7 (N={n}, R=C={r7}; N={n14}, R=C={r14}) torch.equal to "
              f"their plain versions, ragged N={n - RAGGED} and q={Q32} "
              f"included", flush=True)

    def split_keyswitch(d2, level, km, whole_ms):
        """Device time of each step of FusedKeySwitch.apply, on the
        operands apply gives it, beside the time of the whole call."""
        steps = fks.steps(d2, level, km)
        res = {}
        for name, fn in steps:
            res[name] = fn(res)
        parts = {name: device_ms(torch, lambda fn=fn: fn(res))[0]
                 for name, fn in steps}
        total = sum(parts.values())
        print("  fused keyswitch device time split (relin, B = "
              f"{BATCH}): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        parts.items())
              + f" ms; sum {total:.4f} ms against {whole_ms:.4f} ms for "
              f"the whole call", flush=True)

    with Phase("keyswitch"):
        level = LEVEL
        elt = ctx.rotation_element(1)
        gk = enc.galois_keygen(sk, [elt])[elt]
        d2 = rand_d2(level)
        for key_id, key in (("relin", rk), (("gk", elt), gk)):
            km = fks.ksk_mont(key_id, level, key.data)
            before = common.dispatch_count()
            e0, e1 = fks.apply(d2, level, km)
            got = common.dispatch_count() - before
            if got != ks.FusedKeySwitch.DISPATCHES_PER_APPLY:
                raise AssertionError(f"fused keyswitch took {got} "
                                     f"dispatches, expected 4")
            r0, r1 = hops.key_switch(ctx, d2, level, key)
            if not (torch.equal(e0, r0) and torch.equal(e1, r1)):
                raise AssertionError(f"fused keyswitch ({key_id}) differs "
                                     f"from core/ops.key_switch")
            ms_f = cuda_ms(torch, lambda: fks.apply(d2, level, km), 5)
            dev_f, host_f = device_ms(torch, lambda: fks.apply(d2, level,
                                                               km))
            ms_l = cuda_ms(torch, lambda: hops.key_switch(ctx, d2, level,
                                                          key), 5)
            print(f"  {key_id}: bit-equal to the library route for all "
                  f"{BATCH} rows, 4 dispatches; fused {ms_f:.3f} ms a call "
                  f"at B = {BATCH} ({dev_f:.3f} ms device time over "
                  f"{REPS} calls, host {host_f:.3f} ms to enqueue one), "
                  f"library {ms_l:.3f} ms", flush=True)
            if key_id == "relin":
                split_keyswitch(d2, level, km, dev_f)

    paths = {}
    with Phase("staged"):
        row1 = d2[:1]
        n_dig = len(params.digit_indices(level))
        want = 7 * n_dig + 10
        common.reset_launches()
        for key_id, key in (("relin", rk), (("gk", elt), gk)):
            common.reset_dispatch_count()
            s0, s1 = ks.keyswitch_staged(ctx, row1[0], level, key)
            got = common.dispatch_count()
            if got != want:
                raise AssertionError(f"staged keyswitch took {got} "
                                     f"dispatches, expected {want}")
            e0, e1 = fks.apply(row1, level, fks.ksk_mont(key_id, level,
                                                         key.data))
            r0, r1 = hops.key_switch(ctx, row1, level, key)
            for name, (x0, x1) in (("fused", (e0, e1)),
                                   ("library", (r0, r1))):
                if not (torch.equal(s0, x0[0]) and torch.equal(s1, x1[0])):
                    raise AssertionError(f"staged keyswitch ({key_id}) "
                                         f"differs from the {name} route")
        paths["staged"] = launched = {
            k: v.launches for k, v in common.KERNELS.items()}
        expect = {"modmul": 2 * (n_dig + 2), "mulacc": 2 * 2 * n_dig,
                  "bconv": 2 * (n_dig + 2)}
        got = {k: launched[k] for k in STAGED_KERNELS}
        if got != expect:
            raise AssertionError(f"staged launches {got}, expected "
                                 f"{expect}")
        km = fks.ksk_mont("relin", level, rk.data)
        ms_s = cuda_ms(torch, lambda: ks.keyswitch_staged(
            ctx, row1[0], level, rk), 5)
        ms_f = cuda_ms(torch, lambda: fks.apply(row1, level, km), 5)
        ms_l = cuda_ms(torch, lambda: hops.key_switch(ctx, row1, level,
                                                      rk), 5)
        print(f"  staged keyswitch, level {level}, one row: bit-equal to "
              f"the fused and library routes (relin and Galois keys), "
              f"{want} dispatches against 4 fused; staged {ms_s:.3f} ms, "
              f"fused {ms_f:.3f} ms, library {ms_l:.3f} ms; launches per "
              f"keyswitch K4 {n_dig + 2}, K5 {2 * n_dig}, K6 {n_dig + 2}",
              flush=True)
        del ctx, enc, sk, rk, gk, fks, d2, row1, e0, e1, r0, r1, s0, s1
        torch.cuda.empty_cache()

    with Phase("fig14"):
        common.reset_launches()
        records = fig14_kernels.main(["--device", "cuda"])
        torch.cuda.synchronize()
        paths["fig14"] = launched = {
            k: v.launches for k, v in common.KERNELS.items()}
        missing = [k for k in FIG14_KERNELS if launched[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the fig14 "
                                 f"path: {missing}")
        red = next(r for r in records
                   if r["name"] == "fig14_keyswitch_dispatch_reduction")
        print(f"fig14: {len(records)} rows on the card, dispatch "
              f"reduction {red['reduction']:.2f}x (asserted >= 4x), "
              f"launches {launched}", flush=True)

    with Phase("serve"):
        args = serve_fhe.parse_args([
            "--backend", "ciphertext", "--use-kernels", "--device", "cuda",
            "--requests", "8", "--deadline-ms", "0",
            # the default 256 MiB key cache cannot pin two 120 MiB evks
            # of this parameter set (the reference refuses the same way)
            "--cache-mb", "4096"])
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        res = serve_fhe.serve(args)
        torch.cuda.synchronize()
        paths["serve"] = launches = {
            k: v.launches for k, v in common.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        m = res.executor.metrics
        served = sorted(m.decrypt_error)
        if res.accuracy_ok is not True or served != sorted(
                serve_fhe.WORKLOADS):
            raise AssertionError(f"serve accuracy {res.accuracy_ok}, "
                                 f"workloads served {served}")
        missing = [k for k in SERVE_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the serve "
                                 f"path: {missing}")
        stage_s = sum(m.occupancy.busy_s)     # serve batches' stages
        service_s = m.batch_service.mean * m.batch_service.count
        print(f"serve: op execution (device-synchronised stages) "
              f"{stage_s:.2f} s of {service_s:.2f} s batch service; the "
              f"rest is packing, encryption, decryption and decode")
        if res.executor.backend.pad_batch_to != BATCH:
            raise AssertionError(f"serve pads to "
                                 f"{res.executor.backend.pad_batch_to}, "
                                 f"not {BATCH}")
        # the host side of a batch, alone: encrypt and decode 8 rows
        eng = res.executor.backend.engine
        t0 = time.perf_counter()
        cb = eng.encrypt_batch(np.zeros((BATCH, params.slots)), LEVEL)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.decode_batch(cb)
        t_dec = time.perf_counter() - t0
        print(f"serve: host work of one batch of {BATCH} at level "
              f"{LEVEL}: encrypt_batch {t_enc:.3f} s, decode_batch "
              f"{t_dec:.3f} s")
        print(f"serve: warmup {res.warmup_s:.2f} s, p50 latency "
              f"{m.request_latency.p50 * 1e3:.1f} ms, throughput "
              f"{m.throughput_rps():.3f} req/s, "
              f"{m.count('requests_completed')} requests completed, "
              f"peak device memory {peak / 2 ** 30:.2f} GiB, "
              f"launches {launches}", flush=True)

    del res, eng, cb
    gc.collect()
    torch.cuda.empty_cache()

    def no_kernel_launched(path):
        """The deep workloads keyswitch through the library route of
        core/ops, as the reference does, and the pim path simulates: no
        kernel of K1-K7 may launch."""
        paths[path] = launched = {
            k: v.launches for k, v in common.KERNELS.items()}
        if any(launched.values()):
            raise AssertionError(f"kernels launched on the {path} path: "
                                 f"{launched}")

    with Phase("fleet"):
        paths["fleet"] = launches = fleet_phase(torch, dev)
        missing = [k for k in SERVE_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the fleet "
                                 f"path: {missing}")

    with Phase("pim"):
        common.reset_launches()
        pim_phase(dev)
        no_kernel_launched("pim")

    with Phase("linalg"):
        common.reset_launches()
        linalg_phase(dev, params, LEVEL)
        no_kernel_launched("linalg")
        torch.cuda.empty_cache()

    with Phase("bootstrap"):
        common.reset_launches()
        times = {}
        out, err = bootstrap_ring.run_bootstrap(dev, BOOT_LOG_N, times)
        no_kernel_launched("bootstrap")
        print("  " + bootstrap_ring.describe(BOOT_LOG_N, times, out, err),
              flush=True)
        if not bootstrap_ring.within_bound(out, err):
            raise AssertionError(f"bootstrap: level {out.level}, error "
                                 f"{err} (needs >= 2 and < 0.05)")

    with Phase("card against CPU"):
        cpu = torch.device("cpu")
        for name, run in (
                ("matvec_bsgs (log N 8, hoisted and not)", small_matvec),
                (f"bootstrap (log N {BOOT_SMALL_LOG_N})",
                 lambda d: [bootstrap_ring.run_bootstrap(
                     d, BOOT_SMALL_LOG_N)[0]])):
            (card, t_card), (host, t_host) = (
                bench_common.synced(run, d, device=d) for d in (dev, cpu))
            for a, b in zip(card, host):
                if not (a.level == b.level and a.scale == b.scale
                        and torch.equal(a.data.cpu(), b.data)):
                    raise AssertionError(f"{name}: card and CPU differ")
            print(f"  {name}: card and CPU torch.equal ({t_card:.2f} s on "
                  f"the card, {t_host:.2f} s on the CPU)", flush=True)

    if set(ORDER) != set(common.KERNELS) or set(ORDER) != set(rows):
        raise AssertionError(f"kernel rows {sorted(rows)} against "
                             f"registered {sorted(common.KERNELS)}")
    for name in ORDER:
        path = "serve" if name in SERVE_KERNELS else "fig14"
        rows[name]["path"] = path
        rows[name]["launches"] = paths[path][name]
        rows[name]["launches_by_path"] = {p: c[name] for p, c in
                                          paths.items()}
    print(json.dumps({"kernels": [rows[k] for k in ORDER]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
