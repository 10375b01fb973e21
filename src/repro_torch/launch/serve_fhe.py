"""Multi-tenant FHE serving driver over repro_torch.runtime.

Synthetic tenants submit requests against the registered FHE workloads;
the runtime batches them into slot groups, keeps stage constants
resident in the key cache, and drains them through the load-save
pipeline. Reports latency percentiles, throughput, cache hit rates, and
(on the ciphertext backend) per-workload decrypt accuracy: the run exits
1 if any workload's max |decrypt error| exceeds the parameter set's CKKS
tolerance.

Backends: ``analytic`` (MemoryModel cost model, virtual clock),
``mesh`` (distributed placeholder stages over torch.distributed, wall
clock; world size 1 in-process unless a process group is already
initialised), ``ciphertext`` (real encrypted execution through the
batched CKKS engine, wall clock) and ``pim`` (discrete-event simulation
of the hierarchical FHEmem hardware model, repro_torch.pim; pick the
hardware point with ``--pim-preset``). Everything runs on ``--device`` (default
cuda; the run fails without a CUDA device unless ``--device cpu`` is
given). Without ``--smoke`` the parameters are the paper's deep set
(logN=16, L=23, dnum=4) from start level 20.

``--mem-profile {flat,fhemem,hbm2}`` selects the memory model the mapper
and analytic backend price against from the same preset registry the
pim backend's hardware points come from (repro_torch.pim.arch).
``--fleet N`` serves on N devices (repro_torch.fleet), each with its own
backend instance: a ciphertext fleet builds N engines on the one torch
device. ``--trace-out`` / ``--metrics-out`` / ``--log-json`` export the
serve's span trees, time series and lifecycle events (repro_torch.obs).
``--verify`` sweeps every compiled schedule and lowered PIM program with
the static verifier (repro_torch.analysis) and prints its summary.

    PYTHONPATH=src python -m repro_torch.launch.serve_fhe \\
        --backend ciphertext --use-kernels
    PYTHONPATH=src python -m repro_torch.launch.serve_fhe --smoke \\
        --backend ciphertext --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_fhe --smoke \\
        --backend pim --fleet 4 --router least_loaded --device cpu \\
        --trace-out trace.json --metrics-out metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.serve_fhe --smoke \\
        --backend mesh --verify --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import IO, List, Optional

import numpy as np

from repro_torch.compiler import PassConfig
from repro_torch.core.context import resolve_device
from repro_torch.core.params import (CkksParams, paper_params_bootstrap,
                                     test_params)
from repro_torch.core.pipeline import MemoryModel
from repro_torch.core.trace import LevelBudgetExhausted
from repro_torch.fleet.router import POLICIES as ROUTER_POLICIES
from repro_torch.obs import (JsonEventLog, SloBurnRate, Telemetry, Tracer,
                             parse_openmetrics, write_metrics, write_trace)
from repro_torch.pim.arch import PRESETS as PIM_PRESETS
from repro_torch.pim.arch import memory_model as pim_memory_model
from repro_torch.runtime import (BatchPolicy, KeyCache, PipelinedExecutor,
                                 Request)
from repro_torch.runtime.executor import resolve_backend
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)

WORKLOADS = {
    "helr": (make_helr_iter(), 2, HELR_CONSTS),
    "lola": (lola_infer, 1, LOLA_CONSTS),
    # rotation-heavy: the compiler's BSGS + lazy-rescale showcase
    "matvec": (make_matvec(16), 1, matvec_consts(16)),
    # deeper than the start level: needs bootstrap insertion
    "poly": (make_poly_eval(12), 1, poly_consts(12)),
}


def register_workloads(ex, start_level: int) -> None:
    """Register every WORKLOADS entry on an executor or a fleet; one too
    deep for `start_level` without the compiler's bootstrap insertion is
    skipped with a note."""
    for name, (fn, n_in, consts) in WORKLOADS.items():
        try:
            ex.register(name, fn, n_in, const_names=consts,
                        start_level=start_level)
        except LevelBudgetExhausted:
            print(f"skipping workload {name!r}: deeper than "
                  f"start_level={start_level} and --no-opt disables "
                  f"automatic bootstrap insertion")


def build_executor(params: CkksParams, mem: MemoryModel, *,
                   backend_name: str, max_batch: int, max_wait_s: float,
                   cache_bytes: int, start_level: int, opt: bool = True,
                   use_kernels: Optional[bool] = None,
                   device=None, verify: bool = False) -> PipelinedExecutor:
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=max_batch,
                         max_wait_s=max_wait_s)
    key_cache = (KeyCache(cache_bytes, load_bw=mem.load_bw)
                 if cache_bytes > 0 else None)
    backend = resolve_backend(backend_name, params, mem,
                              use_kernels=use_kernels, device=device,
                              verify=verify)
    ex = PipelinedExecutor(params, mem, backend=backend, policy=policy,
                           key_cache=key_cache,
                           pass_config=PassConfig() if opt else None,
                           verify=verify)
    register_workloads(ex, start_level)
    return ex


def build_fleet_scheduler(params: CkksParams, mem: MemoryModel, *,
                          n_devices: int, backend_name: str, router: str,
                          max_batch: int, max_wait_s: float,
                          cache_bytes: int, start_level: int,
                          opt: bool = True, continuous_batching: bool = False,
                          preempt: bool = False,
                          use_kernels: Optional[bool] = None, device=None,
                          verify: bool = False):
    """Fleet-mode mirror of build_executor: N devices (each with its own
    backend instance and caches, all on the torch `device`), one router,
    one scheduler."""
    from repro_torch.fleet import FleetScheduler
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=max_batch,
                         max_wait_s=max_wait_s)

    def backend_factory():
        return resolve_backend(backend_name, params, mem,
                               use_kernels=use_kernels, device=device,
                               verify=verify)
    fleet = FleetScheduler(
        params, mem, n_devices=n_devices, backend=backend_factory,
        router=router, policy=policy, cache_bytes=cache_bytes,
        pass_config=PassConfig() if opt else None,
        continuous_batching=continuous_batching, preempt=preempt,
        verify=verify)
    register_workloads(fleet, start_level)
    return fleet


def synth_arrivals(ex, *, n_tenants: int, n_requests: int,
                   rate_rps: float, seed: int, deadline_s: float,
                   encrypt: bool, max_slots: int, device=None) -> list:
    """Poisson arrivals from round-robin tenants, alternating workloads.

    With ``encrypt``, each request carries a real CKKS ciphertext
    (public-key encryption of a random slot vector on a small parameter
    set, on `device`); the runtime never sees plaintext payloads.
    """
    enc = None
    if encrypt:
        from repro_torch.core.ciphertext import Plaintext
        from repro_torch.core.context import CkksContext
        from repro_torch.core.encoder import CkksEncoder
        from repro_torch.core.encryptor import CkksEncryptor
        p_enc = test_params(log_n=8, n_levels=2, dnum=1)
        ctx = CkksContext(p_enc, device)
        encoder = CkksEncoder(ctx)
        encryptor = CkksEncryptor(ctx, seed=seed)
        sk = encryptor.keygen()
        pk = encryptor.public_keygen(sk)
        scale = float(2 ** p_enc.log_scale)

        def enc(vals):
            pt = Plaintext(encoder.encode(vals, scale, level=1), 1, scale)
            return encryptor.encrypt_pk(pt, pk)

    rng = np.random.default_rng(seed)
    names = list(ex.workloads)
    arrivals = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        slots = int(rng.integers(1, max_slots + 1))
        # bounded payload values keep deep Horner ladders (poly) inside
        # the first-modulus headroom on the real ciphertext backend
        vals = rng.uniform(-0.8, 0.8, size=min(slots, 128))
        payload = enc(vals) if enc is not None else vals
        arrivals.append(Request(
            ex.next_request_id(),
            tenant=f"tenant{i % n_tenants}",
            workload=names[i % len(names)],
            arrival_s=t, slots_needed=slots,
            deadline_s=t + deadline_s if deadline_s > 0 else None,
            payload=payload))
    return arrivals


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small params, few requests, fast end-to-end check")
    ap.add_argument("--backend",
                    choices=("analytic", "mesh", "ciphertext", "pim"),
                    default="analytic")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device everything runs on; cuda fails "
                         "when no CUDA device is present")
    ap.add_argument("--pim-preset", choices=sorted(PIM_PRESETS),
                    default="fhemem",
                    help="hardware point for --backend pim "
                         "(repro_torch.pim.arch presets)")
    ap.add_argument("--mem-profile", choices=sorted(PIM_PRESETS),
                    default=None,
                    help="price the pipeline against this preset's "
                         "memory model instead of the built-in "
                         "defaults (shared registry with the pim "
                         "backend; defaults to --pim-preset when "
                         "--backend pim)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve on a simulated fleet of N devices "
                         "(repro_torch.fleet), each wrapping its own "
                         "--backend instance; 0 = single executor")
    ap.add_argument("--router", choices=ROUTER_POLICIES,
                    default="round_robin",
                    help="fleet admission-time placement policy")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="fleet: refill free slot rows of in-flight "
                         "batches between pipeline rounds")
    ap.add_argument("--preempt", action="store_true",
                    help="fleet: preempt best-effort batches at round "
                         "boundaries when a deadline batch is ready")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="offered load, requests/s (aggregate)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=200.0,
                    help="per-request deadline; 0 disables")
    ap.add_argument("--cache-mb", type=int, default=256,
                    help="key cache capacity; 0 disables the cache")
    ap.add_argument("--no-encrypt", action="store_true",
                    help="skip real CKKS payload encryption at ingest")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="(--backend ciphertext) route keyswitch + modmul "
                         "through the hand-written CUDA kernels "
                         "(repro_torch.kernels; bit-exact vs the library "
                         "path; their plain torch versions on the CPU); "
                         "default: on iff --device cuda")
    ap.add_argument("--verify", action="store_true",
                    help="static verification (repro_torch.analysis): sweep "
                         "every freshly compiled schedule (per-pass "
                         "diffs, trace/schedule invariants) and — with "
                         "--backend pim — hazard-analyze every lowered "
                         "instruction stream; an error finding aborts "
                         "instead of serving a corrupt artifact")
    ap.add_argument("--opt", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the optimizing trace compiler "
                         "(repro_torch.compiler) before pipeline mapping; "
                         "--no-opt serves every trace verbatim")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record per-request span trees (repro_torch.obs) "
                         "and write a Chrome/Perfetto trace_event JSON "
                         "here (load in https://ui.perfetto.dev or "
                         "chrome://tracing); one track per device, one "
                         "per tenant")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="sample time-series telemetry (repro_torch.obs."
                         "telemetry: per-bank PIM utilization, queue "
                         "depths, goodput, SLO burn rates) during the "
                         "serve and write an OpenMetrics/Prometheus "
                         "exposition here (self-validated; inspect "
                         "with any promtool-compatible reader)")
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON line per request lifecycle "
                         "event (accepted/routed/preempted/completed/"
                         "dropped...) to stdout as it happens")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # one preset registry (repro_torch.pim.arch): the pim backend
    # recovers its arch from the mem via resolve_backend, so the two
    # flags cannot name different hardware points
    if (args.backend == "pim" and args.mem_profile is not None
            and args.mem_profile != args.pim_preset):
        ap.error(f"--backend pim derives its hardware point from "
                 f"the memory model, so --mem-profile {args.mem_profile!r} "
                 f"would silently override --pim-preset "
                 f"{args.pim_preset!r}; pass one of them")
    return args


def verify_summary(ex):
    """What --verify swept on an executor or a fleet: (schedules, lowered
    programs, findings, wall seconds). Warmup compiles point metrics at a
    scratch registry, so the durable record is the one riding the cached
    schedules (and, for pim, the backend's lower-time counters)."""
    devices = getattr(ex, "devices", None) or [ex]
    scheds = [s for d in devices for s in d.compile_cache._cache.values()]
    backends = [d.backend for d in devices]
    v_wall = sum(getattr(s, "_verify_wall_s", 0.0) for s in scheds)
    v_find = sum(len(s.verify_report.findings) for s in scheds
                 if getattr(s, "verify_report", None) is not None)
    v_wall += sum(getattr(b, "verify_wall_s", 0.0) for b in backends)
    v_find += sum(getattr(b, "verify_findings", 0) for b in backends)
    n_prog = sum(len(getattr(b, "_lowered", ())) for b in backends)
    return len(scheds), n_prog, v_find, v_wall


@dataclasses.dataclass
class ServeResult:
    # a PipelinedExecutor, or a FleetScheduler with --fleet N;
    # .metrics holds the serve's record
    executor: object
    warmup_s: float
    accuracy_ok: Optional[bool]         # None unless --backend ciphertext
    arrivals: list                      # the served requests


def serve(args: argparse.Namespace,
          log_stream: Optional[IO[str]] = None) -> ServeResult:
    """Build the executor (or fleet), warm it up, serve the synthetic
    arrivals, write the trace and metrics files asked for and
    (ciphertext backend) check every workload's decrypt accuracy,
    printing the report as it goes. ``--log-json`` events go to
    `log_stream` (stdout when None)."""
    device = resolve_device(args.device)

    if args.smoke:
        args.requests = min(args.requests, 60)
        params = test_params(log_n=10, n_levels=8, dnum=2)
        start_level = 7
        mem = MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20)
        if args.backend == "ciphertext":
            # real homomorphic execution: fewer requests, a smaller ring,
            # and no deadlines (wall-clock batches would expire a 200ms
            # budget spuriously on slow runners)
            args.requests = min(args.requests, 24)
            params = test_params(log_n=8, n_levels=8, dnum=2)
            args.deadline_ms = 0.0
    else:
        params = paper_params_bootstrap()
        start_level = 20
        mem = MemoryModel(n_partitions=16, partition_bytes=96 * 2 ** 20)

    profile = args.pim_preset if args.backend == "pim" else args.mem_profile
    if profile is not None:
        mem = pim_memory_model(profile)

    # the ciphertext backend owns the ingress encryptor (payload values
    # are encrypted under the serving keys at pack time), so the
    # synthetic foreign-key ciphertext wrapping is redundant there
    encrypt = not args.no_encrypt and args.backend != "ciphertext"
    if args.fleet > 0:
        ex = build_fleet_scheduler(
            params, mem, n_devices=args.fleet, backend_name=args.backend,
            router=args.router, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms * 1e-3,
            cache_bytes=args.cache_mb * 2 ** 20,
            start_level=start_level, opt=args.opt,
            continuous_batching=args.continuous_batching,
            preempt=args.preempt, use_kernels=args.use_kernels,
            device=device, verify=args.verify)
    else:
        ex = build_executor(params, mem, backend_name=args.backend,
                            max_batch=args.max_batch,
                            max_wait_s=args.max_wait_ms * 1e-3,
                            cache_bytes=args.cache_mb * 2 ** 20,
                            start_level=start_level, opt=args.opt,
                            use_kernels=args.use_kernels, device=device,
                            verify=args.verify)
    arrivals = synth_arrivals(
        ex, n_tenants=args.tenants, n_requests=args.requests,
        rate_rps=args.rate, seed=args.seed,
        deadline_s=args.deadline_ms * 1e-3,
        encrypt=encrypt, max_slots=min(128, params.slots), device=device)

    cache_tag = "off" if args.cache_mb <= 0 else f"{args.cache_mb}MiB"
    cb_tag = ", continuous batching" if args.continuous_batching else ""
    fleet_tag = (f"fleet of {args.fleet} ({args.router} router{cb_tag}"
                 f"{', preemption' if args.preempt else ''}), "
                 if args.fleet > 0 else "")
    print(f"serving {len(arrivals)} requests from {args.tenants} tenants "
          f"({fleet_tag}{args.backend} backend on {device}, key cache "
          f"{cache_tag}, compiler {'on' if args.opt else 'off'})")
    t0 = time.perf_counter()
    ex.warmup()
    warmup_s = time.perf_counter() - t0
    print(f"warmup (compile + key preload): {warmup_s:.2f} s")
    # observability: the tracer/event log hang off the shared registry
    # (fleet devices all share ex.metrics), attached after warmup so
    # deploy-time work stays out of the serving trace
    clock = "wall" if args.backend in ("mesh", "ciphertext") else "virtual"
    tracer = None
    if args.trace_out:
        tracer = ex.metrics.tracer = Tracer()
    if args.log_json:
        ex.metrics.event_log = JsonEventLog(
            sys.stdout if log_stream is None else log_stream)
    telemetry = None
    if args.metrics_out:
        telemetry = ex.metrics.telemetry = Telemetry(clock=clock)
        if args.deadline_ms > 0:
            ex.metrics.slo = SloBurnRate()
    m = ex.serve(arrivals)
    print(m.format_table())
    if args.verify:
        n_sched, n_prog, v_find, v_wall = verify_summary(ex)
        print(f"verify: {n_sched} schedule(s) + {n_prog} lowered "
              f"program(s) swept, {v_find} finding(s), "
              f"{v_wall * 1e3:.1f} ms wall")
    if tracer is not None:
        obj = write_trace(tracer.store, args.trace_out, clock=clock,
                          telemetry=telemetry)
        print(f"trace: {len(tracer.store)} spans "
              f"({len(obj['traceEvents'])} events"
              + (f", {len(telemetry)} counter tracks"
                 if telemetry is not None else "")
              + f") -> {args.trace_out}")
    if telemetry is not None:
        text = write_metrics(args.metrics_out, telemetry, ex.metrics)
        n = len(parse_openmetrics(text)[0])
        slo = ex.metrics.slo
        slo_tag = (f", {len(slo.alerts)} SLO alert(s)"
                   if slo is not None else "")
        print(f"metrics: {len(telemetry)} series "
              f"({telemetry.n_points()} points, {n} samples, "
              f"{telemetry.clock} clock{slo_tag}) -> {args.metrics_out}")

    accuracy_ok = None
    if args.backend == "ciphertext":
        tol = (ex.devices[0].backend if args.fleet > 0
               else ex.backend).tolerance
        accuracy_ok = True
        for w in ex.workloads:
            err = m.decrypt_error.get(w)
            if err is None:
                print(f"accuracy {w:<12} no batch served")
                continue
            ok = err <= tol
            accuracy_ok &= ok
            print(f"accuracy {w:<12} max|err|={err:.3e} "
                  f"tol={tol:.3e} {'OK' if ok else 'FAIL'}")
    return ServeResult(ex, warmup_s, accuracy_ok, arrivals)


def main(argv: Optional[List[str]] = None) -> int:
    return 1 if serve(parse_args(argv)).accuracy_ok is False else 0


if __name__ == "__main__":
    sys.exit(main())
