"""Multi-tenant FHE serving driver over repro_torch.runtime.

Synthetic tenants submit requests against the registered FHE workloads;
the runtime batches them into slot groups, keeps stage constants
resident in the key cache, and drains them through the load-save
pipeline. Reports latency percentiles, throughput, cache hit rates, and
(on the ciphertext backend) per-workload decrypt accuracy: the run exits
1 if any workload's max |decrypt error| exceeds the parameter set's CKKS
tolerance.

Backends: ``analytic`` (MemoryModel cost model, virtual clock) and
``ciphertext`` (real encrypted execution through the batched CKKS
engine, wall clock). Everything runs on ``--device`` (default cuda; the
run fails without a CUDA device unless ``--device cpu`` is given).
Without ``--smoke`` the parameters are the paper's deep set (logN=16,
L=23, dnum=4) from start level 20.

    PYTHONPATH=src python -m repro_torch.launch.serve_fhe \\
        --backend ciphertext --use-kernels
    PYTHONPATH=src python -m repro_torch.launch.serve_fhe --smoke \\
        --backend ciphertext --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np

from repro_torch.compiler import PassConfig
from repro_torch.core.context import resolve_device
from repro_torch.core.params import (CkksParams, paper_params_bootstrap,
                                     test_params)
from repro_torch.core.pipeline import MemoryModel
from repro_torch.core.trace import LevelBudgetExhausted
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


def build_executor(params: CkksParams, mem: MemoryModel, *,
                   backend_name: str, max_batch: int, max_wait_s: float,
                   cache_bytes: int, start_level: int, opt: bool = True,
                   use_kernels: Optional[bool] = None,
                   device=None) -> PipelinedExecutor:
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=max_batch,
                         max_wait_s=max_wait_s)
    key_cache = (KeyCache(cache_bytes, load_bw=mem.load_bw)
                 if cache_bytes > 0 else None)
    backend = resolve_backend(backend_name, params, mem,
                              use_kernels=use_kernels, device=device)
    ex = PipelinedExecutor(params, mem, backend=backend, policy=policy,
                           key_cache=key_cache,
                           pass_config=PassConfig() if opt else None)
    for name, (fn, n_in, consts) in WORKLOADS.items():
        try:
            ex.register(name, fn, n_in, const_names=consts,
                        start_level=start_level)
        except LevelBudgetExhausted:
            print(f"skipping workload {name!r}: deeper than "
                  f"start_level={start_level} and --no-opt disables "
                  f"automatic bootstrap insertion")
    return ex


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
    ap.add_argument("--backend", choices=("analytic", "ciphertext"),
                    default="analytic")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device everything runs on; cuda fails "
                         "when no CUDA device is present")
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
    ap.add_argument("--opt", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the optimizing trace compiler "
                         "(repro_torch.compiler) before pipeline mapping; "
                         "--no-opt serves every trace verbatim")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class ServeResult:
    executor: PipelinedExecutor         # .metrics holds the serve's record
    warmup_s: float
    accuracy_ok: Optional[bool]         # None unless --backend ciphertext


def serve(args: argparse.Namespace) -> ServeResult:
    """Build the executor, warm it up, serve the synthetic arrivals and
    (ciphertext backend) check every workload's decrypt accuracy,
    printing the report as it goes."""
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

    # the ciphertext backend owns the ingress encryptor (payload values
    # are encrypted under the serving keys at pack time), so the
    # synthetic foreign-key ciphertext wrapping is redundant there
    encrypt = not args.no_encrypt and args.backend != "ciphertext"
    ex = build_executor(params, mem, backend_name=args.backend,
                        max_batch=args.max_batch,
                        max_wait_s=args.max_wait_ms * 1e-3,
                        cache_bytes=args.cache_mb * 2 ** 20,
                        start_level=start_level, opt=args.opt,
                        use_kernels=args.use_kernels, device=device)
    arrivals = synth_arrivals(
        ex, n_tenants=args.tenants, n_requests=args.requests,
        rate_rps=args.rate, seed=args.seed,
        deadline_s=args.deadline_ms * 1e-3,
        encrypt=encrypt, max_slots=min(128, params.slots), device=device)

    cache_tag = "off" if args.cache_mb <= 0 else f"{args.cache_mb}MiB"
    print(f"serving {len(arrivals)} requests from {args.tenants} tenants "
          f"({args.backend} backend on {device}, key cache {cache_tag}, "
          f"compiler {'on' if args.opt else 'off'})")
    t0 = time.perf_counter()
    ex.warmup()
    warmup_s = time.perf_counter() - t0
    print(f"warmup (compile + key preload): {warmup_s:.2f} s")
    m = ex.serve(arrivals)
    print(m.format_table())

    accuracy_ok = None
    if args.backend == "ciphertext":
        tol = ex.backend.tolerance
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
    return ServeResult(ex, warmup_s, accuracy_ok)


def main(argv: Optional[List[str]] = None) -> int:
    return 1 if serve(parse_args(argv)).accuracy_ok is False else 0


if __name__ == "__main__":
    sys.exit(main())
