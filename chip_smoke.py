#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds; any failure raises and exits
non-zero:

1. build  — compile the CUDA kernels K1-K4 from src/repro_torch/csrc;
2. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (paper_params_bootstrap, level 20, batch 8, plus level
   13 with a ragged tail digit): torch.equal, then median CUDA-event
   times of kernel and plain version, and the kernel's bound;
3. keyswitch — the 4-launch fused keyswitch against the library
   core/ops.key_switch, relin and Galois key, bit-equal, 4 dispatches
   per apply;
4. serve  — the port's serve_fhe main path (--backend ciphertext
   --use-kernels --device cuda, paper parameters from start level 20,
   8 requests over helr/lola/matvec/poly): every workload's accuracy OK
   and every kernel launched.

Then a JSON line of per-kernel numbers, the card's name and power limit
from nvidia-smi, and the final status line. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of fn over `reps` runs (CUDA events)."""
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script measures the port on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.core import modarith as ma
    from repro_torch.core import ops as hops
    from repro_torch.core.context import CkksContext
    from repro_torch.core.encryptor import CkksEncryptor
    from repro_torch.core.params import paper_params_bootstrap
    from repro_torch.kernels import build, common
    from repro_torch.kernels import keyswitch as ks
    from repro_torch.kernels import modmul as mm
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
                              lambda: ks.intt_scale(*a1c),
                              lambda: ks.intt_scale_plain(*a1c))
            a3 = (g, vp, t.wpq_m, t.rp_m, t.t_q32, t.t_qi32, t.pinv_m)
            _, e3 = compare(f"moddown@{level}",
                            lambda: ks.moddown(*a3),
                            lambda: ks.moddown_plain(*a3))
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
                ("moddown", e3, lambda: ks.moddown(*a3),
                 lambda: ks.moddown_plain(*a3), k3_bytes, k3_ops, None),
                ("modmul", e4, lambda: mm.modmul_mont(*a4),
                 lambda: mm.modmul_mont_plain(*a4), k4_bytes, k4_ops,
                 lambda: torch.remainder(
                     ct.reshape(2 * BATCH, l, n) * pt,
                     q64[:, None])),
            ]
            for name, err, kern, plain, nb, nops, lib in specs:
                info = common.KERNELS[name]
                b_ms, b_by = bound(nb, nops)
                rows[name] = {
                    "name": name, "route": "cuda", "source": info.source,
                    "replaces": info.replaces, "launches": 0,
                    "max_abs_err": err, "ms": cuda_ms(torch, kern),
                    "plain_ms": cuda_ms(torch, plain), "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": cuda_ms(torch, lib) if lib else None}
                r = rows[name]
                print(f"  {name:<17} {r['ms']:.4f} ms (plain "
                      f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
                      f"{b_by}, {nb / 1e6:.1f} MB, {nops / 1e9:.2f} Gop"
                      + (f", library {r['library_ms']:.4f} ms" if lib
                         else "") + ")", flush=True)

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
            ms_l = cuda_ms(torch, lambda: hops.key_switch(ctx, d2, level,
                                                          key), 5)
            print(f"  {key_id}: bit-equal to the library route for all "
                  f"{BATCH} rows, 4 dispatches; fused {ms_f:.3f} ms, "
                  f"library {ms_l:.3f} ms", flush=True)
        del ctx, enc, sk, rk, gk, fks, d2, e0, e1, r0, r1
        torch.cuda.empty_cache()

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
        launches = {k: v.launches for k, v in common.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        m = res.executor.metrics
        served = sorted(m.decrypt_error)
        if res.accuracy_ok is not True or served != sorted(
                serve_fhe.WORKLOADS):
            raise AssertionError(f"serve accuracy {res.accuracy_ok}, "
                                 f"workloads served {served}")
        missing = [k for k, c in launches.items() if c == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
        stage_s = sum(m.occupancy.busy_s)     # serve batches' stages
        service_s = m.batch_service.mean * m.batch_service.count
        print(f"serve: op execution (device-synchronised stages) "
              f"{stage_s:.2f} s of {service_s:.2f} s batch service; the "
              f"rest is packing, encryption, decryption and decode")
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

    for name, c in launches.items():
        rows[name]["launches"] = c
    print(json.dumps({"kernels": [rows[k] for k in
                                  ("intt_scale", "bconv_ntt_mulacc",
                                   "moddown", "modmul")]}))
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
