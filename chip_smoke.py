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
   --use-kernels --device cuda --verify, paper parameters from start
   level 20, 8 requests over helr/lola/matvec/poly): every workload's
   accuracy OK, K1-K4 launched, and the static verifier's sweep of every
   compiled schedule with 0 findings (its wall ms printed);
7. fleet  — serve_fhe on a fleet of FLEET_DEVICES = 2 ciphertext devices
   (--fleet 2 --router least_loaded, the serve phase's other flags), each
   device with its own engine, keys and kernel tables on the one card:
   every workload's accuracy OK, each device with at least one batch and
   busy time, K1-K4 launched (launches per device printed), the devices'
   relin keys torch.equal, every batch padded to --max-batch, the trace
   valid with one track per device, the OpenMetrics text parsed;
8. pim    — serve_fhe --backend pim --pim-preset fhemem --fleet 4
   --router least_loaded --continuous-batching --preempt --requests 200
   --verify, payloads encrypted on the card: 200 requests completed,
   trace and metrics valid, every schedule and lowered program verified
   with 0 findings, no kernel launched; and the reference's anchor, the
   flat preset's PimBackend within 1 % of AnalyticBackend on every
   workload's schedule at paper parameters;
9. verify — the lint gate (python -m repro_torch.analysis.lint --prove)
   at paper parameters: every artifact (trace, schedule, lowered PIM
   program of each workload, pass configuration, preset and mapper)
   with 0 errors, every rule of the catalogue proven to fire, artifacts
   and verify ms printed; host work, no kernel launched;
10. mesh  — serve_fhe --backend mesh --device cuda at paper parameters
   (the serve phase's 8 requests): every request completed, every
   batch's (8, 32768) output on the card, on an nccl group of world size
   1 that the serve starts; on that mesh distributed_bconv (ring and
   all-gather) at S = 6 -> D = 21, N = 65536 with 3221225473 among the
   destinations, torch.equal to core.rns.bconv and each timed; the
   limb-sharded hmul (with rescale) and rotate (core.ops on the basis
   fhe_dist.limb_ops.LimbShard) at level 20 (l = 21, T = 27, N = 65536, 3221225473 among the special
   primes; keys and ciphertexts from the port's encryptor) under both
   BConv schedules, torch.equal to core.ops.hmul / core.ops.rotate, each
   timed with CUDA events beside core.ops, with its device time and
   kernels a call from torch.profiler and the card's name and power
   limit; and 8 pipeline rounds within rtol 1e-6 of the sequential
   composition; the process group is destroyed at the end; no kernel
   launched;
11. linalg — core/linalg at full width (paper_params_bootstrap, one
   ciphertext at level 20): matvec_bsgs over a banded 16-diagonal matrix
   with and without hoisting (6 Galois keys), a degree-31 Chebyshev
   series and HELR's degree-3 sigmoid, each decrypt within the engine's
   tolerance of numpy on the plaintext, each call's time and the keygen
   time printed;
12. bootstrap — core/bootstrap at tests/test_bootstrap.py's parameters on
   the ring 2^BOOT_LOG_N = 2^9 (log N 16 is out of reach of the
   reference's dense n x n embedding inverse, and above 2^9 its error
   passes the test's bound): a level-0 ciphertext refreshed to level >= 2
   with max error < 0.05, the setup and each stage timed;
13. card against CPU — one matvec_bsgs (both modes, log N 8) and one
   bootstrap (log N 7) on the card and on the CPU from the same seeds:
   torch.equal. The CPU tests hold the CPU route to the JAX package.
14. llm — the LLM serve path (repro_torch.launch.serve, models/,
   configs/): qwen3-8b at its published configuration (36 layers,
   d_model 4096, vocab 151936, bf16, weights from a seeded generator on
   the card) at --batch 8 --prompt-len 32 --gen 32, with its parameter
   count, weight GiB, peak memory, median ms a decode step
   (device-synchronised), tok/s and the HBM bound of a step (the bytes
   a step must move: the weights it reads, the batch's embedding rows,
   the KV cache up to the position; for the MoE families also with at
   most batch * top_k experts of a layer read); then every
   other family once at full width for 7 steps at batch 8, depth cut
   only where one card forces it (deepseek-v3 1 dense + 1 MoE layer,
   arctic 1 layer, llama-3.2-vision 1 superblock of 4 + 1 cross; each
   cut listed in the `reduced` field of its `llm {...}` line), finite
   logits and tokens in range; then qwen3 and deepseek in float32, the
   smoke configs and full width cut to depth 1 (deepseek: 1 dense + 1
   MoE layer of 256 experts), for 4 teacher-forced steps on the card and
   on the CPU from the same weights, logits and every cache leaf within
   1e-4 of the CPU's largest value. No kernel of K1-K7 launches on this
   path.
15. train — LLM training (models.make_train_step on autograd, train/,
   data/, launch/train): qwen3-8b at full width (d_model 4096, vocab
   151936, untied head, bf16, weights from a seeded generator on the
   card), n_layers cut 36 -> 16 for 80 GB (the `reduced` field), at
   launch/train's defaults (batch 8, seq 128, lr 3e-4): 1 warm-up and 5
   timed steps, each ending in a device barrier, with ms a step (median),
   tok/s, peak memory, every loss (finite), the parameter count, the
   share of the bf16 dense peak that 6 * N * tokens a step is, and one
   more step under torch.profiler (CUDA activity only) for the idle share
   and the kernels that take the device time; then one float32 step at
   batch 2, seq 32 of every smoke config and of qwen3-8b at full width,
   depth 1, on the card and on the CPU from the same weights (loss, grad
   norm, every grad, m, v and the updated parameters where the gradient
   is not near 0 within 1e-4 of the CPU's largest value); then
   launch/train --smoke cut after 2 steps and resumed from its checkpoint
   to 4, torch.equal to an unbroken 4-step run. No kernel of K1-K7
   launches on this path.
16. dryrun — the sharding and dry-run slice (sharding/rules,
   launch/{specs, dryrun, roofline}): the dry run of every architecture
   x shape on the 16x16 mesh with the bytes on 2x16x16 (80 records, 16
   of them long_500k skips), each cell's status, per-device GiB and,
   for DRYRUN_COUNTED's architectures, matmul TFLOPs (FlopCounterMode
   over the whole step on meta tensors; the CLI counts the others); any
   `error`, or an `ok` cell whose per-device argument bytes pass 80 GiB
   on 16x16 without its record saying so, fails the phase. Then the
   roofline checked against real steps on the card (launch/roofline
   --measure): qwen3-8b at full width cut to 4 layers, train at batch 8
   x seq 128 on a mesh of one device, where FlopCounterMode over the real
   step equals the meta count, the spec-derived argument bytes equal the
   real params', AdamW state's and batch's nbytes (printed beside the
   memory_allocated delta), and the median of 5 steps after 1 warm-up is
   at least the bound (the ratio printed); then qwen3-8b decode at batch
   8 over the 32768-slot cache, step time against memory_s, printed
   beside the llm phase's step_bytes bound. No kernel of K1-K7 launches.

The deep workloads (11-13) keyswitch through the library route, as the
reference does, and launch no kernel: their counts must stay 0, as must
the pim, verify, mesh, llm, train and dryrun paths'. Launch counts are
set to 0 just before each of the staged, fig14, serve, fleet, pim,
verify, mesh, linalg, bootstrap, llm, train and dryrun paths and read
just after. The fleet and pim phases write their trace and metrics
files (the verify phase its lint JSON lines) under
build/repro_torch/chip_smoke/ and keep the event log in memory. Then a JSON line of per-kernel numbers (all ten kernel rows,
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

# the llm phase: qwen3-8b at its published configuration through
# repro_torch.launch.serve, then every other family once at full width
# (depth cut only where one card's 80 GB forces it; listed as `reduced`)
LLM_ARCH = "qwen3-8b"
LLM_SERVE = ["--batch", "8", "--prompt-len", "32", "--gen", "32"]
LLM_FAMILY_SERVE = ["--batch", "8", "--prompt-len", "4", "--gen", "4"]
LLM_FAMILIES = (
    ("deepseek-v3-671b", dict(n_layers=2, first_k_dense=1),
     ["n_layers 61 -> 2: first_k_dense 3 -> 1 dense + 1 MoE layer of 256 "
      "experts (the MTP block kept)"]),
    ("arctic-480b", dict(n_layers=1), ["n_layers 35 -> 1 (128 experts)"]),
    ("llama-3.2-vision-90b", dict(n_layers=5),
     ["n_layers 100 -> 5: 1 superblock of 4 self-attention + 1 cross-"
      "attention layer"]),
    ("seamless-m4t-large-v2", {}, []),
    ("rwkv6-3b", {}, []),
    ("recurrentgemma-2b", {}, []),
    ("granite-3-8b", {}, []),
    ("codeqwen1.5-7b", {}, []),
    ("mistral-nemo-12b", {}, []),
)
# card against CPU in float32: (arch, smoke config, depth cut); the full
# width ones take 5.8 and 58 GB on each side, and the CPU rehearsal
# (llm_phase's smoke) runs only the smoke configs
LLM_CHECKS = (
    ("qwen3-8b", True, {}),
    ("deepseek-v3-671b", True, {}),
    ("qwen3-8b", False, dict(n_layers=1)),
    ("deepseek-v3-671b", False, dict(n_layers=2, first_k_dense=1)),
)
LLM_CHECK_STEPS = 4
LLM_CHECK_TOL = 1e-4    # max |card - CPU| / max |CPU|, float32, no TF32

# the train phase: qwen3-8b at full width (d_model 4096, vocab 151936,
# untied head) through models.make_train_step at launch/train's defaults
# (batch 8, seq 128, lr 3e-4), cut in depth to what one card's 80 GB
# holds. Training keeps ~14 bytes a parameter (bf16 weights and grads, f32
# m and v, the clipped grads): 1244663808 parameters outside the layers
# and 192946432 a layer give ~61 GB at 16 layers, ~115 GB at 36.
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS = 16
TRAIN_REDUCED = ["n_layers 36 -> 16: 14 bytes a parameter of training "
                 "state hold 4.33 B parameters in ~61 GB of 80; 36 layers "
                 "need ~115 GB"]
TRAIN_WARMUP, TRAIN_STEPS = 1, 5
BF16_DENSE_PEAK = 989.4e12   # H100 SXM bf16 dense FLOP/s at 700 W
# card against CPU: one float32 train step at batch 2, seq 32 of every
# smoke config and of qwen3-8b at full width and depth 1, held to the CPU
# tests' limits (tests/test_torch_llm_train.py)
TRAIN_CHECK_TOL = 1e-4
TRAIN_FLAT_GRAD = 1e-3  # |g| <= this * max |g|: Adam's sign may flip there

# the dryrun phase: the architectures whose cells it counts (FlopCounterMode
# over the whole step on meta tensors; the others' bytes only: the dry-run
# CLI counts every cell), and the cut cells it runs on the card through
# launch/roofline --measure: qwen3-8b at full width, 36 -> 4 layers
# (~2.0 B parameters, 20 GB of weights and AdamW state) at launch/train's
# batch 8 x seq 128, and its decode at batch 8 over decode_32k's 32768-slot cache at
# full depth (16 GB of weights, 39 GB of cache)
DRYRUN_COUNTED = ("qwen3-8b", "deepseek-v3-671b", "arctic-480b")
DRYRUN_TRAIN = dict(arch="qwen3-8b", shape="train_4k", layers=4, batch=8,
                    seq=128)
DRYRUN_DECODE = dict(arch="qwen3-8b", shape="decode_32k", batch=8)

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
         "--metrics-out", prom, "--log-json", "--verify"]
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
    check_verified("pim", serve_fhe, res)
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


def check_verified(name, serve_fhe, res):
    """A --verify serve swept its schedules (and lowered programs) with
    no finding; prints the sweep's verify wall time."""
    n_sched, n_prog, found, wall = serve_fhe.verify_summary(res.executor)
    print(f"{name}: verify swept {n_sched} schedule(s) + {n_prog} lowered "
          f"program(s), {found} finding(s), {wall * 1e3:.1f} ms verify "
          f"wall", flush=True)
    if found or not n_sched:
        raise AssertionError(f"{name}: verify found {found} finding(s) "
                             f"over {n_sched} schedule(s)")


def verify_phase(smoke=False):
    """The lint gate, `python -m repro_torch.analysis.lint --prove`, at
    its default paper parameters (--smoke: the CPU rehearsal's point):
    every artifact clean and every rule of the catalogue proven live on a
    seeded mutation. Host work only."""
    from repro_torch.analysis import RULES, lint
    os.makedirs(OUT_DIR, exist_ok=True)
    jsonl = os.path.join(OUT_DIR, "lint.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    t0 = time.perf_counter()
    rc = lint.main(["--prove", "--jsonl", jsonl]
                   + (["--smoke"] if smoke else []))
    wall = time.perf_counter() - t0
    with open(jsonl) as f:
        reports = [json.loads(line) for line in f]
    n_err = sum(r["n_errors"] for r in reports)
    n_warn = sum(r["n_warnings"] for r in reports)
    v_wall = sum(r["wall_s"] for r in reports)
    print(f"verify: lint sweep at {'smoke' if smoke else 'paper'} "
          f"parameters: {len(reports)} artifacts, {n_err} errors, {n_warn} "
          f"warnings, {v_wall * 1e3:.1f} ms verify wall; "
          f"{len(RULES)} rules proven; {wall:.2f} s with compile, lowering "
          f"and the proof", flush=True)
    if rc != 0 or n_err or not reports:
        raise AssertionError(f"lint exit {rc}, {n_err} errors over "
                             f"{len(reports)} artifacts")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def limb_sharded_check(torch, dev, mesh, params, card):
    """The limb-sharded hmul (with rescale) and rotate (core.ops on the
    basis fhe_dist.limb_ops.LimbShard) on `mesh` at `params`' level
    LEVEL, under both BConv schedules, torch.equal to core.ops on the
    whole basis on the same device, each timed beside it (CUDA events,
    and torch.profiler's device time of one call). Keys and
    ciphertexts come from the port's encryptor (seed 5; vectors from
    numpy's rng 2, scale 2^26)."""
    import torch.distributed as dist
    from repro_torch.core import ops
    from repro_torch.core.ciphertext import Plaintext
    from repro_torch.core.context import CkksContext
    from repro_torch.core.encoder import CkksEncoder
    from repro_torch.core.encryptor import CkksEncryptor
    from repro_torch.fhe_dist import limb_ops as lo
    ctx = CkksContext(params, dev)
    encr = CkksEncryptor(ctx, seed=5)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    gk = encr.rotation_keygen(sk, [1])[ctx.rotation_element(1)]
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(2)
    scale = 2.0 ** 26
    ct1, ct2 = (encr.encrypt_sk(Plaintext(enc.encode(
        rng.normal(size=ctx.n // 2) * 0.3, scale, LEVEL), LEVEL, scale), sk)
        for _ in range(2))

    def ms(fn):
        """(ms a call between CUDA events, device ms a call, kernels and
        copies a call) on the card; nan on the CPU."""
        if dev.type != "cuda":
            return float("nan"), float("nan"), float("nan")
        n_ev, busy = device_busy(torch, fn, steps=1)
        return cuda_ms(torch, fn), busy, n_ev

    want = {"hmul": ops.hmul(ctx, ct1, ct2, rk),
            "rotate": ops.rotate(ctx, ct1, 1, gk)}
    times = {("core.ops", "hmul"): ms(lambda: ops.hmul(ctx, ct1, ct2, rk)),
             ("core.ops", "rotate"): ms(lambda: ops.rotate(ctx, ct1, 1, gk))}
    for variant in ("ring", "allgather"):
        sh = lo.LimbShard(mesh, variant)
        a, b = lo.shard_ciphertext(sh, ct1), lo.shard_ciphertext(sh, ct2)
        rk_l = lo.shard_key(sh, ctx, rk, LEVEL)
        gk_l = lo.shard_key(sh, ctx, gk, LEVEL)
        runs = {"hmul": lambda: ops.hmul(ctx, a, b, rk_l, basis=sh),
                "rotate": lambda: ops.rotate(ctx, a, 1, gk_l, basis=sh)}
        for op, run in runs.items():
            got = lo.gather_ciphertext(sh, run())
            if not (torch.equal(got.data, want[op].data)
                    and (got.level, got.scale) == (want[op].level,
                                                   want[op].scale)):
                raise AssertionError(f"limb-sharded {op} ({variant}) "
                                     f"differs from core.ops.{op}")
            times[(variant, op)] = ms(run)
    print(f"mesh: limb-sharded hmul (with rescale) and rotate at level "
          f"{LEVEL}, l = {LEVEL + 1}, T = {LEVEL + 1 + ctx.n_p}, N = "
          f"{ctx.n} (special primes up to {max(ctx.p_primes)}), world size "
          f"{mesh.axis_size('model')} on {dist.get_backend()}: ring and "
          f"allgather torch.equal to core.ops; a call, ms between CUDA "
          f"events / device ms / kernels and copies ({card}):", flush=True)
    for op in ("hmul", "rotate"):
        print("  " + op + ": " + ", ".join(
            f"{who} {t:.4f} / {busy:.4f} / {n_ev:.0f}"
            for who in ("ring", "allgather", "core.ops")
            for t, busy, n_ev in [times[(who, op)]]), flush=True)


def mesh_phase(torch, dev, smoke=False):
    """serve_fhe --backend mesh on `dev` (paper parameters; --smoke: the
    CPU rehearsal's point), then, on the world-size-1 mesh that serve
    started (nccl on the card), distributed_bconv in both schedules at the
    ModUp shape of level 20 against core.rns.bconv, the limb-sharded hmul
    and rotate against core.ops (`limb_sharded_check`), and a pipeline of
    rounds against the sequential composition. The process group is
    destroyed at the end, pass or fail."""
    import torch.distributed as dist
    from repro_torch.core import rns
    from repro_torch.core.context import CkksContext
    from repro_torch.core.params import test_params
    from repro_torch.fhe_dist.collective_bconv import (bconv_tables_device,
                                                       distributed_bconv)
    from repro_torch.fhe_dist.pipeline_exec import run_load_save_pipeline
    from repro_torch.launch import serve_fhe
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.executor import MeshBackend
    args = serve_fhe.parse_args(
        ["--backend", "mesh", "--device", dev.type, "--requests", "8",
         "--deadline-ms", "0", "--cache-mb", "4096"]
        + (["--smoke"] if smoke else []))
    outputs = []
    execute = MeshBackend.execute

    def recorded(self, schedule, batch, **kw):
        dt = execute(self, schedule, batch, **kw)
        out = batch.outputs
        outputs.append((out.device.type, tuple(out.shape),
                        bool(torch.isfinite(out).all())))
        return dt

    MeshBackend.execute = recorded
    try:
        res = serve_fhe.serve(args)
    finally:
        MeshBackend.execute = execute
    try:
        m, ex = res.executor.metrics, res.executor
        slots = ex.params.slots
        done = m.count("requests_completed")
        want_out = (dev.type, (BATCH, slots), True)
        if done != 8 or not outputs or set(outputs) != {want_out}:
            raise AssertionError(f"mesh serve: {done} of 8 completed, "
                                 f"outputs {sorted(set(outputs))}")
        backend = dist.get_backend()
        print(f"mesh: serve of {done} requests over {len(outputs)} "
              f"executions (warmup included) on a {backend} group of "
              f"{dist.get_world_size()}, outputs ({BATCH}, {slots}) float32 "
              f"on {dev.type}; warmup {res.warmup_s:.2f} s, p50 latency "
              f"{m.request_latency.p50 * 1e3:.3f} ms, throughput "
              f"{m.throughput_rps():.1f} req/s", flush=True)

        # the serve's parameters; the rehearsal's --smoke point has no
        # level 20, so it takes the paper's depth at log N 10
        params = (test_params(log_n=10, n_levels=23, dnum=4) if smoke
                  else ex.params)
        ctx = CkksContext(params, dev)
        digit = params.digit_indices(LEVEL)[0]
        dst = [i for i in list(range(LEVEL + 1)) + ctx.p_idx()
               if i not in digit]
        if not smoke and Q32 not in [ctx.primes[i] for i in dst]:
            raise AssertionError(f"{Q32} is not among the destinations")
        rng = np.random.default_rng(11)
        v = torch.from_numpy(np.stack([
            rng.integers(0, ctx.primes[i], size=ctx.n) for i in digit])).to(
                dev)
        tabs = bconv_tables_device(ctx, digit, dst)
        mesh = make_host_mesh(1, 1, device=dev)
        plain = rns.bconv(v, ctx.bconv_tables(digit, dst))

        def ms(fn):
            return cuda_ms(torch, fn) if dev.type == "cuda" else float("nan")

        times = {"rns.bconv": ms(lambda: rns.bconv(
            v, ctx.bconv_tables(digit, dst)))}
        for variant in ("ring", "allgather"):
            got = distributed_bconv(v, *tabs, mesh, variant=variant,
                                    gather=True)
            if not torch.equal(got, plain):
                raise AssertionError(f"distributed_bconv ({variant}) "
                                     f"differs from rns.bconv")
            times[variant] = ms(lambda: distributed_bconv(
                v, *tabs, mesh, variant=variant, gather=True))
        top = max(ctx.primes[i] for i in dst)
        print(f"mesh: distributed_bconv S = {len(digit)} -> D = {len(dst)}, "
              f"N = {ctx.n} (destinations up to {top}), world size 1 on "
              f"{backend}: ring and allgather torch.equal "
              f"to rns.bconv; ring {times['ring']:.4f} ms, allgather "
              f"{times['allgather']:.4f} ms, rns.bconv "
              f"{times['rns.bconv']:.4f} ms a call", flush=True)

        if not smoke and Q32 not in ctx.p_primes:
            raise AssertionError(f"{Q32} is not among the special primes")
        limb_sharded_check(torch, dev, mesh, params,
                           "cpu rehearsal" if smoke else card_line())

        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=(BATCH, 16, 32)).astype(np.float32)).to(dev)
        fns = [lambda t, k=k: t * (1 + 0.01 * k) + k for k in range(8)]
        got = run_load_save_pipeline([[f] for f in fns], x, mesh)
        want = x
        for f in fns:
            want = f(want)
        if not torch.allclose(got, want, rtol=1e-6, atol=0):
            raise AssertionError("pipeline rounds differ from the "
                                 "sequential composition")
        print(f"mesh: {len(fns)} pipeline rounds of {BATCH} microbatches "
              f"on {dev.type} within rtol 1e-6 of the sequential "
              f"composition", flush=True)
    finally:
        dist.destroy_process_group()


def device_busy(torch, fn, steps: int = 4):
    """Kernels a call of fn launches and the device time they take (ms),
    each the mean over `steps` calls, from torch.profiler's CUDA events
    (kernels and copies; one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_ev)
    return len(dev_ev) / steps, busy_us / steps / 1e3


def step_bytes(torch, M, cfg, model, batch, s_max, pos):
    """Bytes one decode step at position `pos` must move, as (every expert
    read, at most batch * top_k experts of a MoE layer read). Parameters:
    the top-level subtrees decode_forward reads (recorded on one step of
    a fresh cache; deepseek's MTP block and seamless's encoder are not),
    of the embedding table only the batch's rows unless it is the output
    head too. Cache: of a KV, latent or ring cache the positions up to
    `pos` read and one written; a recurrent state read and written whole;
    the encoder memory and the image tokens read. The logits written."""
    seen = set()

    class Reads(dict):
        def __getitem__(self, key):
            seen.add(key)
            return dict.__getitem__(self, key)

    with torch.no_grad():
        M.decode_forward(Reads(model.params), cfg,
                         model.init_cache(batch, s_max),
                         torch.zeros(batch, dtype=torch.int32,
                                     device=model.device), 0)
    logical = dict(M.tree_items(M.param_schema(cfg)))
    experts = (min(cfg.n_experts, batch * cfg.top_k) / cfg.n_experts
               if cfg.n_experts else 1.0)
    every = active = 0.0
    for path, p in M.tree_items(model.params):
        if path[0] not in seen:
            continue
        n = p.numel() * p.element_size()
        if path[0] == "embed" and not cfg.tie_embeddings:
            n = batch * p.shape[-1] * p.element_size()
        every += n
        active += n * experts if "experts" in logical[path].logical else n
    schema = dict(M.tree_items(M.cache_schema(cfg, batch, s_max)))
    for path, m in M.tree_items(M.abstract_cache(cfg, batch, s_max)):
        n = m.numel() * m.element_size()
        ps = schema[path]
        if path[0] in ("memory", "images"):
            n_moved = n
        elif "seq" in ps.logical:
            slots = ps.shape[ps.logical.index("seq")]
            n_moved = n / slots * (min(pos + 1, slots) + 1)
        else:
            n_moved = 2 * n
        every += n_moved
        active += n_moved
    logits = batch * cfg.vocab * M.dtype_of(cfg).itemsize
    return every + logits, active + logits


def llm_phase(torch, dev, card, smoke=False):
    """The LLM serve path (repro_torch.models through launch/serve):
    qwen3-8b at its full published configuration, every other family once
    at full width, and the float32 smoke configs of qwen3 and deepseek on
    the card against the CPU. --smoke (the CPU rehearsal) serves the SMOKE
    configs instead. Every model's memory is freed before the next."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    def served(arch, argv, changes, reduced):
        args = serve.parse_args(["--arch", arch, "--device", dev.type]
                                + (["--smoke"] if smoke else []) + argv)
        cfg = dataclasses.replace(get_config(arch, smoke=smoke), **changes)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = serve.serve(args, cfg=cfg)
        model = res.model
        logits, _ = model.decode(res.cache, res.last_tokens,
                                 args.prompt_len + args.gen - 1)
        n_params = sum(p.numel() for p in model.parameters())
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        # the bound at the median decode step's position
        moved, moved_active = step_bytes(
            torch, M, cfg, model, args.batch, args.prompt_len + args.gen,
            args.prompt_len - 1 + args.gen // 2)
        if n_params != cfg.param_count():
            raise AssertionError(f"{arch}: {n_params} parameters on the "
                                 f"card, param_count() {cfg.param_count()}")
        gen = res.generated
        if not (bool(torch.isfinite(logits).all()) and gen.min() >= 0
                and gen.max() < cfg.vocab
                and gen.shape == (args.batch, args.gen)):
            raise AssertionError(f"{arch}: logits finite "
                                 f"{bool(torch.isfinite(logits).all())}, "
                                 f"tokens in [{gen.min()}, {gen.max()}] of "
                                 f"vocab {cfg.vocab}, shape {gen.shape}")
        step_ms = statistics.median(res.decode_step_s) * 1e3
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if dev.type == "cuda" else float("nan"))
        row = {"arch": arch, "config": cfg.name, "reduced": reduced,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "dtype": cfg.dtype, "batch": args.batch,
               "steps": res.steps, "params": n_params,
               "weight_gib": weight_bytes / 2 ** 30,
               "peak_gib": peak,
               "ms_per_step": step_ms,
               "tok_s": args.batch / step_ms * 1e3,
               "serve_tok_s": args.batch * res.steps / res.total_s,
               "step_bytes": moved,
               "hbm_bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "card": card}
        if cfg.n_experts:
            row.update(step_bytes_active=moved_active,
                       hbm_bound_active_ms=moved_active / HBM_BYTES_PER_S
                       * 1e3)
        return res, row

    # qwen3-8b, full width and depth, through the serve entry point
    res, row = served(LLM_ARCH, LLM_SERVE, {}, [])
    if dev.type == "cuda":
        # one more step at the last position, over and over: the device's
        # share of a step (the profiler slows the host, not the kernels)
        last = row["steps"]
        n_dev, busy_ms = device_busy(torch, lambda: res.model.serve_step(
            res.cache, res.last_tokens, last))
        row.update(device_events_per_step=n_dev, device_busy_ms=busy_ms,
                   idle_share=1 - busy_ms / row["ms_per_step"])
    for line in serve.report(res, row["batch"]):
        print(f"  {line}")
    print(f"llm: {row['config']} {row['params']} parameters "
          f"({row['weight_gib']:.2f} GiB of {row['dtype']} weights), peak "
          f"device memory {row['peak_gib']:.2f} GiB, "
          f"{row['ms_per_step']:.3f} ms a decode step (median of "
          f"{len(res.decode_step_s)}, device-synchronised), "
          f"{row['tok_s']:.1f} tok/s at batch {row['batch']}; HBM bound "
          f"{row['hbm_bound_ms']:.3f} ms a step ({row['step_bytes'] / 1e9:.3f}"
          f" GB a step must move: the weights it reads, {row['batch']} "
          f"embedding rows, the KV cache up to the position; / "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]", flush=True)
    if "device_busy_ms" in row:
        print(f"llm: {row['config']} a decode step under torch.profiler: "
              f"{row['device_events_per_step']:.0f} kernels and copies, "
              f"{row['device_busy_ms']:.3f} ms of device time; idle "
              f"{100 * row['idle_share']:.1f} % of the "
              f"{row['ms_per_step']:.3f} ms step [{card}]", flush=True)
    print("llm " + json.dumps(row), flush=True)
    del res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    for arch, changes, reduced in LLM_FAMILIES:
        res, row = served(arch, LLM_FAMILY_SERVE, {} if smoke else changes,
                          [] if smoke else reduced)
        print("llm " + json.dumps(row), flush=True)
        del res
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # the card against the CPU: same weights, same teacher-forced tokens
    cpu = torch.device("cpu")
    for arch, small, changes in LLM_CHECKS:
        if smoke and not small:
            continue
        cfg = dataclasses.replace(get_config(arch, smoke=small),
                                  dtype="float32", **changes)
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        card_m = M.DecodeModel(cfg, dev, params=params)
        host = M.DecodeModel(cfg, cpu, params=M.tree_map(
            lambda t: t.to(cpu), params))
        b = 8 if cfg.n_experts else 2
        c_host, c_card = host.init_cache(b, 8), card_m.init_cache(b, 8)
        toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                                 (LLM_CHECK_STEPS, b))
        worst = 0.0
        for i in range(LLM_CHECK_STEPS):
            tok = torch.as_tensor(toks[i], dtype=torch.int32)
            l_host, c_host = host.decode(c_host, tok, i)
            l_card, c_card = card_m.decode(c_card, tok.to(dev), i)
            pairs = [(f"logits step {i}", l_card, l_host)] + [
                (f"cache {'/'.join(p)} step {i}", a, h) for (p, a), (_, h)
                in zip(M.tree_items(c_card), M.tree_items(c_host))]
            for what, a, h in pairs:
                err = (a.cpu().double() - h.double()).abs().max().item()
                scale = h.double().abs().max().item()
                if not err <= LLM_CHECK_TOL * max(scale, 1e-30):
                    raise AssertionError(f"{cfg.name} {what}: card and CPU "
                                         f"differ by {err} (max {scale})")
                worst = max(worst, err / max(scale, 1e-30))
        cut = "" if small else (f", full width, n_layers {cfg.n_layers}"
                                + (f" (first_k_dense {cfg.first_k_dense})"
                                   if cfg.first_k_dense else ""))
        print(f"llm: {cfg.name} float32{cut}, {LLM_CHECK_STEPS} steps at "
              f"batch {b}: card and CPU logits and every cache leaf within "
              f"{LLM_CHECK_TOL} of the CPU's largest value (worst "
              f"{worst:.2e})", flush=True)
        del params, card_m, host, c_host, c_card, l_host, l_card, pairs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _train_batch(cfg, b=2, s=32):
    """tests/test_torch_llm_train.py's float32 batch (numpy rng 0)."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.xattn_period:
        out["images"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def train_phase(torch, dev, card, smoke=False):
    """LLM training (models.make_train_step on autograd, train/, data/,
    launch/train): qwen3-8b at full width, cut in depth to TRAIN_LAYERS, 1
    warm-up and TRAIN_STEPS timed steps at launch/train's defaults, one
    more under torch.profiler (CUDA activity only) for the idle share;
    then one float32 train step of every smoke config and of qwen3-8b at
    depth 1 on the card and on the CPU from the same weights; then
    launch/train --smoke cut after 2 steps and resumed to 4 against an
    unbroken 4-step run, bit for bit. --smoke (the CPU rehearsal) trains
    the smoke config and checks only the smoke configs. One process group
    of world size 1 serves both devices (gloo for CPU tensors, nccl for
    the card's; the MoE layers' all_to_all runs on it) and is destroyed at
    the end, pass or fail."""
    import dataclasses
    import shutil
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import SyntheticLMDataset, shard_batch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import optim

    cpu = torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    mesh_mod.STORE_DIR.mkdir(parents=True, exist_ok=True)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{mesh_mod.STORE_DIR}/train-{os.getpid()}",
        world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_host_mesh(device=dev)
        cpu_mesh = mesh_mod.Mesh((1, 1), ("data", "model"), cpu)

        # qwen3-8b at full width through the train step
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=smoke),
                                  **({} if smoke else
                                     {"n_layers": TRAIN_LAYERS}))
        args = launch_train.parse_args([])
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(t.numel() for _, t in M.tree_items(params))
        if n_params != cfg.param_count():
            raise AssertionError(f"train: {n_params} parameters, "
                                 f"param_count() {cfg.param_count()}")
        opt = optim.adamw_init(params)
        ds = SyntheticLMDataset(cfg, args.batch, args.seq)
        step_fn = M.make_train_step(cfg, mesh, learning_rate=args.lr)
        losses, step_s = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS + 1):
            batch = shard_batch(ds.batch_at(i), dev)
            sync()
            if i == TRAIN_WARMUP + TRAIN_STEPS and dev.type == "cuda":
                # one more step under the profiler: the device's share
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    params, opt, metrics = step_fn(params, opt, batch)
                    sync()
                    prof_s = time.perf_counter() - t0
                continue
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train: losses {losses}")
        tokens = args.batch * args.seq
        ms = statistics.median(step_s[TRAIN_WARMUP:]) * 1e3
        flop = 6 * n_params * tokens
        row = {"arch": TRAIN_ARCH, "config": cfg.name,
               "reduced": [] if smoke else TRAIN_REDUCED,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "tie_embeddings": cfg.tie_embeddings,
               "dtype": cfg.dtype, "batch": args.batch, "seq": args.seq,
               "lr": args.lr, "params": n_params, "tokens_per_step": tokens,
               "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
               "ms_per_step": ms,
               "ms_steps": [t * 1e3 for t in step_s],
               "tok_s": tokens / ms * 1e3,
               "losses": losses,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if dev.type == "cuda" else float("nan")),
               "flop_per_step_6nt": flop,
               "bf16_dense_peak_flop_s": BF16_DENSE_PEAK,
               "flop_share": flop / (ms / 1e3) / BF16_DENSE_PEAK,
               "card": card}
        if dev.type == "cuda":
            dev_ev = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
            by_kernel = collections.defaultdict(lambda: [0, 0.0])
            for e in dev_ev:
                by_kernel[e.name][0] += 1
                by_kernel[e.name][1] += e.time_range.elapsed_us() / 1e3
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
            row.update(profiled_step_ms=prof_s * 1e3,
                       device_events_per_step=len(dev_ev),
                       device_busy_ms=busy_ms,
                       idle_share=1 - busy_ms / (prof_s * 1e3),
                       top_kernels=[{"name": n[:90], "count": c, "ms": t}
                                    for n, (c, t) in top])
        print(f"train: {cfg.name} at n_layers {cfg.n_layers}, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters, "
              f"batch {args.batch} x seq {args.seq}; {ms:.3f} ms a step "
              f"(median of {TRAIN_STEPS} after {TRAIN_WARMUP} warm-up, each "
              f"ending in a device barrier), {row['tok_s']:.1f} tok/s, peak "
              f"{row['peak_gib']:.2f} GiB, 6·N·tokens at "
              f"{100 * row['flop_share']:.2f} % of {BF16_DENSE_PEAK / 1e12} "
              f"TFLOP/s bf16 dense; losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]",
              flush=True)
        if "idle_share" in row:
            print(f"train: one step under torch.profiler (CUDA activity "
                  f"only): {row['device_events_per_step']} kernels and "
                  f"copies, {row['device_busy_ms']:.3f} ms of device time "
                  f"in a {row['profiled_step_ms']:.3f} ms step; idle "
                  f"{100 * row['idle_share']:.1f} % [{card}]", flush=True)
        print("train " + json.dumps(row), flush=True)
        print(f"train: full-width part {time.perf_counter() - t_phase:.1f} "
              f"s", flush=True)
        del params, opt, step_fn, metrics, batch
        free()

        # the card against the CPU: one float32 step from the same weights
        checks = [(a, True, {}) for a in list_archs()]
        if not smoke:
            checks.append((TRAIN_ARCH, False, {"n_layers": 1}))
        for arch, small, changes in checks:
            cfg = dataclasses.replace(get_config(arch, smoke=small),
                                      dtype="float32", **changes)
            params = M.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            for path, t in M.tree_items(params):
                if path[-1] == "gate":       # cross attention reaches out
                    t.fill_(0.5)
            nb = _train_batch(cfg)
            sides, side_s = {}, {}
            for side, d, m in (("card", dev, mesh), ("cpu", cpu, cpu_mesh)):
                t_side = time.perf_counter()
                p = M.tree_map(lambda t: t.to(d, copy=True), params)
                batch = shard_batch(nb, d, torch.float32)
                paths = [q for q, _ in M.tree_items(p)]
                leaves = [t.detach().requires_grad_()
                          for _, t in M.tree_items(p)]
                loss, _ = M.loss_fn(M.tree_unflatten(paths, leaves), cfg,
                                    batch, m)
                grads = torch.autograd.grad(loss, leaves)
                del leaves, loss
                p, o, metrics = M.make_train_step(cfg, m)(
                    p, optim.adamw_init(p), batch)
                sides[side] = (
                    dict(zip(paths, grads)),
                    {f"{k}/{'/'.join(q)}": t for k, tree in
                     (("params", p), ("m", o["m"]), ("v", o["v"]))
                     for q, t in M.tree_items(tree)},
                    {k: float(v) for k, v in metrics.items()})
                del p, o, batch, grads
                free()
                side_s[side] = time.perf_counter() - t_side
            del params
            (g_card, s_card, m_card), (g_cpu, s_cpu, m_cpu) = (
                sides["card"], sides["cpu"])
            worst = 0.0

            def held(what, a, b, mask=None):
                """a (the card's) against b (the CPU's), compared on a's
                device in float32."""
                nonlocal worst
                b = b.to(a.device)
                diff = (a - b).abs()
                if mask is not None:
                    diff = diff[mask]
                err = diff.max().item() if diff.numel() else 0.0
                scale = max(b.abs().max().item(), 1e-30)
                if not (bool(torch.isfinite(a).all())
                        and err <= TRAIN_CHECK_TOL * scale):
                    raise AssertionError(f"train {cfg.name} {what}: card and "
                                         f"CPU differ by {err} (max {scale})")
                worst = max(worst, err / scale)

            for k in m_cpu:
                held(k, torch.tensor(m_card[k]), torch.tensor(m_cpu[k]))
            for q, g in g_cpu.items():
                held(f"grad {'/'.join(q)}", g_card[q], g)
            for key, t in s_cpu.items():
                mask = None
                if key.startswith("params/"):
                    g = g_cpu[tuple(key.split("/")[1:])].to(dev).abs()
                    mask = g > TRAIN_FLAT_GRAD * g.max()
                held(key, s_card[key], t, mask)
            cut = "" if small else f", full width, n_layers {cfg.n_layers}"
            print(f"train: {cfg.name} float32{cut}, one step at batch 2 x "
                  f"seq 32: card and CPU loss, grad norm, every grad, "
                  f"updated parameter (where |g| > {TRAIN_FLAT_GRAD} max "
                  f"|g|), m and v within {TRAIN_CHECK_TOL} of the CPU's "
                  f"largest value (worst {worst:.2e}; {side_s['card']:.1f} "
                  f"s on the card, {side_s['cpu']:.1f} s on the CPU)",
                  flush=True)
            del sides, g_card, s_card, g_cpu, s_cpu
            free()

        # checkpoint and resume through the entry point
        t_resume = time.perf_counter()
        ck = os.path.join(OUT_DIR, "train_ckpt")
        shutil.rmtree(ck, ignore_errors=True)
        base = ["--arch", TRAIN_ARCH, "--smoke", "--ckpt-every", "2",
                "--log-every", "1", "--device", dev.type]
        whole = launch_train.main(base + ["--steps", "4", "--ckpt-dir",
                                          os.path.join(ck, "whole")])
        launch_train.main(base + ["--steps", "2", "--ckpt-dir",
                                  os.path.join(ck, "cut")])
        resumed = launch_train.main(base + ["--steps", "4", "--ckpt-dir",
                                            os.path.join(ck, "cut"),
                                            "--resume"])
        same = resumed.start == 2 and all(
            qa == qb and torch.equal(a, b) for tree in ("params", "opt_state")
            for (qa, a), (qb, b) in zip(
                M.tree_items(getattr(whole, tree)),
                M.tree_items(getattr(resumed, tree))))
        if not same or whole.history[2:] != resumed.history:
            raise AssertionError("train: the run resumed at step "
                                 f"{resumed.start} differs from the "
                                 f"unbroken one")
        print(f"train: launch/train --smoke on {dev.type}, cut after 2 steps "
              f"and resumed from its checkpoint to 4: parameters and AdamW "
              f"state torch.equal to an unbroken 4-step run "
              f"({time.perf_counter() - t_resume:.1f} s)", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_phase(torch, dev, card, smoke=False):
    """The sharding and dry-run slice: the dry run's sweep (counts for
    DRYRUN_COUNTED's architectures), then the roofline checked against
    real steps on `dev`: the DRYRUN_TRAIN and DRYRUN_DECODE cells through
    roofline.measure. --smoke (the CPU rehearsal) counts no cell of the
    sweep and measures the smoke configs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline, serve
    from repro_torch.launch.specs import SHAPES
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    counts, recs, by_status = {}, [], collections.Counter()
    with open(os.path.join(OUT_DIR, "dryrun.jsonl"), "w") as f:
        for arch in dryrun.canonical_archs():
            for shape in SHAPES:
                for multi_pod in (False, True):
                    rec = dryrun.run_cell(
                        arch, shape, multi_pod, counts=counts,
                        count=not smoke and arch in DRYRUN_COUNTED)
                    f.write(json.dumps(rec) + "\n")
                    recs.append(rec)
                    by_status[rec["status"]] += 1
                    print("  " + dryrun.describe(rec), flush=True)
    errors = [r for r in recs if r["status"] == "error"]
    if errors:
        raise AssertionError(f"dryrun: {len(errors)} cells failed: "
                             + "; ".join(f"{r['arch']} {r['shape']} "
                                         f"{r['mesh']}: {r['error']}"
                                         for r in errors))
    silent = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"
              and r["argument_bytes"] > dryrun.DEVICE_MEMORY_BYTES
              and (r["fits_device"] or "note" not in r)]
    if silent:
        raise AssertionError(
            f"dryrun: over 80 GiB a device without a note: "
            f"{[(r['arch'], r['shape']) for r in silent]}")
    if len(recs) != 80 or by_status["skipped"] != 16:
        raise AssertionError(f"dryrun: {len(recs)} records, {dict(by_status)}")
    print(f"dryrun: sweep of {len(recs)} records ({dict(by_status)}) in "
          f"{time.perf_counter() - t0:.1f} s; counted "
          f"{'none' if smoke else ', '.join(DRYRUN_COUNTED)} (FlopCounterMode "
          f"on meta tensors, counts not measurements)", flush=True)

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    rows = {}
    for name, cell in (("train", DRYRUN_TRAIN), ("decode", DRYRUN_DECODE)):
        t_cell = time.perf_counter()
        kw = dict(cell, smoke=smoke)
        if smoke:
            kw.update(layers=None, batch=2, seq=16 if name == "train" else 64)
        r = roofline.measure(device=dev, **kw)
        free()
        r["card"] = card
        if r["real_matmul_flops"] != r["meta_matmul_flops"]:
            raise AssertionError(f"dryrun {name}: FlopCounterMode counts "
                                 f"{r['real_matmul_flops']} on the real "
                                 f"step, {r['meta_matmul_flops']} on meta")
        if r["real_argument_bytes"] != r["argument_bytes"]:
            raise AssertionError(f"dryrun {name}: argument bytes from specs "
                                 f"{r['argument_bytes']}, real tensors "
                                 f"{r['real_argument_bytes']}")
        if r["ms"] < r["bound_ms"]:
            raise AssertionError(f"dryrun {name}: {r['ms']} ms a step is "
                                 f"under the bound {r['bound_ms']} ms: the "
                                 f"count is wrong")
        print(f"dryrun: {roofline.describe_measure(r)} "
              f"({time.perf_counter() - t_cell:.1f} s) [{card}]", flush=True)
        rows[name] = r

    # the decode bound beside the llm phase's: step_bytes on meta tensors
    cfg = get_config(DRYRUN_DECODE["arch"], smoke=smoke)
    model = M.DecodeModel(cfg, "meta", params=M.abstract_params(cfg))
    llm = serve.parse_args(LLM_SERVE)
    d = rows["decode"]
    b, s = d["batch"], d["seq"]
    at_llm = step_bytes(torch, M, cfg, model, llm.batch,
                        llm.prompt_len + llm.gen,
                        llm.prompt_len - 1 + llm.gen // 2)[0]
    at_cell = step_bytes(torch, M, cfg, model, b, s, s - 1)[0]
    d.update(step_bytes_llm_phase=at_llm,
             step_bytes_llm_phase_ms=at_llm / HBM_BYTES_PER_S * 1e3,
             step_bytes_at_cell=at_cell,
             step_bytes_at_cell_ms=at_cell / HBM_BYTES_PER_S * 1e3)
    print(f"dryrun: decode bounds of {cfg.name} at batch {b}: memory_s "
          f"{d['memory_s'] * 1e3:.3f} ms (arguments and outputs: the whole "
          f"{s}-slot cache read and written anew, the whole embedding "
          f"table) against step_bytes {d['step_bytes_at_cell_ms']:.3f} ms at "
          f"the cell's position {s - 1} (the cache read whole, one slot "
          f"written in place, {b} embedding rows) and the llm phase's "
          f"{d['step_bytes_llm_phase_ms']:.3f} ms (s_max "
          f"{llm.prompt_len + llm.gen}, the cache up to position "
          f"{llm.prompt_len - 1 + llm.gen // 2}); the step took "
          f"{d['ms']:.3f} ms [{card}]", flush=True)
    for name, r in rows.items():
        print(f"dryrun {name} " + json.dumps(r), flush=True)


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
            "--requests", "8", "--deadline-ms", "0", "--verify",
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
        check_verified("serve", serve_fhe, res)
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
        core/ops, as the reference does, the pim path simulates, the
        verify and mesh paths are host analysis and torch ops, and the llm,
        train and dryrun paths reach no Pallas kernel in the reference: no
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

    with Phase("verify"):
        common.reset_launches()
        verify_phase()
        no_kernel_launched("verify")

    with Phase("mesh"):
        common.reset_launches()
        mesh_phase(torch, dev)
        torch.cuda.synchronize()
        no_kernel_launched("mesh")
        torch.cuda.empty_cache()

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

    with Phase("llm"):
        common.reset_launches()
        llm_phase(torch, dev, card_line())
        torch.cuda.synchronize()
        no_kernel_launched("llm")
        torch.cuda.empty_cache()

    with Phase("train"):
        common.reset_launches()
        train_phase(torch, dev, card_line())
        torch.cuda.synchronize()
        no_kernel_launched("train")
        torch.cuda.empty_cache()

    with Phase("dryrun"):
        common.reset_launches()
        dryrun_phase(torch, dev, card_line())
        torch.cuda.synchronize()
        no_kernel_launched("dryrun")
        torch.cuda.empty_cache()

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
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
