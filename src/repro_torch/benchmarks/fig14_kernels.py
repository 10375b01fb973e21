"""Fig. 14 counterpart of the port: the compute paths of the NTT, the
modular products, BConv and the keyswitch, on one device.

  * iterative NTT, torch library ops (core/ntt.py)
  * four-step NTT through K7 (``ntt_col`` + ``ntt_row``) and its oracle
  * modmul reduction strategies (generic / Barrett / Montgomery / Solinas)
  * BConv through K6, eager and lazy
  * fused keyswitch (4 launches) vs dispatch-per-stage (7·digits + 10,
    through K4-K6 and library NTTs)

The same sections, ``--smoke`` sizes and assertion as
``benchmarks/fig14_kernels.py``: the fused keyswitch takes 4 dispatches
and the staged route at least 4x as many. Every kernel's output is also
held to its oracle (the four-step NTT to ``ref.four_step_ntt_ref``, both
BConv schedules to ``ref.bconv_ref``, staged to fused keyswitch).

Row names say the route: ``_cuda`` where the hand-written kernels ran
(``--device cuda``, the default, which raises without a CUDA device),
``_plain`` where their plain versions ran (``--device cpu``). Times are
medians of device-synchronised wall clocks.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig14_kernels \\
        [--smoke] [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows and rewrites
``build/repro_torch/results/fig14_kernels.jsonl``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, timeit, write_records
from repro_torch.core import modarith as ma
from repro_torch.core import ntt as nttm
from repro_torch.core.context import CkksContext, resolve_device
from repro_torch.core.encryptor import CkksEncryptor
from repro_torch.core.params import (find_2nth_root, find_ntt_primes,
                                     test_params)
from repro_torch.kernels import common as kcom
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.keyswitch import FusedKeySwitch, keyswitch_staged


def _exact(name, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its oracle")


def keyswitch_comparison(records, smoke: bool, dev: torch.device,
                         route: str) -> None:
    """Fused 4-launch keyswitch vs the dispatch-per-stage route: count
    dispatches on both (asserting the >= 4x reduction the fused pipeline
    exists for), check they agree bit for bit, and time them."""
    if smoke:
        params = test_params(log_n=8, n_levels=4, dnum=2, log_scale=26)
    else:
        params = test_params(log_n=10, n_levels=8, dnum=2, log_scale=26)
    level = params.n_levels
    ctx = CkksContext(params, dev)
    enc = CkksEncryptor(ctx, seed=11)
    rk = enc.relin_keygen(enc.keygen())
    rng = np.random.default_rng(0)
    d2 = torch.from_numpy(np.stack([
        rng.integers(0, int(q), size=ctx.n)
        for q in ctx.primes[:level + 1]])[None]).to(dev)

    fks = FusedKeySwitch(ctx)
    km = fks.ksk_mont("relin", level, rk.data)
    kcom.reset_dispatch_count()
    f0, f1 = fks.apply(d2, level, km)
    fused_disp = kcom.dispatch_count()
    kcom.reset_dispatch_count()
    s0, s1 = keyswitch_staged(ctx, d2[0], level, rk)
    staged_disp = kcom.dispatch_count()
    digits = len(params.digit_indices(level))
    reduction = staged_disp / fused_disp
    assert fused_disp == FusedKeySwitch.DISPATCHES_PER_APPLY, fused_disp
    assert reduction >= 4.0, (
        f"fused keyswitch must cut dispatches >= 4x: "
        f"staged={staged_disp} fused={fused_disp}")
    _exact("staged keyswitch", torch.stack([s0, s1]),
           torch.stack([f0[0], f1[0]]))

    iters = 2 if smoke else 3
    t_fused = timeit(lambda: fks.apply(d2, level, km), device=dev,
                     warmup=1, iters=iters)
    t_staged = timeit(lambda: keyswitch_staged(ctx, d2[0], level, rk),
                      device=dev, warmup=1, iters=iters)
    emit(records, f"fig14_keyswitch_fused_{route}", t_fused * 1e6,
          f"4 launches, digits={digits} level={level}",
          dispatches=fused_disp, digits=digits, level=level,
          log_n=params.log_n)
    emit(records, f"fig14_keyswitch_staged_{route}", t_staged * 1e6,
          f"{staged_disp} launches (7*digits+10)",
          dispatches=staged_disp, digits=digits, level=level,
          log_n=params.log_n)
    emit(records, "fig14_keyswitch_dispatch_reduction", 0.0,
          f"{staged_disp}/{fused_disp} = {reduction:.2f}x (asserted >= 4x)",
          staged_dispatches=staged_disp, fused_dispatches=fused_disp,
          reduction=reduction)


def main(argv=()) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small ring + short timing loops, fast CI check")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a CUDA device) runs "
                         "the hand-written kernels, cpu their plain versions")
    args = ap.parse_args(list(argv))
    dev = resolve_device(args.device)
    route = "cuda" if dev.type == "cuda" else "plain"

    log_n = 8 if args.smoke else 12
    n = 1 << log_n
    mod = find_ntt_primes(30, log_n, 1)[0]
    q = mod.value
    psi = find_2nth_root(q, 2 * n)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, q, size=n)).to(dev)
    tabs = nttm.NttTables([mod], log_n, dev)
    records = []

    t = timeit(lambda: nttm.ntt(a[None], tabs), device=dev)
    emit(records, "fig14_ntt_iterative_torch", t * 1e6, f"N=2^{log_n}")
    kern = kops.NttKernel(q, psi, log_n, log_n // 2)
    _exact("four-step NTT", kern(a), kref.four_step_ntt_ref(a, kern.tabs))
    t = timeit(lambda: kern(a), device=dev, warmup=1, iters=3)
    emit(records, f"fig14_ntt_fourstep_{route}", t * 1e6,
          "K7 ntt_col + ntt_row" if route == "cuda" else
          "K7's plain version")
    t = timeit(lambda: kref.four_step_ntt_ref(a, kern.tabs), device=dev,
               warmup=1, iters=3)
    emit(records, "fig14_ntt_fourstep_ref", t * 1e6)

    # modmul reduction strategies (paper §IV-B: Montgomery-friendly moduli)
    b = torch.from_numpy(rng.integers(0, q, size=(4, n))).to(dev)
    qv = torch.tensor(q, device=dev)
    emit(records, "fig14_modmul_generic", 1e6 * timeit(
        lambda: ma.mulmod(b, b, qv), device=dev), "int64 split remainder")
    mu = torch.tensor(ma.barrett_mu(q), device=dev)
    emit(records, "fig14_modmul_barrett", 1e6 * timeit(
        lambda: ma.mulmod_barrett(b, b, qv, mu), device=dev))
    qi = torch.tensor(ma.mont_qinv_neg(q), device=dev)
    emit(records, "fig14_modmul_montgomery", 1e6 * timeit(
        lambda: ma.mont_mul(b, b, qv, qi), device=dev))
    bb, ss = mod.solinas
    emit(records, "fig14_modmul_solinas_shiftadd", 1e6 * timeit(
        lambda: ma.mulmod_solinas(b, b, qv, bb, ss), device=dev),
        f"q=2^{bb}-2^{ss}+1 hamming={mod.hamming_weight}")

    # bconv kernel schedules
    src = [m.value for m in find_ntt_primes(28, 10, 6)]
    dst = [m.value for m in find_ntt_primes(30, 10, 4)]
    bn = 256 if args.smoke else 1024
    v = torch.from_numpy(np.stack([rng.integers(0, p, size=bn)
                                   for p in src])).to(dev)
    w = torch.from_numpy(rng.integers(0, min(dst), size=(6, 4))).to(dev)
    want = kref.bconv_ref(v, w, torch.tensor(dst, device=dev))
    for lazy, name, note in ((False, "eager", ""),
                             (True, "lazy", "deferred modular folds")):
        _exact(f"{name} BConv", kops.bconv(v, w, dst, lazy=lazy), want)
        emit(records, f"fig14_bconv_kernel_{name}_{route}", 1e6 * timeit(
            lambda: kops.bconv(v, w, dst, lazy=lazy), device=dev,
            warmup=1, iters=3), note)

    keyswitch_comparison(records, args.smoke, dev, route)

    write_records("fig14_kernels.jsonl", records, dev,
                  smoke=bool(args.smoke))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
