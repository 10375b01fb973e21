"""Bootstrapping (core/bootstrap) on one device at a range of ring sizes.

tests/test_bootstrap.py's parameters (L 16, dnum 2, hamming weight 16,
EvalMod's Chebyshev degree 63, K = 6) on the ring 2^log_n: a level-0
ciphertext of seeded slots is refreshed to level L. One row a ring: the
Bootstrapper's setup (the dense canonical-embedding matrices, their
inverse and diagonals on the host, then the Galois and relinearization
keys), each stage (ModRaise, CoefToSlot, EvalMod for the real and the
imaginary part together, SlotToCoef), the total, the output level and the
max decrypt error (the test's bound is 0.05). Stage times are wall
seconds with the device synchronised around each stage.

The setup grows as n^3 (a dense n x n complex inverse) and n^2 (the
diagonals, in Python): log N 16 would need a 64 GiB matrix, so the
paper's ring is out of reach of this algorithm, in the reference as here.
The error grows with the ring too: CoefToSlot and SlotToCoef encode
every diagonal of their dense matrices at the ciphertext's scale, so the
rounding of N/2 diagonals adds up; each row says whether the test's bound
still holds (a row that misses it is reported, not raised).

    PYTHONPATH=src python -m repro_torch.benchmarks.bootstrap_ring \\
        [--log-n 9 10 11 12] [--device {cuda,cpu}]

Rewrites ``build/repro_torch/results/bootstrap_ring.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from repro_torch.benchmarks.common import RESULTS, CkksStack, synced
from repro_torch.core.bootstrap import BootstrapConfig, Bootstrapper
from repro_torch.core.context import resolve_device
from repro_torch.core.params import CkksParams

STAGES = ("mod_raise", "coef_to_slot", "eval_mod", "slot_to_coef")
MAX_ERR = 0.05      # tests/test_bootstrap.py's bound


def bootstrap_params(log_n: int) -> CkksParams:
    return CkksParams(log_n=log_n, log_scale=25, n_levels=16, dnum=2,
                      first_mod_bits=29, scale_mod_bits=25,
                      special_mod_bits=29, hamming_weight_sk=16)


def run_bootstrap(device, log_n: int, times: Optional[Dict] = None):
    """One bootstrap at ring 2^log_n on `device`. Returns (output, max
    decrypt error) and fills `times` with the setup and stage seconds."""
    params = bootstrap_params(log_n)
    times = {} if times is None else times
    st = CkksStack(params, device, seed=11)
    bts, times["setup"] = synced(
        Bootstrapper, st.ctx, st.enc, st.encr, st.sk,
        BootstrapConfig(eval_mod_degree=63, k_range=6.0), device=device)
    times["galois_keys"] = len(bts.gks)
    for name in STAGES:
        def stage(*args, _fn=getattr(bts, name), _name=name):
            out, secs = synced(_fn, *args, device=device)
            times[_name] = times.get(_name, 0.0) + secs
            return out
        setattr(bts, name, stage)
    rng = np.random.default_rng(2)
    s = params.slots
    v = 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s))
    ct0 = st.encrypt(v, 2.0 ** params.log_scale, 0)
    out, times["total"] = synced(bts.bootstrap, ct0, params.n_levels,
                                 device=device)
    return out, float(np.abs(st.decrypt(out) - v).max())


def within_bound(out, err: float) -> bool:
    """tests/test_bootstrap.py's check: usable levels left, small error."""
    return out.level >= 2 and err < MAX_ERR


def describe(log_n: int, times: Dict, out, err: float) -> str:
    return (f"bootstrap at log N {log_n} (L 16, dnum 2, hamming 16, "
            f"Chebyshev degree 63; {times['galois_keys']} Galois keys): "
            f"setup {times['setup']:.3f} s, ModRaise "
            f"{times['mod_raise']:.3f} s, CoefToSlot "
            f"{times['coef_to_slot']:.3f} s, EvalMod (real and imaginary) "
            f"{times['eval_mod']:.3f} s, SlotToCoef "
            f"{times['slot_to_coef']:.3f} s, total {times['total']:.3f} s; "
            f"level 0 -> {out.level}, max |err| {err:.3e}")


def main(argv=()) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log-n", type=int, nargs="+",
                    default=[9, 10, 11, 12])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ciphertext arithmetic runs")
    args = ap.parse_args(list(argv))
    dev = resolve_device(args.device)
    records = []
    for log_n in args.log_n:
        times: Dict = {}
        out, err = run_bootstrap(dev, log_n, times)
        ok = within_bound(out, err)
        print(f"{describe(log_n, times, out, err)}; level >= 2 and error "
              f"< {MAX_ERR}: {ok}", flush=True)
        records.append({"log_n": log_n, "level": out.level, "err": err,
                        "within_bound": ok, "device": str(dev), **times})
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "bootstrap_ring.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
