"""Carry the reference's key material and tables into the port.

`from_reference` takes numpy arrays exported from the JAX package (its
secret key, relinearization and Galois keys, and its `CkksContext`
tables) and returns the port's objects on a port context's device. The
parity tests use it to hand both packages identical inputs; with the
same seeds the port's own keygen reproduces the same arrays anyway
(tests/test_torch_core.py checks that too).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.ciphertext import KeySwitchKey, SecretKey
from repro_torch.core.context import CkksContext, to_device

# CkksContext attribute -> the tables it carries (reference names)
TABLES = ("q_all", "root_powers", "inv_root_powers", "n_inv",
          "barrett_mu", "mont_qinv_neg", "mont_r2", "p_inv_mod_q")


@dataclasses.dataclass
class Carried:
    sk: Optional[SecretKey]
    rk: Optional[KeySwitchKey]
    gks: Dict[int, KeySwitchKey]


def context_tables(ctx) -> Dict[str, np.ndarray]:
    """The tables `from_reference` compares, read off a context of either
    package as numpy arrays (works on jax and torch arrays alike)."""
    src = {"q_all": ctx.q_all,
           "root_powers": ctx.tables.root_powers,
           "inv_root_powers": ctx.tables.inv_root_powers,
           "n_inv": ctx.tables.n_inv,
           "barrett_mu": ctx.barrett_mu,
           "mont_qinv_neg": ctx.mont_qinv_neg,
           "mont_r2": ctx.mont_r2,
           "p_inv_mod_q": ctx.p_inv_mod_q}
    out = {}
    for k, v in src.items():
        if isinstance(v, torch.Tensor):
            v = v.cpu()
        out[k] = np.asarray(v).astype(np.int64)
    return out


def from_reference(ctx: CkksContext, *,
                   s_ntt: Optional[np.ndarray] = None,
                   rk: Optional[np.ndarray] = None,
                   gks: Mapping[int, np.ndarray] = (),
                   tables: Optional[Mapping[str, np.ndarray]] = None
                   ) -> Carried:
    """Reference arrays (uint64 residues) -> the port's keys on ctx's
    device. `tables`, if given, must equal the port context's own tables
    (keys are only meaningful under the same moduli and twiddles); a
    mismatch raises ValueError naming the table."""
    if tables is not None:
        mine = context_tables(ctx)
        for name in TABLES:
            if not np.array_equal(np.asarray(tables[name], np.int64),
                                  mine[name]):
                raise ValueError(f"reference table {name!r} differs from "
                                 f"the port's")
    dev = ctx.device
    return Carried(
        sk=SecretKey(to_device(s_ntt, dev)) if s_ntt is not None else None,
        rk=KeySwitchKey(to_device(rk, dev)) if rk is not None else None,
        gks={int(k): KeySwitchKey(to_device(v, dev))
             for k, v in dict(gks).items()})
