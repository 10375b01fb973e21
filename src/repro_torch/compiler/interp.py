"""Trace interpreters: the compiler's semantic ground truth.

* `reference_eval` — numpy on plaintext slot vectors (inputs may be
  ``(slots,)`` or ``(B, slots)``): the oracle for the serving runtime's
  decrypt-accuracy metric.
* `CkksTraceInterpreter` — a single-sample facade over the batched
  engine (repro_torch.compiler.engine.CkksEngine), which executes a trace
  op by op through the real CKKS stack.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.compiler.engine import CkksEngine, const_vec
from repro_torch.core.context import DeviceLike
from repro_torch.core.params import CkksParams
from repro_torch.core.trace import FheTrace


def reference_eval(trace: FheTrace, inputs: Sequence[np.ndarray],
                   consts: Optional[Dict[str, np.ndarray]] = None
                   ) -> List[np.ndarray]:
    """Plaintext oracle: exact slotwise arithmetic, no noise, no scales.
    Inputs may carry leading batch dimensions; slot ops act on the last
    axis."""
    consts = consts or {}
    slots = np.asarray(inputs[0]).shape[-1]
    env: Dict[int, np.ndarray] = {}
    for i, idx in enumerate(trace.inputs):
        env[idx] = np.asarray(inputs[i])
    for op in trace.ops:
        if op.kind in ("input", "const"):
            continue
        a = [env[x] for x in op.args]
        if op.kind == "hadd":
            env[op.idx] = a[0] + a[1]
        elif op.kind == "hsub":
            env[op.idx] = a[0] - a[1]
        elif op.kind == "hmul":
            env[op.idx] = a[0] * a[1]
        elif op.kind == "pmul":
            env[op.idx] = a[0] * const_vec(op, consts, slots)
        elif op.kind == "padd":
            env[op.idx] = a[0] + const_vec(op, consts, slots)
        elif op.kind == "rotate":
            env[op.idx] = np.roll(a[0], -op.meta["step"], axis=-1)
        elif op.kind == "conjugate":
            env[op.idx] = np.conj(a[0])
        elif op.kind in ("rescale", "bootstrap"):
            env[op.idx] = a[0]
        else:
            raise ValueError(op.kind)
    return [env[o] for o in trace.outputs]


class CkksTraceInterpreter(CkksEngine):
    """Single-sample facade over `CkksEngine` (1-D vectors in, 1-D
    decodes out through `run`)."""

    def __init__(self, params: CkksParams, seed: int = 7,
                 device: DeviceLike = None):
        super().__init__(params, seed=seed, device=device)
