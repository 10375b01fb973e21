"""Faults planted under the timed path, to show that the check catches
them. Each is a context manager that patches the program's engine
(`repro_torch.compiler.engine.CkksEngine`) for its duration:

    unchanged   a rotation returns its input unchanged
    half_batch  each op computes the first half of the batch's rows and
                hands back copies of them for the rest
    altered     one residue of the batch's output is changed where the
                engine produces it
    few_slots   every constant is encoded 1.0 off in 16 of its slots
    stale       each op hands back what it produced in the first batch
                it ran, as a cache keyed by anything but the input would

The cells run on one card, so there is no exchange between chips to
leave out.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np


@contextlib.contextmanager
def unchanged() -> Iterator[None]:
    from repro_torch.compiler.engine import CkksEngine
    orig = CkksEngine._galois
    CkksEngine._galois = lambda self, cb, elt: cb
    try:
        yield
    finally:
        CkksEngine._galois = orig


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    import torch
    from repro_torch.compiler.engine import CkksEngine, CtBatch
    orig = CkksEngine.run_ops

    def run_ops(self, ops, env, consts, **kw):
        b = next(iter(env.values())).batch
        h = (b + 1) // 2
        if b < 2:
            return orig(self, ops, env, consts, **kw)
        half: Dict = {k: CtBatch(v.data[:h], v.level, v.scale)
                      for k, v in env.items()}
        orig(self, ops, half, consts, **kw)
        for op in ops:
            if op.idx in half and op.idx not in env:
                v = half[op.idx]
                data = torch.cat([v.data, v.data[:b - h]])
                env[op.idx] = CtBatch(data, v.level, v.scale)

    CkksEngine.run_ops = run_ops
    try:
        yield
    finally:
        CkksEngine.run_ops = orig


@contextlib.contextmanager
def altered() -> Iterator[None]:
    from repro_torch.compiler.engine import CkksEngine, CtBatch
    orig = CkksEngine.run_ops

    def run_ops(self, ops, env, consts, **kw):
        out = orig(self, ops, env, consts, **kw)
        last = ops[-1].idx
        if last in env:
            v = env[last]
            data = v.data.clone()
            limb = min(3, v.level)
            q = self.ctx.primes[limb]
            data[0, 0, limb, 0] = (data[0, 0, limb, 0] + 1) % q
            env[last] = CtBatch(data, v.level, v.scale)
        return out

    CkksEngine.run_ops = run_ops
    try:
        yield
    finally:
        CkksEngine.run_ops = orig


@contextlib.contextmanager
def few_slots() -> Iterator[None]:
    from repro_torch.compiler import engine
    orig = engine.const_vec

    def const_vec(op, consts, slots):
        v = np.array(orig(op, consts, slots))
        v[..., :16] += 1.0
        return v

    engine.const_vec = const_vec
    try:
        yield
    finally:
        engine.const_vec = orig


@contextlib.contextmanager
def stale() -> Iterator[None]:
    from repro_torch.compiler.engine import CkksEngine
    orig = CkksEngine.run_ops
    memo: Dict = {}

    def run_ops(self, ops, env, consts, **kw):
        key = tuple(op.idx for op in ops)
        if key not in memo:
            orig(self, ops, env, consts, **kw)
            memo[key] = {op.idx: env[op.idx] for op in ops
                         if op.idx in env}
        env.update(memo[key])
        return list(memo[key].values())

    CkksEngine.run_ops = run_ops
    try:
        yield
    finally:
        CkksEngine.run_ops = orig


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "few_slots": few_slots, "stale": stale}
