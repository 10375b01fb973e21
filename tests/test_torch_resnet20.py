"""ResNet-20's first stage (`runtime/workloads.make_resnet20_stage`)
against its plain float32 reference (`examples/resnet20_plain`): on slot
vectors at the published 32x32x16 with packed real weights, and through
`CkksEngine` at a small ring; and the rotation planner's split of a
convolution's 144 steps, with its record."""
import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.compiler import PassConfig, optimize_trace
from repro_torch.compiler.engine import CkksEngine, decrypt_tolerance
from repro_torch.compiler.passes import RotationOpt
from repro_torch.core.params import paper_params_bootstrap
from repro_torch.core.params import test_params as small_params
from repro_torch.core.pipeline import MemoryModel
from repro_torch.core.trace import infer_levels, trace_program
from repro_torch.examples import resnet20_plain as plain
from repro_torch.runtime import conv_pack
from repro_torch.runtime import workloads as wl
from repro_torch.runtime.compile_cache import CompileCache

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from bench import reference  # noqa: E402

PAPER = paper_params_bootstrap()
# the planner's split of one conv's 144 terms (143 nonzero steps)
CONV_PLAN = {"terms": 144, "g": 1024, "babies": 8, "giants": 16,
             "rotations_before": 143, "rotations_after": 24}


def _trace(fn, consts, start):
    tr = trace_program(fn, 1, consts)
    infer_levels(tr, start_level=start)
    return tr


def test_pack_roundtrip_and_duplicate():
    x = np.random.default_rng(0).normal(size=(3, 16, 32, 32))
    v = conv_pack.pack(x)
    assert v.shape == (3, PAPER.slots)
    assert np.array_equal(v[:, :16384], v[:, 16384:])
    assert np.array_equal(conv_pack.unpack(v, 16, 32), x)
    assert v[1, 1024 * 5 + 32 * 7 + 9] == x[1, 5, 7, 9]


def _stage_on_slots(params, x, blocks=3):
    consts = conv_pack.stage_consts(params, 32)
    assert set(consts) == set(wl.resnet20_consts(blocks=blocks))
    out = reference.evaluate(wl.make_resnet20_stage(blocks=blocks),
                             [conv_pack.pack(x)], consts)[0]
    return conv_pack.unpack(out, 16, 32)


def test_stage_on_slots_equals_plain_reference():
    """The program on slot vectors (float64, the benchmark's `evaluate`)
    with packed real weights, masks and folded batch norms against the
    float32 reference over 4 images at 32x32x16 and 3 blocks. Tolerance
    1e-5 (1 + |want|): float32's unit roundoff 6e-8 over six
    convolutions of 144 products each and six squarings lands at a few
    1e-6 of the output (3.5e-6 at its largest, 7.4, on these seeds); a
    missing padding mask or a tap off by one channel moves outputs by
    1e-1 and more."""
    params = plain.random_params(3, 16, seed=5)
    x = np.random.default_rng(2).uniform(-1, 1, (4, 16, 32, 32)).astype(
        np.float32)
    want = plain.forward(torch.from_numpy(x), params).numpy()
    got = _stage_on_slots(params, x)
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))
    # the comparison is sharp: a tap taken from the wrong channel fails it
    bad = [dict(p) for p in params]
    bad[1]["w2"] = np.roll(params[1]["w2"], 1, axis=1)
    assert np.abs(_stage_on_slots(bad, x) - want).max() > 1e-2


@pytest.mark.parametrize("use_kernels", [False, True])
def test_one_block_through_the_engine(use_kernels):
    """One block compiled by `CompileCache.get_schedule` and run by
    `CkksEngine.run_schedule` at log N 10 (512 slots: 16 channels of 4x4,
    written twice), from level 7 to 1, decrypts to the float32 reference
    within the engine's decrypt tolerance 512 N / 2^log_scale (2e-3 at
    these parameters; 4e-4 measured): 24 rotations a conv and the
    residual and activation adds across levels all land exactly."""
    params = small_params(log_n=10, n_levels=8, dnum=2, log_scale=28)
    start, hw = 7, 4
    tr = _trace(wl.make_resnet20_stage(blocks=1, hw=hw),
                wl.resnet20_consts(blocks=1), start)
    sched = CompileCache().get_schedule(
        tr, params, MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20),
        pass_config=PassConfig(start_level=start))
    kinds = [o.kind for o in sched.trace.ops]
    assert kinds.count("rotate") == 48 and kinds.count("hmul") == 2
    blocks = plain.random_params(1, 16, seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, hw, hw)).astype(
        np.float32)
    want = plain.forward(torch.from_numpy(x), blocks).numpy()
    eng = CkksEngine(params, seed=11, device="cpu", use_kernels=use_kernels)
    dec, _ = eng.run_schedule(sched, [conv_pack.pack(x)],
                              conv_pack.stage_consts(blocks, hw),
                              start_level=start)
    got = conv_pack.unpack(dec[0], 16, hw)
    assert np.abs(got - want).max() < decrypt_tolerance(params)
    assert len(eng._gks) == 24


def test_compiled_stage_keyswitches():
    tr = _trace(wl.make_resnet20_stage(), wl.resnet20_consts(), 20)
    opt, rep = optimize_trace(tr, PAPER, PassConfig())
    kinds = [o.kind for o in opt.ops]
    assert kinds.count("rotate") + kinds.count("hmul") == 150
    assert len({o.meta["step"] for o in opt.ops if o.kind == "rotate"}) == 24
    assert opt.ops[opt.outputs[0]].level == 2
    rot = next(s for s in rep.passes if s.name == "rotation")
    assert rot.records == [CONV_PLAN] * 6


def test_matvec_still_plans_to_6():
    tr = _trace(wl.make_matvec(16), wl.matvec_consts(16), 7)
    _, recs = RotationOpt().run_recorded(
        tr, small_params(log_n=8, n_levels=8), PassConfig())
    assert recs == [{"terms": 16, "g": 4, "babies": 3, "giants": 3,
                     "rotations_before": 15, "rotations_after": 6}]


def test_contiguous_steps_keep_round_sqrt():
    """Steps 0..n-1 (a matvec's diagonals) plan best at round(sqrt(n)),
    which the planner keeps on a tie with a power of two."""
    for n in range(2, 70):
        assert RotationOpt._split(list(range(n)), 1 << 15) == max(
            1, int(round(math.sqrt(n)))), n


def test_planner_record_is_emitted():
    """A compiled schedule's pass report carries the rotation pass's
    record of each tree it factored: the stage's six convs."""
    tr = _trace(wl.make_resnet20_stage(), wl.resnet20_consts(), 20)
    mem = MemoryModel(n_partitions=16, partition_bytes=96 * 2 ** 20)
    sched = CompileCache().get_schedule(tr, PAPER, mem,
                                        pass_config=PassConfig())
    rot = next(s for s in sched.pass_report.passes if s.name == "rotation")
    assert rot.applied and rot.records == [CONV_PLAN] * 6
    assert all(s.records == [] for s in sched.pass_report.passes
               if s.name != "rotation")


def test_plain_reference_imports_only_torch_and_numpy():
    with open(plain.__file__) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert roots <= {"typing", "numpy", "torch"}


class _PeakDict(dict):
    """An environment that remembers how many values it held at most."""
    peak = 0

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.peak = max(self.peak, len(self))


def test_engine_holds_only_live_values():
    """A compiled schedule's ops carry `frees`: run_ops drops each value
    after its last reader, keeps the outputs, and gives bit-identical
    outputs to a run that keeps every value."""
    params = small_params(log_n=8, n_levels=8)
    tr = _trace(wl.make_matvec(16), wl.matvec_consts(16), 7)
    sched = CompileCache().get_schedule(
        tr, params, MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20),
        pass_config=PassConfig(start_level=7))
    ops = [op for st in sched.stages for op in st.ops]
    freed = [a for op in ops for a in op.frees]
    assert len(freed) == len(set(freed))
    assert not set(freed) & set(sched.trace.outputs)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, params.slots))
    consts = {n: rng.normal(size=params.slots) for n in wl.matvec_consts(16)}
    eng = CkksEngine(params, seed=3, device="cpu")
    inputs = eng.encrypt_inputs(sched.trace, [x], 7)
    outs = []
    for keep_all in (False, True):
        if keep_all:
            for op in ops:
                op.frees = ()
        env = _PeakDict(inputs)
        got = eng.run_ops(ops, env, consts, start_level=7)
        outs.append((env, got))
    (lean, got), (full, _) = outs
    assert set(lean) == set(sched.trace.outputs)
    assert [g is lean[o] for o, g in zip(sched.trace.outputs, got)] == [True]
    assert lean.peak < full.peak == len(full)
    for o in sched.trace.outputs:
        assert torch.equal(lean[o].data, full[o].data)
