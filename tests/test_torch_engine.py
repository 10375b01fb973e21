"""Parity of the port's batched engine (repro_torch.compiler.engine) with
the JAX reference on the four serve workloads, on the CPU.

The workloads (helr, lola, matvec, poly; launch/serve_fhe.py) are
compiled by each package's own ``optimize_trace`` +
``generate_load_save_pipeline`` at the ciphertext smoke's parameters
(test_params(log_n=8, n_levels=8, dnum=2), start level 7), and

* the compiled schedules are equal, stage for stage and op for op;
* executing them with ``CkksEngine.run_schedule`` on the same (B=2,
  slots) inputs, the port's engine with ``use_kernels`` False and True
  (the plain K1-K4 path) ends in ciphertexts bit-equal to the reference
  engine's library route (``use_kernels=False``; its fused route is held
  bit-identical to that by tests/test_keyswitch_fused.py), and decodes
  within atol 1e-9 of the reference's: both sides run the same numpy FFT
  on equal integer data, so only float evaluation order could differ.

The reference engine runs each op eagerly (its per-signature ``jax.jit``
memo is bypassed, which changes nothing it computes) so the test pays no
whole-op compile per signature.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler import PassConfig as JPassConfig  # noqa: E402
from repro.compiler import optimize_trace as j_optimize  # noqa: E402
from repro.compiler.engine import CkksEngine as JEngine  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.core.pipeline import MemoryModel as JMem  # noqa: E402
from repro.core.pipeline import \
    generate_load_save_pipeline as j_map  # noqa: E402
from repro.core.trace import LevelBudgetExhausted as JBudget  # noqa: E402
from repro.core.trace import infer_levels as j_infer  # noqa: E402
from repro.core.trace import trace_program as j_trace  # noqa: E402
from repro.runtime.ciphertext_backend import base_const_names  # noqa: E402
from repro.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,  # noqa: E402
                                     lola_infer, make_helr_iter, make_matvec,
                                     make_poly_eval, matvec_consts,
                                     poly_consts)
from repro_torch.compiler import PassConfig as TPassConfig  # noqa: E402
from repro_torch.compiler import optimize_trace as t_optimize  # noqa: E402
from repro_torch.compiler.engine import CkksEngine as TEngine  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.core.pipeline import MemoryModel as TMem  # noqa: E402
from repro_torch.core.pipeline import \
    generate_load_save_pipeline as t_map  # noqa: E402
from repro_torch.core.trace import LevelBudgetExhausted as TBudget  # noqa: E402
from repro_torch.core.trace import infer_levels as t_infer  # noqa: E402
from repro_torch.core.trace import trace_program as t_trace  # noqa: E402
from repro_torch.runtime import workloads as tw  # noqa: E402

PARAMS = dict(log_n=8, n_levels=8, dnum=2)
START = 7
BATCH = 2
MEM = dict(n_partitions=4, partition_bytes=8 * 2 ** 20)
WORKLOADS = {
    "helr": ((make_helr_iter(), 2, HELR_CONSTS),
             (tw.make_helr_iter(), 2, tw.HELR_CONSTS)),
    "lola": ((lola_infer, 1, LOLA_CONSTS),
             (tw.lola_infer, 1, tw.LOLA_CONSTS)),
    "matvec": ((make_matvec(16), 1, matvec_consts(16)),
               (tw.make_matvec(16), 1, tw.matvec_consts(16))),
    "poly": ((make_poly_eval(12), 1, poly_consts(12)),
             (tw.make_poly_eval(12), 1, tw.poly_consts(12))),
}


def _register(trace_fn, infer, budget_error, fn, n_in, consts):
    """Capture as PipelinedExecutor.register does: levels from START;
    a trace deeper than the chain keeps its input levels for bootstrap
    insertion."""
    tr = trace_fn(fn, n_in, consts)
    try:
        infer(tr, start_level=START)
    except budget_error:
        pass
    return tr


def compile_both(name):
    (jfn, n_in, jc), (tfn, _, tc) = WORKLOADS[name]
    jtr, _ = j_optimize(_register(j_trace, j_infer, JBudget, jfn, n_in, jc),
                        j_test_params(**PARAMS), JPassConfig())
    ttr, _ = t_optimize(_register(t_trace, t_infer, TBudget, tfn, n_in, tc),
                        t_test_params(**PARAMS), TPassConfig())
    return (j_map(jtr, j_test_params(**PARAMS), JMem(**MEM)),
            t_map(ttr, t_test_params(**PARAMS), TMem(**MEM)))


def signature(sched):
    """Everything a schedule determines, as plain data."""
    def op(o):
        return (o.idx, o.kind, tuple(o.args),
                tuple(sorted((k, repr(v)) for k, v in o.meta.items())),
                o.level)
    tr = sched.trace
    return (
        [(s.idx, s.partition, s.const_bytes, s.compute_s, s.out_bytes,
          [op(o) for o in s.ops]) for s in sched.stages],
        [[s.idx for s in r] for r in sched.rounds],
        sched.reload_per_op, [op(o) for o in tr.ops], list(tr.inputs),
        list(tr.outputs), list(tr.consts), sched.stage_times(BATCH))


@pytest.fixture(scope="module")
def engines():
    jeng = JEngine(j_test_params(**PARAMS), seed=7)
    jeng._opfn = lambda key, build: build()      # eager, never jit
    return (jeng,
            TEngine(t_test_params(**PARAMS), seed=7, device="cpu"),
            TEngine(t_test_params(**PARAMS), seed=7, device="cpu",
                    use_kernels=True))


def run_schedule(engine, sched, inputs, consts, name):
    """engine.run_schedule, also returning the output ciphertexts: they
    are the last batches it hands to decode_batch (a bootstrap refresh
    decodes too, earlier)."""
    seen = []
    decode = engine.decode_batch
    engine.decode_batch = lambda cb: (seen.append(cb), decode(cb))[1]
    try:
        decs, stage_s = engine.run_schedule(sched, inputs, consts,
                                            start_level=START,
                                            const_scope=(name,))
    finally:
        del engine.decode_batch
    assert len(stage_s) == len(sched.stages)
    return seen[len(seen) - len(decs):], decs


# One test per workload, run in this order: the three engines draw their
# encryption and Galois-key randomness in the same sequence.
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_schedule_and_run_bit_equal(engines, name):
    jsched, tsched = compile_both(name)
    assert signature(tsched) == signature(jsched)
    rng = np.random.default_rng(len(name))
    slots = t_test_params(**PARAMS).slots
    inputs = [rng.uniform(-0.8, 0.8, size=(BATCH, slots))
              for _ in jsched.trace.inputs]
    consts = {c: 0.25 * rng.standard_normal(slots)
              for c in base_const_names(jsched.trace)}
    j_out, j_dec = run_schedule(engines[0], jsched, inputs, consts, name)
    for eng in engines[1:]:
        t_out, t_dec = run_schedule(eng, tsched, inputs, consts, name)
        assert len(t_out) == len(j_out) == len(jsched.trace.outputs) > 0
        for jc, tc, jd, td in zip(j_out, t_out, j_dec, t_dec):
            assert (tc.level, tc.scale) == (jc.level, jc.scale)
            np.testing.assert_array_equal(
                tc.data.numpy(), np.asarray(jc.data).astype(np.int64))
            np.testing.assert_allclose(td, jd, rtol=0, atol=1e-9)
