"""The engine's spans (`CkksEngine.obs`, an `obs.EngineObs`), on the CPU
at the ciphertext smoke's ring (log N 8, 8 levels, dnum 2) on the kernel
route's plain K1-K4:

* without a context the engine makes no span and reads no clock, and its
  outputs are bit-equal to a run with one;
* each op kind has its span tree and attributes;
* Galois keygen, the evk's Montgomery form and a const miss are spanned
  on first use only, and the store exports as a valid trace;
* the spans share torch.profiler's host clock: every ATen call the
  engine makes lies inside the innermost engine span open when it began.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.compiler.engine import CkksEngine
from repro_torch.core.params import test_params as small_params
from repro_torch.core.trace import infer_levels, trace_program
from repro_torch.obs import EngineObs, Tracer, validate_file, write_trace
from repro_torch.obs import tracer as tracer_mod

PARAMS = dict(log_n=8, n_levels=8, dnum=2)
START = 7
BATCH = 2


def program(x, consts=None):
    s = x * x                   # hmul with its rescale
    r = s.rotate(1)
    c = x.conjugate()           # a level above r
    a = r - c                   # hsub: c brought down by a unit pmul
    p = a * consts["w"]         # lazy pmul (marked below)
    q = p.rescale()
    m = q * consts["w"]         # pmul with its rescale
    t = m + consts["b"]         # padd
    return (t + t).bootstrap()


@pytest.fixture(scope="module")
def case():
    tr = trace_program(program, 1, ("w", "b"))
    next(op for op in tr.ops if op.kind == "pmul").meta["lazy"] = True
    infer_levels(tr, start_level=START)
    rng = np.random.default_rng(3)
    slots = small_params(**PARAMS).slots
    x = rng.uniform(-0.5, 0.5, size=(BATCH, slots))
    consts = {c: 0.25 * rng.standard_normal(slots) for c in ("w", "b")}
    return tr, x, consts


def fresh(case):
    tr, x, _ = case
    eng = CkksEngine(small_params(**PARAMS), seed=5, use_kernels=True,
                     device="cpu")
    return eng, eng.encrypt_inputs(tr, [x], START)


def run(eng, case, env):
    """Every value the program makes, by op index."""
    tr, _, consts = case
    env = dict(env)
    eng.run_ops(tr.ops, env, consts, start_level=START,
                const_scope=("spans",))
    return env


def armed(eng) -> Tracer:
    tr = Tracer()
    eng.obs = EngineObs(tr)
    return tr


def test_no_context_reads_no_clock_and_makes_no_span(case, monkeypatch):
    eng, env = fresh(case)
    assert eng.obs is None

    def boom(*a, **k):
        raise AssertionError("read a clock or made a span")
    with monkeypatch.context() as m:
        for name in ("time", "time_ns", "perf_counter", "perf_counter_ns",
                     "monotonic", "monotonic_ns"):
            m.setattr(time, name, boom)
        m.setattr(tracer_mod, "Span", boom)
        off = run(eng, case, env)
    store = armed(eng).store
    on = run(eng, case, env)
    assert len(store) > 0
    # all but the bootstrap's, a fresh encryption
    tr = case[0]
    made = [op.idx for op in tr.ops if op.kind not in (
        "input", "const", "bootstrap")]
    assert len(made) == len(tr.ops) - 2 == 9
    for i in made:
        assert (off[i].level, off[i].scale) == (on[i].level, on[i].scale)
        assert torch.equal(off[i].data, on[i].data)


CHILDREN = {
    "hmul": ["engine.tensor", "engine.keyswitch", "engine.combine",
             "engine.rescale"],
    "rotate": ["engine.keygen", "engine.perm", "engine.keyswitch",
               "engine.combine"],
    "conjugate": ["engine.keygen", "engine.perm", "engine.keyswitch",
                  "engine.combine"],
    "hsub": ["engine.align"],
    "pmul": ["engine.const", "engine.product"],
    "rescale": ["engine.rescale"],
    "padd": ["engine.const"],
    "hadd": [],
    "bootstrap": [],
}


def test_each_op_kind_has_its_span_tree(case):
    eng, env = fresh(case)
    tracer = Tracer()
    parent = tracer.begin("batch", 0.0)
    eng.obs = EngineObs(tracer, parent=parent, track="device:0")
    store = tracer.store
    run(eng, case, env)
    tr = case[0]
    ops = store.by_name("engine.op")
    compute = [op for op in tr.ops if op.kind not in ("input", "const")]
    assert [s.attrs["op"] for s in ops] == [op.idx for op in compute]
    pmuls = 0
    for s, op in zip(ops, compute):
        assert s.parent_id == parent and s.track == "device:0"
        assert s.start_s <= s.end_s
        assert s.attrs["kind"] == op.kind and s.attrs["batch"] == BATCH
        assert s.attrs["level_in"] == min(tr.ops[a].level for a in op.args)
        assert s.attrs["level_out"] == op.level
        kids = [c.name for c in store.children(s.span_id)]
        want = list(CHILDREN[op.kind])
        if op.kind == "pmul":
            pmuls += 1
            if not op.meta.get("lazy"):
                want.append("engine.rescale")
        assert kids == want, (op.kind, kids)
        for c in store.children(s.span_id):
            assert s.start_s <= c.start_s <= c.end_s <= s.end_s
    assert pmuls == 2
    # first use: the relinearization key's and each Galois key's
    # Montgomery form inside their keyswitch
    for k in store.by_name("engine.keyswitch"):
        assert k.attrs["batch"] == BATCH
        assert [c.name for c in store.children(k.span_id)] == [
            "engine.ksk_mont"]
        (m,) = store.children(k.span_id)
        assert (m.attrs["key"], m.attrs["level"]) == (k.attrs["key"],
                                                      k.attrs["level"])
    keys = [k.attrs["key"] for k in store.by_name("engine.keyswitch")]
    assert keys[0] == "relin" and keys[1][0] == keys[2][0] == "gk"
    assert [k.attrs["key"] for k in store.by_name("engine.keygen")] == \
        keys[1:]
    (align,) = store.by_name("engine.align")
    assert [c.name for c in store.children(align.span_id)] == [
        "engine.const", "engine.product", "engine.rescale"]
    for r in store.by_name("engine.rescale"):
        assert r.attrs["batch"] == BATCH and 1 <= r.attrs["level"] <= START
    slots = small_params(**PARAMS).slots
    for c in store.by_name("engine.const"):
        assert c.attrs["hit"] is False
        assert c.attrs["hashed"] == slots * 8    # float64 slots
    assert store.open_spans() == [store.get(parent)]


def test_first_use_work_is_spanned_once(case, tmp_path):
    eng, env = fresh(case)
    store = armed(eng).store
    run(eng, case, env)
    first = len(store)
    names = [s.name for s in store.spans]
    assert names.count("engine.keygen") == 2
    assert names.count("engine.ksk_mont") == 3
    run(eng, case, env)
    again = store.spans[first:]
    assert [s.name for s in again if s.name in (
        "engine.keygen", "engine.ksk_mont")] == []
    consts = [s for s in again if s.name == "engine.const"]
    assert len(consts) == names.count("engine.const") == 4
    assert all(s.attrs["hit"] for s in consts)
    write_trace(store, str(tmp_path / "engine.json"), clock="wall")
    assert validate_file(str(tmp_path / "engine.json")) == []


def test_spans_share_the_profilers_host_clock(case):
    """Each ATen host event the engine's ops make lies inside the
    innermost engine span open at its start, on the profiler's own
    timeline: the spans' clock is the profiler's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr, _, consts = case
    eng, env = fresh(case)
    run(eng, case, env)                      # keys and consts made
    obs = EngineObs(Tracer())
    eng.obs = obs
    env = dict(env)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for op in tr.ops:
            with record_function("test.op"):
                eng.run_ops([op], env, consts, start_level=START)
    spans = [(obs.anchor_ns + round(s.start_s * 1e9),
              obs.anchor_ns + round(s.end_s * 1e9), s)
             for s in obs.tracer.store.spans]
    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == "test.op"]
    aten = [e for e in events if e.name().startswith("aten::")
            and any(r0 <= e.start_ns() <= r1 for r0, r1 in ranges)]
    assert len(aten) > 50
    for e in aten:
        t0, t1 = e.start_ns(), e.end_ns()
        open_ = [sp for sp in spans if sp[0] <= t0 <= sp[1]]
        assert open_, (e.name(), t0)
        inner = max(open_, key=lambda sp: sp[0])
        assert t1 <= inner[1], (e.name(), inner[2].name, t1 - inner[1])
