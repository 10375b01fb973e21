"""bench/spans.py: the device work of a synthetic profile charged to the
engine's spans (nesting, the innermost span, arrivals, time launched
outside every span, idle gaps); the readers of its keys; and a traced run
on the CPU with the spans armed, and one without."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from _bench_small import small_cell
from bench import bound, cells, harness, spans
from repro_torch.obs import Tracer

ROOT = Path(__file__).resolve().parents[2]
NEW = [m["name"] for m in spans.METRICS]


class Ev:
    def __init__(self, name, start, end, corr=0, cuda=False):
        self._v = (name, start, end, corr, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"


def synthetic():
    """Two ops of one batch, in ns from the spans' anchor 0: an hmul-like
    op with a Montgomery conversion inside its keyswitch, a pmul-like op
    whose constant the cache held, then a request's arrival."""
    tr = Tracer()

    def span(name, t0, t1, parent=None, **attrs):
        return tr.span(name, t0 * 1e-9, t1 * 1e-9, parent, **attrs)
    op1 = span("engine.op", 10, 400, kind="hmul")
    span("engine.tensor", 20, 100, op1)
    ks = span("engine.keyswitch", 110, 300, op1, key="relin", level=3,
              batch=2)
    span("engine.ksk_mont", 120, 150, ks)
    span("engine.combine", 310, 390, op1)
    op2 = span("engine.op", 500, 900, kind="pmul")
    span("engine.const", 510, 700, op2, hit=True)
    span("engine.product", 710, 800, op2)
    span("harness.loop", 0, 1000)         # not the engine's: ignored
    host = [Ev("bench.batch", 0, 1000), Ev("bench.arrive", 920, 990)]
    launches = [(1, 30, 100, 200), (2, 130, 200, 260), (3, 200, 260, 400),
                (4, 320, 400, 450), (5, 450, 450, 470), (6, 720, 750, 800),
                (7, 930, 930, 950)]
    for corr, at, d0, d1 in launches:
        host.append(Ev("cudaLaunchKernel", at, at + 5, corr))
        host.append(Ev(f"kernel{corr}", d0, d1, corr, cuda=True))
    host.append(Ev("memset", 960, 970, 99, cuda=True))   # no runtime call
    host.append(Ev("bench.op.hmul", 10, 400, 0, cuda=True))   # mirror
    return spans.records(host), tr.store.spans


def test_device_work_charged_to_the_innermost_span():
    rec, sp = synthetic()
    assert [d[2] for d in rec["device"]] == [30, 130, 200, 320, 450, 720,
                                             930, None]
    out = spans.reduce(rec, sp, 0, 256, 1, 2)
    ns = 1e-9
    assert out["span_device_s"] == pytest.approx({
        "engine.tensor": 100 * ns, "engine.ksk_mont": 60 * ns,
        "engine.keyswitch": 140 * ns, "engine.combine": 50 * ns,
        "engine.product": 50 * ns})
    incl = out["span_device_incl_s"]
    assert incl["engine.op"] == pytest.approx(400 * ns)
    assert incl["engine.keyswitch"] == pytest.approx(200 * ns)
    # the arrival's kernel counts nowhere; the kernel launched between
    # the ops and the set with no runtime call are uncharged
    assert out["span_uncharged_s"] == pytest.approx(30 * ns)
    assert out["span_host_s"]["engine.op"] == pytest.approx(790 * ns)
    assert out["span_host_s"]["engine.const"] == pytest.approx(190 * ns)
    assert "harness.loop" not in out["span_count"]
    assert out["span_count"]["engine.op"] == 2
    assert out["span_hits"] == {"engine.const": 1}
    assert out["keyswitch_bound_s"] == pytest.approx(bound.seconds(
        2 * bound.keyswitch_products(256, 3, 1, 2),
        3 * bound.ct_bytes(256, 3) + bound.key_bytes(256, 3, 1, 2)))
    assert out["rescale_bound_s"] == 0.0
    # idle: [0,100] [470,750] [800,930] [950,960] [970,1000], each split
    # by the innermost span the host was in
    assert out["span_gaps"] == pytest.approx({
        "engine.op": 130 * ns, "engine.tensor": 80 * ns,
        "engine.const": 190 * ns, "engine.product": 40 * ns,
        spans.OUTSIDE: 110 * ns})


def test_readers():
    rec, sp = synthetic()
    red = dict(spans.reduce(rec, sp, 0, 256, 1, 2), batches=2,
               device_s=450e-9)
    read = {m: cells.reader(m)(red) for m in NEW}
    assert read["keyswitch_roofline"] is None     # 30 of 450 ns uncharged
    assert read["rescale_roofline"] is None
    assert read["tensor_product_ms"] == pytest.approx(50e-9 * 1e3)
    assert read["engine_host_ms"] == pytest.approx(395e-9 * 1e3)
    assert read["const_host_ms"] == pytest.approx(95e-9 * 1e3)
    assert read["const_hit_pct"] == 100.0
    red.update(span_uncharged_s=4e-9)
    assert cells.reader("keyswitch_roofline")(red) == pytest.approx(
        100 * red["keyswitch_bound_s"] / 140e-9)
    assert cells.reader("rescale_roofline")(red) is None   # no rescale


def test_readers_find_nothing_without_spans():
    """A record of the benchmark's own traced run, which does not arm the
    engine's spans."""
    rec = {"batches": 3, "device_events": 30, "device_s": 0.1,
           "unattributed_s": 0.0, "kind_device_s": {"hmul": 0.05},
           "kind_bound_s": {"hmul": 0.001}, "enqueue_s": 0.02}
    assert {m: cells.reader(m)(rec) for m in NEW} == dict.fromkeys(NEW)


def test_traced_run_on_cpu_reads_the_host_spans():
    cell = spans.with_metrics(small_cell("helr-paper.b8"))
    assert [m["name"] for m in cell["per_layer"]][-len(NEW):] == NEW
    run_cls = harness.Run
    with spans.armed():
        out = harness.execute(cell, 2 ** 31 + 3, 0.2, True, "cpu")
    assert harness.Run is run_cls
    assert out["correct"], out["check"]
    # no device events on the CPU: only the host's readings
    assert set(out["metrics"]) == {"engine_enqueue_ms", "engine_host_ms",
                                   "const_host_ms", "const_hit_pct"}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["const_hit_pct"] == 100.0            # the warm batches filled it
    assert 0 < m["const_host_ms"] < m["engine_host_ms"] < \
        m["engine_enqueue_ms"]
    rec = out["extra"]["record"]
    assert rec["span_count"]["engine.op"] == rec["ops_traced"]
    assert "engine.keygen" not in rec["span_count"]
    assert rec["span_count"]["engine.keyswitch"] == 8 * rec["batches"]
    json.dumps(out["extra"])
    # the benchmark's own traced run: the readers find nothing
    plain = harness.execute(cell, 2 ** 31 + 3, 0.2, True, "cpu")
    assert set(plain["metrics"]) == {"engine_enqueue_ms"}


@pytest.mark.cuda
@pytest.mark.parametrize("w", [w["name"] for w in cells.spec()["workloads"]])
def test_all_six_read_on_the_card(cuda, w):
    r = subprocess.run([sys.executable, "-m", "bench.spans", "--workload", w,
                        "--seed", str(2 ** 31 + 23), "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    want = {m["name"] for m in spans.with_metrics(cells.cell(w))[
        "per_layer"]} - {"hmul_roofline"}
    assert want <= set(out["metrics"])
    assert ("tensor_product_ms" in out["metrics"]) == w.startswith("helr")
    for m in ("keyswitch_roofline", "rescale_roofline"):
        assert 0 < out["metrics"][m]["value"] < 100
    note = next(ln for ln in r.stderr.splitlines() if ln.startswith("bench: "))
    rec = json.loads(note[len("bench: "):])["record"]
    ops = sum(rec["kind_device_s"].values())
    assert sum(rec["span_device_s"].values()) >= 0.99 * ops
