"""The cell resnet20-s1.b8: its parts found by name, the ResNet program's
copy against the port's, and a CPU run at a small ring that passes the
check."""
from _bench_small import small_cell
from bench import cells, harness


def test_cell_resolves():
    c = cells.cell("resnet20-s1.b8")
    fn, n_inputs, consts = cells.program(c["config"])
    assert callable(fn) and n_inputs == 1
    assert "row_tail_pct" in cells.limits("resnet20-s1.b8")
    assert {m["name"] for m in c["end_to_end"]} == {
        "ct_per_s", "batch_ms_p95", "setup_s"}
    assert c["per_layer"] and c["chips"] == 1


def test_resnet_config_and_program():
    cfg = cells.config("resnet20-s1")
    assert cfg["reduced"] == ["ckks", "depth"]
    assert {"depth", "ckks", "const_std"} <= set(cfg["assumed"])
    assert cfg["ckks"] == cells.config("helr-paper")["ckks"]
    fn, n_inputs, consts = cells.program(cfg)
    assert n_inputs == 1 and len(consts) == 6 * (144 + 4)


def test_resnet_program_is_the_ports():
    """The benchmark's copy is `runtime/workloads.make_resnet20_stage`
    with the activations' linear coefficients b taken as 1 + b: on slot
    vectors, the copy at b equals the port's at 1 + b, and traces to the
    port's ops with one hadd more an activation."""
    import numpy as np
    from collections import Counter

    from bench import reference
    from repro_torch.core.trace import trace_program
    from repro_torch.runtime import workloads as wl
    fn, n_in, consts = cells.program(cells.config("resnet20-s1"))
    assert consts == wl.resnet20_consts()
    kw = {"blocks": 1, "channels": 4, "hw": 4}
    small, _, names = cells.program({"program": "resnet20",
                                     "program_args": kw})
    rng = np.random.default_rng(0)
    cs = {n: 0.1 * rng.standard_normal(128) for n in names}
    port_cs = {n: v + 1 if n.endswith(".b") else v for n, v in cs.items()}
    x = rng.uniform(-0.8, 0.8, (2, 128))
    got = reference.evaluate(small, [x], cs)[0]
    want = reference.evaluate(wl.make_resnet20_stage(**kw), [x], port_cs)[0]
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert sorted(n for n in port_cs if n.endswith(".b")) == [
        "b0.h1.b", "b0.h2.b"]
    kinds = Counter(o.kind for o in trace_program(fn, n_in, consts).ops)
    port = Counter(o.kind for o in trace_program(
        wl.make_resnet20_stage(), 1, wl.resnet20_consts()).ops)
    port["hadd"] += 6
    assert kinds == port


def test_small_run_passes_the_check():
    """One block of 4 channels of 4x4 at log N 8 (128 slots)."""
    cell = small_cell("resnet20-s1.b8")
    cell["config"]["program_args"] = {"blocks": 1, "channels": 4, "hw": 4}
    out = harness.execute(cell, 2 ** 31 + 17, 0.2, False, "cpu",
                          limits=harness.cell_limits(cell))
    assert out["correct"], out["check"]
    assert out["check"]["bad_coeffs"]["value"] == 0
    assert out["attempted"] >= 2 * cell["traffic"]["batch"]


def test_error_in_the_first_conv_fails_the_check(monkeypatch):
    """A relative error of 1e-2 planted in the stage's first conv's
    diagonals, where the engine encodes them, reaches the output at about
    its own size (3 blocks of 4 channels of 4x4, log N 8), so the check
    fails: the first conv counts as much as the last."""
    import numpy as np

    from repro_torch.compiler import engine
    cell = small_cell("resnet20-s1.b8")
    cell["config"]["program_args"] = {"blocks": 3, "channels": 4, "hw": 4}
    orig = engine.const_vec

    def const_vec(op, consts, slots):
        v = np.array(orig(op, consts, slots))
        if engine._const_key(op).startswith("b0.c1.w"):
            v = v * (1 + 1e-2 * np.random.default_rng(0).standard_normal(
                v.shape))
        return v

    monkeypatch.setattr(engine, "const_vec", const_vec)
    out = harness.execute(cell, 2 ** 31 + 19, 0.2, False, "cpu",
                          limits=harness.cell_limits(cell))
    assert not out["correct"]
    assert out["check"]["row_tail_pct"]["value"] > 50
