"""The paper's example applications on the port
(repro_torch.examples.*) against the repository's `examples/`, on the CPU.

Each reference example is imported by its path and its ``main()`` run,
then the port's ``main(["--device", "cpu"])``, both with stdout captured.
Their printed lines must be identical strings: every error printed is
formatted from decrypts of bit-equal ciphertexts (same parameters, same
seeds, same op sequence). The port's returned outputs must then pass the
example's own final assertion.
"""
import contextlib
import importlib
import importlib.util
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def reference_main(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(*args)
    return buf.getvalue().splitlines(), result


def check_quickstart(out):
    # the example asserts nothing; hold each op to the engine's decrypt
    # tolerance at its parameters, 512 * N / 2^log_scale
    for got, want in out.values():
        assert np.abs(got - want).max() < 512 * 1024 / 2.0 ** 26


def check_lola_mnist(outputs):
    assert len(outputs) == 4
    assert all(np.argmax(got) == np.argmax(want) for got, want in outputs), \
        "encrypted inference disagreed with plaintext"


def check_helr_training(trajectory):
    got_w, w = trajectory[-1]
    assert len(trajectory) == 3
    assert np.abs(got_w - w).max() < 5e-2, \
        "encrypted HELR diverged from plaintext"


def check_sorting(result):
    got, want = result
    err = np.abs(got - want).max()
    assert err < 0.05 and bool((np.diff(got) > -1e-3).all()), \
        "homomorphic sort failed"


CHECKS = {"quickstart": check_quickstart, "lola_mnist": check_lola_mnist,
          "helr_training": check_helr_training, "sorting": check_sorting}


@pytest.mark.parametrize("name", list(CHECKS))
def test_example_prints_reference_lines(name):
    ref_lines, _ = run(reference_main(name))
    port = importlib.import_module(f"repro_torch.examples.{name}")
    lines, result = run(port.main, ["--device", "cpu"])
    assert len(ref_lines) >= 4
    assert lines == ref_lines
    CHECKS[name](result)
