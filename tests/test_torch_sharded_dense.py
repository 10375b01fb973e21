"""The port's partitioned LLM step against the JAX package's on a (2, 4)
mesh for the dense archs besides qwen3-8b, in float32 on the CPU: the
smoke configs of granite-3-8b (tied embeddings: the logits' product
reads the embedding table), mistral-nemo-12b (GQA without qk-norm) and
codeqwen1.5-7b (as many KV heads as query heads, so KV heads split over
`model`). What is compared and how: tests/test_torch_sharded_step.py
and tests/_sharded_parity.py.
"""
import pytest

torch = pytest.importorskip("torch")

import _sharded_parity as P  # noqa: E402

ARCHS = ["granite-3-8b", "mistral-nemo-12b", "codeqwen1.5-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, tmp_path_factory):
    return P.run_both(request.param, tmp_path_factory.mktemp("sharded_dense"))


def test_forward_and_loss_match_reference(runs):
    P.check_forward(*runs)


def test_train_step_matches_reference(runs):
    P.check_train(*runs)


def test_prefill_matches_reference(runs):
    P.check_prefill(*runs)


def test_decode_matches_reference(runs):
    P.check_decode(*runs)


def test_partitioned_equals_unsharded(runs):
    """The port's unsharded step against the partitioned one, with the
    same tolerances, in every part."""
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    grads = {k: v for k, v in runs[0].items() if k.startswith("grads/")}
    for check in (P.check_forward, P.check_train, P.check_prefill,
                  P.check_decode):
        check(dict(plain, **grads), port)
