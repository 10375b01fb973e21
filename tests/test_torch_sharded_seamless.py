"""The port's partitioned LLM step against the JAX package's on a (2, 4)
mesh: the seamless-m4t-large-v2 smoke config (an encoder-decoder: the
encoder over `frames`, the decoder's cross attention over its memory,
whose length is the encoder's, not the query's) in float32, on the CPU.
What is compared and how: tests/test_torch_sharded_step.py and
tests/_sharded_parity.py.

This arch runs two pieces of the partitioned step that the other parity
files do not: the `frames` batch constraint (the encoder input laid out
over the data axes) and the cross-attention island
(`attention._attend_island` with a KV length other than the query's),
in the train step, the prefill and every decode step (the cache's
encoder memory is read, never written).
"""
import pytest

torch = pytest.importorskip("torch")

import _sharded_parity as P  # noqa: E402

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return P.run_both(ARCH, tmp_path_factory.mktemp("sharded_seamless"))


def test_forward_and_loss_match_reference(runs):
    P.check_forward(*runs)


def test_train_step_matches_reference(runs):
    P.check_train(*runs)


def test_prefill_matches_reference(runs):
    P.check_prefill(*runs)


def test_decode_matches_reference(runs):
    P.check_decode(*runs)


@pytest.mark.parametrize("part", ["forward", "train", "prefill", "decode"])
def test_partitioned_equals_unsharded(runs, part):
    """The port's unsharded step against the partitioned one, with the
    same tolerances."""
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    grads = {k: v for k, v in runs[0].items() if k.startswith("grads/")}
    check = {"forward": P.check_forward, "train": P.check_train,
             "prefill": P.check_prefill, "decode": P.check_decode}[part]
    check(dict(plain, **grads), port)
