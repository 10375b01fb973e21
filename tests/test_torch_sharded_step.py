"""The port's partitioned LLM step (DTensors over a (data 2, model 4)
mesh, models.model's DTensor path) against the JAX package's jax.jit
step on a (2, 4) mesh of 8 host devices: the qwen3-8b smoke config
(dense GQA with qk-norm) in float32, on the CPU.

The reference runs in a process of its own (tests/_jax_sharded_step.py),
the port on 8 gloo ranks, one process each (tests/_torch_dist_worker.py,
scenario ``sharded``), side by side; inputs come from numpy with a fixed
seed (tests/_sharded_inputs.py). Compared, gathered whole
(`full_tensor`): forward's logits and loss_fn's metrics, one
make_train_step step (metrics, updated parameters, AdamW's m and v), the
prefill step's last logits and caches, and 4 greedy decode steps under
the serving rules (logits, tokens, the cache after them, and
make_serve_step's tokens). The tolerances are tests/_sharded_parity.py's
(those of test_torch_llm_train and test_torch_llm_serve). The same
steps, unsharded in the port (plain tensors), equal the partitioned
ones. tests/test_torch_sharded_{deepseek,arctic}.py hold the MoE archs,
tests/test_torch_sharded_seamless.py the encoder-decoder. Plain
parameters on a mesh of more than one rank are refused.
"""
import pytest

torch = pytest.importorskip("torch")

import _sharded_parity as P  # noqa: E402

ARCH = "qwen3-8b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return P.run_both(ARCH, tmp_path_factory.mktemp("sharded_qwen3"))


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
    """The port's unsharded step (plain tensors, one rank) against the
    partitioned one, with the same tolerances: its outputs stand where
    the reference's did."""
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    grads = {k: v for k, v in runs[0].items() if k.startswith("grads/")}
    check = {"forward": P.check_forward, "train": P.check_train,
             "prefill": P.check_prefill, "decode": P.check_decode}[part]
    check(dict(plain, **grads), port)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b"])
def test_plain_params_on_multi_rank_mesh_raise(arch):
    """Plain (not distributed) parameters on a mesh of two ranks would
    run the whole step on each rank with no gradient reduction: forward,
    decode and the train step refuse them for a dense arch too."""
    from repro_torch.compat import abstract_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import optim
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    two = abstract_mesh((1, 2), ("data", "model"))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        M.forward(params, cfg, batch, two)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        M.make_train_step(cfg, two)(params, optim.adamw_init(params), batch)
    cache = M.init_cache(cfg, 2, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        M.decode_forward(params, cfg, cache, tokens[:, 0], 0, two)
    # the same parameters on a one-rank mesh run
    one = abstract_mesh((1, 1), ("data", "model"))
    assert M.forward(params, cfg, batch, one)[0].shape == (2, 8, cfg.vocab)
