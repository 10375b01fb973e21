"""The port's partitioned LLM step against the JAX package's on a (2, 4)
mesh: the arctic smoke config (GQA with KV heads that do not split over
`model`, an MoE with a dense residual branch) in float32, on the CPU.
What is compared and how: tests/test_torch_sharded_step.py and
tests/_sharded_parity.py.

Both MoE routes run: the all_to_all route in the train step and the
prefill (128 tokens, 16 a rank), the psum route in decode. The
reference's aux under its shard_map's out_specs P() is each device's
own (ROADMAP §3, F11); the port keeps it so, and the host reads rank 0's
as it reads device 0's.

The port's unsharded step differs from the partitioned one where the
reference's does: the all_to_all route sizes each rank's expert
capacity from its own tokens, and aux is a rank's own. So it is held to
the partitioned step in decode only, where the psum route's capacity is
the same (4 slots) and nothing is dropped.

The MoE layer's all-to-all bytes per device, counted on the port's
ranks (launch.dryrun.StepCounter) in the prefill step of the config cut
to one MoE layer, equal the reference's count in its compiled HLO
(repro.launch.dryrun.collective_bytes) of the same cut cell's MoE
buffers. Both are the shard_map body's two exchanges; the other
collectives each partitioner places for itself are written down in
PERF.md, not compared.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import _sharded_parity as P  # noqa: E402

ARCH = "arctic-480b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return P.run_both(ARCH, tmp_path_factory.mktemp("sharded_arctic"))


def test_forward_and_loss_match_reference(runs):
    P.check_forward(*runs)


def test_train_step_matches_reference(runs):
    P.check_train(*runs)


def test_prefill_matches_reference(runs):
    P.check_prefill(*runs)


def test_decode_matches_reference(runs):
    P.check_decode(*runs)


def test_decode_equals_unsharded(runs):
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    P.check_decode(plain, port)


def test_moe_all_to_all_bytes_equal_reference(runs):
    ref, port = runs
    mine = int(port["count_op/c10d.alltoall_base_"])
    assert mine == int(ref["cut_moe_all_to_all"]) > 0
    # the DTensor path places no all-to-all of its own in this cell
    assert int(port["count/all-to-all"]) == mine
    assert json.loads(str(ref["cut_collective_bytes"]))["all-to-all"] >= mine


def test_routes_a2a_at_prefill_psum_at_decode(runs):
    _, port = runs
    assert int(port["count_op/c10d.alltoall_base_"]) > 0
    assert "count_decode_op/c10d.alltoall_base_" not in port
    assert int(port["count_decode_op/c10d.allreduce_"]) > 0
