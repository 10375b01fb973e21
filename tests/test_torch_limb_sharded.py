"""The port's limb-sharded HMul (core.ops on the basis
repro_torch.fhe_dist.limb_ops.LimbShard) against the JAX reference, on
the CPU with gloo.

The reference shards a ciphertext by limb over 8 host devices and lets
GSPMD partition `ops.hmul`; tests/distributed_worker.py holds that to
`ops.hmul` on one device, bit for bit. The port has no GSPMD: its
keyswitch, rescale, hmul, hsquare and rotate run on each rank's own
limbs with collectives for ModUp, ModDown and the rescale's last limb.

* Multi-rank cases start one process a rank (tests/_torch_dist_worker.py
  scenario ``limb``) on a (1, 8) and a (2, 4) mesh, under both BConv
  schedules. Each gathered result is assert_array_equal to the
  reference's `ops` on one device (one reference run for the module):
  hmul with rescale, hsquare, rotate and an hmul against a ciphertext
  switched to a lower level, on the reference worker's exact inputs
  (CkksEncryptor seed 5, rng 2, scale 2^26), on a batch of two split
  along `data`, and at a small ring with 3221225473 among its special
  primes. At these shapes the keyswitch basis (12 limbs), the special
  limbs (4) and the rescaled ciphertext (7 limbs) split over 8 ranks
  unevenly; on 4 ranks the rescale from level 4 regroups its blocks.
* World size 1 in this process: the same operations and schedules.
* The uneven block rule of fhe_dist.layout, on a mesh stub of each rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core import rns as j_rns  # noqa: E402
from repro.core.ciphertext import Plaintext as JPt  # noqa: E402
from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.encoder import CkksEncoder as JEnc  # noqa: E402
from repro.core.encryptor import CkksEncryptor as JEncr  # noqa: E402
from repro.core.params import CkksParams as JParams  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.fhe_dist import layout  # noqa: E402
from repro_torch.fhe_dist import limb_ops as lo  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

VARIANTS = ("ring", "allgather")
MESHES = ((1, 8), (2, 4))


def _ref_case(params_kw):
    """The reference's inputs of the limb cases at `params_kw`, drawn in
    `worker.limb_inputs`'s order, and its single-device results for the
    operand pairs (ct1, ct2) and (ct2, ct2), as numpy arrays."""
    params = JParams(**params_kw)
    ctx = JCtx(params)
    enc = JEnc(ctx)
    encr = JEncr(ctx, seed=5)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    rng = np.random.default_rng(2)
    s = ctx.n // 2
    v1 = rng.normal(size=s) * 0.3
    v2 = rng.normal(size=s) * 0.3
    scale = 2.0 ** 26
    lvl = params.n_levels
    ct1 = encr.encrypt_sk(JPt(enc.encode(v1, scale, lvl), lvl, scale), sk)
    ct2 = encr.encrypt_sk(JPt(enc.encode(v2, scale, lvl), lvl, scale), sk)
    gk = encr.rotation_keygen(sk, [worker.ROT_STEP])[
        ctx.rotation_element(worker.ROT_STEP)]

    def results(a, b):
        res = {"hmul": j_ops.hmul(ctx, a, b, rk),
               "hsquare": j_ops.hsquare(ctx, a, rk),
               "rotate": j_ops.rotate(ctx, a, worker.ROT_STEP, gk),
               "low": j_ops.hmul(ctx, a, j_ops.mod_switch_to_level(
                   b, worker.LOW_LEVEL), rk)}
        return {k: (np.asarray(ct.data).astype(np.int64), ct.level,
                    ct.scale) for k, ct in res.items()}
    return ([np.asarray(x).astype(np.int64) for x in
             (ct1.data, ct2.data, rk.data, gk.data)],
            results(ct1, ct2), results(ct2, ct2))


@pytest.fixture(scope="module")
def ref():
    """One reference run for the module: each limb case's inputs and
    results, and the reference's rns.bconv of the uneven BConv inputs.
    Its ops take one ciphertext, so the batch case's results are those
    of its two operand pairs, stacked."""
    out, done = {}, {}
    for case, (kw, batch) in worker.LIMB_CASES.items():
        key = tuple(sorted(kw.items()))
        if key not in done:
            done[key] = _ref_case(kw)
        inputs, first, second = done[key]
        want = first if not batch else {
            k: (np.stack([first[k][0], second[k][0]]),) + first[k][1:]
            for k in first}
        out[case] = {"inputs": inputs, "want": want}
    ctx, v, src, dst = worker.uneven_bconv_inputs()
    jctx = JCtx(JParams(**worker.REF_PARAMS))
    assert jctx.primes == ctx.primes
    out["bconv_uneven"] = np.asarray(j_rns.bconv(
        jnp.asarray(v.astype(np.uint64)),
        jctx.bconv_tables(src, dst))).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def limb_runs(tmp_path_factory):
    """Each (variant, data, model) scenario run once for the module."""
    cache = {}

    def get(variant, data, model):
        key = (variant, data, model)
        if key not in cache:
            tmp = tmp_path_factory.mktemp(f"limb-{variant}-{data}x{model}")
            cache[key] = run_ranks(tmp, "limb", data * model, variant, data,
                                   model)
        return cache[key]
    return get


@pytest.mark.parametrize("case", sorted(worker.LIMB_CASES))
def test_port_inputs_equal_reference(ref, case):
    """The workers draw their inputs with the port's encryptor: the same
    ciphertexts and keys as the reference's, limb for limb."""
    ctx, rk, gk, ct1, ct2 = worker.limb_inputs(worker.LIMB_CASES[case][0])
    for got, want in zip((ct1.data, ct2.data, rk.data, gk.data),
                         ref[case]["inputs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "wide":
        assert {3221225473, 4293918721} <= set(ctx.p_primes)


@pytest.mark.parametrize("op", worker.LIMB_OPS)
@pytest.mark.parametrize("case", sorted(worker.LIMB_CASES))
@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_limb_sharded_bit_exact(ref, limb_runs, variant, data, model, case,
                                op):
    """Every rank's gathered result equals the reference's ops on one
    device: values, level and scale."""
    want, level, scale = ref[case]["want"][op]
    for got in limb_runs(variant, data, model):
        np.testing.assert_array_equal(got[f"{case}_{op}"], want)
        np.testing.assert_array_equal(got[f"{case}_{op}_meta"],
                                      [level, scale])


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rank_holds_its_block(ref, limb_runs, variant, data, model):
    """Each rank keeps only its block(level + 1) of the rescaled hmul (and
    of its data row's ciphertext in the batch)."""
    for r, got in enumerate(limb_runs(variant, data, model)):
        d, m = divmod(r, model)
        for case in worker.LIMB_CASES:
            want, level, _ = ref[case]["want"]["hmul"]
            rows = layout.block_range(level + 1, model, m)
            if case == "batch":
                want = want[layout.block(2, _Stub({"data": data}, d),
                                         "data")]
            np.testing.assert_array_equal(
                got[f"{case}_hmul_block"],
                want[..., rows.start:rows.stop, :])


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_uneven_distributed_bconv(ref, limb_runs, variant, data, model):
    """distributed_bconv from 12 limbs onto 7, split over 8 or 4 ranks by
    the uneven rule, equals the reference's rns.bconv."""
    for got in limb_runs(variant, data, model):
        np.testing.assert_array_equal(got["bconv_uneven"],
                                      ref["bconv_uneven"])


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh1():
    """A (1, 1) CPU mesh over a fresh world-size-1 gloo group, destroyed
    afterwards."""
    assert not dist.is_initialized()
    m = tmesh.make_host_mesh(1, 1, device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("variant", VARIANTS)
def test_limb_ops_world1(ref, mesh1, variant):
    sh = lo.LimbShard(mesh1, variant)
    for case, (kw, batch) in worker.LIMB_CASES.items():
        ctx, rk, gk, ct1, ct2 = worker.limb_inputs(kw)
        a, b = (lo.shard_ciphertext(sh, c)
                for c in worker.limb_operands(ct1, ct2, batch))
        got = worker.limb_results(ctx, sh, a, b, rk, gk)
        for op, ct in got.items():
            want, level, scale = ref[case]["want"][op]
            np.testing.assert_array_equal(
                lo.gather_ciphertext(sh, ct).data.numpy(), want)
            assert (ct.level, ct.scale) == (level, scale)


def test_key_of_another_level_raises(mesh1):
    ctx, rk, _, ct1, ct2 = worker.limb_inputs(worker.REF_PARAMS)
    sh = lo.LimbShard(mesh1)
    with pytest.raises(ValueError, match="shard it with shard_key"):
        t_ops.hmul(ctx, ct1, ct2, lo.shard_key(sh, ctx, rk, worker.LOW_LEVEL),
                   basis=sh)
    with pytest.raises(ValueError, match="unknown variant"):
        t_ops.hmul(ctx, ct1, ct2,
                   lo.shard_key(sh, ctx, rk, ctx.params.n_levels),
                   basis=lo.LimbShard(mesh1, "bus"))


# ---------------------------------------------------------------------------
# the uneven block rule
# ---------------------------------------------------------------------------

class _Stub:
    """The coordinates `layout.block` reads, for rank `index` of every
    axis in `shape`."""

    def __init__(self, shape, index):
        self.shape, self._index = shape, index

    def axis_size(self, axis):
        return self.shape[axis]

    def axis_index(self, axis):
        return self._index


@pytest.mark.parametrize("n,k,sizes", [
    (12, 8, [2, 2, 2, 2, 2, 2, 0, 0]),   # the keyswitch basis Q_7 ∪ P
    (7, 8, [1, 1, 1, 1, 1, 1, 1, 0]),    # after rescale from level 7
    (4, 8, [1, 1, 1, 1, 0, 0, 0, 0]),    # the special limbs
    (5, 4, [2, 2, 1, 0]),
    (8, 4, [2, 2, 2, 2]),                # even: n / k each, as before
    (3, 1, [3]),
    (0, 2, [0, 0])])
def test_block_rule(n, k, sizes):
    assert layout.block_sizes(n, k) == sizes
    x = torch.arange(2 * n * 3).reshape(2, n, 3)
    spec = (None, "model", None)
    blocks = [layout.local_block(x, spec, _Stub({"model": k}, i))
              for i in range(k)]
    assert [b.shape[1] for b in blocks] == sizes
    # contiguous and in rank order: the blocks concatenate to the whole
    assert torch.equal(torch.cat(blocks, dim=1), x)
    for i in range(k):
        r = layout.block_range(n, k, i)
        assert layout.block(n, _Stub({"model": k}, i), "model") == \
            slice(r.start, r.stop)
        # the rescale's last limb is broadcast from its owner
        assert all(layout.owner(n, k, j) == i for j in r)


def test_even_block_is_unchanged():
    """Where n divides, rank i holds [i·n/k, (i+1)·n/k), as before the
    uneven rule."""
    for n, k in [(8, 8), (8, 4), (24, 4), (21, 1), (12, 6)]:
        for i in range(k):
            assert layout.block(n, _Stub({"model": k}, i), "model") == \
                slice(i * n // k, (i + 1) * n // k)


def test_gather_and_regroup_world1(mesh1):
    """At world size 1 gather is the block itself and regroup needs no
    collective."""
    x = torch.arange(2 * 5 * 4).reshape(2, 5, 4)
    assert torch.equal(layout.gather(x, 5, mesh1), x)
    assert torch.equal(layout.regroup(x[:, :4], [4], 4, mesh1), x[:, :4])
    assert torch.equal(layout.gather_blocks(x, [5], mesh1, "model"), x)
