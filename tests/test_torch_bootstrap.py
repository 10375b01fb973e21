"""Parity of the port's CKKS bootstrapping (repro_torch.core.bootstrap)
with the JAX reference (repro.core.bootstrap), on the CPU at
tests/test_bootstrap.py's parameters (log N 7, L 16, dnum 2, hamming
weight 16, Chebyshev degree 63, K = 6).

One bootstrap runs on each side. Every stage method of both
Bootstrappers is wrapped on the instance to record its inputs and output,
so ModRaise, CoefToSlot, both EvalMods and SlotToCoef are each held bit
for bit (``assert_array_equal`` on the limbs), inputs included, from the
one run. The host float matrices, their diagonals, the Chebyshev
coefficients and the keys the Bootstrapper draws are held exactly too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import Pair, eq_ct, eq_keys  # noqa: E402
from repro.core.bootstrap import BootstrapConfig as JConfig  # noqa: E402
from repro.core.bootstrap import Bootstrapper as JBootstrapper  # noqa: E402
from repro.core.params import CkksParams as JParams  # noqa: E402
from repro_torch.benchmarks import bootstrap_ring  # noqa: E402
from repro_torch.core.bootstrap import BootstrapConfig as TConfig  # noqa: E402
from repro_torch.core.bootstrap import \
    Bootstrapper as TBootstrapper  # noqa: E402
from repro_torch.core.params import CkksParams as TParams  # noqa: E402

PARAMS = dict(log_n=7, log_scale=25, n_levels=16, dnum=2, first_mod_bits=29,
              scale_mod_bits=25, special_mod_bits=29, hamming_weight_sk=16)
CONFIG = dict(eval_mod_degree=63, k_range=6.0)
SCALE = 2.0 ** 25
STAGES = ("mod_raise", "coef_to_slot", "eval_mod", "slot_to_coef")


def record(bts, log):
    """Wrap each stage method of one Bootstrapper instance so that its
    calls append (stage, ciphertext in, ciphertext out) to `log`."""
    for name in STAGES:
        fn = getattr(bts, name)

        def wrapped(ct, *args, _fn=fn, _name=name):
            out = _fn(ct, *args)
            log.append((_name, ct, out))
            return out
        setattr(bts, name, wrapped)


@pytest.fixture(scope="module")
def boot():
    p = Pair(JParams(**PARAMS), TParams(**PARAMS), seed=11)
    jbts = JBootstrapper(p.jctx, p.jcode, p.jenc, p.jsk, JConfig(**CONFIG))
    tbts = TBootstrapper(p.tctx, p.tcode, p.tenc, p.tsk, TConfig(**CONFIG))
    rng = np.random.default_rng(2)
    s = p.jctx.n // 2
    v = 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s))
    jct0, tct0 = p.encrypt(v, SCALE, 0)
    jlog, tlog = [], []
    record(jbts, jlog)
    record(tbts, tlog)
    jout = jbts.bootstrap(jct0, PARAMS["n_levels"])
    tout = tbts.bootstrap(tct0, PARAMS["n_levels"])
    return dict(p=p, jbts=jbts, tbts=tbts, v=v, ct0=(jct0, tct0),
                jlog=jlog, tlog=tlog, out=(jout, tout))


def calls(boot, stage):
    j = [(i, o) for name, i, o in boot["jlog"] if name == stage]
    t = [(i, o) for name, i, o in boot["tlog"] if name == stage]
    assert len(j) == len(t) >= 1
    return list(zip(j, t))


def test_host_matrices_and_coefficients_equal(boot):
    j, t = boot["jbts"], boot["tbts"]
    for name in ("A_cts", "B_cts", "A_stc", "B_stc", "cheb"):
        assert np.array_equal(getattr(j, name), getattr(t, name)), name
    for name in ("diags_A_cts", "diags_B_cts", "diags_A_stc", "diags_B_stc"):
        jd, td = getattr(j, name), getattr(t, name)
        assert sorted(jd) == sorted(td), name
        for d in jd:
            assert np.array_equal(jd[d], td[d]), (name, d)


def test_bootstrapper_keys_bit_equal(boot):
    j, t = boot["jbts"], boot["tbts"]
    eq_keys(j.gks, t.gks)
    eq_keys({0: j.rk}, {0: t.rk})


@pytest.mark.parametrize("stage", STAGES)
def test_stage_bit_equal(boot, stage):
    for (ji, jo), (ti, to) in calls(boot, stage):
        eq_ct(ji, ti)
        eq_ct(jo, to)


def test_mod_raise_levels(boot):
    """A direct ModRaise to another level, as tests/test_bootstrap.py's
    bookkeeping check: same limbs, level 6, 7 limbs."""
    jct0, tct0 = boot["ct0"]
    jr = boot["jbts"].mod_raise(jct0, 6)
    tr = boot["tbts"].mod_raise(tct0, 6)
    eq_ct(jr, tr)
    assert tr.level == 6 and tr.data.shape[-2] == 7


def test_full_bootstrap_bit_equal(boot):
    jout, tout = boot["out"]
    eq_ct(jout, tout)
    assert tout.level >= 2, "bootstrap must return usable levels"
    err = np.abs(boot["p"].decode(tout) - boot["v"]).max()
    assert err < 0.05, f"bootstrap error too large: {err}"


def test_ring_benchmark_is_the_reference_bootstrap(boot):
    """benchmarks/bootstrap_ring.py (which chip_smoke.py runs on the card)
    draws the same keys and slots at log N 7: its output is the
    reference's bootstrap, bit for bit."""
    times = {}
    out, err = bootstrap_ring.run_bootstrap(torch.device("cpu"), 7, times)
    eq_ct(boot["out"][0], out)
    assert err == np.abs(boot["p"].decode(boot["out"][1]) - boot["v"]).max()
    assert set(times) >= {"setup", "total", *STAGES}
    assert times["galois_keys"] == len(boot["jbts"].gks)
