"""Import and device hygiene of the PyTorch port (src/repro_torch).

* The port and chip_smoke.py import neither jax nor the JAX package.
* Its entry points run on CUDA unless asked for the CPU, and raise when
  there is no CUDA device instead of carrying on on the CPU.
* A kernel wrapper launches its kernel or raises: tensors on a device it
  has no route for are refused before any launch, and a library that
  cannot be built (no nvcc) raises.
"""
import ast
import importlib
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.kernels import bconv as bc  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import keyswitch as ks  # noqa: E402
from repro_torch.kernels import modmul as mm  # noqa: E402
from repro_torch.kernels import ntt as kntt  # noqa: E402
from repro_torch.kernels.ref import FourStepTables  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
CHIP_SMOKE = os.path.join(ROOT, "chip_smoke.py")


def imported_roots(path):
    """Top-level module names a file imports (absolute imports)."""
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys\n"
            "import repro_torch, repro_torch.launch.serve_fhe\n"
            "import repro_torch.runtime.ciphertext_backend\n"
            "import repro_torch.kernels.keyswitch, repro_torch.kernels.ops\n"
            "import repro_torch.kernels.bconv, repro_torch.kernels.ntt\n"
            "import repro_torch.kernels.ref\n"
            "import repro_torch.benchmarks.fig14_kernels\n"
            "import repro_torch.core.linalg, repro_torch.core.bootstrap\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.lola_mnist\n"
            "import repro_torch.examples.helr_training\n"
            "import repro_torch.examples.sorting\n"
            "import repro_torch.obs, repro_torch.pim, repro_torch.fleet\n"
            "import repro_torch.analysis, repro_torch.analysis.lint\n"
            "import repro_torch.analysis.mutate, repro_torch.launch.mesh\n"
            "import repro_torch.fhe_dist.collective_bconv\n"
            "import repro_torch.fhe_dist.pipeline_exec\n"
            "import repro_torch.models, repro_torch.models.model\n"
            "import repro_torch.configs, repro_torch.launch.serve\n"
            "import repro_torch.launch.train, repro_torch.data.pipeline\n"
            "import repro_torch.train.optim, repro_torch.train.checkpoint\n"
            "import repro_torch.train.fault, repro_torch.train.compress\n"
            "import repro_torch.compat, repro_torch.sharding.rules\n"
            "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.roofline\n"
            "from repro_torch.configs import get_config, list_archs\n"
            "[get_config(a, smoke=s).param_count() for a in list_archs()\n"
            " for s in (False, True)]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_import_no_reference():
    files = list(port_files())
    assert len(files) > 30
    walked = {os.path.relpath(f, PKG) for f in files}
    assert {"core/linalg.py", "core/bootstrap.py", "examples/__init__.py",
            "examples/quickstart.py", "examples/lola_mnist.py",
            "examples/helr_training.py", "examples/sorting.py",
            "obs/log.py", "obs/telemetry.py", "obs/openmetrics.py",
            "obs/perfetto.py", "obs/critical_path.py", "pim/__init__.py",
            "pim/arch.py", "pim/isa.py", "pim/layout.py", "pim/lower.py",
            "pim/backend.py", "fleet/__init__.py", "fleet/device.py",
            "fleet/router.py", "fleet/scheduler.py", "analysis/__init__.py",
            "analysis/findings.py", "analysis/verify_ir.py",
            "analysis/verify_schedule.py", "analysis/pim_hazards.py",
            "analysis/mutate.py", "analysis/lint.py", "fhe_dist/__init__.py",
            "fhe_dist/layout.py", "fhe_dist/collective_bconv.py",
            "fhe_dist/pipeline_exec.py", "launch/mesh.py",
            "models/__init__.py", "models/config.py", "models/layers.py",
            "models/attention.py", "models/moe.py", "models/recurrent.py",
            "models/model.py", "configs/__init__.py", "configs/qwen3_8b.py",
            "configs/deepseek_v3_671b.py", "launch/serve.py",
            "launch/train.py", "data/__init__.py", "data/pipeline.py",
            "train/__init__.py", "train/optim.py", "train/checkpoint.py",
            "train/fault.py", "train/compress.py", "compat.py",
            "sharding/__init__.py", "sharding/rules.py", "launch/specs.py",
            "launch/dryrun.py", "launch/roofline.py"} <= walked
    for path in files + [CHIP_SMOKE]:
        bad = imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, (path, bad)


def test_chip_smoke_imports_only_port_torch_numpy_stdlib():
    allowed = {"repro_torch", "torch", "numpy", "__future__"}
    extra = imported_roots(CHIP_SMOKE) - allowed - set(
        sys.stdlib_module_names)
    assert not extra, extra


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no CUDA device, the defaults raise instead of running on the
    CPU; an explicit CPU request runs."""
    from repro_torch.benchmarks import fig14_kernels
    from repro_torch.compiler.engine import CkksEngine
    from repro_torch.core.context import CkksContext
    from repro_torch.launch import mesh, serve_fhe
    from repro_torch.runtime.ciphertext_backend import CiphertextBackend
    from repro_torch.runtime.executor import MeshBackend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = t_test_params(log_n=6, n_levels=2, dnum=1)
    for make in (lambda: CkksEngine(params), lambda: CkksContext(params),
                 lambda: CiphertextBackend(params),
                 lambda: CkksEngine(params, device="cuda"),
                 lambda: MeshBackend(), lambda: mesh.make_host_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for argv in (["--smoke"], ["--smoke", "--backend", "ciphertext"],
                 ["--smoke", "--fleet", "2", "--backend", "ciphertext"],
                 ["--smoke", "--fleet", "4", "--backend", "pim"],
                 ["--smoke", "--backend", "mesh"],
                 ["--smoke", "--backend", "mesh", "--verify"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_fhe.main(argv)
    for argv in (["--smoke"], ["--smoke", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fig14_kernels.main(argv)
    for name in ("quickstart", "lola_mnist", "helr_training", "sorting"):
        example = importlib.import_module(f"repro_torch.examples.{name}")
        for argv in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                example.main(argv)
    assert CkksContext(params, device="cpu").device.type == "cpu"
    assert not torch.distributed.is_initialized()
    assert CiphertextBackend(params, device="cpu").use_kernels is False


def test_deep_workloads_refuse_cpu_fallback(monkeypatch):
    """Without CUDA, Bootstrapper and matvec_bsgs on a default-device
    context raise (the context resolves the device once, and refuses a
    missing CUDA device) instead of running on the CPU; on a context that
    asks for the CPU they run there."""
    import numpy as np
    from repro_torch.core import linalg
    from repro_torch.core.bootstrap import Bootstrapper
    from repro_torch.core.ciphertext import Plaintext
    from repro_torch.core.context import CkksContext
    from repro_torch.core.encoder import CkksEncoder
    from repro_torch.core.encryptor import CkksEncryptor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = t_test_params(log_n=6, n_levels=2, dnum=1)
    ctx = CkksContext(params, device="cpu")
    enc, encr = CkksEncoder(ctx), CkksEncryptor(ctx, seed=1)
    sk = encr.keygen()
    scale = 2.0 ** params.log_scale
    ct = encr.encrypt_sk(Plaintext(enc.encode(np.ones(params.slots), scale,
                                              2), 2, scale), sk)
    diags = {1: np.ones(params.slots)}
    gks = encr.galois_keygen(sk, linalg.matvec_keys_needed(ctx, diags))
    out = linalg.matvec_bsgs(ctx, ct, diags, gks, enc)
    assert out.level == 1 and out.data.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Bootstrapper(CkksContext(params), enc, encr, sk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linalg.matvec_bsgs(CkksContext(params), ct, diags, gks, enc)


def test_llm_serve_refuses_cpu_fallback(monkeypatch, capsys):
    """The LLM serve entry point and DecodeModel raise without CUDA unless
    asked for the CPU; asked for the CPU they run there."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import DecodeModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--arch", "qwen3-8b", "--smoke", "--batch", "1",
             "--prompt-len", "2", "--gen", "1"]
    for argv in (small, small + ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeModel(get_config("qwen3-8b", smoke=True))
    assert serve.main(small + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(
        "arch=qwen3-smoke generated (1, 1) tokens")
    model = DecodeModel(get_config("rwkv6-3b", smoke=True), "cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_llm_train_refuses_cpu_fallback(monkeypatch, capsys, tmp_path):
    """The LLM train entry point raises without CUDA unless asked for the
    CPU, and starts no process group before it raises; asked for the CPU
    it trains there and leaves no group behind."""
    from repro_torch.launch import train
    from repro_torch.models.model import tree_items
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--arch", "qwen3-8b", "--smoke", "--batch", "1", "--seq", "4",
             "--steps", "1", "--ckpt-dir", str(tmp_path)]
    for argv in (small, small + ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(argv)
    assert not torch.distributed.is_initialized()
    res = train.main(small + ["--device", "cpu"])
    assert capsys.readouterr().out.startswith("arch=qwen3-smoke params~")
    assert len(res.history) == 1 and not torch.distributed.is_initialized()
    assert {t.device.type for _, t in tree_items(res.params)} == {"cpu"}


def test_roofline_measure_refuses_cpu_fallback(monkeypatch, tmp_path):
    """The roofline's --measure runs one real step: without CUDA it raises
    unless asked for the CPU. The dry run and the roofline's counts need
    no device (meta tensors)."""
    from repro_torch.launch import roofline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--arch", "qwen3-8b", "--shape", "train_4k", "--measure",
             "--smoke", "--batch", "1", "--seq", "4", "--out",
             str(tmp_path / "r.jsonl")]
    for argv in (small, small + ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.main(argv)
    assert roofline.main(small + ["--device", "cpu"]) == 0


def _kernel_calls(device, n=64):
    """Every kernel wrapper, called with well-formed operands on
    `device` (small shapes: l=3 Q limbs, 2 special, 2 digits of 2)."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    b, l, n_p, t_n = 2, 3, 2, 5
    kt = kntt.FourStepKernelTables(FourStepTables(257, 3, 4, 2), device)
    return {
        "intt_scale": lambda: ks.intt_scale(z(b, l, n), 0, l, z(l, n),
                                            z(l), z(l), z(l)),
        "bconv_ntt_mulacc": lambda: ks.bconv_ntt_mulacc(
            z(b, l, n), z(2, 2, t_n), z(t_n, n), z(t_n), z(t_n),
            z(2, 2, t_n, n), 2),
        "moddown": lambda: ks.moddown(z(2 * b, t_n, n), z(2 * b, n_p, n),
                                      z(n_p, l), z(t_n, n), z(t_n), z(t_n),
                                      z(l)),
        "modmul": lambda: mm.modmul_mont(
            z(2 * l, n, dtype=torch.int64), z(l, n), z(l), z(l)),
        "mulacc": lambda: mm.mulacc_mont(
            z(2 * l, n, dtype=torch.int64), z(l, n),
            z(2 * l, n, dtype=torch.int64), z(l), z(l)),
        "bconv": lambda: bc.bconv_mont(z(l, n, dtype=torch.int64),
                                       z(t_n, l), z(t_n), z(t_n)),
        "bconv_lazy": lambda: bc.bconv_mont(z(l, n, dtype=torch.int64),
                                            z(t_n, l), z(t_n), z(t_n),
                                            lazy=True),
        "ntt_col": lambda: kntt.ntt_col(z(16, dtype=torch.int64), kt, 2),
        "ntt_row": lambda: kntt.ntt_row(z(4, 4), kt, 2),
    }


@pytest.mark.parametrize("name", ["intt_scale", "bconv_ntt_mulacc",
                                  "moddown", "modmul", "mulacc", "bconv",
                                  "bconv_lazy", "ntt_col", "ntt_row"])
def test_wrapper_refuses_device_without_route(name):
    """A device that is neither the CPU (plain version) nor CUDA (the
    kernel) is refused before any library is loaded or launch made."""
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _kernel_calls("meta")[name]()
    assert _kernel_calls("cpu")[name]() is not None


def test_wrapper_checks_operands():
    z = torch.zeros((3, 64), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        mm.modmul_mont(z, z, z[:, 0].contiguous(), z[:, 0].contiguous())
    a = torch.zeros((6, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="not contiguous"):
        mm.modmul_mont(a, z.t().contiguous().t(), z[:, 0].contiguous(),
                       z[:, 0].contiguous())
    with pytest.raises(ValueError, match="do not tile"):
        mm.modmul_mont(a[:5], z, z[:, 0].contiguous(), z[:, 0].contiguous())
    with pytest.raises(ValueError, match="power of two"):
        ks.intt_scale(torch.zeros((1, 1, 48), dtype=torch.int32), 0, 1,
                      torch.zeros((1, 48), dtype=torch.int32),
                      *[torch.zeros(1, dtype=torch.int32)] * 3)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("modmul.cu")
    assert not list(tmp_path.iterdir())
