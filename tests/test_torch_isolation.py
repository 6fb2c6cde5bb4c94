"""The port stands alone: no JAX, no flax, nothing of `horovod_tpu`, no
PyYAML.

`horovod_tpu_torch` and `chip_smoke.py` must run on a machine that has no
JAX and no PyYAML at all, so an AST scan refuses any such import (static
or through ``importlib``), and a fresh interpreter importing every port
module must not have loaded ``jax`` or ``yaml`` (job specs are read by
`launch.specfile`). Entry points default to the card and refuse to
carry on silently on the CPU; ``chip_smoke.py`` prints no result without
CUDA or without the package beside it.
"""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu", "yaml")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            horovod_tpu_torch.__path__, "horovod_tpu_torch."
        )
    )


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            arg = node.args[0]
            if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                    and getattr(node.func, "attr", getattr(node.func, "id", ""))
                    in ("import_module", "__import__")
                    and _forbidden(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_every_module_imports_here():
    for m in _modules():
        importlib.import_module(m)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-card refusal is not testable")


def test_entry_points_default_to_cuda_and_refuse_cpu_fallback(no_cuda,
                                                               tmp_path,
                                                               monkeypatch):
    from horovod_tpu_torch.launch.serve import make_server
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import export_generate, load_generate

    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(vocab_size=16, d_model=8, n_heads=2, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.resolve_device("cuda")
    m = TransformerLM(vocab_size=16, d_model=8, n_heads=2, n_layers=1,
                      device="cpu")
    d = export_generate(str(tmp_path), m, batch_size=1, prompt_len=4,
                        max_new_tokens=2, streaming_chunk=1, timestamp="t")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_generate(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.Trainer(m, horovod_tpu_torch.adamw(1e-3))
    assert horovod_tpu_torch.resolve_device("cpu").type == "cpu"

    # The MNIST data-parallel slice's entry points.
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.models.cnn import MnistCNN

    with pytest.raises(RuntimeError, match="CUDA"):
        MnistCNN()
    cnn = MnistCNN(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.Trainer(cnn, horovod_tpu_torch.adam(1e-3))
    for name in ("HVT_COORDINATOR_ADDRESS", "HVT_NUM_PROCESSES",
                 "HVT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.init()
    assert not horovod_tpu_torch.is_initialized()
    bundle = checkpoint.export_serving(str(tmp_path / "export"), cnn,
                                       input_shape=(1, 28, 28, 1),
                                       timestamp="t")
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_serving(bundle)
    assert checkpoint.load_serving(bundle, device="cpu")(
        np.zeros((3, 28, 28, 1), np.float32)).shape == (3, 10)


def test_training_modules_are_scanned():
    """The scans above reach the training slice's subpackages."""
    mods = _modules()
    for m in ("horovod_tpu_torch.training.trainer",
              "horovod_tpu_torch.training.optimizer",
              "horovod_tpu_torch.training.train_state",
              "horovod_tpu_torch.data.datasets",
              "horovod_tpu_torch.ops.fused_ce"):
        assert m in mods
    assert os.path.join(PKG, "training", "trainer.py") in _port_files()


@pytest.mark.parametrize("sub", ["parallel", "examples", "launch"])
def test_data_parallel_subpackages_are_scanned(sub):
    """The MNIST data-parallel slice's subpackages are in both scans: every
    module of them is imported by the fresh interpreter, and every file is
    parsed for forbidden imports."""
    mods = _modules()
    names = [n[:-3] for n in os.listdir(os.path.join(PKG, sub))
             if n.endswith(".py")]
    assert names
    for name in names:
        mod = f"horovod_tpu_torch.{sub}" + ("" if name == "__init__"
                                            else f".{name}")
        assert mod in mods
        assert os.path.join(PKG, sub, f"{name}.py") in _port_files()


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_fails_without_cuda(no_cuda):
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("entry", ["resnet", "vit", "trainer"])
def test_cifar_slice_entry_points_refuse_cpu_fallback(no_cuda, entry):
    """The CIFAR slice's models and their trainer default to the card and
    raise without CUDA; the CPU runs only when named."""
    from horovod_tpu_torch.models.resnet import ResNetCIFAR
    from horovod_tpu_torch.models.vit import ViT

    make = {"resnet": lambda **kw: ResNetCIFAR(depth=8, **kw),
            "vit": lambda **kw: ViT(d_model=16, n_heads=2, n_layers=1, **kw),
            "trainer": lambda **kw: horovod_tpu_torch.Trainer(
                ResNetCIFAR(depth=8, device="cpu"),
                horovod_tpu_torch.adam(1e-3), **kw)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu") is not None


def test_cifar_slice_modules_are_scanned():
    mods = _modules()
    for m in ("horovod_tpu_torch.models.resnet",
              "horovod_tpu_torch.models.vit",
              "horovod_tpu_torch.examples.cifar10_resnet"):
        assert m in mods
        path = os.path.join(REPO, *m.split(".")) + ".py"
        assert path in _port_files()


DECODE_MODULES = ("data.tokenizer", "models.quant", "models.speculative",
                  "models.beam", "models.decoding", "examples.lm_generate")


@pytest.mark.parametrize("name", DECODE_MODULES)
def test_decode_slice_modules_are_scanned(name):
    """The decode slice's modules are in both scans (imported by the fresh
    interpreter, parsed for forbidden imports)."""
    assert f"horovod_tpu_torch.{name}" in _modules()
    path = os.path.join(PKG, *name.split(".")) + ".py"
    assert path in _port_files()


def test_decode_slice_entry_points_refuse_cpu_fallback(no_cuda, tmp_path,
                                                       monkeypatch):
    """The twin defaults to the card and raises without CUDA; a bundle with
    a tokenizer and the int8 knobs loads onto the card by default too."""
    from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer
    from horovod_tpu_torch.examples import lm_generate
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import export_generate, load_generate

    monkeypatch.delenv("HVT_DEVICE", raising=False)
    for name in ("HVT_COORDINATOR_ADDRESS", "HVT_NUM_PROCESSES",
                 "HVT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_generate.main()
    m = TransformerLM(vocab_size=300, d_model=8, n_heads=2, n_layers=1,
                      device="cpu")
    tok = ByteBPETokenizer.train(["a b a b c"], 260)
    d = export_generate(str(tmp_path), m, batch_size=1, prompt_len=4,
                        max_new_tokens=2, tokenizer=tok, quantized_cache=True,
                        speculative_gamma=2, timestamp="t")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_generate(d)
    assert load_generate(d, device="cpu").generate_text(["a b"])


SERVE_TIER_MODULES = ("obs", "obs.core", "obs.prom", "obs.server",
                      "serving.router", "launch.serve")


@pytest.mark.parametrize("name", SERVE_TIER_MODULES)
def test_serving_tier_modules_are_scanned(name):
    """The serving tier's modules are in both scans (imported by the fresh
    interpreter, parsed for forbidden imports)."""
    assert f"horovod_tpu_torch.{name}" in _modules()
    path = os.path.join(PKG, *name.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert path in _port_files()


def test_serving_tier_entry_points_refuse_cpu_fallback(no_cuda, tmp_path):
    """A predict bundle's server and the launched server default to the
    card and raise without CUDA; the CPU serves only when named."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.launch.serve import make_server
    from horovod_tpu_torch.models.cnn import MnistCNN

    bundle = checkpoint.export_serving(
        str(tmp_path), MnistCNN(device="cpu"), input_shape=(2, 28, 28, 1),
        timestamp="t")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(bundle)
    srv = make_server(bundle, device="cpu")
    srv.server_close()
    srv.app.close()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.launch.serve", bundle,
         "--port", "0", "--host", "127.0.0.1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert "serving" not in proc.stdout


REDUCTION_MODULES = ("training.zero1", "training.optimizer",
                     "parallel.collectives", "parallel.mesh")


@pytest.mark.parametrize("name", REDUCTION_MODULES)
def test_reduction_slice_modules_are_scanned(name):
    """The sharded and quantized reduction's modules are in both scans."""
    assert f"horovod_tpu_torch.{name}" in _modules()
    path = os.path.join(PKG, *name.split(".")) + ".py"
    assert path in _port_files()


def test_reduction_entry_points_refuse_cpu_fallback(no_cuda):
    """A ZeRO-1, int8-wire Trainer defaults to the card and raises without
    CUDA; it runs on the CPU only when named."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.transformer import TransformerLM

    m = TransformerLM(vocab_size=16, d_model=8, n_heads=2, n_layers=1,
                      device="cpu")
    tx = ht.DistributedOptimizer(ht.adamw(1e-3), compression="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Trainer(m, tx, loss="module", shard_update=True)
    assert ht.Trainer(m, tx, loss="module", shard_update=True,
                      device="cpu").device.type == "cpu"


LAUNCH_LAYER_MODULES = ("analysis", "analysis.registry", "launch.ci_gate",
                        "launch.specfile", "launch.launcher",
                        "launch.supervisor", "launch.job", "testing",
                        "testing.faults", "training.callbacks")


@pytest.mark.parametrize("name", LAUNCH_LAYER_MODULES)
def test_launch_layer_modules_are_scanned(name):
    """The launch layer's modules are in both scans (imported by the fresh
    interpreter, parsed for forbidden imports, PyYAML included)."""
    assert f"horovod_tpu_torch.{name}" in _modules()
    path = os.path.join(PKG, *name.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert path in _port_files()


def test_no_port_module_imports_yaml():
    """PyYAML is absent on the card's machine: the scan refuses it."""
    assert _forbidden("yaml") and _forbidden("yaml.loader")
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not any(n.split(".")[0] == "yaml" for n in names), path


MOE_SLICE_MODULES = ("models.moe", "models.transformer", "parallel.mesh",
                     "models.convert", "training.train_state")


@pytest.mark.parametrize("name", MOE_SLICE_MODULES)
def test_moe_slice_modules_are_scanned(name):
    """The mesh and MoE slice's modules are in both scans."""
    assert f"horovod_tpu_torch.{name}" in _modules()
    assert os.path.join(PKG, *name.split(".")) + ".py" in _port_files()


def test_moe_entry_points_refuse_cpu_fallback(no_cuda):
    """An MoE model and a mesh Trainer default to the card and raise
    without CUDA; they run on the CPU only when named."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import mesh

    kw = dict(vocab_size=16, d_model=8, n_heads=2, n_layers=2, moe_every=2,
              n_experts=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(**kw)
    m = TransformerLM(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Trainer(m, ht.adamw(1e-3), loss="module",
                   mesh=mesh.build_mesh())
    assert ht.Trainer(m, ht.adamw(1e-3), loss="module",
                      mesh=mesh.build_mesh(), device="cpu").dp == 1
