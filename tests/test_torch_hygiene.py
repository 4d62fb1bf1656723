"""What the port may import and run where there is no card.

The card's machine has torch, numpy and the CUDA toolkit but no jax, flax,
PIL, cv2 or tensorflow, so neither twingan_tpu_torch nor chip_smoke.py may
load them (PIL only inside the functions that read or write image files or
decode JPEG, cv2 only inside the converters' blur filter, tensorflow only
inside the TF checkpoint reader and the SavedModel export); the data path decodes
PNG and resizes without them. Without a
card, chip_smoke.py and the port's entry points fail instead of falling
back to the CPU; and the port never routes attention to a library kernel.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "twingan_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "twingan_tpu", "PIL", "cv2", "tensorflow")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import twingan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(twingan_tpu_torch.__path__, "twingan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(",".join(names))
banned = sorted(m for m in sys.modules if m.split(".")[0] in {BANNED!r})
print("BANNED:" + ",".join(banned))
"""


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


# Modules every slice so far added; the walk must reach each of them.
EXPECTED_MODULES = (
    "twingan_tpu_torch.bridge", "twingan_tpu_torch.infer.translate",
    "twingan_tpu_torch.models.pggan", "twingan_tpu_torch.ops.attention",
    "twingan_tpu_torch.ops.cuda_build", "twingan_tpu_torch.ops.fused_conv",
    "twingan_tpu_torch.serve.clients", "twingan_tpu_torch.train.base",
    "twingan_tpu_torch.train.gan_trainer", "twingan_tpu_torch.train.losses",
    "twingan_tpu_torch.train.optimizers", "twingan_tpu_torch.train.state",
    "twingan_tpu_torch.train.twingan_trainer",
    "twingan_tpu_torch.native", "twingan_tpu_torch.data.example",
    "twingan_tpu_torch.data.tfrecord", "twingan_tpu_torch.data.png",
    "twingan_tpu_torch.data.datasets", "twingan_tpu_torch.data.converters",
    "twingan_tpu_torch.data.pipeline", "twingan_tpu_torch.data.preprocess",
    "twingan_tpu_torch.ops.swd", "twingan_tpu_torch.ops.msssim",
    "twingan_tpu_torch.evals.metrics", "twingan_tpu_torch.evals.gallery",
    "twingan_tpu_torch.evals.run_eval",
    "twingan_tpu_torch.data.resample", "twingan_tpu_torch.serve.haar",
    "twingan_tpu_torch.serve.face_detection", "twingan_tpu_torch.serve.server",
    "twingan_tpu_torch.utils.visualization", "twingan_tpu_torch.utils.image_io",
    "twingan_tpu_torch.models.classifiers", "twingan_tpu_torch.models.inception",
    "twingan_tpu_torch.models.nasnet", "twingan_tpu_torch.models.grad_cam",
    "twingan_tpu_torch.data.preprocessing_factory", "twingan_tpu_torch.utils.misc",
    "twingan_tpu_torch.train.classifier_trainer", "twingan_tpu_torch.runner.classifier_runner",
    "twingan_tpu_torch.ops.quant", "twingan_tpu_torch.infer.quantize",
    "twingan_tpu_torch.infer.export",
    "twingan_tpu_torch.parallel", "twingan_tpu_torch.parallel.mesh",
    "twingan_tpu_torch.parallel.multihost",
    "twingan_tpu_torch.models.plain_layers", "twingan_tpu_torch.models.dcgan",
    "twingan_tpu_torch.models.cyclegan", "twingan_tpu_torch.models.pix2pix",
    "twingan_tpu_torch.infer.import_tf", "twingan_tpu_torch.infer.savedmodel",
)


def test_port_and_smoke_import_nothing_the_card_lacks():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                          text=True, cwd=REPO, env=_no_card_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    names, banned = proc.stdout.strip().splitlines()[-2:]
    names = names.split(",")
    assert len(names) >= 40  # every module of the package was imported
    assert set(EXPECTED_MODULES) <= set(names), set(EXPECTED_MODULES) - set(names)
    assert banned == "BANNED:", banned


WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")


def test_parallel_package_and_worker_import_only_torch_numpy_and_the_port():
    """The processes of the multi-process tests run the worker script,
    which must not load JAX or the JAX package either."""
    code = f"""
import sys
sys.path.insert(0, {os.path.dirname(WORKER)!r})
import torch_parallel_worker
import twingan_tpu_torch.parallel
banned = sorted(m for m in sys.modules if m.split(".")[0] in {BANNED!r})
print("BANNED:" + ",".join(banned))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=_no_card_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "BANNED:"
    with open(WORKER) as fh:
        text = fh.read()
    for word in ("import jax", "import flax", "from twingan_tpu ", "from twingan_tpu.",
                 "import twingan_tpu\n"):
        assert word not in text, word


def test_every_kernel_source_is_built_by_the_package():
    csrc = os.path.join(PACKAGE, "csrc")
    sources = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))
    assert sources == ["conv_i8", "flash_attn_bwd", "flash_attn_fwd", "fused_conv"]
    from twingan_tpu_torch.ops import attention, fused_conv, quant

    assert {attention.KERNEL_NAME, attention.BWD_LIBRARY, fused_conv.KERNEL_NAME,
            quant.KERNEL_NAME} == set(sources)


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=REPO, env=_no_card_env(), timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=str(tmp_path), env=_no_card_env(), timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _port_sources():
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


@pytest.mark.parametrize("word", [
    "scaled_dot_product_attention", "torch.compile", "cpp_extension", "torch/extension.h",
    "import jax", "import flax", "from twingan_tpu ", "from twingan_tpu.", "import twingan_tpu\n",
])
def test_port_sources_avoid(word):
    hits = [path for path, text in _port_sources() if word in text]
    assert not hits, f"{word!r} in {hits}"
