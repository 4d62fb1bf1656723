"""The banked-checkpoint gate: the JAX package's trained 256 px TwinGAN
(``docs/native256/ckpt_256.tar.gz``, ckpt-15000) translated by the port.

The tar holds no ``config.json``. It is rebuilt from the recipe that
trained it (``tools/quality_curves.py:329-347``: instance norm,
max_channels 128, eq-lr, pixel norm, two domains, UNet skips, the plain
GAN loss, Adam at 2e-4, l_cyc 5, l_content 0.1, no attention or spectral
norm), and confirmed by a strict match of every leaf's path and shape
against the restored tree. ``tools/orbax_to_torch_stage.py`` converts the
stage; then the port's ``translate`` and its ``run_eval --mode msssim``
are held against the JAX package's in float32 on the CPU (the run trained
in bfloat16, the compute type; the parameters are float32 either way).
"""

import dataclasses
import importlib.util
import os
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.evals import run_eval as jrun_eval  # noqa: E402
from twingan_tpu.models.config import PGGANConfig  # noqa: E402
from twingan_tpu.runner.checkpoint import CheckpointManager  # noqa: E402
from twingan_tpu.runner.checkpoint import save_config_snapshot  # noqa: E402
from twingan_tpu.runner.stage_runner import RunConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.evals import run_eval  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAR = os.path.join(REPO, "docs", "native256", "ckpt_256.tar.gz")
STEP = 15000
# Max abs difference of the float32 translations (output std about 0.17).
TRANSLATE_ATOL = 1e-4
MSSSIM_ATOL = 1e-5


def banked_config(dtype: str = "bfloat16") -> TwinGANConfig:
    """The trainer config of tools/quality_curves.py:329-347 at its
    defaults (no attention, spectral norm, remat or discriminator rate)."""
    return TwinGANConfig(
        model=PGGANConfig(resolution=256, max_channels=128, norm_type="instance_norm",
                          equalized_lr=True, do_pixel_norm=True, num_domains=2, dtype=dtype),
        loss=GanLossConfig(architecture="gan"), opt=OptimizerConfig(learning_rate=2e-4),
        batch_size=8, use_unet=True, l_cyc_weight=5.0, l_content_weight=0.1)


def shape_of(leaf):
    """A leaf's shape; an empty leaf (no Polyak average) stays as it is."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else leaf


@pytest.fixture(scope="module")
def banked(tmp_path_factory):
    root = tmp_path_factory.mktemp("banked")
    stage = str(root / "jax" / "256")
    os.makedirs(stage)
    with tarfile.open(TAR) as tar:
        tar.extractall(stage, filter="data")
    trainer = TwinGANTrainer(banked_config())
    template = jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))
    raw = CheckpointManager(stage).restore_dict(STEP)
    shapes = {k: shape_of(v) for k, v in flax.traverse_util.flatten_dict(
        flax.serialization.to_state_dict(template), sep="/").items()}
    restored = {k: shape_of(v) for k, v in flax.traverse_util.flatten_dict(
        raw, sep="/").items()}
    # float32 for the comparisons: the compute type only, the weights are
    # the same.
    cfg = banked_config("float32")
    save_config_snapshot(stage, {"run": RunConfig(program="twingan", start_hw=4, max_hw=256,
                                                  num_devices=1), "trainer": cfg})
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch_stage", os.path.join(REPO, "tools", "orbax_to_torch_stage.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    port_stage = str(root / "port" / "256")
    assert tool.convert_stage(stage, port_stage) == [STEP]
    state = flax.serialization.from_state_dict(
        jax.eval_shape(TwinGANTrainer(cfg).init_state, jax.random.PRNGKey(0)), raw)
    return dict(root=root, stage=stage, port_stage=port_stage, shapes=shapes,
                restored=restored, cfg=cfg, state=state)


def test_rebuilt_config_matches_the_restored_tree_exactly(banked):
    assert banked["restored"] == banked["shapes"]
    assert len(banked["shapes"]) == 621
    assert int(banked["state"].step) == STEP


def test_translate_matches_jax(banked):
    x = np.random.RandomState(0).rand(2, 256, 256, 3).astype(np.float32)
    trainer = TwinGANTrainer(banked["cfg"])
    inferer = ImageInferer(banked["port_stage"], device="cpu")
    assert inferer.step == STEP and inferer.cfg.model.dtype == "float32"
    assert dataclasses.asdict(inferer.cfg.model)["norm_type"] == "instance_norm"
    for direction in ("s2t", "t2s"):
        theirs = np.asarray(trainer.translate(banked["state"], jnp.asarray(x), direction))
        ours = inferer.translate(torch.from_numpy(x), direction).numpy()
        diff = float(np.abs(ours - theirs).max())
        print(f"banked ckpt-{STEP} {direction}: max abs diff {diff:.3g}, "
              f"output std {float(theirs.std()):.3g}")
        assert diff <= TRANSLATE_ATOL


def test_run_eval_msssim_matches_jax(banked, monkeypatch):
    seen = {}
    for name in ("msssim_eval", "pairwise_msssim"):
        orig = getattr(jrun_eval, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen[_name] = _orig(*a, **kw)
            return seen[_name]

        monkeypatch.setattr(jrun_eval, name, spy)
    args = ["--mode=msssim", "--use_synthetic_data", "--batch_size=2", "--num_images=4"]
    jrun_eval.main(args + [f"--model_path={banked['stage']}",
                           f"--eval_dir={banked['root'] / 'jax_eval'}"])
    result = run_eval.main(args + [f"--model_path={banked['port_stage']}",
                                   f"--eval_dir={banked['root'] / 'port_eval'}",
                                   "--device=cpu"])
    print(f"banked ckpt-{STEP} msssim: diversity {result['diversity']:.6f} "
          f"(JAX {seen['msssim_eval']:.6f}), fidelity {result['fidelity']:.6f} "
          f"(JAX {seen['pairwise_msssim']:.6f})")
    assert abs(result["diversity"] - seen["msssim_eval"]) <= MSSSIM_ATOL
    assert abs(result["fidelity"] - seen["pairwise_msssim"]) <= MSSSIM_ATOL
