"""A DCGAN stage through the port's ``StageRunner`` and its CLI, on the
CPU (JAX ``tests/test_runner.py``'s DCGAN case; ``test_torch_alt_trainer.py``
holds the steps to the JAX package): the stage's steps, checkpoint,
``model.pt``, its sample grid (a latent interpolation) and in-training
SWD, skipping a finished stage and restoring its checkpoint; and
``pggan_runner --generator_network=dcgan|cyclegan``."""

import os

import pytest

torch = pytest.importorskip("torch")

from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner import pggan_runner  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import CheckpointManager  # noqa: E402
from twingan_tpu_torch.runner.stage_runner import RunConfig, StageRunner  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GEN, GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402

from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)


def dcgan_run_cfg(tmp_path, res):
    trainer = GanTrainerConfig(
        model=PGGANConfig(resolution=res, max_channels=16), batch_size=4,
        opt=OptimizerConfig(learning_rate=1e-3), generator_network="dcgan",
        dcgan_depth=8, dcgan_latent_dim=8)
    return RunConfig(program="image_generation", train_dir=str(tmp_path / "dcgan"),
                     start_hw=res, max_hw=res, num_images_per_resolution=12,
                     batch_schedule={res: 4}, use_synthetic_data=True, trainer=trainer,
                     log_every_n_steps=1, save_every_n_steps=2, keep_checkpoints=2,
                     log_image_every_n_iter=2, eval_every_n_iter_in_training=2,
                     log_image_n_per_hw=3)


def test_dcgan_single_stage_run(tmp_path, capsys):
    """One fixed-resolution DCGAN stage through the runner (JAX
    ``tests/test_runner.py``'s case at 16 px): 3 steps, its checkpoint,
    its sample grid (a latent interpolation) and its in-training SWD;
    then a second call skips the finished stage, and a fresh runner
    resumes from its checkpoint with the same state."""
    cfg = dcgan_run_cfg(tmp_path, 16)
    summary = StageRunner(cfg, device="cpu").run()
    assert summary["16"]["steps"] == 3
    stage_dir = os.path.join(cfg.train_dir, "16")
    cm = CheckpointManager(stage_dir)
    assert cm.latest_step() == 3
    assert os.path.isfile(os.path.join(stage_dir, "model.pt"))
    assert os.path.isfile(os.path.join(stage_dir, "generated_samples", "2.png"))
    assert os.path.isfile(os.path.join(stage_dir, "swd_in_training_2.txt"))
    assert "failed" not in capsys.readouterr().out
    again = StageRunner(cfg, device="cpu").run()
    assert again["16"]["skipped"]
    trainer = GanTrainer(dcgan_run_cfg(tmp_path, 16).trainer.replace(batch_size=4),
                         device="cpu")
    restored = cm.restore(trainer.init_state(1))
    assert restored.step == 3 and "deconv1_bn.mean" in dict(restored.nets[GEN].named_buffers())


@pytest.mark.parametrize("network", ["dcgan", "cyclegan"])
def test_cli_trains_the_network(tmp_path, capsys, network):
    """``pggan_runner --generator_network`` trains one 16 px stage of either
    network at the CLI's widths (depth or filters 64) with its sample
    grids and in-training SWD: DCGAN's from latents, CycleGAN's from the
    source images its synthetic batches carry."""
    train_dir = tmp_path / network
    summary = pggan_runner.main([
        f"--train_dir={train_dir}", "--device=cpu", "--use_synthetic_data=true",
        "--program_name=image_generation", f"--generator_network={network}",
        "--start_hw=16", "--max_hw=16", "--num_images_per_resolution=8", "--batch_size=4",
        "--log_image_every_n_iter=1", "--eval_every_n_iter_in_training=1"])
    assert summary["16"]["steps"] == 2
    stage_dir = train_dir / "16"
    assert os.path.isfile(stage_dir / "model.pt")
    for step in (1, 2):
        assert os.path.isfile(stage_dir / "generated_samples" / f"{step}.png")
        assert os.path.isfile(stage_dir / f"swd_in_training_{step}.txt")
    assert "failed" not in capsys.readouterr().out
