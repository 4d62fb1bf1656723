"""The port's stage runner on real data, against the JAX runner, on the CPU.

Shards written by the JAX converter (JPEG, images of two shapes, so PAD
resamples) train PGGAN generation 4 -> 8 -> 16 px in both packages, with
the in-training SWD every step. Every raw (pre-augmentation) batch the
port's stages feed the augmentation equals the JAX runner's, stage by
stage; a run that streams through the ``DevicePrefetcher``
(``device_resident_gb=0``) sees the same batches as the device-resident
one and ends in the same state, also with ``rounds_per_scan=2``; the
``swd_in_training_<step>.txt`` files have the JAX layout at every step
from 16 px on. Real data and the in-training SWD no longer raise. A
TwinGAN stage on two domains is in ``test_torch_runner_realdata_twingan.py``
(a file of its own, so that its JAX compiles land on another worker).
Widths 8, batch 2, 2 steps a stage; the summary writers are stubbed out
(their TensorFlow import alone takes about 11 s, and nothing here reads
the logs).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

from twingan_tpu.data import converters as jconverters  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.runner import stage_runner as jstage_runner  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402

from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner import stage_runner  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import load_model  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig  # noqa: E402

GEN_MODEL = dict(max_channels=8, norm_type="none", do_pixel_norm=True, equalized_lr=True)
TWIN_MODEL = dict(max_channels=8, num_domains=2)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("realdata")
    rng = np.random.RandomState(0)
    for dom in ("a", "b"):
        imgs = root / f"imgs_{dom}"
        imgs.mkdir()
        for i in range(7):
            h, w = (24, 24) if i % 2 else (28, 20)
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
                str(imgs / f"{i}.png"))
        jconverters.convert_image_folder(str(imgs), str(root / dom), num_shards=2)
    return root


def run_kw(root, program, name, start_hw, max_hw, **kw):
    out = dict(program=program, train_dir=str(root / name), start_hw=start_hw, max_hw=max_hw,
               num_images_per_resolution=4, batch_schedule={4: 2, 8: 2, 16: 2},
               dataset_dir=str(root / "a"), log_every_n_steps=1, save_every_n_steps=2,
               keep_checkpoints=2, log_image_every_n_iter=0, eval_every_n_iter_in_training=1,
               seed=1)
    if program == "twingan":
        out["target_dataset_dir"] = str(root / "b")
    out.update(kw)
    return out


class NullWriter:
    def scalars(self, step, values):
        pass

    def histograms(self, step, values):
        pass

    def images(self, step, tag, images):
        pass

    def close(self):
        pass


def recording(module, monkeypatch, jax_signature: bool):
    """Every raw image batch the runner hands ``augment_batch``, per call
    (and no summary files)."""
    monkeypatch.setattr(module, "SummaryWriter", lambda *a, **kw: NullWriter())
    seen = []
    orig = module.augment_batch

    def spy(*args, **kw):
        images = args[1] if jax_signature else args[0]
        seen.append(np.asarray(images) if jax_signature else images.cpu().numpy())
        return orig(*args, **kw)

    monkeypatch.setattr(module, "augment_batch", spy)
    return seen


def jax_run(root, monkeypatch, program, name, start_hw, max_hw):
    kw = run_kw(root, program, name, start_hw, max_hw, num_devices=1)
    opt = JaxOptimizerConfig(learning_rate=1e-3)
    if program == "twingan":
        trainer = JaxTwinGANConfig(model=JaxPGGANConfig(resolution=start_hw, **TWIN_MODEL),
                                   batch_size=2, opt=opt)
    else:
        trainer = JaxGanTrainerConfig(model=JaxPGGANConfig(resolution=start_hw, **GEN_MODEL),
                                      batch_size=2, opt=opt)
    seen = recording(jstage_runner, monkeypatch, True)
    jstage_runner.StageRunner(jstage_runner.RunConfig(trainer=trainer, **kw)).run()
    monkeypatch.undo()
    return seen


def port_run(root, monkeypatch, program, name, start_hw, max_hw, **extra):
    kw = run_kw(root, program, name, start_hw, max_hw, **extra)
    opt = OptimizerConfig(learning_rate=1e-3)
    if program == "twingan":
        trainer = TwinGANConfig(model=PGGANConfig(resolution=start_hw, **TWIN_MODEL),
                                batch_size=2, opt=opt)
    else:
        trainer = GanTrainerConfig(model=PGGANConfig(resolution=start_hw, **GEN_MODEL),
                                   batch_size=2, opt=opt)
    seen = recording(stage_runner, monkeypatch, False)
    runner = stage_runner.StageRunner(stage_runner.RunConfig(trainer=trainer, **kw),
                                      device="cpu")
    summary = runner.run()
    monkeypatch.undo()
    return seen, summary


def same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def swd_layout(path):
    lines = open(path).read().splitlines()
    return lines[:2], [line.split("\t")[0] for line in lines[2:]], [
        len(line.split("\t")) for line in lines[2:]]


STAGES = ("4", "4to8", "8", "8to16", "16")


@pytest.fixture(scope="module")
def generation_runs(shards):
    mp = pytest.MonkeyPatch()
    try:
        theirs = jax_run(shards, mp, "image_generation", "jax", 4, 16)
        resident, summary = port_run(shards, mp, "image_generation", "resident", 4, 16)
        streaming, _ = port_run(shards, mp, "image_generation", "streaming", 4, 16,
                                device_resident_gb=0)
    finally:
        mp.undo()
    return theirs, resident, streaming, summary


def test_raw_batches_equal_the_jax_runner(generation_runs):
    theirs, resident, _, summary = generation_runs
    assert [s for s in summary if not s.startswith("_")] == list(STAGES)
    assert all(summary[s]["data_s"] > 0 for s in STAGES)  # the resident dataset, per stage
    # 5 stages x 2 rounds x n_critic 2 batches.
    assert len(resident) == 20
    same_batches(resident, theirs)
    assert [b.shape[1] for b in resident[::4]] == [4, 8, 8, 16, 16]


def test_streaming_equals_resident(generation_runs, shards):
    _, resident, streaming, _ = generation_runs
    same_batches(streaming, resident)
    for stage in STAGES:
        a, step_a = load_model(str(shards / "resident" / stage))
        b, step_b = load_model(str(shards / "streaming" / stage))
        assert step_a == step_b == 2
        for k in a:
            assert torch.equal(a[k], b[k]), (stage, k)


def test_scan_rounds_stream_and_resident_agree(shards, monkeypatch):
    resident, _ = port_run(shards, monkeypatch, "image_generation", "scan_res", 8, 8,
                           rounds_per_scan=2, num_images_per_resolution=8)
    streaming, _ = port_run(shards, monkeypatch, "image_generation", "scan_stream", 8, 8,
                            rounds_per_scan=2, num_images_per_resolution=8,
                            device_resident_gb=0)
    assert len(resident) == 2  # two scan chunks, each augmented at once
    same_batches(streaming, resident)
    a, _ = load_model(str(shards / "scan_res" / "8"))
    b, _ = load_model(str(shards / "scan_stream" / "8"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_in_training_swd_has_the_jax_layout(generation_runs, shards):
    for stage in STAGES:
        names = sorted(n for n in os.listdir(shards / "resident" / stage)
                       if n.startswith("swd_in_training"))
        jnames = sorted(n for n in os.listdir(shards / "jax" / stage)
                        if n.startswith("swd_in_training"))
        assert names == jnames
        assert names == (["swd_in_training_1.txt", "swd_in_training_2.txt"]
                         if stage in ("8to16", "16") else [])
        for name in names:
            ours = swd_layout(shards / "resident" / stage / name)
            assert ours == swd_layout(shards / "jax" / stage / name)
            assert ours[1] == ["16", "Average"]
            values = open(shards / "resident" / stage / name).read().split()[-2:]
            assert all(np.isfinite(float(v)) for v in values)


def test_real_data_and_in_training_swd_no_longer_raise(shards):
    cfg = stage_runner.RunConfig(**run_kw(shards, "image_generation", "x", 4, 4))
    stage_runner.require_ported_run(cfg)
    stage_runner.StageRunner(cfg, device="cpu")
    assert jax.default_backend() == "cpu"


def test_the_cli_takes_the_class_count_from_the_dataset():
    from twingan_tpu_torch.runner import pggan_runner

    args = pggan_runner.build_parser().parse_args(
        ["--train_dir=/tmp/x", "--program_name=image_generation",
         "--dataset_name=anime_faces", "--use_conditional_labels=true"])
    assert pggan_runner.config_from_args(args).trainer.num_classes == 51
