"""The translation slice as a whole: the port's ImageInferer, served through
its clients, against TwinGANTrainer.translate of the JAX package.

A stage dir is written from a JAX ``TwinGANTrainer.init_state`` (32 px,
max_channels 16, batch norm or instance norm, UNet, self-attention at 16 px
with sa_gamma 0.7, norm banks and moving statistics randomized from a seed)
through the bridge; ``ImageInferer(device="cpu")`` loads it and translates
the same uint8 images. Tolerance rtol 1e-4 / atol 2e-4 in fp32: about 40
conv/norm layers whose fp32 sums XLA and ATen take in different orders
(the largest difference seen is 4e-5 on outputs of magnitude 5).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.data import preprocess as jpreprocess  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.serve import clients as jclients  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402
from twingan_tpu.utils import image_io as jimage_io  # noqa: E402

from twingan_tpu_torch.bridge import translator_state_dict  # noqa: E402
from twingan_tpu_torch.data import preprocess  # noqa: E402
from twingan_tpu_torch.infer import translate as ptranslate  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402
from twingan_tpu_torch.runner.config_io import trainer_config_from_dict  # noqa: E402
from twingan_tpu_torch.serve import clients  # noqa: E402
from twingan_tpu_torch.utils import image_io  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
STEP = 250


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k == "sa_gamma":
            out[k] = np.full(v.shape, 0.7, np.float32)
        elif k.startswith(("gamma_", "moving_var_")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith(("beta_", "moving_mean_")):
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_cfg(norm_type="batch_norm", growing=False):
    return JaxTwinGANConfig(
        model=JaxPGGANConfig(resolution=32, max_channels=16, norm_type=norm_type,
                             equalized_lr=True, do_pixel_norm=True, num_domains=2,
                             do_self_attention=True, self_attention_hw=16,
                             is_growing=growing),
        use_unet=True, batch_size=2, max_steps=1000)


def _stage(tmp_path, norm_type="batch_norm", growing=False):
    """(JAX trainer, its randomized state, stage dir written for the port)."""
    jcfg = _jax_cfg(norm_type, growing)
    trainer = TwinGANTrainer(jcfg)
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    params = randomize(jax.device_get(state.params), rng)
    model_state = randomize(jax.device_get(state.model_state), rng)
    state = state.replace(params=params, model_state=model_state,
                          step=jnp.asarray(STEP, jnp.int32))
    stage_dir = str(tmp_path / ("32to64" if growing else "32"))
    # The JAX config goes through the port's own config loader, as a JAX
    # config.json would.
    pcfg = trainer_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg)["model"] == dataclasses.asdict(jcfg)["model"]
    save_stage(stage_dir, pcfg, translator_state_dict(params, model_state), step=STEP)
    return trainer, state, stage_dir


def _images(n=2, hw=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("norm_type,growing,direction", [
    ("batch_norm", False, "s2t"),
    ("batch_norm", False, "t2s"),
    ("instance_norm", False, "s2t"),
    ("batch_norm", True, "s2t"),
])
def test_image_inferer_matches_trainer_translate(tmp_path, norm_type, growing, direction):
    trainer, state, stage_dir = _stage(tmp_path, norm_type, growing)
    images = _images()
    batch = np.stack([im.astype(np.float32) / 255.0 for im in images])
    ref = np.asarray(trainer.translate(state, jnp.asarray(batch), direction))
    inferer = ImageInferer(stage_dir, direction=direction, device="cpu")
    assert inferer.step == STEP
    out = inferer.infer_batch(images)
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)
    if growing:  # alpha follows the step: 0.25 here, and it matters
        inferer.step = 0
        assert np.abs(inferer.infer_batch(images) - out).max() > 1e-3


def test_train_dir_clients_and_cli(tmp_path):
    """A train dir resolves to its latest stage; the local, batching and
    mock clients and the CLI serve what infer_batch computes."""
    trainer, state, stage_dir = _stage(tmp_path)
    images = _images(5, hw=40, seed=1)  # 40 px: RESHAPE resizes to 32
    inferer = ImageInferer(str(tmp_path), device="cpu")
    assert inferer.image_hw == 32
    expect = inferer.infer_batch(images)
    batch = np.stack([jpreprocess.host_resize(im, "RESHAPE", 32) for im in images])
    ref = np.asarray(trainer.translate(state, jnp.asarray(batch), "s2t"))
    np.testing.assert_allclose(expect, ref, **TOL)

    local = clients.LocalTwinGANClient(stage_dir, device="cpu")
    np.testing.assert_allclose(local.do_inference(images[0]), expect[0], rtol=1e-5, atol=1e-5)

    batching = clients.BatchingLocalClient(inferer, max_batch=4, max_wait_ms=200.0)
    try:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(5) as pool:
            outs = list(pool.map(batching.do_inference, images))
    finally:
        batching.close()
    assert 2 <= batching.dispatches <= 5
    for out, exp in zip(outs, expect):
        np.testing.assert_allclose(out, exp, rtol=1e-5, atol=1e-5)

    mock = clients.MockTwinGANClient(16)
    np.testing.assert_array_equal(mock.do_inference(images[0]),
                                  jclients.MockTwinGANClient(16).do_inference(images[0]))

    src = tmp_path / "in.png"
    image_io.imsave_float(str(src), images[0].astype(np.float32) / 255.0)
    dst = tmp_path / "out.png"
    ptranslate.main([f"--model_path={stage_dir}", f"--input_image_path={src}",
                     f"--output_image_path={dst}", "--device=cpu"])
    saved = image_io.imread_rgb(str(dst))
    assert saved.shape == (32, 32, 3)
    ref_png = np.clip(inferer.infer_batch([images[0]])[0] * 255.0, 0, 255).astype(np.uint8)
    assert np.abs(saved.astype(int) - ref_png.astype(int)).max() <= 1

    folder, out_dir = tmp_path / "faces" / "a", tmp_path / "translated"
    folder.mkdir(parents=True)
    for i, im in enumerate(images[:3]):
        image_io.imsave_float(str(folder / f"{i}.png"), im.astype(np.float32) / 255.0)
    ptranslate.main([f"--model_path={tmp_path}", f"--input_image_path={tmp_path / 'faces'}",
                     f"--output_image_path={out_dir}", "--device=cpu", "--batch_size=2"])
    assert sorted(os.listdir(out_dir)) == ["a_0.png", "a_1.png", "a_2.png"]


def test_batching_client_hands_errors_to_callers():
    class Broken:
        image_hw = 8

        def infer_batch(self, images):
            raise RuntimeError("boom")

    client = clients.BatchingLocalClient(Broken(), max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            client.do_inference(np.zeros((8, 8, 3), np.uint8))
    finally:
        client.close()


def test_inferer_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageInferer(str(tmp_path))
    assert ptranslate.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("shape,mode,hw", [
    ((32, 32, 3), "RESHAPE", 32),   # already at size: no resize
    ((40, 24, 3), "RESHAPE", 32),
    ((20, 20), "RESHAPE", 16),      # grayscale 2-D
    ((17, 9, 3), "NONE", 32),
])
def test_host_resize_matches(shape, mode, hw):
    img = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(preprocess.host_resize_uint8(img, mode, hw),
                                  jpreprocess.host_resize_uint8(img, mode, hw))
    np.testing.assert_array_equal(preprocess.host_resize(img, mode, hw),
                                  jpreprocess.host_resize(img, mode, hw))


def test_host_resize_refuses_unported_modes():
    # Every mode of the JAX package is ported (PAD is checked bit-exact in
    # test_torch_data_pipeline.py); a mode neither package knows raises.
    with pytest.raises(ValueError, match="BOGUS"):
        preprocess.host_resize(np.zeros((4, 4, 3), np.uint8), "BOGUS", 8)


def test_image_io_matches(tmp_path):
    img = np.random.RandomState(5).rand(12, 10, 3).astype(np.float32) * 1.2 - 0.1
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    image_io.imsave_float(a, img)
    jimage_io.imsave_float(b, img)
    np.testing.assert_array_equal(image_io.imread_rgb(a), jimage_io.imread_rgb(b))
    assert image_io.imread_rgb(a).dtype == np.uint8
    gray = str(tmp_path / "g" / "gray.png")
    image_io.imsave_float(gray, img[..., :1])
    assert image_io.imread_rgb(gray).shape == (12, 10, 3)
    assert os.path.exists(gray)
