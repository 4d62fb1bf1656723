"""W8A8 serving in float32: calibration and the int8 translate against the
JAX package, ``ImageInferer(quantize=True)``, the translate CLI's and the
server's ``--quantize``, and a style stage.

- float32 against the JAX package: every conv's abs-maxima within
  ``FP32_AMAX_RTOL`` (measured: 3.1e-7 at most). The last bits of the two
  packages' float32 activations differ (XLA and ATen sum in other orders),
  and a value that lands within them of a rounding boundary takes the other
  int8 code; a flip moves one product of the next conv by a whole
  quantization step, and the flips spread downstream. Measured on these
  stages (seeds 3 and 4): with fused scale and with pixel norm, no flip
  reached the output (1.2e-7 of the output's range at most); on the growing
  batch-norm stage, flips did: 2.5e-2 of the range at most at one pixel,
  1.5e-3 in the mean. Limits ``FP32_MAX_TOL`` and ``FP32_MEAN_TOL``, of the
  range. The float64 tests of ``test_torch_quantize.py``, where the codes
  agree, hold the function to 1e-6.
- ``ImageInferer(quantize=True)``: its first batch is calibrated on and
  served in int8 as the JAX inferer's (``twingan_tpu/infer/translate.py``:
  ``calibrate`` on the preprocessed batch, two slices, then
  ``translate``); then it keeps raising the scales until it has seen
  ``CALIB_MIN_IMAGES`` images and freezes them (a deliberate divergence:
  the JAX inferer freezes after its first batch).
- A style stage calibrates its style encoder too and translates in int8
  (the JAX ``calibrate`` skips it, a defect the port does not copy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.data import preprocess as jpreprocess  # noqa: E402
from twingan_tpu.infer.quantize import calibrate as jax_calibrate  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.infer import translate as ptranslate  # noqa: E402
from twingan_tpu_torch.infer.quantize import CALIB_MIN_IMAGES, calibrate  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402
from twingan_tpu_torch.serve import clients, server  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    TwinGANConfig,
    TwinGANTranslator,
    translate,
)
from twingan_tpu_torch.utils import image_io  # noqa: E402

from test_torch_quantize import (  # noqa: E402
    INT8_VS_FP_TOL,
    MODEL_KW,
    STEP,
    TRAINER_KW,
    a_max_of,
    images,
    jax_a_max,
    randomize,
    stage,
)
from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

FP32_AMAX_RTOL = 1e-5
FP32_MAX_TOL = 5e-2
FP32_MEAN_TOL = 5e-3
# int8 against fp on the style stage, of the output's range: the style
# comes from a second quantized encoder, and its error moves every
# conditional norm of the generator (measured 2.06e-2 here; the stages
# without style stay inside the JAX package's 2e-2).
STYLE_INT8_VS_FP_TOL = 5e-2


def compare_fp32(got, want, got_amax, want_amax):
    assert set(got_amax) == set(want_amax) and len(got_amax) > 20
    for k in want_amax:
        np.testing.assert_allclose(got_amax[k], want_amax[k], rtol=FP32_AMAX_RTOL, err_msg=k)
    diff = np.abs(got - want) / (want.max() - want.min())
    assert diff.max() <= FP32_MAX_TOL and diff.mean() <= FP32_MEAN_TOL, (diff.max(),
                                                                          diff.mean())


@pytest.mark.parametrize("kind", ["batch_norm_growing", "fused_scale_unet"])
def test_float32_within_the_flip_tolerance(kind):
    jcfg, state, pcfg, model = stage(kind, seed=4)
    x = images(seed=4)
    q8, state_q = jax_calibrate(TwinGANTrainer(jcfg), state, jnp.asarray(x))
    want = np.asarray(q8.translate(state_q, jnp.asarray(x), "s2t"))
    enc, gen = model.encoder_content, model.generator
    cfg8 = calibrate(pcfg, enc, gen, torch.from_numpy(x), step=STEP)
    got = translate(cfg8, enc, gen, torch.from_numpy(x), step=STEP).numpy()
    compare_fp32(got, want, a_max_of(model), jax_a_max(jax.device_get(state_q.model_state)))


def _uint8_images(n, seed, high=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, high, (32, 32, 3)).astype(np.uint8) for _ in range(n)]


def _write_stage(tmp_path, pcfg, model, name="32"):
    stage_dir = str(tmp_path / name)
    save_stage(stage_dir, pcfg, model.state_dict(), step=STEP)
    return stage_dir


def test_inferer_first_batch_is_the_jax_inferers(tmp_path):
    jcfg, state, pcfg, model = stage("fused_scale_unet")
    stage_dir = _write_stage(tmp_path, pcfg, model)
    imgs = _uint8_images(2, seed=5)
    # The JAX ImageInferer's first batch: preprocess, calibrate, translate.
    batch = np.stack([jpreprocess.host_resize(im, "RESHAPE", 32) for im in imgs])
    q8, state_q = jax_calibrate(TwinGANTrainer(jcfg), state, jnp.asarray(batch), "s2t")
    want = np.asarray(q8.translate(state_q, jnp.asarray(batch), "s2t"))

    inferer = ImageInferer(stage_dir, device="cpu", quantize=True)
    assert inferer.cfg.model.quantized_inference == ""
    got = inferer.infer_batch(imgs)
    assert inferer.calibrated_images == 2
    assert inferer.cfg.model.quantized_inference == "int8"
    compare_fp32(got, want, a_max_of(inferer.model), jax_a_max(jax.device_get(
        state_q.model_state)))
    fp = ImageInferer(stage_dir, device="cpu").infer_batch(imgs)
    assert 1e-5 < np.abs(got - fp).mean() / (fp.max() - fp.min()) < INT8_VS_FP_TOL


def test_inferer_calibrates_until_calib_min_images_then_freezes(tmp_path):
    _, _, pcfg, model = stage("batch_norm_growing")
    inferer = ImageInferer(_write_stage(tmp_path, pcfg, model), device="cpu", quantize=True)
    first = inferer.model.encoder_content.from_rgb_32_conv.conv
    assert CALIB_MIN_IMAGES == 64
    for i in range(7):  # 56 images, none above 100/255
        inferer.infer_batch(_uint8_images(8, seed=10 + i, high=101))
    assert inferer.calibrated_images == 56
    assert float(first.a_max[0]) <= 100 / 255 + 1e-6
    inferer.infer_batch(_uint8_images(8, seed=20, high=201))  # still calibrating: 64
    raised = first.a_max.clone()
    assert inferer.calibrated_images == CALIB_MIN_IMAGES
    assert 150 / 255 < float(raised[0]) <= 200 / 255 + 1e-6
    frozen = {k: v.clone() for k, v in inferer.model.state_dict().items()
              if k.endswith("a_max")}
    out = inferer.infer_batch(_uint8_images(8, seed=21))  # frozen: 255 changes nothing
    assert inferer.calibrated_images == CALIB_MIN_IMAGES and np.isfinite(out).all()
    for k, v in inferer.model.state_dict().items():
        if k.endswith("a_max"):
            assert torch.equal(v, frozen[k]), k


def test_translate_cli_and_server_quantize(tmp_path, capsys):
    _, _, pcfg, model = stage("pixel_norm_b4_route")
    stage_dir = _write_stage(tmp_path, pcfg, model)
    src = tmp_path / "in"
    src.mkdir()
    for i, im in enumerate(_uint8_images(3, seed=6)):
        image_io.imsave_float(str(src / f"{i}.png"), im.astype(np.float32) / 255.0)
    for flags, out in (([], "fp"), (["--quantize"], "int8")):
        ptranslate.main([f"--model_path={stage_dir}", f"--input_image_path={src}",
                         f"--output_image_path={tmp_path / out}", "--batch_size=2",
                         "--device=cpu"] + flags)
    for i in range(3):
        fp = image_io.imread_rgb(str(tmp_path / "fp" / f"{i}.png"))
        q8 = image_io.imread_rgb(str(tmp_path / "int8" / f"{i}.png"))
        assert fp.shape == q8.shape == (32, 32, 3)
        assert np.abs(fp.astype(int) - q8.astype(int)).mean() < 255 * INT8_VS_FP_TOL

    service = server.build_service(server.parse_args(
        [f"--model_path={stage_dir}", "--quantize", "--device=cpu", "--serve_batch=1",
         f"--output_dir={tmp_path / 'serve'}"]))
    assert isinstance(service.client, clients.LocalTwinGANClient)
    inferer = service.client.inferer
    assert inferer.quantize and inferer.calibrated_images == 0
    out = service.client.do_inference(_uint8_images(1, seed=7)[0])
    assert out.shape == (32, 32, 3) and np.isfinite(out).all()
    assert inferer.calibrated_images == 1 and inferer.cfg.model.quantized_inference == "int8"
    mock = server.build_service(server.parse_args(["--debug", "--quantize"]))
    assert isinstance(mock.client, clients.MockTwinGANClient)
    with pytest.raises(SystemExit):
        server.parse_args(["--help"])
    assert f"first {CALIB_MIN_IMAGES} images" in " ".join(capsys.readouterr().out.split())


def test_style_stage_calibrates_its_style_encoder():
    pcfg = TwinGANConfig(model=PGGANConfig(**{**MODEL_KW, "style_dim": 8}),
                         use_style_embedding=True, style_embed_size=8, **TRAINER_KW)
    model = TwinGANTranslator(pcfg)
    randomize(model, seed=8)
    x = torch.from_numpy(images(seed=8))
    enc, gen, enc_style = model.encoder_content, model.generator, model.encoder_style
    fp = translate(pcfg, enc, gen, x, step=STEP, enc_style=enc_style).numpy()
    with pytest.raises(ValueError, match="style encoder"):
        calibrate(pcfg, enc, gen, x, step=STEP)
    cfg8 = calibrate(pcfg, enc, gen, x, step=STEP, enc_style=enc_style)
    style_convs = [m for n, m in enc_style.named_modules() if n.endswith(".conv")]
    assert len(style_convs) > 10
    assert all(c.quantize == "int8" and float(c.a_max[0]) > 0 for c in style_convs)
    got = translate(cfg8, enc, gen, x, step=STEP, enc_style=enc_style).numpy()
    assert np.isfinite(got).all()
    assert 1e-5 < np.abs(got - fp).mean() / (fp.max() - fp.min()) < STYLE_INT8_VS_FP_TOL
    # A given style reaches the calibrated generator too.
    style = torch.from_numpy(np.random.RandomState(9).randn(2, 8).astype(np.float32))
    assert np.isfinite(translate(cfg8, enc, gen, x, step=STEP, style=style,
                                 enc_style=enc_style).numpy()).all()
