"""W8A8 calibration and the int8 translate of a whole stage, the port's
``infer/quantize.py`` against ``twingan_tpu/infer/quantize.py``.

The same JAX TwinGAN stage (32 px, max_channels 16, attention at 16 px,
UNet, norm banks and moving statistics drawn from a seed) goes through
both packages' ``calibrate`` on the same images and then their int8
translate, in three configurations: batch norm on a growing stage (alpha
0.25), ``norm_type="none"`` with pixel norm (the generator's blocks have
kernel B4's structure: "calib" records and runs B4, "int8" must not), and
``fused_scale`` with UNet (the generator's conv0 quantizes the
pre-upsample tensor and the skip apart).

- float64 on both sides (``torch_quant_parity``): every conv's abs-maxima
  within 1e-6 relative and the int8 images within 1e-6 of JAX's. The
  codes agree there.
- The int8 translate against the port's own fp translate within the JAX
  package's 2 % bound (``tests/test_quantize.py``).
- The B4 route: "calib" records each fusable block's input and runs B4,
  "int8" never runs it. A layer whose input was all zeros raises, naming
  it; the discriminator and both trainers refuse the option.

The weights are drawn in the port and bridged to the JAX package
(``bridge.flax_train_state``), which spares the JAX initializer. float32,
``ImageInferer(quantize=True)``, the CLIs and the style stage are in
``test_torch_quantize_serve.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.infer.quantize import calibrate as jax_calibrate  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.state import GanTrainState  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.bridge import flax_train_state, train_state_dict  # noqa: E402
from twingan_tpu_torch.infer.quantize import calibrate  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.models.layers import EqConv, reset_parameters  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    ENC,
    GEN,
    TwinGANConfig,
    TwinGANTranslator,
    translate,
)

from torch_quant_parity import (  # noqa: E402
    as_float64,
    float64_jax,
    float64_port,
    two_torch_threads,
)

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

STEP = 250
TOL64 = 1e-6
INT8_VS_FP_TOL = 0.02

CONFIGS = {
    "batch_norm_growing": dict(norm_type="batch_norm", is_growing=True),
    "pixel_norm_b4_route": dict(norm_type="none"),
    "fused_scale_unet": dict(norm_type="batch_norm", fused_scale=True),
}


MODEL_KW = dict(resolution=32, max_channels=16, equalized_lr=True, do_pixel_norm=True,
                num_domains=2, do_self_attention=True, self_attention_hw=16)
TRAINER_KW = dict(use_unet=True, batch_size=2, max_steps=1000)


def randomize(model, seed):
    """The JAX initializers' distributions, then every norm bank, moving
    statistic and bias drawn away from its init value and sa_gamma 0.7."""
    gen = torch.Generator().manual_seed(seed)
    reset_parameters(model, gen)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "sa_gamma":
                t.fill_(0.7)
            elif leaf.startswith(("gamma_", "moving_var_")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif leaf.startswith(("beta_", "moving_mean_")) or leaf == "bias":
                t.normal_(0.0, 0.3, generator=gen)


def stage(kind, seed=3):
    """(JAX config, JAX state of the encoder and generator, port config,
    port translator): one set of weights, drawn in the port and bridged."""
    model_kw = {**MODEL_KW, **CONFIGS[kind]}
    pcfg = TwinGANConfig(model=PGGANConfig(**model_kw), **TRAINER_KW)
    model = TwinGANTranslator(pcfg)
    randomize(model, seed)
    params, model_state = flax_train_state(model.state_dict(), (ENC, GEN))
    jcfg = JaxTwinGANConfig(model=JaxPGGANConfig(**model_kw), **TRAINER_KW)
    zero = jnp.asarray(0, jnp.int32)
    state = GanTrainState(step=jnp.asarray(STEP, jnp.int32), critic_step=zero,
                          params=params, model_state=model_state, gen_opt_state=None,
                          dis_opt_state=None, gdrop_strength=jnp.asarray(0.0),
                          gen_loss_ema=jnp.asarray(0.0))
    return jcfg, state, pcfg, model


def images(n=2, seed=0):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


def a_max_of(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
            if k.endswith("a_max")}


def jax_a_max(model_state):
    sd = train_state_dict({n: {} for n in (ENC, GEN)}, model_state, (ENC, GEN))
    return {k: v.numpy() for k, v in sd.items() if k.endswith("a_max")}


def compare_a_max(got, want, rtol):
    assert set(got) == set(want) and len(got) > 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)
        assert got[k][0] > 0, k


def float64_translator(pcfg, model):
    """The same weights in a translator built in float64 (call inside
    ``float64_port``)."""
    model64 = TwinGANTranslator(pcfg)
    model64.load_state_dict({k: v.double() if v.is_floating_point() else v
                             for k, v in model.state_dict().items()}, strict=True)
    return model64


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_calibrate_and_int8_translate_match_jax_in_float64(kind):
    jcfg, state, pcfg, model = stage(kind)
    x = images()
    with float64_jax():
        trainer64 = TwinGANTrainer(jcfg.replace(model=jcfg.model.replace(dtype="float64")))
        state64 = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, as_float64(state.params)),
            model_state=jax.tree_util.tree_map(jnp.asarray, as_float64(state.model_state)))
        q8, state_q = jax_calibrate(trainer64, state64, jnp.asarray(x, jnp.float64),
                                    calib_batches=1)
        want = np.asarray(q8.translate(state_q, jnp.asarray(x, jnp.float64), "s2t"))
        want_amax = jax_a_max(jax.device_get(state_q.model_state))
    with float64_port():
        model64 = float64_translator(pcfg, model)
        enc, gen = model64.encoder_content, model64.generator
        xt = torch.from_numpy(x).double()
        fp = translate(pcfg, enc, gen, xt, step=STEP).numpy()
        cfg8 = calibrate(pcfg, enc, gen, xt, step=STEP, calib_batches=1)
        assert cfg8.model.quantized_inference == "int8"
        got = translate(cfg8, enc, gen, xt, step=STEP).numpy()
        got_amax = a_max_of(model64)
    compare_a_max(got_amax, want_amax, TOL64)
    assert got.dtype == np.float64 and got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL64)
    rel = np.abs(got - fp).mean() / (fp.max() - fp.min())
    assert 1e-5 < rel < INT8_VS_FP_TOL, rel  # int8, and within JAX's bound of fp
    if kind == "fused_scale_unet":  # the split: conv0's skip slot calibrated
        split = [v for k, v in got_amax.items() if k.startswith("generator.block_")
                 and k.endswith("conv0.conv.a_max") and not k.startswith("generator.block_4_")]
        assert len(split) == 3 and all(v[1] > 0 for v in split)


def test_pixel_norm_route_calibrates_through_b4_and_serves_without_it():
    from twingan_tpu_torch.ops import fused_conv

    _, _, pcfg, model = stage("pixel_norm_b4_route")
    gen = model.generator
    fusable = [n for n, m in gen.named_modules() if getattr(m, "fusable", False)]
    assert len(fusable) >= 8
    x = torch.from_numpy(images())
    calls = []
    original = fused_conv.fused_conv
    fused_conv.fused_conv = lambda *a: calls.append(1) or original(*a)
    try:
        calibrate(pcfg, model.encoder_content, gen, x, calib_batches=1)
        assert len(calls) == len(fusable)  # calib: B4's route, one call a block
        for name in fusable:
            assert float(gen.get_submodule(name).conv.a_max[0]) > 0, name
        calls.clear()
        translate(pcfg, model.encoder_content, gen, x)
        assert calls == []  # int8: never B4, which computes the fp conv
    finally:
        fused_conv.fused_conv = original


def test_an_uncalibrated_layer_raises_naming_it():
    _, _, pcfg, model = stage("batch_norm_growing")
    black = torch.zeros(2, 32, 32, 3)  # from_rgb's input: all zeros
    with pytest.raises(ValueError, match="from_rgb_32_conv.conv"):
        calibrate(pcfg, model.encoder_content, model.generator, black, step=STEP)
    convs = [m for m in model.modules() if isinstance(m, EqConv)]
    assert all(c.quantize == "int8" for c in convs)


def test_discriminator_and_trainers_refuse_it():
    from twingan_tpu_torch.models.pggan import Discriminator
    from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer as PortTwinGANTrainer

    for mode in ("calib", "int8"):
        cfg = PGGANConfig(resolution=8, max_channels=8, num_domains=2, quantized_inference=mode)
        with pytest.raises(ValueError, match="inference-only"):
            Discriminator(cfg)
        with pytest.raises(ValueError, match="inference-only"):
            PortTwinGANTrainer(TwinGANConfig(model=cfg), device="cpu")
        with pytest.raises(ValueError, match="inference-only"):
            GanTrainer(GanTrainerConfig(model=cfg.replace(num_domains=1)), device="cpu")
