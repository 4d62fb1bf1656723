"""The runner's data path and configs against the JAX package:

- ``SyntheticSource`` yields bit-equal arrays for the same seed, keys and
  ``num_classes``;
- ``augment_batch`` agrees within 1e-6 absolute in [0, 1] image units
  (255 times that with ``subtract_mean``, which leaves the images on the
  0-255 scale, where float32's spacing near 120 is 7.6e-6) given the same
  draws (the
  JAX function's own, re-derived from its PRNG key and handed to the
  port), for each colour space, fast and full colour distortion, with and
  without the random crop, shared flips, ``subtract_mean`` and uint8
  input; in eval mode, and where it enlarges; shrinking raises;
- ``postprocess_image`` agrees within 1e-6;
- the CLI parser builds the same ``RunConfig`` as the JAX parser for the
  same argv (every field, the trainer's as plain dicts);
- a stage's ``config.json`` written by either package loads in the other's
  reader.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.data import preprocess as jpre  # noqa: E402
from twingan_tpu.data.pipeline import SyntheticSource as JaxSyntheticSource  # noqa: E402
from twingan_tpu.runner import pggan_runner as jax_cli  # noqa: E402
from twingan_tpu.runner.checkpoint import save_config_snapshot as jax_snapshot  # noqa: E402
from twingan_tpu.runner.config_io import load_stage_config as jax_load  # noqa: E402

from twingan_tpu_torch.data import preprocess as ppre  # noqa: E402
from twingan_tpu_torch.data.pipeline import SyntheticSource  # noqa: E402
from twingan_tpu_torch.runner import pggan_runner as port_cli  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_config_snapshot  # noqa: E402
from twingan_tpu_torch.runner.config_io import (  # noqa: E402
    load_stage_config,
    run_config_from_dict,
)

ATOL = 1e-6
B, OUT = 4, 8
SHAPES = {"brightness": (B, 1, 1, 1), "contrast": (B, 1, 1, 1),
          "saturation": (B, 1, 1), "hue": (B, 1, 1)}


@pytest.mark.parametrize("keys,num_classes,seed", [
    (("source", "target"), 0, 0), (("target",), 0, 7),
    (("target", "conditional_labels"), 5, 3)])
def test_synthetic_source_is_bit_equal(keys, num_classes, seed):
    a = iter(JaxSyntheticSource(3, 8, seed=seed, keys=keys, num_classes=num_classes))
    b = iter(SyntheticSource(3, 8, seed=seed, keys=keys, num_classes=num_classes))
    for _ in range(3):
        ja, pb = next(a), next(b)
        assert ja.keys() == pb.keys()
        for k in ja:
            assert ja[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(pb[k], ja[k])


def jax_draws(key, cfg, shape):
    """The draws ``twingan_tpu.data.preprocess.augment_batch`` makes from
    ``key``, in its order, as the port's ``AugmentDraws``."""
    b, hw, _, c = shape
    k_crop, k_flip, k_sel, k_col = jax.random.split(key, 4)
    draws = ppre.AugmentDraws(None, None, None)
    if cfg.do_random_cropping and hw > cfg.output_hw:
        ky, kx = jax.random.split(k_crop)
        span = hw - cfg.output_hw + 1
        draws.crop_y = torch.tensor(np.asarray(jax.random.randint(ky, (b,), 0, span)))
        draws.crop_x = torch.tensor(np.asarray(jax.random.randint(kx, (b,), 0, span)))
    flips = (jax.random.uniform(k_flip, ()) if cfg.shared_flip
             else jax.random.uniform(k_flip, (b, 1, 1, 1)).reshape(b)) < 0.5
    draws.flip = torch.tensor(np.asarray(flips))
    if cfg.color_space != "gray" and c == 3:
        ordering = int(jax.random.randint(k_sel, (), 0, 4))
        ordering = min(ordering, 1) if cfg.fast_mode else ordering
        orders = ppre.ORDERINGS[cfg.fast_mode]
        ops = orders[ordering % len(orders)]
        keys = jax.random.split(k_col, 4)
        draws.ordering = ordering
        draws.color = tuple(
            torch.tensor(np.asarray(jax.random.uniform(
                keys[i], SHAPES[op], minval=ppre.COLOR_RANGES[op][0],
                maxval=ppre.COLOR_RANGES[op][1])).reshape(b))
            for i, op in enumerate(ops))
    return draws


AUGMENT_CASES = [
    dict(color_space="rgb"),
    dict(color_space="rgb", fast_mode=False),
    dict(color_space="yiq", do_random_cropping=True),
    dict(color_space="yiq", fast_mode=False, do_random_cropping=True),
    dict(color_space="bgr", shared_flip=True),
    dict(color_space="bgr", fast_mode=False, subtract_mean=True),
    dict(color_space="gray"),
    dict(color_space="gray", do_random_cropping=True, shared_flip=True),
    dict(color_space="rgb", do_random_cropping=True, subtract_mean=True),
]


@pytest.mark.parametrize("kw", AUGMENT_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items()) for kw in AUGMENT_CASES])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_augment_batch_matches_jax(kw, uint8):
    cfg_kw = dict(output_hw=OUT, is_training=True, **kw)
    jcfg, pcfg = jpre.PreprocessConfig(**cfg_kw), ppre.PreprocessConfig(**cfg_kw)
    assert jcfg.host_hw == pcfg.host_hw
    rng = np.random.RandomState(len(str(kw)))
    images = rng.rand(B, pcfg.host_hw, pcfg.host_hw, 3).astype(np.float32)
    if uint8:
        images = (images * 255).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jpre.augment_batch(key, jnp.asarray(images), jcfg))
    draws = jax_draws(key, pcfg, images.shape)
    out = ppre.augment_batch(torch.from_numpy(images), pcfg, draws=draws).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    scale = 255.0 if pcfg.subtract_mean else 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL * scale)
    if pcfg.color_space != "gray":
        # The colour factors show: a batch without them differs.
        plain = ppre.augment_batch(torch.from_numpy(images), pcfg, draws=dataclasses.replace(
            draws, color=tuple(torch.zeros(B) if op in ("brightness", "hue") else torch.ones(B)
                               for op in ppre.ORDERINGS[pcfg.fast_mode][draws.ordering])))
        assert np.abs(plain.numpy() - ref).max() > 1e-3 * scale


def test_augment_batch_draws_from_a_generator():
    cfg = ppre.PreprocessConfig(output_hw=OUT, is_training=True, fast_mode=False,
                                do_random_cropping=True)
    x = torch.rand(B, cfg.host_hw, cfg.host_hw, 3, generator=torch.Generator().manual_seed(0))
    a, b, c = (ppre.augment_batch(x, cfg, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert a.shape == (B, OUT, OUT, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator or draws"):
        ppre.augment_batch(x, cfg)


@pytest.mark.parametrize("hw", [OUT, 4], ids=["same_size", "enlarge"])
@pytest.mark.parametrize("color_space", ["rgb", "yiq", "gray"])
def test_augment_batch_eval_mode_and_resize_match_jax(hw, color_space):
    kw = dict(output_hw=OUT, is_training=False, color_space=color_space)
    images = np.random.RandomState(hw).rand(2, hw, hw, 3).astype(np.float32)
    ref = np.asarray(jpre.augment_batch(jax.random.PRNGKey(0), jnp.asarray(images),
                                        jpre.PreprocessConfig(**kw)))
    out = ppre.augment_batch(torch.from_numpy(images), ppre.PreprocessConfig(**kw)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_shrinking_resize_raises():
    """Shrinking raised until the antialiased resize was ported; it now
    computes ``jax.image.resize``'s function, as the CPU tests of
    ``tests/test_torch_resize.py`` hold it."""
    x = np.random.RandomState(8).rand(2, 8, 8, 3).astype(np.float32)
    kw = dict(output_hw=3, is_training=False)
    ref = np.asarray(jpre.augment_batch(jax.random.PRNGKey(0), jnp.asarray(x),
                                        jpre.PreprocessConfig(**kw)))
    out = ppre.augment_batch(torch.from_numpy(x), ppre.PreprocessConfig(**kw)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("color_space,subtract_mean,channels", [
    ("rgb", False, 3), ("yiq", False, 3), ("bgr", True, 3), ("rgb", True, 3),
    ("gray", False, 1), ("rgb", False, 4)])
def test_postprocess_image_matches_jax(color_space, subtract_mean, channels):
    x = np.random.RandomState(channels).uniform(-0.5, 1.5, (2, 6, 6, channels))
    if subtract_mean:
        x = x * 255.0 - 120.0
    x = x.astype(np.float32)  # outputs in [0, 1]
    ref = np.asarray(jpre.postprocess_image(jnp.asarray(x), color_space, subtract_mean))
    out = ppre.postprocess_image(torch.from_numpy(x), color_space, subtract_mean).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------- #
# Configs


def plain(cfg) -> dict:
    """A config as nested plain values (the trainer types differ)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


CLI_ARGVS = [
    ["--train_dir=/tmp/x"],
    ["--train_dir=/tmp/x", "--program_name=twingan", "--max_hw=256", "--use_unet=true",
     "--generator_norm_type=batch_norm", "--do_self_attention=true",
     "--self_attention_hw=64", "--dtype=bfloat16", "--equalized_learning_rate=true",
     "--do_pixel_norm=true", "--hw_to_batch_size={4: 8, 256: 3}", "--seed=5",
     "--checkpoint_exclude_scopes=block_4_conv0,to_rgb", "--rounds_per_scan=4",
     "--async_probe=true", "--use_synthetic_data=true", "--learning_rate=0.0005"],
    ["--train_dir=/tmp/g", "--program_name=image_generation", "--start_hw=4",
     "--max_hw=256", "--generator_norm_type=none", "--do_pixel_norm=true",
     "--equalized_learning_rate=true", "--batch_size=12", "--use_ttur=true",
     "--loss_architecture=wgan_gp", "--max_stages_per_run=7", "--optimizer=momentum",
     "--keep_checkpoints=2", "--save_every_n_steps=2", "--num_images_per_resolution=48"],
]


@pytest.mark.parametrize("argv", CLI_ARGVS, ids=["defaults", "twingan", "generation"])
def test_cli_builds_the_jax_run_config(argv):
    jcfg = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    args = port_cli.build_parser().parse_args(argv)
    assert args.device is None  # the card, unless --device=cpu
    pcfg = port_cli.config_from_args(args)
    assert [f.name for f in dataclasses.fields(pcfg)] == [f.name for f in
                                                          dataclasses.fields(jcfg)]
    assert plain(pcfg) == plain(jcfg)


def run_and_trainer_configs():
    argv = CLI_ARGVS[1]
    jrun = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    prun = port_cli.config_from_args(port_cli.build_parser().parse_args(argv))
    return jrun, prun


def test_jax_stage_config_loads_in_the_port(tmp_path):
    jrun, prun = run_and_trainer_configs()
    jax_snapshot(str(tmp_path), {"run": jrun.replace(trainer=None), "trainer": jrun.trainer})
    run, trainer = load_stage_config(str(tmp_path))
    assert run_config_from_dict(run, trainer) == prun
    assert trainer == prun.trainer


def test_port_stage_config_loads_in_jax(tmp_path):
    jrun, prun = run_and_trainer_configs()
    save_config_snapshot(str(tmp_path / "port"), {"run": prun.replace(trainer=None),
                                                  "trainer": prun.trainer})
    jax_snapshot(str(tmp_path / "jax"), {"run": jrun.replace(trainer=None),
                                         "trainer": jrun.trainer})
    run, trainer = jax_load(str(tmp_path / "port"))
    run_ref, trainer_ref = jax_load(str(tmp_path / "jax"))
    assert run == run_ref
    assert trainer == trainer_ref
