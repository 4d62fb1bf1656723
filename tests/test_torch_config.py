"""The port's configs against the JAX dataclasses, and config.json loading.

twingan_tpu_torch keeps its own copies of PGGANConfig, TwinGANConfig,
GanTrainerConfig, GanLossConfig and OptimizerConfig; they must stay field
for field the same
(names, order, defaults, validation), so a stage dir written by the JAX
runner loads in the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.runner.checkpoint import save_config_snapshot  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402
from twingan_tpu_torch.runner.config_io import (  # noqa: E402
    find_latest_stage_dir,
    load_stage_config,
    trainer_config_from_dict,
)
from twingan_tpu_torch.train.gan_trainer import GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, fade_alpha  # noqa: E402

PAIRS = [
    (JaxPGGANConfig, PGGANConfig),
    (JaxTwinGANConfig, TwinGANConfig),
    (JaxGanTrainerConfig, GanTrainerConfig),
    (JaxGanLossConfig, GanLossConfig),
    (JaxOptimizerConfig, OptimizerConfig),
]


def _default(field):
    if field.default_factory is not dataclasses.MISSING:
        return field.default_factory()
    return field.default


def _as_plain(obj):
    """Nested dataclass -> dict, with tuples and lists compared alike."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_as_plain(x) for x in obj]
    return obj


@pytest.mark.parametrize("jax_cls,port_cls", PAIRS, ids=[p[1].__name__ for p in PAIRS])
def test_fields_and_defaults_match(jax_cls, port_cls):
    jf, pf = dataclasses.fields(jax_cls), dataclasses.fields(port_cls)
    assert [f.name for f in jf] == [f.name for f in pf]
    for a, b in zip(jf, pf):
        assert _as_plain(_default(a)) == _as_plain(_default(b)), a.name
    assert _as_plain(jax_cls()) == _as_plain(port_cls())


@pytest.mark.parametrize("kw", [
    {"norm_type": "group_norm"},
    {"resolution": 48},
    {"resolution": 4, "is_growing": True},
    {"fused_scale_impl": "winograd"},
    {"quantized_inference": "int4"},
])
def test_pggan_validation_matches(kw):
    with pytest.raises(ValueError):
        JaxPGGANConfig(**kw)
    with pytest.raises(ValueError):
        PGGANConfig(**kw)


def test_twingan_validation_matches():
    for kw in ({"model": {"num_domains": 1}},
               {"model": {"norm_type": "batch_norm", "num_domains": 2}, "fuse_passes": True}):
        with pytest.raises(ValueError):
            JaxTwinGANConfig(model=JaxPGGANConfig(**kw["model"]),
                             **{k: v for k, v in kw.items() if k != "model"})
        with pytest.raises(ValueError):
            TwinGANConfig(model=PGGANConfig(**kw["model"]),
                          **{k: v for k, v in kw.items() if k != "model"})


@pytest.mark.parametrize("kw", [
    {"resolution": 256, "max_channels": 256},
    {"resolution": 64, "max_channels": 32, "min_channels": 48},
    {"resolution": 512, "max_channels": 512},
])
def test_channel_schedule_matches(kw):
    j, p = JaxPGGANConfig(**kw), PGGANConfig(**kw)
    assert (j.max_stage, j.noise_dim) == (p.max_stage, p.noise_dim)
    assert [j.channels(s) for s in range(j.max_stage + 1)] == [
        p.channels(s) for s in range(p.max_stage + 1)]


def test_jax_config_json_loads_in_port(tmp_path):
    jcfg = JaxTwinGANConfig(
        model=JaxPGGANConfig(resolution=64, max_channels=32, norm_type="instance_norm",
                             equalized_lr=True, do_pixel_norm=True, num_domains=2,
                             do_self_attention=True, self_attention_hw=16, dtype="bfloat16"),
        loss=JaxGanLossConfig(architecture="wgan_gp"),
        opt=JaxOptimizerConfig(learning_rate=0.001, frozen_scopes=("encoder",)),
        use_unet=True, max_steps=1234)
    save_config_snapshot(str(tmp_path), {"run": {"train_dir": "x"}, "trainer": jcfg})
    run, cfg = load_stage_config(str(tmp_path))
    assert run == {"train_dir": "x"}
    assert isinstance(cfg, TwinGANConfig)
    assert _as_plain(cfg) == _as_plain(jcfg)
    # And the port writes the same schema back.
    save_stage(str(tmp_path / "port"), cfg, {}, step=3)
    with open(tmp_path / "config.json") as a, open(tmp_path / "port" / "config.json") as b:
        assert json.load(a)["trainer"] == json.load(b)["trainer"]


def test_gan_trainer_config_is_not_ported(tmp_path):
    """A GanTrainerConfig written by the JAX runner (no ``l_cyc_weight``)
    loads as the port's GanTrainerConfig, and the port writes the same
    schema back. (The name is that of the check it replaces, from before
    the port read this config.)"""
    jcfg = JaxGanTrainerConfig(
        model=JaxPGGANConfig(resolution=256, max_channels=256, norm_type="none",
                             do_pixel_norm=True, equalized_lr=True, dtype="bfloat16"),
        loss=JaxGanLossConfig(architecture="dragan"),
        opt=JaxOptimizerConfig(frozen_scopes=("block_4",)),
        batch_size=12, n_critic=2, moving_average_decay=0.999, max_steps=4321)
    save_config_snapshot(str(tmp_path), {"run": {"train_dir": "g"}, "trainer": jcfg})
    run, cfg = load_stage_config(str(tmp_path))
    assert run == {"train_dir": "g"}
    assert isinstance(cfg, GanTrainerConfig)
    assert _as_plain(cfg) == _as_plain(jcfg)
    assert isinstance(trainer_config_from_dict({"model": {}}), GanTrainerConfig)
    save_stage(str(tmp_path / "port"), cfg, {}, step=3)
    with open(tmp_path / "config.json") as a, open(tmp_path / "port" / "config.json") as b:
        assert json.load(a)["trainer"] == json.load(b)["trainer"]


def test_find_latest_stage_dir(tmp_path):
    for name in ("8", "8to16", "16to32", "32", "64to128"):
        os.makedirs(tmp_path / name)
    for name in ("8", "8to16", "16to32", "32"):
        (tmp_path / name / "model.pt").write_bytes(b"")
    # 64to128 has no checkpoint; 32 (stable) outranks 16to32 (growing).
    assert find_latest_stage_dir(str(tmp_path)) == str(tmp_path / "32")
    with pytest.raises(FileNotFoundError):
        find_latest_stage_dir(str(tmp_path / "64to128"))


@pytest.mark.parametrize("growing,step", [(False, 500), (True, 0), (True, 250), (True, 1000)])
def test_fade_alpha_matches(growing, step):
    import jax.numpy as jnp

    jcfg = JaxTwinGANConfig(model=JaxPGGANConfig(resolution=8, is_growing=growing, num_domains=2),
                            grow_start_step=100, max_steps=1100)
    pcfg = TwinGANConfig(model=PGGANConfig(resolution=8, is_growing=growing, num_domains=2),
                         grow_start_step=100, max_steps=1100)
    ref = float(TwinGANTrainer(jcfg)._alpha(jnp.asarray(step, jnp.int32)))
    assert fade_alpha(pcfg, step) == pytest.approx(ref, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("kw,name", [
    ({"quantized_inference": "int8"}, "quantized_inference"),
    ({"attention_context_parallel": True}, "attention_context_parallel"),
    ({"norm_type": "none", "do_pixel_norm": True, "min_channels": 2048}, "min_channels"),
])
def test_unported_options_raise(kw, name):
    """Each option that once raised here is ported now: the modules build
    it and the trainers take it (or, for int8, refuse it as inference-only)."""
    from twingan_tpu_torch.train.base import require_trainable

    if name == "quantized_inference":
        # Ported (W8A8 serving, A12) for the encoder and generator; it is
        # inference-only, so the trainers refuse it instead.
        cfg = PGGANConfig(resolution=8, max_channels=8, **kw)
        pggan.Encoder(cfg)
        pggan.Generator(cfg)
        with pytest.raises(ValueError, match=f"{name}.*inference-only"):
            require_trainable(TwinGANConfig(model=PGGANConfig(num_domains=2, **kw)))
        return
    if name == "attention_context_parallel":
        # Ported (A8): the modules and the trainers take it
        # (test_torch_parallel.py holds it on two processes).
        cfg = PGGANConfig(resolution=8, max_channels=8, num_domains=2, **kw)
        pggan.Encoder(cfg)
        pggan.Discriminator(cfg)
        require_trainable(TwinGANConfig(model=PGGANConfig(num_domains=2, **kw)))
        return
    # Cout 2048 past what one block of B4 holds: B4 takes it in two passes,
    # so every module builds and a generator runs (B4's route, here its plain
    # version, with no gradient).
    from twingan_tpu_torch.models.layers import reset_parameters

    cfg = PGGANConfig(resolution=4, **kw)
    gen = pggan.Generator(cfg, noise_input=True)
    reset_parameters(gen, torch.Generator().manual_seed(0))
    pggan.Discriminator(cfg)
    require_trainable(GanTrainerConfig(model=cfg))
    z = torch.from_numpy(np.random.RandomState(0).randn(*pggan.noise_shape(cfg, 1))
                         .astype(np.float32))
    with torch.no_grad():
        out = gen(z)
    assert out.shape == (1, 4, 4, 3) and bool(torch.isfinite(out).all())


PORTED_OPTIONS = [
    {"fused_scale": True},
    {"fused_scale": True, "fused_scale_impl": "parity", "use_res_block": True},
    {"spectral_norm": True, "spectral_norm_in_non_discriminator": True},
    {"style_dim": 8},
    {"norm_type": "batch_renorm"},
    {"norm_type": "layer_norm"},
]


@pytest.mark.parametrize("kw", PORTED_OPTIONS)
def test_ported_options_pass(kw):
    """The modules take these options, and so do the trainers (conditional
    norms, ``style_dim``, through the style embedding or conditional
    labels, ``test_torch_twingan_step_options.py``)."""
    from twingan_tpu_torch.train.base import require_trainable

    cfg = PGGANConfig(resolution=8, max_channels=8, num_domains=2, **kw)
    pggan.Encoder(cfg)
    pggan.Generator(cfg, unet=True, conditional=True)
    pggan.Discriminator(cfg)
    require_trainable(TwinGANConfig(model=cfg))


def test_discriminator_only_spectral_norm_is_allowed():
    # spectral_norm alone touches only the discriminator, which translation
    # does not run.
    cfg = PGGANConfig(resolution=8, max_channels=8, spectral_norm=True)
    pggan.Encoder(cfg)
    pggan.Generator(cfg)
    pggan.Discriminator(cfg)
