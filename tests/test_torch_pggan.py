"""The port's Encoder -> Generator against the Flax modules, the
noise-input generator of generation, and the bridge (one network's tree,
and a whole TwinGAN train state's four networks).

Both modules run with UNet skips and self-attention (sa_gamma 0.7), for
batch and instance norm, on a stable and a growing stage, at 16 px with
max_channels 16, batch 2, fp32, eval statistics. Flax weights (norm banks
and moving statistics randomized from a seed) reach the port through
``bridge.state_dict_from_flax``. Tolerance rtol 1e-4 / atol 1e-4: about 20
conv/norm layers whose fp32 sums XLA and ATen take in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.models.layers import reset_parameters  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer as PortTrainer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k == "sa_gamma":
            out[k] = np.full(v.shape, 0.7, np.float32)
        elif k.startswith(("gamma_", "moving_var_")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith(("beta_", "moving_mean_", "bias")):
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _flax_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flax_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def build_pair(kw, alpha=0.3, domains=(0, 1), seed=0):
    """JAX and port encoder/generator on the same weights and images.
    Returns (jax outputs, port outputs, flax variables, port modules)."""
    jcfg, pcfg = JaxPGGANConfig(**kw), PGGANConfig(**kw)
    res = kw["resolution"]
    x = np.random.RandomState(seed).rand(2, res, res, 3).astype(np.float32)
    src, dst = domains
    jenc, jgen = jpggan.Encoder(jcfg), jpggan.Generator(jcfg)
    enc_vars = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(seed + 1)
    enc_vars = {k: randomize(v, rng) for k, v in enc_vars.items()}
    code, skips = jenc.apply(enc_vars, jnp.asarray(x), alpha=alpha, domain=src)
    gen_vars = jax.device_get(jgen.init(jax.random.PRNGKey(1), code, unet_skips=skips))
    gen_vars = {k: randomize(v, rng) for k, v in gen_vars.items()}
    out, _ = jgen.apply(gen_vars, code, alpha=alpha, domain=dst, unet_skips=skips)

    enc, gen = pggan.Encoder(pcfg), pggan.Generator(pcfg, unet=True)
    enc.load_state_dict(state_dict_from_flax(enc_vars["params"], enc_vars.get("batch_stats")))
    gen.load_state_dict(state_dict_from_flax(gen_vars["params"], gen_vars.get("batch_stats")))
    with torch.no_grad():
        pcode, pskips = enc(torch.from_numpy(x), alpha=alpha, domain=src)
        pout = gen(pcode, alpha=alpha, domain=dst, unet_skips=pskips)
    return ((np.asarray(code), skips, np.asarray(out)), (pcode.numpy(), pskips, pout.numpy()),
            (enc_vars, gen_vars), (enc, gen))


@pytest.mark.parametrize("norm_type", ["batch_norm", "instance_norm"])
@pytest.mark.parametrize("growing", [False, True])
def test_encoder_generator_match(norm_type, growing):
    kw = dict(resolution=16, max_channels=16, norm_type=norm_type, equalized_lr=True,
              do_pixel_norm=True, num_domains=2, do_self_attention=True,
              self_attention_hw=8, is_growing=growing)
    (code, skips, out), (pcode, pskips, pout), _, _ = build_pair(kw)
    np.testing.assert_allclose(pcode, code, **TOL)
    assert sorted(pskips.blocks) == sorted(skips.blocks)
    assert sorted(pskips.interp) == sorted(skips.interp)
    for hw, feat in skips.blocks.items():
        np.testing.assert_allclose(pskips.blocks[hw].numpy(), np.asarray(feat), **TOL)
    for hw, feat in skips.interp.items():
        np.testing.assert_allclose(pskips.interp[hw].numpy(), np.asarray(feat), **TOL)
    assert pout.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(pout, out, **TOL)


def test_rgb_filters_res_blocks_and_unet_limit():
    """Even to_rgb kernels with SAME padding (use_larger_filter_at_rgb_layer:
    k 4 at 8 px, k 2 for the 4 px layer of the growing stage), residual
    shortcuts, and UNet skips only up to unet_max_concat_hw."""
    kw = dict(resolution=8, max_channels=8, norm_type="batch_norm", equalized_lr=True,
              do_pixel_norm=False, num_domains=2, is_growing=True,
              use_larger_filter_at_rgb_layer=True, use_res_block=True)
    (code, _, out), (pcode, _, pout), _, (_, gen) = build_pair(kw, alpha=0.6, domains=(1, 0))
    assert gen.to_rgb_8.conv.kernel.shape[-1] == 4 and gen.to_rgb_4.conv.kernel.shape[-1] == 2
    np.testing.assert_allclose(pcode, code, **TOL)
    np.testing.assert_allclose(pout, out, **TOL)

    kw.update(resolution=16, max_channels=16, is_growing=False, unet_max_concat_hw=8)
    (_, _, out), (_, _, pout), _, (_, gen) = build_pair(kw, domains=(0, 1))
    assert gen.block_16_conv0.conv.kernel.shape[1] == 16  # no skip concatenated at 16
    np.testing.assert_allclose(pout, out, **TOL)


@pytest.mark.parametrize("norm_type", ["batch_norm", "instance_norm"])
def test_bridge_covers_every_leaf_and_round_trips(norm_type):
    kw = dict(resolution=16, max_channels=16, norm_type=norm_type, equalized_lr=True,
              do_pixel_norm=True, num_domains=2, do_self_attention=True,
              self_attention_hw=8, is_growing=True, use_res_block=True)
    _, _, variables, modules = build_pair(kw)
    for var, module in zip(variables, modules):
        stats = var.get("batch_stats", {})
        sd = state_dict_from_flax(var["params"], stats)
        port_sd = module.state_dict()
        leaves = {**_flax_leaves(var["params"]), **_flax_leaves(stats)}
        # Every Flax leaf maps to exactly one port tensor, and nothing else
        # is in the port's state_dict.
        assert len(sd) == len(leaves)
        assert set(sd) == set(port_sd)
        for k, t in sd.items():
            assert tuple(t.shape) == tuple(port_sd[k].shape), k
        params, back_stats = flax_from_state_dict(port_sd)
        assert _flax_leaves(params).keys() == _flax_leaves(var["params"]).keys()
        for k, v in _flax_leaves(var["params"]).items():
            np.testing.assert_array_equal(_flax_leaves(params)[k], v)
        for k, v in _flax_leaves(stats).items():
            np.testing.assert_array_equal(_flax_leaves(back_stats)[k], v)
        assert set(_flax_leaves(back_stats)) == set(_flax_leaves(stats))


@pytest.mark.parametrize("norm_type,growing,rank", [
    ("none", False, 4), ("none", True, 2), ("batch_norm", False, 4)])
def test_noise_input_generator_matches(norm_type, growing, rank):
    """The generation generator: [B,1,1,C] (or [B,C]) noise padded to 7x7,
    block_4_conv0 a k4 VALID conv. Under norm_type "none" with pixel norm
    its conv-leaky-pixel-norm steps take B4's route with no gradient (the
    plain version on the CPU) and the layers with one; both agree with
    the Flax generator."""
    kw = dict(resolution=16, max_channels=16, norm_type=norm_type, equalized_lr=True,
              do_pixel_norm=True, is_growing=growing)
    jcfg, pcfg = JaxPGGANConfig(**kw), PGGANConfig(**kw)
    assert pggan.noise_shape(pcfg, 3) == jpggan.noise_shape(jcfg, 3)
    z = np.random.RandomState(3).randn(*pggan.noise_shape(pcfg, 2)).astype(np.float32)
    if rank == 2:
        z = z[:, 0, 0, :]
    jgen = jpggan.Generator(jcfg)
    variables = jax.device_get(jgen.init(jax.random.PRNGKey(2), jnp.asarray(z)))
    variables = {k: randomize(v, np.random.RandomState(4)) for k, v in variables.items()}
    ref, _ = jgen.apply(variables, jnp.asarray(z), alpha=0.4)
    gen = pggan.Generator(pcfg, noise_input=True)
    gen.load_state_dict(state_dict_from_flax(variables["params"], variables.get("batch_stats")))
    assert gen.block_4_conv0.conv.kernel.shape == (16, pcfg.noise_dim, 4, 4)
    with torch.no_grad():
        out = gen(torch.from_numpy(z), alpha=0.4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out_grad = gen(torch.from_numpy(z), alpha=0.4)
    assert out_grad.grad_fn is not None
    np.testing.assert_allclose(out_grad.detach().numpy(), np.asarray(ref), **TOL)


def test_generator_input_contract():
    cfg = PGGANConfig(resolution=8, max_channels=8, num_domains=2)
    gen = pggan.Generator(cfg, unet=False)
    with pytest.raises(ValueError, match="noise_input=True"):
        gen(torch.zeros(1, 1, 1, cfg.noise_dim))
    with pytest.raises(ValueError, match="noise"):
        pggan.Generator(cfg, noise_input=True)(torch.zeros(1, 4, 4, cfg.channels(0)))
    with pytest.raises(ValueError, match="unet"):
        gen(torch.zeros(1, 4, 4, cfg.channels(0)), unet_skips=pggan.EncoderSkips())
    with pytest.raises(ValueError, match="16 px"):
        pggan.Encoder(cfg.replace(resolution=16))(torch.zeros(1, 8, 8, 3))


@pytest.mark.parametrize("kw,name", [
    ({"quantized_inference": "int8"}, "quantized_inference"),
    ({"attention_context_parallel": True}, "attention_context_parallel"),
    ({"norm_type": "none", "do_pixel_norm": True, "min_channels": 2048}, "min_channels"),
])
def test_modules_refuse_unported_options(kw, name):
    cfg = PGGANConfig(resolution=8, max_channels=8, num_domains=2, **kw)
    if name == "quantized_inference":
        # Ported (W8A8 serving, A12): the encoder and generator take it, the
        # discriminator refuses it as inference-only.
        pggan.Encoder(cfg)
        pggan.Generator(cfg)
        with pytest.raises(ValueError, match=f"{name}.*inference-only"):
            pggan.Discriminator(cfg)
        return
    if name == "attention_context_parallel":
        # Ported (A8): every module takes it, and without a process group
        # the attention takes the local path, bit for bit
        # (test_torch_parallel.py runs the split on two processes).
        cfg = cfg.replace(do_self_attention=True, self_attention_hw=8)
        pggan.Encoder(cfg)
        pggan.Generator(cfg)
        cp, local = pggan.Discriminator(cfg), pggan.Discriminator(
            cfg.replace(attention_context_parallel=False))
        reset_parameters(local, torch.Generator().manual_seed(0))
        with torch.no_grad():
            local.self_attention_8.sa_gamma.fill_(1.0)
        cp.load_state_dict(local.state_dict())
        x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(cp(x), local(x), rtol=0, atol=0)
        return
    # Cout 2048, past what one block of B4 holds: B4 takes it in two
    # passes, so the encoder and the generator build and run (B4's route,
    # here its plain version, in the generator's no-gradient pass).
    cfg = cfg.replace(resolution=4)
    x = torch.rand(1, 4, 4, 3, generator=torch.Generator().manual_seed(1))
    enc, gen = pggan.Encoder(cfg), pggan.Generator(cfg)
    for seed, net in enumerate((enc, gen)):
        reset_parameters(net, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        code, _ = enc(x)
        out = gen(code)
    assert out.shape == (1, 4, 4, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("norm_type", ["batch_norm", "instance_norm"])
def test_train_state_bridge_round_trips(norm_type):
    """All four networks of a JAX TwinGAN train state, params and
    batch_stats, into the port's train state and back, exactly."""
    kw = dict(resolution=16, max_channels=16, norm_type=norm_type, equalized_lr=True,
              num_domains=2, do_self_attention=True, self_attention_hw=8)
    jtrainer = TwinGANTrainer(JaxTwinGANConfig(model=JaxPGGANConfig(**kw), use_unet=True,
                                               batch_size=2))
    jstate = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    params = randomize(jax.device_get(jstate.params), rng)
    model_state = randomize(jax.device_get(jstate.model_state), rng)
    assert set(params) == {"encoder_content", "generator", "discriminator_s", "discriminator_t"}

    trainer = PortTrainer(TwinGANConfig(model=PGGANConfig(**kw), use_unet=True, batch_size=2),
                          device="cpu")
    state = bridge.twingan_state_from_flax(trainer, params, model_state, step=3, critic_step=5)
    assert (state.step, state.critic_step) == (3, 5)
    back_params, back_state = bridge.flax_from_twingan_state(state)
    assert set(back_state) == set(model_state)
    for name in params:
        assert _flax_leaves(back_params[name]).keys() == _flax_leaves(params[name]).keys()
        for k, v in _flax_leaves(params[name]).items():
            np.testing.assert_array_equal(_flax_leaves(back_params[name])[k], v, err_msg=k)
        stats = _flax_leaves(model_state[name])
        assert _flax_leaves(back_state[name]).keys() == stats.keys()
        for k, v in stats.items():
            np.testing.assert_array_equal(_flax_leaves(back_state[name])[k], v, err_msg=k)
    has_stats = norm_type == "batch_norm"
    assert bool(model_state["generator"]) == has_stats
    assert model_state["discriminator_s"] == {}
