"""TwinGANTrainer's style embedding, encoder distillation and gdrop: one G
step and one D step of the port against the JAX package's, from the same
bridged state and injected draws.

32 px, max_channels 16, batch 2, UNet, eq-lr, pixel norm, DRAGAN, SGD with
recorded gradients (as ``tests/test_torch_twingan_step.py``), self-attention
at 16 px in every network (the style encoder's body included), at global
step 101 with gdrop strength 0.05 (``STRENGTH``). The style embedding is 4 wide, so the
generator's norms are conditional; distillation has 6-wide source and
target embeddings in the batch. This file runs the G step on batch norm
(the unfused passes) with distillation from 16 px, so that its heads run;
``*_d.py`` the D step, and ``*_fused.py`` and ``*_fused_d.py`` both steps
on instance norm (the fused passes) with distillation from 64 px, so that
the heads do not run, each in a file of its own so that the JAX
compilations run on separate test workers. Both packages start from the
port's initial networks, bridged, with every norm bank, moving statistic
and bias drawn from a seed. The random
style and every discriminator pass's gdrop noise are the JAX step's own
draws, recomputed from its key: the style from ``fold_in(k_fwd, 7)``,
gdrop per pass from ``fold_in(k_gdrop, i)`` through the Flax
discriminator's ``make_rng`` (``test_torch_discriminator.jax_gdrop_noise``).

Tolerances are ``tests/test_torch_twingan_step.py``'s (losses atol 1e-4,
states 1e-5, gradient norms rtol 1e-3, gradients rtol 1e-3 plus 1e-2 of
the network's largest on the generator side), for the same reasons; the
discriminator side's share is 3e-3 here (``OPTIONS_DIS_GRAD_SHARE``, the
reason beside it), parameters after the G step's SGD are held to what
the gradients' tolerance implies (``check_state_after_sgd``), and
``translate`` to ``tests/test_torch_translate.py``'s 1e-4 / 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_discriminator import jax_gdrop_noise  # noqa: E402
from test_torch_twingan_step import (  # noqa: E402,F401
    BATCH,
    DIS_SIDE,
    GEN_GRAD_SHARE,
    GRAD_REL,
    LR,
    STATE_ATOL,
    Recorder,
    _flat,
    _two_torch_threads,
    check_grads,
    check_metrics,
    randomize,
    recording_sgd,
)
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.state import GanTrainState as JaxGanTrainState  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    DIS_S,
    TwinGANConfig,
    TwinGANTrainer,
)

RES = 32
STEP = 101
# The largest strength the gdrop schedule reaches at its defaults: coef 0.2 x
# (1 - lim 0.5) ** exp 2. At 0.3 (out of the schedule's reach) the fused
# passes' t-domain discriminator turns so sensitive that one unit in the last
# place of every weight moves the port's own fool loss by 1.3e-4.
STRENGTH = 0.05
STYLE_DIM = 4
EMBED_DIM = 6
# The discriminator side's gradient share (DIS_GRAD_SHARE is 1e-3). On the
# unfused D step's s domain, the JAX discriminator's own gradients move by
# 1.4e-3 of the largest when it is handed the port's s_prime (within 1.5e-5
# of its own, the generator's fp32 rounding) in place of its own: one
# leaky-ReLU input near 0 crosses its kink, which changes one term of each
# first-layer sum over 2 x 32 x 32 positions. The port's gradients on its
# s_prime agree with JAX's on the same input to 1.5e-6 of the largest.
OPTIONS_DIS_GRAD_SHARE = 3e-3
TRANSLATE_TOL = dict(rtol=1e-4, atol=2e-4)  # tests/test_torch_translate.py's
MODEL_KW = dict(resolution=RES, max_channels=16, equalized_lr=True, do_pixel_norm=True,
                num_domains=2, do_self_attention=True, self_attention_hw=16,
                style_dim=STYLE_DIM)
TRAINER_KW = dict(batch_size=BATCH, use_unet=True, n_critic=2, use_gdrop=True,
                  use_style_embedding=True, style_embed_size=STYLE_DIM,
                  do_encoder_distillation=True, source_embed_dim=EMBED_DIM,
                  target_embed_dim=EMBED_DIM)


def configs(norm_type, distillation_start_hw):
    kw = dict(TRAINER_KW, distillation_start_hw=distillation_start_hw)
    jcfg = JaxTwinGANConfig(
        model=JaxPGGANConfig(norm_type=norm_type, **MODEL_KW),
        loss=JaxGanLossConfig(architecture="dragan"),
        opt=JaxOptimizerConfig(optimizer="sgd", learning_rate=LR), **kw)
    pcfg = TwinGANConfig(
        model=PGGANConfig(norm_type=norm_type, **MODEL_KW),
        loss=GanLossConfig(architecture="dragan"),
        opt=OptimizerConfig(optimizer="sgd", learning_rate=LR), **kw)
    return jcfg, pcfg


def g_draws(rng, critic_step, fuse, shapes):
    """The JAX _g_step's random style and gdrop draws, by the names the
    port's g_step takes."""
    k_fwd, k_gdrop = jax.random.split(jax.random.fold_in(rng, critic_step))
    style = jax.random.normal(jax.random.fold_in(k_fwd, 7), (BATCH, STYLE_DIM), jnp.float32)
    # 32 px: no cycle GAN term, so one discriminator pass (the prime) per domain.
    gdrop = {(d if fuse else f"{d}_prime"): jax_gdrop_noise(jax.random.fold_in(k_gdrop, 2 * i),
                                                            shapes(BATCH))
             for i, d in enumerate("st")}
    return torch.tensor(np.asarray(style)), gdrop


def d_draws(rng, critic_step, fuse, shapes, image_shape):
    """The JAX _d_step's random style, gdrop and gradient-penalty draws."""
    k_fwd, k_gdrop, k_gp_s, k_gp_t = jax.random.split(jax.random.fold_in(rng, critic_step), 4)
    style = jax.random.normal(jax.random.fold_in(k_fwd, 7), (BATCH, STYLE_DIM), jnp.float32)
    gdrop, gp = {}, {}
    for b, (d, k_gp) in enumerate((("s", k_gp_s), ("t", k_gp_t))):
        fold = lambda i, b=b: jax.random.fold_in(k_gdrop, 4 * b + i)  # noqa: E731
        if fuse:
            gdrop[d] = jax_gdrop_noise(fold(0), shapes(2 * BATCH))
        else:
            gdrop[f"{d}_real"] = jax_gdrop_noise(fold(0), shapes(BATCH))
            gdrop[f"{d}_prime"] = jax_gdrop_noise(fold(1), shapes(BATCH))
        gdrop[f"{d}_gp"] = jax_gdrop_noise(fold(3), shapes(BATCH))
        k_alpha, k_perturb = jax.random.split(k_gp)
        gp[d] = {"alpha": torch.tensor(np.asarray(
                     jax.random.uniform(k_alpha, (BATCH, 1, 1, 1), jnp.float32))),
                 "noise": torch.tensor(np.asarray(
                     jax.random.uniform(k_perturb, image_shape, jnp.float32, -1.0, 1.0)))}
    return torch.tensor(np.asarray(style)), gdrop, gp


def port_state(trainer, jstate):
    state = bridge.twingan_state_from_flax(trainer, jstate.params, jstate.model_state,
                                           int(jstate.step), int(jstate.critic_step))
    state.gdrop_strength = torch.tensor(float(jstate.gdrop_strength))
    state.gen_opt, state.dis_opt = Recorder(state.gen_opt), Recorder(state.dis_opt)
    return state


def initial_states(norm_type, distillation_start_hw):
    """(JAX trainer with recording SGD, JAX state, port trainer): the
    networks drawn by the port's init and bridged (which spares the JAX
    init's compilation), every norm bank, moving statistic and bias drawn
    from a seed, at step 101 with gdrop strength 0.3."""
    jcfg, pcfg = configs(norm_type, distillation_start_hw)
    assert jcfg.fuse == pcfg.fuse == (norm_type == "instance_norm")
    jtrainer = JaxTwinGANTrainer(jcfg)
    jtrainer.gen_tx = recording_sgd(LR)
    jtrainer.dis_tx = recording_sgd(LR)
    ptrainer = TwinGANTrainer(pcfg, device="cpu")
    params, model_state = bridge.flax_from_twingan_state(ptrainer.init_state(0))
    rs = np.random.RandomState(5)
    params, model_state = randomize(params, rs), randomize(model_state, rs)
    assert set(params) == set(jtrainer.generator_side_keys + DIS_SIDE)
    side = lambda keys: {k: params[k] for k in keys}  # noqa: E731
    state0 = JaxGanTrainState(
        step=np.int32(STEP), critic_step=np.int32(2 * STEP), params=params,
        model_state=model_state,
        gen_opt_state=jtrainer.gen_tx.init(side(jtrainer.generator_side_keys)),
        dis_opt_state=jtrainer.dis_tx.init(side(DIS_SIDE)),
        gdrop_strength=np.float32(STRENGTH), gen_loss_ema=np.float32(0.0))
    return jtrainer, state0, ptrainer


def batch(seed):
    rs = np.random.RandomState(seed)
    images = rs.rand(2, BATCH, RES, RES, 3).astype(np.float32)
    embeds = rs.randn(2, BATCH, EMBED_DIM).astype(np.float32)
    return {"source": images[0], "target": images[1], "source_embedding": embeds[0],
            "target_embedding": embeds[1]}


def tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def run_g_step(norm_type, distillation_start_hw):
    """Both trainers' G step from the same state and draws."""
    jtrainer, state0, ptrainer = initial_states(norm_type, distillation_start_hw)
    b = batch(6)
    rng = jax.random.PRNGKey(1)
    state1, jm = jtrainer.g_step(tree(state0), tree(b), rng)
    shapes = ptrainer.build_nets()[DIS_S].gdrop_shapes
    style, gdrop = g_draws(rng, 2 * STEP, ptrainer.cfg.fuse, shapes)
    port, pm = ptrainer.g_step(port_state(ptrainer, state0), torch_batch(b),
                               random_style=style, gdrop_noise=gdrop)
    return dict(jtrainer=jtrainer, ptrainer=ptrainer, state0=state0,
                state1=jax.device_get(state1), jm=jax.device_get(jm), port=port, pm=pm)


def run_d_step(norm_type, distillation_start_hw):
    """Both trainers' D step from the same state and draws."""
    jtrainer, state0, ptrainer = initial_states(norm_type, distillation_start_hw)
    b = batch(7)
    rng = jax.random.PRNGKey(2)
    state1, jm = jtrainer.d_step(tree(state0), tree(b), rng)
    shapes = ptrainer.build_nets()[DIS_S].gdrop_shapes
    style, gdrop, gp = d_draws(rng, 2 * STEP, ptrainer.cfg.fuse, shapes, b["source"].shape)
    port, pm = ptrainer.d_step(port_state(ptrainer, state0), torch_batch(b), gp_noise=gp,
                               random_style=style, gdrop_noise=gdrop)
    return dict(jtrainer=jtrainer, ptrainer=ptrainer, state0=state0,
                state1=jax.device_get(state1), jm=jax.device_get(jm), port=port, pm=pm)


def check_state_after_sgd(jstate, port, names, grads, grad_names, share):
    """The networks ``names`` after a step: moving statistics, and the
    parameters no gradient of ``grad_names`` moved, within STATE_ATOL; the
    others within STATE_ATOL plus LR times their gradient's tolerance
    (GRAD_REL of the gradient and ``share`` of its network's largest): SGD
    moves each by LR times its gradient, and the gradients are as
    rounding-sensitive as ``tests/test_torch_twingan_step.py`` measures
    (the content encoder's here reach 10 in magnitude, so that share is
    past STATE_ATOL)."""
    ref_grads = _flat(grads, grad_names)
    scale = {n: max(float(np.abs(v).max()) for k, v in ref_grads.items()
                    if k.startswith(n + ".")) for n in grad_names}
    ref = {k: v.numpy() for k, v in bridge.train_state_dict(jstate.params, jstate.model_state,
                                                            names).items()}
    got = {k: v.numpy() for k, v in port.nets.state_dict().items()
           if k.split(".", 1)[0] in names}
    assert set(ref) == set(got)
    for k in ref:
        tol = STATE_ATOL
        if k in ref_grads:
            tol = tol + LR * (GRAD_REL * np.abs(ref_grads[k]) + share * scale[k.split(".")[0]])
        assert (np.abs(got[k] - ref[k]) <= tol).all(), (k, np.abs(got[k] - ref[k]).max())


def check_g_step(steps, distilled):
    check_metrics(steps["jm"], steps["pm"])
    names = {k for k in steps["pm"] if "distillation" in k}
    assert bool(names) == distilled, names
    assert {"l_s_style", "l_t_style"} <= set(steps["pm"])
    assert float(steps["jm"]["gdrop_strength"]) > 0
    gen_side = steps["ptrainer"].generator_side_keys
    assert set(gen_side) == set(steps["jtrainer"].generator_side_keys)
    s1 = steps["state1"]
    heads = ("distill_s", "distill_t")
    if not distilled:  # the heads are below their start: no gradient reaches them
        for k, g in _flat(s1.gen_opt_state, heads).items():
            assert not g.any() and not steps["port"].gen_opt.grads[k].any(), k
    live = tuple(n for n in gen_side if distilled or n not in heads)
    recorder = steps["port"].gen_opt
    recorder.grads = {k: v for k, v in recorder.grads.items() if k.split(".")[0] in live}
    check_grads(s1.gen_opt_state, recorder, live, GEN_GRAD_SHARE)
    check_state_after_sgd(s1, steps["port"], gen_side, s1.gen_opt_state, gen_side,
                          GEN_GRAD_SHARE)
    np.testing.assert_allclose(float(steps["port"].gdrop_strength),
                               float(s1.gdrop_strength), atol=STATE_ATOL, rtol=0)


def check_d_step(steps):
    check_metrics(steps["jm"], steps["pm"])
    s1 = steps["state1"]
    check_grads(s1.dis_opt_state, steps["port"].dis_opt, DIS_SIDE, OPTIONS_DIS_GRAD_SHARE)
    check_state_after_sgd(s1, steps["port"], steps["ptrainer"].generator_side_keys + DIS_SIDE,
                          s1.dis_opt_state, DIS_SIDE, OPTIONS_DIS_GRAD_SHARE)


def check_translate(steps):
    """``translate`` (eval mode) after a step: the style from the style
    encoder of the source images by default, as the JAX method computes
    it; a given style replaces it."""
    jtrainer, ptrainer = steps["jtrainer"], steps["ptrainer"]
    s1 = steps["state1"]
    images = np.random.RandomState(9).rand(BATCH, RES, RES, 3).astype(np.float32)
    ref = np.asarray(jtrainer.translate(tree(s1), jnp.asarray(images), "t2s"))
    got = ptrainer.translate(steps["port"], torch.from_numpy(images), "t2s")
    np.testing.assert_allclose(got.numpy(), ref, **TRANSLATE_TOL)
    other = ptrainer.translate(steps["port"], torch.from_numpy(images), "t2s",
                               style=torch.zeros(BATCH, STYLE_DIM))
    assert not torch.allclose(other, got)


@pytest.fixture(scope="module")
def steps():
    return run_g_step("batch_norm", distillation_start_hw=16)


def test_g_step(steps):
    check_g_step(steps, distilled=True)
