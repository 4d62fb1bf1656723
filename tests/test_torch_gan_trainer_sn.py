"""The checks of ``test_torch_gan_trainer.py`` with spectral norm: in the
discriminator (``spectral_norm``), and also in the generator
(``spectral_norm_in_non_discriminator``), where the generator's
conv-leaky-pixel-norm steps (kernel B4's function) take W / sigma.

16 px, max_channels 16, batch 2, fp32 on the CPU, without equalized lr
(see ``CASES``), the rest as in that file: the same state drawn from a seed (the spectral ``u`` as the JAX init
draws it, bridged), the same injected z and penalty draws, the same
tolerances (losses atol 1e-4, gradients rtol 1e-3 plus 1e-2 / 1e-3 of the
largest, states atol 1e-5, ``sample`` rtol/atol 1e-4). Beside them, every
``u`` after each step within 1e-6: the JAX G step writes the generator's
(its one updating pass) and not the discriminator's; the D step writes the
discriminator's once, from the state before the step, which its fake,
real and penalty passes all read, and not the generator's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_gan_trainer as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.ops import fused_conv  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import DIS, GEN, GanTrainer  # noqa: E402

RES = 16
U_ATOL = 1e-6
# Without equalized lr: its input scale on top of W / sigma would shrink
# every layer of the discriminator until its prediction no longer depends
# on its input (chip_smoke.spectral_generation_config).
CASES = {"discriminator": dict(spectral_norm=True, equalized_lr=False),
         "everywhere": dict(spectral_norm=True, spectral_norm_in_non_discriminator=True,
                            equalized_lr=False)}


def run_steps(model_kw):
    jcfg, pcfg = base.configs(RES, **model_kw)
    jtrainer = JaxGanTrainer(jcfg)
    state0 = base.initial_state(jtrainer, 0)
    rs = np.random.RandomState(6)
    shape = (base.BATCH, 1, 1, jcfg.model.noise_dim)
    z_g, z_d, z_s = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    images = rs.rand(2, base.BATCH, RES, RES, 3).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    jbatch = lambda img, z: {"target": jnp.asarray(img), "source": jnp.asarray(z)}  # noqa: E731
    state1, jm_g = jtrainer.g_step(jax.tree_util.tree_map(jnp.asarray, state0),
                                   jbatch(images[0], z_g), rng)
    state1 = jax.device_get(state1)
    state2, jm_d = jtrainer.d_step(jax.tree_util.tree_map(jnp.asarray, state1),
                                   jbatch(images[1], z_d), rng)
    state2 = jax.device_get(state2)
    sample = np.asarray(jtrainer.sample(jax.tree_util.tree_map(jnp.asarray, state2),
                                        jnp.asarray(z_s)))

    ptrainer = GanTrainer(pcfg, device="cpu")
    g_port, pm_g = ptrainer.g_step(bridge.state_from_flax(ptrainer, state0),
                                   {"target": torch.from_numpy(images[0])},
                                   z=torch.from_numpy(z_g))
    fused_conv.reset_launch_counts()
    noise = base.gp_draws(rng, int(state1.critic_step), images[1].shape)
    d_port, pm_d = ptrainer.d_step(bridge.state_from_flax(ptrainer, state1),
                                   {"target": torch.from_numpy(images[1]),
                                    "source": torch.from_numpy(z_d)}, gp_noise=noise)
    d_routes = dict(fused_conv.launch_counts)
    return dict(jcfg=jcfg, ptrainer=ptrainer, state0=state0, state1=state1, state2=state2,
                jm_g=jax.device_get(jm_g), jm_d=jax.device_get(jm_d), g_port=g_port,
                d_port=d_port, pm_g=pm_g, pm_d=pm_d, d_routes=d_routes, sample=sample,
                z_s=z_s, model_kw=model_kw)


@pytest.fixture(scope="module", params=list(CASES))
def steps(request):
    return run_steps(CASES[request.param])


def _u(state, net):
    """One network's spectral vectors of a JAX state, or of the port's."""
    if hasattr(state, "nets"):
        return {k: v.numpy() for k, v in state.nets[net].state_dict().items()
                if k.endswith("u")}
    return {k: v.numpy() for k, v in bridge.state_dict_from_flax(
        {}, spectral=state.model_state[net].get("spectral", {})).items()}


def test_g_step_losses(steps):
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients_and_state(steps):
    base.check_g_step(steps)


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients_and_state(steps):
    base.check_d_step(steps)


def test_sample(steps):
    base.check_sample(steps)


def test_spectral_u_after_each_step(steps):
    everywhere = steps["model_kw"].get("spectral_norm_in_non_discriminator", False)
    s0, s1, s2 = ({net: _u(steps[k], net) for net in (GEN, DIS)}
                  for k in ("state0", "state1", "state2"))
    # from_rgb, two blocks of two convs, before_fc's two, the prediction;
    # block_4's two convs, two blocks of two, to_rgb.
    assert len(s0[DIS]) == 8
    assert len(s0[GEN]) == (7 if everywhere else 0)
    g_port = {net: _u(steps["g_port"], net) for net in (GEN, DIS)}
    d_port = {net: _u(steps["d_port"], net) for net in (GEN, DIS)}
    for k in s0[GEN]:  # written by the G step only
        np.testing.assert_allclose(g_port[GEN][k], s1[GEN][k], atol=U_ATOL, rtol=0, err_msg=k)
        np.testing.assert_array_equal(d_port[GEN][k], s1[GEN][k], err_msg=k)
        np.testing.assert_array_equal(s2[GEN][k], s1[GEN][k], err_msg=k)
        assert not np.array_equal(s1[GEN][k], s0[GEN][k]) or s0[GEN][k].size == 1, k
    for k in s0[DIS]:  # written by the D step only
        np.testing.assert_array_equal(g_port[DIS][k], s0[DIS][k], err_msg=k)
        np.testing.assert_array_equal(s1[DIS][k], s0[DIS][k], err_msg=k)
        np.testing.assert_allclose(d_port[DIS][k], s2[DIS][k], atol=U_ATOL, rtol=0, err_msg=k)
        # u of the [C, 1] prediction is +-1 and cannot move.
        assert not np.array_equal(s2[DIS][k], s1[DIS][k]) or s0[DIS][k].size == 1, k


def test_b4_takes_w_over_sigma(steps):
    """The D step's no-grad generator pass takes B4's route (the plain
    version on the CPU), on W / sigma when the generator has spectral
    norm: its fake images agree with the JAX step's, which the losses
    above hold; here, the route and the folded weights."""
    assert steps["d_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 0}
    gen = steps["d_port"].nets[GEN]
    block = gen.block_8_conv0
    assert block.fusable
    w9 = fused_conv.fold_weights(block.conv.weight(), block.conv.input_scale)
    plain = fused_conv.fold_weights(block.conv.kernel, block.conv.input_scale)
    assert torch.equal(w9, plain) != block.conv.spectral_norm


def test_chip_smoke_spectral_comparison_on_the_cpu():
    """chip_smoke.py's pggan256 spectral-norm comparison, with the CPU
    standing in for the card at 32 px: bf16 against fp32 within the
    script's limits and every discriminator ``u`` after each step within
    SPECTRAL_U_ATOL, fp32 against fp32 exactly."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.spectral_generation_config(batch=base.BATCH)
    assert cfg.model.spectral_norm and not cfg.model.equalized_lr
    cfg = cfg.replace(model=cfg.model.replace(resolution=32, max_channels=16))
    trainer = GanTrainer(cfg, device="cpu")
    state = trainer.init_state(smoke.SEED)
    smoke.randomize_biases(state.nets, smoke.SEED)
    weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
    batches, zs, gp_noise = smoke.generation_inputs(cfg, base.BATCH, 0)
    rows = smoke.compare_generation_steps(cfg, weights, batches, zs, gp_noise, card="cpu",
                                          phase="recipe",
                                          held_buffers={"u": smoke.SPECTRAL_U_ATOL})
    for row in rows:
        assert row["ok"], row["check"]
        held = row["buffers_after_step"]["u"]
        assert held["held"] == 10  # from_rgb, 3 blocks of two, before_fc's two, prediction
        if "float32 vs" in row["check"]:
            assert max(row["loss_abs_err"].values()) == 0.0 and held["max_abs_err"] == 0.0
