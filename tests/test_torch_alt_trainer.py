"""``GanTrainer`` with ``generator_network`` dcgan and cyclegan against the
JAX package's (``test_torch_alt_runner.py`` runs a DCGAN stage through the
port's ``StageRunner`` and CLI).

Shapes of ``tests/test_train.py``'s network-selection cases: DCGAN at 32 px
(depth 8, latent 16), CycleGAN at 16 px (8 filters, the trainer's 6
residual blocks), batch 4, fp32 on the CPU, DRAGAN (so that the D step's
gradient penalty differentiates through the networks' norms), Adam at its
defaults, n_critic 2, a Polyak average (decay 0.9). The state is drawn in
the port (every bias, norm scale and bias and running moment from a seed,
the Polyak average off the parameters) and carried to JAX through
``bridge.flax_state_dict``; the G step starts from it, the D step from the
JAX state after the G step, bridged again. DCGAN's latent is the batch's
2-D "source" item on both sides (JAX's ``_gen_input`` passes it through);
CycleGAN translates the batch's "source" images. The penalty's alpha and
perturbation are the JAX step's draws, injected (``gp_draws``).

Checks, with ``tests/test_torch_gan_trainer.py``'s helpers and tolerances
(losses atol 1e-4, gradient norms rtol 1e-3, gradients from Adam's slots
rtol 1e-3 plus 1e-2 (generator) or 1e-3 (discriminator) of the network's
largest gradient, parameters 1e-5 where the gradient's sign is settled):
the metrics and gradients of each step, CycleGAN's L1 term in the G loss,
the running moments each step moves (DCGAN: the generator's in the G step,
the discriminator's from the fake pass in the D step; atol 1e-5),
``round_step`` (G then D) equal to the two steps, ``sample`` from the JAX
state after both (eval mode, the Polyak average; atol 1e-4), and the whole
state bridged both ways bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_gan_trainer import (  # noqa: E402
    check_metrics,
    check_side,
    check_state_fields,
    gp_draws,
)
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import DIS, GEN, GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402

from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

BATCH = 4
STATS_ATOL = 1e-5
SAMPLE_ATOL = 1e-4
GEN_GRAD_SHARE = 1e-2
DIS_GRAD_SHARE = 1e-3
NETWORKS = {
    "dcgan": (32, dict(dcgan_depth=8, dcgan_latent_dim=16)),
    "cyclegan": (16, dict(cyclegan_num_channels=8)),
}
TRAINER_KW = dict(batch_size=BATCH, n_critic=2, moving_average_decay=0.9, max_steps=10)


def configs(network):
    res, kw = NETWORKS[network]
    model = dict(resolution=res, max_channels=16)
    jcfg = JaxGanTrainerConfig(model=JaxPGGANConfig(**model), generator_network=network,
                               loss=JaxGanLossConfig(architecture="dragan"), **kw, **TRAINER_KW)
    pcfg = GanTrainerConfig(model=PGGANConfig(**model), generator_network=network,
                            loss=GanLossConfig(architecture="dragan"), **kw, **TRAINER_KW)
    return jcfg, pcfg


def seeded_state(ptrainer, seed=5):
    """The port's init_state with every bias, norm scale and bias and
    running moment drawn from ``seed``, and the Polyak average moved off
    the parameters."""
    state = ptrainer.init_state(seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, t in state.nets.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.uniform_(0.5, 1.5, generator=g)
            elif leaf in ("bias", "mean"):
                t.normal_(0.0, 0.3, generator=g)
        for k, t in state.gen_ema_params.items():
            t.copy_(dict(state.nets[GEN].named_parameters())[k]
                    + 0.01 * torch.randn(t.shape, generator=g))
    return state


def jax_state(jtrainer, port_state):
    """The port's state as the JAX trainer's ``GanTrainState``."""
    template = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    state = flax.serialization.from_state_dict(template, bridge.flax_state_dict(port_state))
    return jax.tree_util.tree_map(jnp.asarray, state)


def batches(network, res, rs):
    """(JAX batches, port batches) of the G and the D step."""
    out_j, out_p = [], []
    for _ in range(2):
        target = rs.rand(BATCH, res, res, 3).astype(np.float32)
        if network == "dcgan":
            source = rs.randn(BATCH, NETWORKS[network][1]["dcgan_latent_dim"]).astype(np.float32)
        else:
            source = rs.rand(BATCH, res, res, 3).astype(np.float32)
        out_j.append({"target": jnp.asarray(target), "source": jnp.asarray(source)})
        out_p.append({"target": torch.from_numpy(target), "source": torch.from_numpy(source)})
    return out_j, out_p


def run_steps(network):
    jcfg, pcfg = configs(network)
    res = jcfg.model.resolution
    jtrainer, ptrainer = JaxGanTrainer(jcfg), GanTrainer(pcfg, device="cpu")
    pstate0 = seeded_state(ptrainer)
    state0 = jax_state(jtrainer, pstate0)
    state0_np = jax.device_get(state0)
    jb, pb = batches(network, res, np.random.RandomState(6))
    rng = jax.random.PRNGKey(1)
    state1, jm_g = jtrainer.g_step(jax.tree_util.tree_map(jnp.copy, state0), jb[0], rng)
    state1 = jax.device_get(state1)
    noise = gp_draws(rng, int(state1.critic_step), (BATCH, res, res, 3))
    state2, jm_d = jtrainer.d_step(jax.tree_util.tree_map(jnp.asarray, state1), jb[1], rng)
    state2 = jax.device_get(state2)
    z_s = np.asarray(jb[0]["source"])
    sample = np.asarray(jtrainer.sample(jax.tree_util.tree_map(jnp.asarray, state2),
                                        jnp.asarray(z_s)))

    g_port, pm_g = ptrainer.g_step(bridge.state_from_flax(ptrainer, state0_np), pb[0])
    d_port, pm_d = ptrainer.d_step(bridge.state_from_flax(ptrainer, state1), pb[1],
                                   gp_noise=noise)
    # round_step: the two steps in order, the penalty's draws injected.
    ptrainer.d_step = functools.partial(GanTrainer.d_step, ptrainer, gp_noise=noise)
    round_port, pm_round = ptrainer.round_step(bridge.state_from_flax(ptrainer, state0_np),
                                               pb)
    del ptrainer.d_step
    return dict(network=network, jcfg=jcfg, ptrainer=ptrainer, state0=state0_np,
                state1=state1, state2=state2, jm_g=jax.device_get(jm_g),
                jm_d=jax.device_get(jm_d), g_port=g_port, d_port=d_port, pm_g=pm_g,
                pm_d=pm_d, round_port=round_port, pm_round=pm_round, sample=sample, z_s=z_s,
                pb=pb)


@pytest.fixture(scope="module", params=list(NETWORKS))
def steps(request):
    return run_steps(request.param)


def batch_stats(state_dict, net):
    prefix = f"model_state/{net}/batch_stats/"
    return {k: v for k, v in bridge.flat_from_flax(state_dict).items() if k.startswith(prefix)}


def check_stats(jstate, port_state, net):
    """The network's running moments after a step against the JAX ones."""
    ref, got = batch_stats(jstate, net), batch_stats(bridge.flax_state_dict(port_state), net)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=STATS_ATOL, err_msg=k)
    return ref


def test_g_step(steps):
    check_metrics(steps["jm_g"], steps["pm_g"])
    check_side(steps["state1"], steps["g_port"], "gen", GEN_GRAD_SHARE)
    check_state_fields(steps["state1"], steps["g_port"])
    # The discriminator's parameters and moments did not move.
    ported = bridge.flat_from_flax(bridge.flax_state_dict(steps["g_port"]))
    for k, v in bridge.flat_from_flax(steps["state0"]).items():
        if k.startswith((f"params/{DIS}/", f"model_state/{DIS}/")):
            np.testing.assert_array_equal(ported[k], v, err_msg=k)


def test_d_step(steps):
    check_metrics(steps["jm_d"], steps["pm_d"])
    assert float(steps["pm_d"]["gradient_penalty"]) > 0
    check_side(steps["state2"], steps["d_port"], "dis", DIS_GRAD_SHARE)
    check_state_fields(steps["state2"], steps["d_port"])


def test_running_moments_follow_the_jax_steps(steps):
    """DCGAN: the G step moves the generator's running moments, the D step
    the discriminator's (its fake pass); CycleGAN has none."""
    for port, jstate, net, before in ((steps["g_port"], steps["state1"], GEN, steps["state0"]),
                                      (steps["d_port"], steps["state2"], DIS, steps["state1"])):
        ref = check_stats(jstate, port, net)
        assert bool(ref) == (steps["network"] == "dcgan")
        old = batch_stats(before, net)
        for k in ref:
            assert not np.array_equal(ref[k], old[k]), k


def test_cyclegan_generator_loss_has_the_paired_l1_term(steps):
    """The G loss less the GAN term is the L1 distance of the target and
    the generated images (CycleGAN), or 0 (DCGAN)."""
    from twingan_tpu_torch.train.losses import generator_gan_loss

    ptrainer = steps["ptrainer"]
    state = bridge.state_from_flax(ptrainer, steps["state0"])
    gen, dis = state.nets[GEN], state.nets[DIS]
    batch = steps["pb"][0]
    with torch.no_grad():
        fake = gen(ptrainer._gen_input(batch, None, BATCH), update=False)
        gan = generator_gan_loss(ptrainer.cfg.loss, dis(fake))
    l1 = torch.mean(torch.abs(batch["target"] - fake))
    want = gan + (l1 if steps["network"] == "cyclegan" else 0.0)
    np.testing.assert_allclose(float(steps["pm_g"]["generator_loss"]), float(want),
                               rtol=1e-5, atol=1e-6)


def test_round_step_is_the_two_steps(steps):
    """``round_step`` (the base class's G then n_critic - 1 D steps) equals
    the JAX state after its G and D step."""
    check_side(steps["state2"], steps["round_port"], "dis", DIS_GRAD_SHARE)
    check_side(steps["state1"], steps["round_port"], "gen", GEN_GRAD_SHARE)
    check_state_fields(steps["state2"], steps["round_port"])
    metrics = {**steps["jm_g"], **steps["jm_d"]}
    check_metrics(metrics, steps["pm_round"])


def test_sample(steps):
    ptrainer = steps["ptrainer"]
    state = bridge.state_from_flax(ptrainer, steps["state2"])
    out = ptrainer.sample(state, torch.from_numpy(steps["z_s"]))
    assert out.shape == steps["sample"].shape
    np.testing.assert_allclose(out.numpy(), steps["sample"], rtol=0, atol=SAMPLE_ATOL)
    assert state.nets[GEN].training  # sample restores the mode


def test_state_bridges_both_ways(steps):
    jstate = steps["state2"]
    ref = bridge.flat_from_flax(jstate)
    got = bridge.flat_from_flax(bridge.flax_state_dict(
        bridge.state_from_flax(steps["ptrainer"], jstate)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    has_stats = any("/batch_stats/" in k for k in ref)
    assert has_stats == (steps["network"] == "dcgan")


def test_networks_refuse_conditional_labels():
    for network in NETWORKS:
        with pytest.raises(ValueError, match="pggan"):
            GanTrainer(GanTrainerConfig(generator_network=network,
                                        use_conditional_labels=True, num_classes=3),
                       device="cpu")
