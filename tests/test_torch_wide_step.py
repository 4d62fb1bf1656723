"""One G step and one D step of the port's GanTrainer past 1024 channels
against the JAX package's: kernel B4's function beyond one block's Cout.

8 px, min_channels 1032 (every layer 1032 wide: one block of B4 holds 1024
channels, so on the card each conv-leaky-pixel-norm step takes B4's two
passes, the second tile 8 channels wide), norm "none" with pixel norm and
equalized lr, batch 2, DRAGAN, Adam, n_critic 2, a Polyak average (decay
0.9). The configuration the port refused outright while B4 had its cap.

The weights are drawn in the port (``init_state``, then every bias and the
Polyak average moved from a seed) and carried to the JAX state by
``bridge.flax_state_dict``, which spares the JAX initializer. The checks
and their tolerances are ``tests/test_torch_gan_trainer.py``'s: losses
atol 1e-4, gradient norms rtol 1e-3, gradients (from Adam's slots) rtol
1e-3 plus 1e-2 (generator) or 1e-3 (discriminator) of the network's
largest gradient, parameters 1e-5 where the gradient's sign is settled;
``sample`` (B4's route, the plain version here) to 1e-4.

The G step runs in float32 on both sides. The D step's gradient penalty
is not well conditioned in float32 at this width: it differentiates the
discriminator's input gradient, which switches between the leaky ReLU's
slopes 1 and 0.2 where a pre-activation crosses 0, and among the 132 K
pre-activations of one 1032-channel layer at 8 px a few lie within
float32's rounding of 0. The port's float32 CPU convolutions (oneDNN) put
two of block_8_conv1's pre-activations (-3.0e-7 and -1.2e-7 in float64) on
the other side of 0, which moves the penalty by 1.8e-3 of itself (1.81092
against 1.81415); the JAX package's float32 step rounds them as float64
does (its penalty is within 4e-7 of float64's). So the port's D step runs
in float64 (``float64_port``: the port has no float64 mode and is not
edited for one), the function without rounding, and is held against the
JAX float32 step with the float32 tolerances above (the JAX D step in
float64, jit compile and run, would take this file past a minute).
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from test_torch_gan_trainer import (  # noqa: E402
    TRAINER_KW,
    check_d_step,
    check_g_step,
    check_metrics,
    check_sample,
    gp_draws,
)
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import layers  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import basic, fused_conv  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GEN, GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402

RES = 8
BATCH = TRAINER_KW["batch_size"]
WIDTH = fused_conv.COUT_TILE + 8
MODEL_KW = dict(resolution=RES, min_channels=WIDTH, norm_type="none", do_pixel_norm=True,
                equalized_lr=True)


def seeded_state(ptrainer, seed=5):
    """The port's init_state with every bias drawn from ``seed`` and the
    Polyak average moved off the parameters."""
    state = ptrainer.init_state(seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, t in state.nets.state_dict().items():
            if key.rsplit(".", 1)[-1] == "bias":
                t.normal_(0.0, 0.3, generator=g)
        params = dict(state.nets[GEN].named_parameters())
        for k, t in state.gen_ema_params.items():
            t.copy_(params[k] + 0.01 * torch.randn(t.shape, generator=g))
    return state


@contextlib.contextmanager
def float64_port():
    """The port computes in float64: its default dtype and its "float32"
    compute dtype float64, ``Tensor.float`` keeping float64, minibatch
    stddev keeping float32's epsilon (1e-8, the JAX package's), and kernel
    B4's argument check taking float64 (its plain version, which runs here,
    computes in x's type), as ``tools/twingan_step_rounding.py`` and
    ``tests/torch_quant_parity.py`` do."""
    default, float_, stddev = torch.get_default_dtype(), torch.Tensor.float, basic.minibatch_stddev
    check = fused_conv._check
    torch.set_default_dtype(torch.float64)
    layers._DTYPES["float32"] = torch.float64
    torch.Tensor.float = torch.Tensor.double
    basic.minibatch_stddev = functools.partial(stddev, eps=1e-8)
    fused_conv._check = lambda *ts: check(*(t.to(torch.float32) for t in ts))
    try:
        yield
    finally:
        torch.set_default_dtype(default)
        layers._DTYPES["float32"] = torch.float32
        torch.Tensor.float = float_
        basic.minibatch_stddev = stddev
        fused_conv._check = check


def configs():
    kw = dict(TRAINER_KW, loss=None)
    jcfg = JaxGanTrainerConfig(model=JaxPGGANConfig(**MODEL_KW),
                               **{**kw, "loss": JaxGanLossConfig(architecture="dragan")})
    pcfg = GanTrainerConfig(model=PGGANConfig(**MODEL_KW),
                            **{**kw, "loss": GanLossConfig(architecture="dragan")})
    return jcfg, pcfg


@pytest.fixture(scope="module")
def steps():
    jcfg, pcfg = configs()
    assert {jcfg.model.channels(s) for s in range(2)} == {WIDTH}
    jtrainer, ptrainer = JaxGanTrainer(jcfg), GanTrainer(pcfg, device="cpu")
    template = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    state0 = jax.device_get(serialization.from_state_dict(
        template, bridge.flax_state_dict(seeded_state(ptrainer))))
    rs = np.random.RandomState(6)
    shape = (BATCH, 1, 1, jcfg.model.noise_dim)
    z_g, z_d, z_s = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    images = rs.rand(2, BATCH, RES, RES, 3).astype(np.float32)
    rng = jax.random.PRNGKey(1)

    state1, jm_g = jtrainer.g_step(jax.tree_util.tree_map(jnp.asarray, state0),
                                   {"target": jnp.asarray(images[0]), "source": jnp.asarray(z_g)},
                                   rng)
    state1 = jax.device_get(state1)
    fused_conv.reset_launch_counts()
    g_port, pm_g = ptrainer.g_step(bridge.state_from_flax(ptrainer, state0),
                                   {"target": torch.from_numpy(images[0])},
                                   z=torch.from_numpy(z_g))
    g_routes = dict(fused_conv.launch_counts)

    state2, jm_d = jtrainer.d_step(jax.tree_util.tree_map(jnp.asarray, state1),
                                   {"target": jnp.asarray(images[1]), "source": jnp.asarray(z_d)},
                                   rng)
    state2 = jax.device_get(state2)
    sample = np.asarray(jtrainer.sample(jax.tree_util.tree_map(jnp.asarray, state2),
                                        jnp.asarray(z_s)))
    # The port's D step in float64, from the JAX state after the G step.
    with float64_port():
        ptrainer64 = GanTrainer(pcfg, device="cpu")
        fused_conv.reset_launch_counts()
        noise = {k: v.double() for k, v in
                 gp_draws(rng, int(state1.critic_step), images[1].shape).items()}
        d_port, pm_d = ptrainer64.d_step(bridge.state_from_flax(ptrainer64, state1),
                                         {"target": torch.from_numpy(images[1]),
                                          "source": torch.from_numpy(z_d)}, gp_noise=noise)
        d_routes = dict(fused_conv.launch_counts)
    return dict(ptrainer=ptrainer, state0=state0, state1=state1, state2=state2,
                jm_g=jax.device_get(jm_g), jm_d=jax.device_get(jm_d), g_port=g_port,
                d_port=d_port, pm_g=pm_g, pm_d=pm_d, g_routes=g_routes, d_routes=d_routes,
                sample=sample, z_s=z_s)


def test_g_step_matches_jax(steps):
    check_metrics(steps["jm_g"], steps["pm_g"])
    check_g_step(steps)


def test_d_step_matches_jax(steps):
    assert {p.dtype for p in steps["d_port"].nets.parameters()} == {torch.float64}
    check_metrics(steps["jm_d"], steps["pm_d"])
    check_d_step(steps)


def test_sample_and_routes(steps):
    """The G step differentiates the generator: its 3 fusable steps
    (block_4_conv1, block_8_conv0/1) take the autograd route; the D step's
    generator pass and ``sample`` take B4's (on the card, B4's two passes
    at Cout 1032)."""
    assert steps["g_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 3}
    assert steps["d_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 0}
    check_sample(steps)
