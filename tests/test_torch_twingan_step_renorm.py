"""One TwinGAN G step and one D step of the port under batch renorm (the
reference's headline recipe's norm) against the JAX package's, from the
same bridged state and injected noise.

32 px (no cycle GAN term), max_channels 16, batch 2, UNet, eq-lr, pixel
norm, DRAGAN, self-attention at 16 px in every network with sa_gamma 0.7,
and spectral norm in both discriminators, on the unfused path (batch
renorm couples a pass's batch). The generator side's spectral norms are
held in ``test_torch_spectral.py`` (the u its G step threads through its
passes): with them in this file's model, the encoder's G-step gradients
move by about half this file's gradient tolerance under a 1e-6 relative
change of every weight, which is about what separates XLA's sums from
ATen's. Two starting points, each stepped by both
packages:
- step 0 from the initial renorm state (zero EMAs), where the schedule's
  first clip holds;
- step 10001, where the second clip holds, from renorm EMAs drawn from a
  seed far off the batches' moments, so that r and d are clipped (checked
  by counting the clipped values of the port's pass).
The G step's updating generator-side passes (the encoder's two, the
generator's four) write the renorm EMAs and the moving statistics in the
JAX order, each computing r and d from what the earlier passes left; the
D step's discriminator passes all read the spectral ``u`` from before the
step, and each discriminator's ``u`` advances once.

Tolerances: those of ``test_torch_twingan_step.py`` (losses atol 1e-4,
gradient norms rtol 1e-3, gradients rtol 1e-3 plus 1e-2 / 1e-3 of the
largest magnitude on the generator / discriminator side, every parameter
and buffer after the step atol 1e-5), and the spectral ``u`` after each
step within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_twingan_step as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import norms  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

RES = 32
U_ATOL = 1e-6
MODEL_KW = dict(base.MODEL_KW, resolution=RES, norm_type="batch_renorm", spectral_norm=True)


def renorm_state(tree, rng):
    """Renorm EMAs whose debiased moments lie off the batch's: weights
    0.85-0.95, debiased means N(0, 1) and standard deviations log-uniform
    in [0.1, 5]. Wider draws clip more but make moving variances in the
    thousands, past the fp32 resolution of the state tolerance."""
    out = {}
    weights = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = renorm_state(v, rng)
        elif k.startswith(("renorm_mean_weight_", "renorm_stddev_weight_")):
            out[k] = weights[k] = np.asarray(rng.uniform(0.85, 0.95), np.float32)
    for k, v in tree.items():
        if k.startswith("renorm_mean_") and "weight" not in k:
            w = weights[k.replace("renorm_mean_", "renorm_mean_weight_")]
            out[k] = (w * rng.normal(0.0, 1.0, v.shape)).astype(np.float32)
        elif k.startswith("renorm_stddev_") and "weight" not in k:
            w = weights[k.replace("renorm_stddev_", "renorm_stddev_weight_")]
            out[k] = (w * np.exp(rng.uniform(np.log(0.1), np.log(5.0), v.shape))).astype(
                np.float32)
        elif k not in out:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def jax_trainer():
    jcfg = JaxTwinGANConfig(
        model=JaxPGGANConfig(**MODEL_KW),
        loss=JaxGanLossConfig(architecture="dragan"),
        opt=JaxOptimizerConfig(optimizer="sgd", learning_rate=base.LR), **base.TRAINER_KW)
    assert not jcfg.fuse
    jtrainer = JaxTwinGANTrainer(jcfg)
    jtrainer.gen_tx = base.recording_sgd(base.LR)
    jtrainer.dis_tx = base.recording_sgd(base.LR)
    return jtrainer


def clipped_counter(monkeypatch):
    """Counts the r and d values the port's passes clip."""
    counts = {"clipped": 0}
    real = norms.batch_renorm_correction

    def counting(mean, var, state, clip, **kw):
        r, d, new = real(mean, var, state, clip, **kw)
        counts["clipped"] += int(((r == np.float32(clip["rmax"])) | (r == np.float32(clip["rmin"]))
                                  | (d.abs() == np.float32(clip["dmax"]))).sum())
        return r, d, new

    monkeypatch.setattr(norms, "batch_renorm_correction", counting)
    return counts


def run_steps(jtrainer, step, drawn_state):
    pcfg = TwinGANConfig(
        model=PGGANConfig(**MODEL_KW), loss=GanLossConfig(architecture="dragan"),
        opt=OptimizerConfig(optimizer="sgd", learning_rate=base.LR), **base.TRAINER_KW)
    state0 = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(6)
    params0 = base.randomize(jax.device_get(state0.params), rs)
    model_state0 = base.randomize(jax.device_get(state0.model_state), rs)
    if drawn_state:
        model_state0 = renorm_state(model_state0, rs)
    state0 = state0.replace(params=params0, model_state=model_state0,
                            step=jnp.asarray(step, jnp.int32))
    images = rs.rand(4, base.BATCH, RES, RES, 3).astype(np.float32)
    batch_g = {"source": images[0], "target": images[1]}
    batch_d = {"source": images[2], "target": images[3]}
    rng = jax.random.PRNGKey(1)
    host0 = jax.device_get(state0)  # the steps donate their state
    state1, jm_g = jtrainer.g_step(state0, jax.tree_util.tree_map(jnp.asarray, batch_g), rng)
    state1 = jax.device_get(state1)
    state2, jm_d = jtrainer.d_step(state1, jax.tree_util.tree_map(jnp.asarray, batch_d), rng)
    state2 = jax.device_get(state2)

    ptrainer = TwinGANTrainer(pcfg, device="cpu")
    torch_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        counts = clipped_counter(mp)
        pstate = base._port_state(ptrainer, params0, model_state0, step, 0)
        pstate, pm_g = ptrainer.g_step(pstate, torch_batch(batch_g))
    g_port = pstate
    pstate = base._port_state(ptrainer, state1.params, state1.model_state,
                              int(state1.step), int(state1.critic_step))
    noise = base.gp_draws(rng, int(state1.critic_step), batch_d["source"].shape)
    pstate, pm_d = ptrainer.d_step(pstate, torch_batch(batch_d), gp_noise=noise)
    return dict(state0=host0, state1=state1, state2=state2,
                jm_g=jax.device_get(jm_g), jm_d=jax.device_get(jm_d), g_port=g_port,
                d_port=pstate, pm_g=pm_g, pm_d=pm_d, clipped=counts["clipped"], step=step)


@pytest.fixture(scope="module", params=[0, 10001], ids=["step0", "step10001"])
def steps(request, jax_trainer):
    step = request.param
    return run_steps(jax_trainer, step, drawn_state=step > 0)


def _u(model_state, names):
    return {k: v.numpy() for k, v in bridge.train_state_dict(
        {n: {} for n in names}, model_state, names).items() if k.endswith(".u")}


def test_g_step_losses(steps):
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients(steps):
    base.check_grads(steps["state1"].gen_opt_state, steps["g_port"].gen_opt, base.GEN_SIDE,
                     base.GEN_GRAD_SHARE)


def test_g_step_state(steps):
    """Every renorm EMA (the 0-d weights included) and moving statistic
    after the G step's four updating passes, the parameters and counters."""
    s1 = steps["state1"]
    base.check_state(s1.params, s1.model_state, steps["g_port"], base.GEN_SIDE)
    assert steps["g_port"].step == int(s1.step) == steps["step"] + 1
    assert steps["g_port"].critic_step == int(s1.critic_step) == 1
    names = [k for k in steps["g_port"].nets.state_dict() if ".renorm_" in k]
    assert names and any(k.endswith("renorm_mean_weight_1") for k in names)


def test_renorm_clip_bites(steps):
    """From the drawn state the second regime's clip bites; from the zero
    init the first regime's may too (r and d of the later passes are taken
    against EMAs the earlier ones wrote)."""
    if steps["step"] > 0:
        assert steps["clipped"] > 100, steps["clipped"]


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients(steps):
    base.check_grads(steps["state2"].dis_opt_state, steps["d_port"].dis_opt, base.DIS_SIDE,
                     base.DIS_GRAD_SHARE)


def test_d_step_state(steps):
    base.check_d_state(steps)


def test_spectral_u_after_each_step(steps):
    """The G step leaves the discriminators' u as they were; the D step
    advances each once, from the state before the step."""
    before = _u(steps["state0"].model_state, base.DIS_SIDE)
    after_g = _u(steps["state1"].model_state, base.DIS_SIDE)
    after_d = _u(steps["state2"].model_state, base.DIS_SIDE)
    assert len(before) == 2 * 13
    port_g = {k: v.numpy() for k, v in steps["g_port"].nets.state_dict().items()
              if k.endswith(".u")}
    port_d = {k: v.numpy() for k, v in steps["d_port"].nets.state_dict().items()
              if k.endswith(".u")}
    for k in before:
        np.testing.assert_array_equal(after_g[k], before[k], err_msg=k)
        np.testing.assert_array_equal(port_g[k], before[k], err_msg=k)
        np.testing.assert_allclose(port_d[k], after_d[k], atol=U_ATOL, rtol=0, err_msg=k)
        # u of the [C, 1] prediction is +-1 and cannot move.
        assert not np.array_equal(after_d[k], after_g[k]) or after_d[k].size == 1, k
