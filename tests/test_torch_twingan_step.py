"""One G step and one D step of the port's TwinGANTrainer against the JAX
package's, from the same bridged state and injected noise.

64 px (so the cycle GAN term is on), max_channels 16, batch 2, UNet,
eq-lr, pixel norm, DRAGAN, self-attention at 16 px in every network with
sa_gamma 0.7, norm banks, moving statistics and discriminator biases drawn
from a seed. This file runs batch norm (the unfused path: 4 generator and
6 discriminator passes); ``test_torch_twingan_step_fused.py`` runs the
same checks on instance norm (the fused path), so that the two JAX
compilations run on two test workers. Both sides
run SGD (lr 0.01), and a recording wrapper around each side's optimizer
captures the gradients it is handed: Adam's first update is about
lr * sign(g), so gradients within float noise of 0 would make the
post-step parameters differ by 2 lr. The G step starts from the
randomized initial state; the D step from the JAX state after that G step,
bridged again, with the gradient penalty's alpha and U(-1, 1) noise drawn
the way the JAX ``_d_step`` draws them and injected.

Tolerances, in fp32 on the CPU: losses atol 1e-4 and moving statistics
and post-step parameters atol 1e-5 (the JAX gates); gradient norms rtol
1e-3. Each gradient tensor is held within rtol 1e-3 plus a share of the
largest gradient magnitude of its network: 1e-3 on the discriminator side
(measured: 7e-5), 1e-2 on the generator side (measured: 6e-4 with batch
norm, 3e-3 with instance norm). The generator-side gradients are that
sensitive to rounding whatever computes them:
``test_generator_gradient_rounding_sensitivity`` multiplies every weight
by (1 + 1e-7 N(0, 1)), about one unit in the last place, and finds the
port's own gradients moved by up to 5e-4 (batch norm) and 4e-3 (instance
norm) of that magnitude. The L1 cycle and content losses flip the sign of
their gradient where two nearly equal activations swap order, and
instance norm over the 4x4 maps divides by small deviations.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import attention  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    TwinGANConfig,
    TwinGANTrainer,
    translate,
)

LR = 0.01
BATCH = 2
RES = 64
LOSS_ATOL = 1e-4
GRAD_REL = 1e-3
GEN_GRAD_SHARE = 1e-2
DIS_GRAD_SHARE = 1e-3
STATE_ATOL = 1e-5
MODEL_KW = dict(resolution=RES, max_channels=16, equalized_lr=True, do_pixel_norm=True,
                num_domains=2, do_self_attention=True, self_attention_hw=16)
TRAINER_KW = dict(batch_size=BATCH, use_unet=True, n_critic=2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run puts six test workers on the
    machine's cores, and PyTorch's default of one spinning thread per core
    in each of them starves the others (this module's CPU steps ran 100
    times slower in the full run than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _unoptimized_jax_reference():
    """The JAX reference compiled without XLA's optimization passes
    (``jax_disable_most_optimizations``): the same function on the same
    inputs, whose trace and compile dominate these modules' time and take
    about half as long. The flag is not part of JAX's jit cache key, so the
    caches are cleared after the module: no later module runs what it
    compiled. A module whose tolerances sit near the rounding that XLA's
    fusions change (``test_torch_twingan_step_fused.py``'s instance norm
    gradients) keeps the default."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()


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


def recording_sgd(lr):
    """optax SGD whose state is the last gradient it was handed."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -lr * g, grads), grads

    return optax.GradientTransformation(init, update)


class Recorder:
    """Stands in for the port's optimizer: keeps the gradients, then steps."""

    def __init__(self, inner):
        self.inner, self.names, self.params = inner, inner.names, inner.params
        self.grads = None

    def step(self, grads):
        self.grads = {n: g.detach().clone() for n, g in zip(self.names, grads)}
        self.inner.step(grads)


def gp_draws(rng, critic_step, shape):
    """The JAX _d_step's gradient-penalty draws, per domain."""
    key = jax.random.fold_in(rng, critic_step)
    _, _, k_gp_s, k_gp_t = jax.random.split(key, 4)
    out = {}
    for domain, k in (("s", k_gp_s), ("t", k_gp_t)):
        k_alpha, k_perturb = jax.random.split(k)
        alpha = jax.random.uniform(k_alpha, (shape[0], 1, 1, 1), jnp.float32)
        noise = jax.random.uniform(k_perturb, shape, jnp.float32, -1.0, 1.0)
        out[domain] = {"alpha": torch.tensor(np.asarray(alpha)),
                       "noise": torch.tensor(np.asarray(noise))}
    return out


def _port_state(trainer, params, model_state, step, critic_step):
    state = bridge.twingan_state_from_flax(trainer, params, model_state, step, critic_step)
    state.gen_opt, state.dis_opt = Recorder(state.gen_opt), Recorder(state.dis_opt)
    return state


def _flat(tree_params, names):
    return {k: v.numpy() for k, v in bridge.train_state_dict(tree_params, {}, names).items()}


def run_steps(norm_type):
    """Both trainers' G step and D step from the same state; the JAX steps
    are compiled once."""
    jcfg = JaxTwinGANConfig(
        model=JaxPGGANConfig(norm_type=norm_type, **MODEL_KW),
        loss=JaxGanLossConfig(architecture="dragan"),
        opt=JaxOptimizerConfig(optimizer="sgd", learning_rate=LR), **TRAINER_KW)
    pcfg = TwinGANConfig(
        model=PGGANConfig(norm_type=norm_type, **MODEL_KW),
        loss=GanLossConfig(architecture="dragan"),
        opt=OptimizerConfig(optimizer="sgd", learning_rate=LR), **TRAINER_KW)
    assert jcfg.fuse == pcfg.fuse == (norm_type == "instance_norm")
    jtrainer = JaxTwinGANTrainer(jcfg)
    jtrainer.gen_tx = recording_sgd(LR)
    jtrainer.dis_tx = recording_sgd(LR)
    state0 = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(5)
    params0 = randomize(jax.device_get(state0.params), rs)
    model_state0 = randomize(jax.device_get(state0.model_state), rs)
    state0 = state0.replace(params=params0, model_state=model_state0)
    images = rs.rand(4, BATCH, RES, RES, 3).astype(np.float32)
    batch_g = {"source": images[0], "target": images[1]}
    batch_d = {"source": images[2], "target": images[3]}
    rng = jax.random.PRNGKey(1)

    state1, jm_g = jtrainer.g_step(state0, jax.tree_util.tree_map(jnp.asarray, batch_g), rng)
    state1 = jax.device_get(state1)
    state2, jm_d = jtrainer.d_step(state1, jax.tree_util.tree_map(jnp.asarray, batch_d), rng)
    state2 = jax.device_get(state2)

    ptrainer = TwinGANTrainer(pcfg, device="cpu")
    torch_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    pstate = _port_state(ptrainer, params0, model_state0, 0, 0)
    pstate, pm_g = ptrainer.g_step(pstate, torch_batch(batch_g))
    g_port = pstate
    pstate = _port_state(ptrainer, state1.params, state1.model_state,
                         int(state1.step), int(state1.critic_step))
    noise = gp_draws(rng, int(state1.critic_step), batch_d["source"].shape)
    pstate, pm_d = ptrainer.d_step(pstate, torch_batch(batch_d), gp_noise=noise)
    return dict(jtrainer=jtrainer, state1=state1, state2=state2, jm_g=jax.device_get(jm_g),
                jm_d=jax.device_get(jm_d), g_port=g_port, d_port=pstate, pm_g=pm_g, pm_d=pm_d,
                norm_type=norm_type, params0=params0, model_state0=model_state0,
                batch_g=torch_batch(batch_g))


def check_metrics(jm, pm):
    assert set(pm) == set(jm), sorted(set(pm) ^ set(jm))
    for k in jm:
        tol = (dict(rtol=GRAD_REL, atol=0) if k.endswith("_grad_norm")
               else dict(rtol=0, atol=LOSS_ATOL))
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k, **tol)


def check_grads(jgrads, recorder, names, share):
    ref = _flat(jgrads, names)
    got = {k: v.numpy() for k, v in recorder.grads.items()}
    assert set(ref) == set(got)
    for name in names:
        keys = [k for k in ref if k.startswith(name + ".")]
        scale = max(np.abs(ref[k]).max() for k in keys)
        assert scale > 0
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], rtol=GRAD_REL, atol=share * scale,
                                       err_msg=k)


def check_state(jparams, jmodel_state, port_state, names, atol=STATE_ATOL):
    ref = {k: v.numpy() for k, v in bridge.train_state_dict(jparams, jmodel_state, names).items()}
    got = {k: v.numpy() for k, v in port_state.nets.state_dict().items()
           if k.split(".", 1)[0] in names}
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0, err_msg=k)


GEN_SIDE = ("encoder_content", "generator")
DIS_SIDE = ("discriminator_s", "discriminator_t")


def check_g_state(steps):
    """Moving statistics (updated in the JAX order), post-SGD params and
    counters after the G step."""
    s1 = steps["state1"]
    check_state(s1.params, s1.model_state, steps["g_port"], GEN_SIDE)
    assert steps["g_port"].step == int(s1.step) == 1
    assert steps["g_port"].critic_step == int(s1.critic_step) == 1


def check_d_state(steps):
    s2 = steps["state2"]
    check_state(s2.params, s2.model_state, steps["d_port"], GEN_SIDE + DIS_SIDE)
    assert steps["d_port"].critic_step == int(s2.critic_step) == 2


@pytest.fixture(scope="module")
def steps():
    return run_steps("batch_norm")


def test_g_step_losses(steps):
    check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients(steps):
    check_grads(steps["state1"].gen_opt_state, steps["g_port"].gen_opt, GEN_SIDE,
                GEN_GRAD_SHARE)


def test_g_step_state(steps):
    check_g_state(steps)


def test_d_step_losses(steps):
    check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients(steps):
    check_grads(steps["state2"].dis_opt_state, steps["d_port"].dis_opt, DIS_SIDE,
                DIS_GRAD_SHARE)


def test_d_step_state(steps):
    check_d_state(steps)


# The port's trainer on its own (no JAX): routes, counters, serving.

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_rounding_sensitivity(steps):
    """Why the generator side's gradient tolerance is GEN_GRAD_SHARE: about
    one unit in the last place of every weight, (1 + 1e-7 N(0, 1)), moves
    the port's own G-step gradients within GEN_GRAD_SHARE of the largest
    one, and (with instance norm) by more than the discriminator side's
    share."""
    trainer = _small_trainer(steps["norm_type"])
    state = _port_state(trainer, steps["params0"], steps["model_state0"], 0, 0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in state.nets.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    trainer.g_step(state, steps["batch_g"])
    a, b = steps["g_port"].gen_opt.grads, state.gen_opt.grads
    for name in GEN_SIDE:
        keys = [k for k in a if k.startswith(name + ".")]
        scale = max(float(a[k].abs().max()) for k in keys)
        moved = max(float((a[k] - b[k]).abs().max()) for k in keys) / scale
        assert moved <= GEN_GRAD_SHARE, (name, moved)
        if steps["norm_type"] == "instance_norm" and name == "encoder_content":
            assert moved > DIS_GRAD_SHARE, moved


def test_generator_gradient_rounding_sensitivity(steps):
    check_rounding_sensitivity(steps)


def test_chip_smoke_step_comparison_on_the_cpu():
    """chip_smoke.py's training comparison, with the CPU standing in for the
    card at 64 px: bf16 against fp32 stays within the limits the script
    holds the card to, and fp32 against fp32 agrees exactly."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.train_config(TwinGANConfig(
        model=PGGANConfig(norm_type="batch_norm", dtype="bfloat16", **MODEL_KW),
        use_unet=True))
    trainer = TwinGANTrainer(cfg, device="cpu")
    state = trainer.init_state(smoke.SEED)
    smoke.set_attention_gamma(state.nets)
    weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    noise = {d: {"alpha": torch.rand(smoke.TRAIN_BATCH, 1, 1, 1, generator=gen),
                 "noise": torch.rand(smoke.TRAIN_BATCH, RES, RES, 3, generator=gen) * 2 - 1}
             for d in ("s", "t")}
    rows = smoke.compare_steps(cfg, weights, [smoke._train_batch(rng, cfg, "cpu")
                                              for _ in range(2)], noise, card="cpu")
    assert [r["check"] for r in rows] == [
        f"{k}, card {d} vs CPU float32" for k in ("g_step", "d_step")
        for d in ("float32", "bfloat16")]
    for row in rows:
        assert row["ok"], row["check"]
        if "float32 vs" in row["check"]:
            assert max(row["loss_abs_err"].values()) == 0.0

def _small_trainer(norm_type="batch_norm", res=RES, **kw):
    cfg = TwinGANConfig(model=PGGANConfig(norm_type=norm_type, **dict(MODEL_KW, resolution=res)),
                        **dict(TRAINER_KW, **kw))
    return TwinGANTrainer(cfg, device="cpu")


def _batch(seed, res=RES):
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy(rs.rand(BATCH, res, res, 3).astype(np.float32))
            for k in ("source", "target")}


def test_attention_calls_per_step_by_route(monkeypatch):
    """The unfused round at a resolution with SA in every network: the G
    step runs 4 encoder, 4 generator and 4 discriminator passes through the
    kernel route; the D step 6 generator-side passes and 6 discriminator
    passes through it, and the 2 gradient-penalty passes through the plain
    route (on the card: the launch counts chip_smoke.py asserts)."""
    calls = []
    real = attention.self_attention

    def counting(f, g, h, route="kernel"):
        calls.append((route, torch.is_grad_enabled()))
        return real(f, g, h, route)

    monkeypatch.setattr(attention, "self_attention", counting)
    trainer = _small_trainer()
    state = trainer.init_state(0)
    state, _ = trainer.g_step(state, _batch(0))
    assert calls == [("kernel", True)] * 12
    calls.clear()
    state, _ = trainer.d_step(state, _batch(1))
    assert sorted(calls) == sorted([("kernel", False)] * 6 + [("kernel", True)] * 6
                                   + [("plain", True)] * 2)


def test_scan_rounds_counters_and_metrics():
    trainer = _small_trainer(res=16)
    state = trainer.init_state(0)
    batches = {k: torch.stack([torch.stack([_batch(r * 2 + i, 16)[k] for i in range(2)])
                               for r in range(2)]) for k in ("source", "target")}
    state, metrics = trainer.scan_rounds(state, batches, rng=3)
    assert (state.step, state.critic_step) == (2, 4)
    assert metrics["generator_loss"].shape == (2,)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert "generator_grad_norm" in metrics and "gradient_penalty_s" in metrics


def test_d_step_noise_follows_rng_and_critic_step():
    trainer = _small_trainer(res=16)
    batch = _batch(4, 16)

    def gp(rng):
        state = trainer.init_state(0)
        return float(trainer.d_step(state, batch, rng=rng)[1]["gradient_penalty_s"])

    assert gp(1) == gp(1)
    assert gp(1) != gp(2)


def test_trained_state_serves_through_image_inferer(tmp_path):
    """A trained state written as a stage dir: ImageInferer serves it with
    the moving statistics the round updated (and the Polyak average)."""
    trainer = _small_trainer(res=16, moving_average_decay=0.5)
    state = trainer.init_state(0)
    state, _ = trainer.round_step(state, [_batch(5, 16), _batch(6, 16)])
    sd = trainer.translator_state_dict(state)
    assert not torch.equal(sd["generator.block_8_conv0.norm.moving_mean_1"],
                           torch.zeros_like(sd["generator.block_8_conv0.norm.moving_mean_1"]))
    gen_params = dict(zip(state.gen_opt.names, state.gen_opt.params))
    key = "generator.block_8_conv0.conv.kernel"
    assert not torch.equal(sd[key], gen_params[key].detach())  # the average, not the params
    save_stage(str(tmp_path), trainer.cfg, sd, step=state.step)
    inferer = ImageInferer(str(tmp_path), device="cpu")
    images = [np.random.RandomState(7).randint(0, 256, (16, 16, 3)).astype(np.uint8)]
    out = inferer.infer_batch(images)
    ref = translate(trainer.cfg, inferer.model.encoder_content, inferer.model.generator,
                    torch.from_numpy(inferer.preprocess(images[0])[None]), step=state.step)
    assert out.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize("kw,name", [
    ({"use_style_embedding": True, "model": PGGANConfig(num_domains=2, style_dim=16)},
     "use_style_embedding"),
    ({"do_encoder_distillation": True}, "do_encoder_distillation"),
    ({"remat": True}, "remat"),
    ({"use_gdrop": True}, "use_gdrop"),
    ({"model": PGGANConfig(num_domains=2, style_dim=8)}, "style_dim"),
    ({"model": PGGANConfig(num_domains=2, sync_batch_norm_axis="data")}, "sync_batch_norm_axis"),
])
def test_trainer_refuses_unported_options(kw, name):
    """None of these options raises any more: they train
    (``test_torch_twingan_step_options*`` and ``test_torch_remat.py`` hold
    them to the JAX package; ``test_torch_parallel.py`` holds
    sync_batch_norm_axis's synced moments on two processes), and
    distillation without an embedding width is refused as the JAX trainer
    refuses it. sync_batch_norm_axis reaches every batch norm, and a G
    step runs with it on one process."""
    if name == "sync_batch_norm_axis":
        from twingan_tpu_torch.models.layers import DomainNorm

        trainer = TwinGANTrainer(TwinGANConfig(**kw), device="cpu")
        state = trainer.init_state(0)
        norms = [m for m in state.nets.modules()
                 if isinstance(m, DomainNorm) and m.kind == "batch_norm"]
        assert norms and all(m.sync for m in norms)
        batch = {k: torch.rand(2, 4, 4, 3, generator=torch.Generator().manual_seed(i))
                 for i, k in enumerate(("source", "target"))}
        _, metrics = trainer.g_step(state, batch)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    elif name == "do_encoder_distillation":
        with pytest.raises(ValueError, match="embed_dim"):
            TwinGANTrainer(TwinGANConfig(**kw), device="cpu")
        TwinGANTrainer(TwinGANConfig(source_embed_dim=8, **kw), device="cpu")
    else:
        trainer = TwinGANTrainer(TwinGANConfig(**kw), device="cpu")
        assert trainer.build_nets()["generator"].conditional == (name == "use_style_embedding")
