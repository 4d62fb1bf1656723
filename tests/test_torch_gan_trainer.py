"""One G step and one D step of the port's GanTrainer (PGGAN generation)
against the JAX package's, from the same bridged state, z and
gradient-penalty draws; ``sample``, ``eval_metrics`` and the bridge of the
whole GanTrainState.

32 px, max_channels 16, batch 2, fp32 on the CPU, norm_type "none" with
pixel norm and equalized lr (the generator's conv-leaky-pixel-norm steps,
kernel B4's function), DRAGAN, Adam at its defaults, n_critic 2, a Polyak
average (decay 0.9). Parameters, biases included, and the Polyak average
are drawn from a seed. The G step starts from that state; the D step from
the JAX state after the G step, bridged again. z is injected as the
batch's "source" item on the JAX side (its ``_gen_input`` returns it) and
as the port step's ``z`` argument (G step) or the same "source" item (D
step); the penalty's alpha and U(-1, 1) noise are drawn the way the JAX
``_d_step`` draws them and injected. ``test_torch_gan_trainer_growing.py``
runs the same checks on a growing stage (alpha 0.3), so that the two JAX
compilations run on two test workers.

Tolerances are those of ``tests/test_torch_twingan_step.py``: losses atol
1e-4, gradient norms rtol 1e-3, gradients rtol 1e-3 plus 1e-2 (generator)
or 1e-3 (discriminator) of the network's largest gradient, states atol
1e-5. Adam's first update from zero slots leaves mu = (1 - beta1) g and
nu = (1 - beta2) g^2, so the slots carry each side's gradient and are
compared with the gradient tolerance (nu with the square's). That update
is lr * g / (|g| + eps), about lr * sign(g): where a gradient lies within
its tolerance of 0 the two packages may move the parameter in opposite
directions, so parameters are held to 1e-5 where the gradient's sign is
settled and to 2 lr + 1e-5 elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_twingan_step import _two_torch_threads, randomize  # noqa: E402,F401
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import fused_conv  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import DIS, GEN, GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402

BATCH = 2
LOSS_ATOL = 1e-4
GRAD_REL = 1e-3
GEN_GRAD_SHARE = 1e-2
DIS_GRAD_SHARE = 1e-3
STATE_ATOL = 1e-5
LR = 0.005  # OptimizerConfig's default
BETA1, BETA2 = 0.5, 0.99
MODEL_KW = dict(max_channels=16, norm_type="none", do_pixel_norm=True, equalized_lr=True)
TRAINER_KW = dict(batch_size=BATCH, n_critic=2, moving_average_decay=0.9, max_steps=10)


def configs(res=32, growing=False, **model_kw):
    kw = dict(MODEL_KW, resolution=res, is_growing=growing, **model_kw)
    jcfg = JaxGanTrainerConfig(model=JaxPGGANConfig(**kw),
                               loss=JaxGanLossConfig(architecture="dragan"), **TRAINER_KW)
    pcfg = GanTrainerConfig(model=PGGANConfig(**kw), loss=GanLossConfig(architecture="dragan"),
                            **TRAINER_KW)
    return jcfg, pcfg


def initial_state(jtrainer, step, seed=5):
    """The JAX init_state with every parameter, bias and the Polyak
    average drawn from ``seed``, at global step ``step``."""
    state0 = jax.device_get(jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)
    params = randomize(state0.params, rs)
    return state0.replace(params=params, model_state=randomize(state0.model_state, rs),
                          gen_ema_params=randomize(state0.params[GEN], rs),
                          step=np.int32(step), critic_step=np.int32(2 * step))


def gp_draws(rng, critic_step, shape):
    """The JAX GanTrainer._d_step's gradient-penalty draws."""
    _, _, k_gp = jax.random.split(jax.random.fold_in(rng, critic_step), 3)
    k_alpha, k_perturb = jax.random.split(k_gp)
    alpha = jax.random.uniform(k_alpha, (shape[0], 1, 1, 1), jnp.float32)
    noise = jax.random.uniform(k_perturb, shape, jnp.float32, -1.0, 1.0)
    return {"alpha": torch.tensor(np.asarray(alpha)), "noise": torch.tensor(np.asarray(noise))}


def run_steps(res=32, growing=False, step=0):
    """Both trainers' G step and D step from the same state; the JAX steps
    are compiled once."""
    jcfg, pcfg = configs(res, growing)
    jtrainer = JaxGanTrainer(jcfg)
    state0 = initial_state(jtrainer, step)
    rs = np.random.RandomState(6)
    shape = (BATCH, 1, 1, jcfg.model.noise_dim)
    z_g, z_d, z_s = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    images = rs.rand(2, BATCH, res, res, 3).astype(np.float32)
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
    fused_conv.reset_launch_counts()
    g_port, pm_g = ptrainer.g_step(bridge.state_from_flax(ptrainer, state0),
                                   {"target": torch.from_numpy(images[0])},
                                   z=torch.from_numpy(z_g))
    g_routes = dict(fused_conv.launch_counts)
    fused_conv.reset_launch_counts()
    noise = gp_draws(rng, int(state1.critic_step), images[1].shape)
    d_port, pm_d = ptrainer.d_step(bridge.state_from_flax(ptrainer, state1),
                                   {"target": torch.from_numpy(images[1]),
                                    "source": torch.from_numpy(z_d)}, gp_noise=noise)
    d_routes = dict(fused_conv.launch_counts)
    return dict(jcfg=jcfg, ptrainer=ptrainer, state0=state0, state1=state1, state2=state2,
                jm_g=jax.device_get(jm_g), jm_d=jax.device_get(jm_d), g_port=g_port,
                d_port=d_port, pm_g=pm_g, pm_d=pm_d, g_routes=g_routes, d_routes=d_routes,
                sample=sample, z_s=z_s, z_g=z_g, images=images)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def opt_fields(state_dict, side):
    """(update count, {slot: {path: array}}) of one optimizer of a JAX-layout
    state dict (a JAX state, or ``bridge.flax_state_dict`` of the port's):
    the one count of the chain, and each slot's arrays by parameter path."""
    counts, slots = set(), {}
    for key, v in bridge.flat_from_flax(state_dict).items():
        parts = key.split("/")
        if parts[0] != side:
            continue
        if parts[-1] == "count":
            counts.add(int(v))
        for i, part in enumerate(parts):
            if part in ("mu", "nu", "trace"):
                slots.setdefault(part, {})["/".join(parts[i + 1:])] = v
    assert len(counts) == 1, counts
    return counts.pop(), slots


def net_params(state_dict, net):
    """One network's parameters of a JAX-layout state dict, by path."""
    prefix = f"params/{net}/"
    return {k[len(prefix):]: v for k, v in bridge.flat_from_flax(state_dict).items()
            if k.startswith(prefix)}


def check_metrics(jm, pm):
    assert set(pm) == set(jm), sorted(set(pm) ^ set(jm))
    for k in jm:
        tol = (dict(rtol=GRAD_REL, atol=0) if k.endswith("_grad_norm")
               else dict(rtol=0, atol=LOSS_ATOL))
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k, **tol)


def check_side(jstate, port_state, side, share):
    """One side after its step: the gradient (from Adam's mu and nu), the
    update count, and the parameters (see the module docstring)."""
    opt_name, net = ("gen_opt_state", GEN) if side == "gen" else ("dis_opt_state", DIS)
    ported = bridge.flax_state_dict(port_state)
    count, ref_slots = opt_fields(jstate, opt_name)
    port_count, slots = opt_fields(ported, opt_name)
    assert port_count == count == 1
    mu_ref, nu_ref, mu, nu = ref_slots["mu"], ref_slots["nu"], slots["mu"], slots["nu"]
    assert set(mu) == set(mu_ref)
    g_ref = {k: v / (1 - BETA1) for k, v in mu_ref.items()}
    scale = max(np.abs(v).max() for v in g_ref.values())
    assert scale > 0
    params_ref, params = net_params(jstate, net), net_params(ported, net)
    assert set(params) == set(params_ref) == set(mu)
    for k in mu:
        np.testing.assert_allclose(mu[k] / (1 - BETA1), g_ref[k], rtol=GRAD_REL,
                                   atol=share * scale, err_msg=k)
        np.testing.assert_allclose(nu[k], nu_ref[k], rtol=3 * GRAD_REL,
                                   atol=(1 - BETA2) * 3 * share * scale ** 2, err_msg=k)
        settled = np.abs(g_ref[k]) > 2 * share * scale
        diff = np.abs(params[k] - params_ref[k])
        assert (diff[settled] <= STATE_ATOL).all(), (k, diff[settled].max())
        assert (diff <= 2 * LR + STATE_ATOL).all(), (k, diff.max())


def check_state_fields(jstate, port_state):
    assert (port_state.step, port_state.critic_step) == (int(jstate.step),
                                                         int(jstate.critic_step))
    out = bridge.flax_state_dict(port_state)
    for k in ("gdrop_strength", "gen_loss_ema"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(jstate, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def check_g_step(steps, share=GEN_GRAD_SHARE):
    s1, port = steps["state1"], steps["g_port"]
    check_side(s1, port, "gen", share)
    check_state_fields(s1, port)
    # The Polyak average moved by 0.1 of each parameter's move.
    ema_ref = _leaves(s1.gen_ema_params)
    ported = bridge.flax_state_dict(port)
    ema = _leaves(ported["gen_ema_params"])
    assert set(ema) == set(ema_ref)
    for k in ema:
        np.testing.assert_allclose(ema[k], ema_ref[k], rtol=0,
                                   atol=0.1 * 2 * LR + STATE_ATOL, err_msg=k)
    # The discriminator did not move.
    dis = _leaves(ported["params"][DIS])
    for k, v in _leaves(steps["state0"].params[DIS]).items():
        np.testing.assert_array_equal(dis[k], v, err_msg=k)


def check_d_step(steps, share=DIS_GRAD_SHARE):
    s2, port = steps["state2"], steps["d_port"]
    check_side(s2, port, "dis", share)
    check_state_fields(s2, port)


def check_sample(steps):
    """``sample`` of the JAX state after both steps, bridged: the Polyak
    average in eval mode with no gradient (B4's route)."""
    ptrainer = steps["ptrainer"]
    state = bridge.state_from_flax(ptrainer, steps["state2"])
    fused_conv.reset_launch_counts()
    out = ptrainer.sample(state, torch.from_numpy(steps["z_s"]))
    assert fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] == 0
    assert out.shape == steps["sample"].shape
    np.testing.assert_allclose(out.numpy(), steps["sample"], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def steps():
    return run_steps()


def test_g_step_losses(steps):
    check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients_and_state(steps):
    check_g_step(steps)


def test_d_step_losses(steps):
    check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients_and_state(steps):
    check_d_step(steps)


def test_sample(steps):
    check_sample(steps)


def test_routes_per_step(steps):
    """The G step differentiates the generator: its 7 fusable steps
    (block_4_conv1, then conv0 and conv1 at 8, 16 and 32 px) take the
    autograd route. The D step's generator pass needs no gradient: none
    does (on the card, 7 B4 launches; here the plain version)."""
    assert steps["g_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 7}
    assert steps["d_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 0}


def test_eval_metrics_leaves_the_state_untouched(steps):
    """The G step's metrics (JAX eval_metrics returns _g_step's), and the
    caller's state as it was."""
    ptrainer = steps["ptrainer"]
    state = bridge.state_from_flax(ptrainer, steps["state0"])
    before = {k: v.clone() for k, v in state.nets.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.gen_ema_params.items()}
    slots_before = state.gen_opt.slots()
    metrics = ptrainer.eval_metrics(state, {"target": torch.from_numpy(steps["images"][0])},
                                    z=torch.from_numpy(steps["z_g"]))
    check_metrics(steps["jm_g"], metrics)
    assert (state.step, state.critic_step, state.gen_opt.count) == (0, 0, 0)
    for k, v in state.nets.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.gen_ema_params.items():
        assert torch.equal(v, ema_before[k]), k
    for slot, tensors in state.gen_opt.slots().items():
        for k, v in tensors.items():
            assert torch.equal(v, slots_before[slot][k]), (slot, k)


@pytest.mark.parametrize("norm_type", ["none", "batch_norm"])
def test_gan_state_bridge_round_trips(steps, norm_type):
    """Every field of a JAX GanTrainState (after a G step: Adam slots and
    counts on the generator side, fresh ones on the other) into the port's
    state and back, exactly."""
    if norm_type == "none":
        jstate = steps["state1"]
        ptrainer = steps["ptrainer"]
    else:  # batch statistics in model_state
        jcfg, pcfg = configs(res=8, norm_type=norm_type)
        jstate = initial_state(JaxGanTrainer(jcfg), step=2)
        ptrainer = GanTrainer(pcfg, device="cpu")
    ref = bridge.flat_from_flax(jstate)
    got = bridge.flat_from_flax(bridge.flax_state_dict(bridge.state_from_flax(ptrainer, jstate)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert bool(_leaves(jstate.model_state)) == (norm_type == "batch_norm")
    # Each Adam chain's two counts and its slots, the counters and the gdrop state.
    sides = ("gen_opt_state", "dis_opt_state")
    assert {k for k in ref if k.endswith("count")} == {f"{side}/{i}/count" for side in sides
                                                       for i in (0, 1)}
    for side in sides:
        for slot in ("mu", "nu"):
            assert any(k.startswith(f"{side}/0/{slot}/") for k in ref), (side, slot)
    assert {"step", "critic_step", "gdrop_strength", "gen_loss_ema"} <= ref.keys()


def test_sample_without_a_polyak_average_uses_the_parameters(steps):
    ptrainer = steps["ptrainer"]
    state = bridge.state_from_flax(ptrainer, steps["state2"])
    state.gen_ema_params = None
    z = torch.from_numpy(steps["z_s"])
    out = ptrainer.sample(state, z)
    gen = state.nets[GEN]
    assert gen.training  # sample restores the mode
    gen.eval()
    with torch.no_grad():
        ref = gen(z)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kw,name", [
    ({"use_gdrop": True}, "use_gdrop"),
    ({"use_conditional_labels": True, "num_classes": 4}, "use_conditional_labels"),
    ({"remat": True}, "remat"),
    ({"generator_network": "cyclegan"}, "cyclegan"),
    ({"generator_network": "dcgan"}, "dcgan"),
])
def test_trainer_refuses_unported_options(kw, name):
    """No option of the trainer raises any more: the cyclegan and dcgan
    networks build their CycleGAN and DCGAN pairs
    (``test_torch_alt_trainer.py`` holds their steps to the JAX package);
    gdrop, conditional labels and remat train
    (``test_torch_gan_trainer_options.py`` and ``test_torch_remat.py`` hold
    them to the JAX package)."""
    if name in ("cyclegan", "dcgan"):
        # DCGAN's generator ends at the model's resolution, at least 8 px.
        trainer = GanTrainer(GanTrainerConfig(model=PGGANConfig(resolution=8), **kw),
                             device="cpu")
        nets = trainer.build_nets()
        assert not trainer.is_pggan
        prefix = "CycleGAN" if name == "cyclegan" else "DCGAN"
        assert [type(nets[n]).__name__ for n in (GEN, DIS)] == [f"{prefix}Generator",
                                                                 f"{prefix}Discriminator"]
    else:
        trainer = GanTrainer(GanTrainerConfig(**kw), device="cpu")
        nets = trainer.build_nets()
        assert nets[DIS].do_gdrop == (name == "use_gdrop")
        assert (trainer.cond_lookup is not None) == (name == "use_conditional_labels")


def test_chip_smoke_generation_comparison_on_the_cpu():
    """chip_smoke.py's generation comparison, with the CPU standing in for
    the card at 32 px: bf16 against fp32 stays within the limits the script
    holds the card to, and fp32 against fp32 agrees exactly."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.generation_config(batch=BATCH)
    assert (cfg.model.resolution, cfg.model.max_channels, cfg.model.norm_type,
            cfg.batch_size) == (256, 256, "none", BATCH)
    cfg = cfg.replace(model=cfg.model.replace(resolution=32, max_channels=16))
    trainer = GanTrainer(cfg, device="cpu")
    state = trainer.init_state(smoke.SEED)
    smoke.randomize_biases(state.nets, smoke.SEED)
    weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
    batches, zs, gp_noise = smoke.generation_inputs(cfg, BATCH, 0)
    rows = smoke.compare_generation_steps(cfg, weights, batches, zs, gp_noise, card="cpu")
    assert [r["check"] for r in rows] == [
        f"{k}, card {d} vs CPU float32" for k in ("g_step", "d_step")
        for d in ("float32", "bfloat16")]
    for row in rows:
        assert row["ok"], row["check"]
        assert set(row["grad_cosine"]) == {"generator" if "g_step" in row["check"]
                                           else "discriminator"}
        if "float32 vs" in row["check"]:
            assert max(row["loss_abs_err"].values()) == 0.0
    # B4's bound at the TPU script's shape, by the route of each variant:
    # fp32 on the TF32 tensor cores (three TF32 products a multiply-add),
    # its bytes, and its FLOPs at the CUDA cores' fp32 rate by that route;
    # bf16, on the tensor cores (two bf16 products a multiply-add), its bytes.
    bound_ms, by = smoke.fused_conv_bound(8, 256, 16, 16, "float32")
    assert by == "bytes" and bound_ms == pytest.approx(0.020035, rel=1e-3)
    bound_ms, by = smoke.fused_conv_bound(8, 256, 16, 16, "float32", "cuda_core")
    assert by == "operations" and bound_ms == pytest.approx(0.03606, rel=1e-3)
    bound_ms, by = smoke.fused_conv_bound(8, 256, 16, 16, "bfloat16")
    assert by == "bytes" and bound_ms == pytest.approx(0.010019, rel=1e-3)
