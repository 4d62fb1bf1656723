"""The port's training ops against the JAX package's, in fp32 on the CPU.

Covers minibatch_stddev, train-mode DomainNorm (batch norm with and
without per-group moments and moving-statistic updates, instance norm),
EqDense, the loss library (every architecture, the gradient penalty with
JAX's own random draws handed in, L1 and cosine distance), the optimizer
factory on identical gradients (adam, sgd, momentum x the three schedules
x one or two updates per global step, the clip / weight-decay /
frozen-scope chain, a whole side frozen, and scopes that span two levels
of a nested tree), and the gdrop and Polyak state updates. Inputs come
from numpy seeds. Tolerances: single ops atol 1e-5 (fp32 sums taken in
other orders); optimizers after five updates rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.models import layers as jlayers  # noqa: E402
from twingan_tpu.train import losses as jlosses  # noqa: E402
from twingan_tpu.train import optimizers as joptimizers  # noqa: E402
from twingan_tpu.train import state as jstate  # noqa: E402

from twingan_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.models import layers  # noqa: E402
from twingan_tpu_torch.ops import basic  # noqa: E402
from twingan_tpu_torch.train import losses, optimizers, state  # noqa: E402

ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_minibatch_stddev_matches(groups):
    x = np.random.RandomState(groups).randn(6, 4, 4, 5).astype(np.float32)
    ref = np.asarray(jops.minibatch_stddev(jnp.asarray(x), num_groups=groups))
    out = basic.minibatch_stddev(torch.from_numpy(x), num_groups=groups)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    out_nchw = basic.minibatch_stddev(nchw(x), num_groups=groups, nchw=True)
    np.testing.assert_allclose(out_nchw.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL, rtol=0)


def test_minibatch_stddev_eps_follows_dtype():
    x = torch.zeros(2, 4, 4, 3)
    assert float(basic.minibatch_stddev(x)[0, 0, 0, -1]) == pytest.approx(1e-4)
    xb = x.to(torch.bfloat16)
    assert float(basic.minibatch_stddev(xb)[0, 0, 0, -1]) == pytest.approx(1e-3, rel=1e-2)
    with pytest.raises(ValueError, match="num_groups"):
        basic.minibatch_stddev(torch.zeros(4, 2, 2, 1), num_groups=3)


def _randomized_norm_vars(jmod, x, ctx):
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), ctx))
    rng = np.random.RandomState(7)
    params = {k: (rng.uniform(0.5, 1.5, v.shape) if k.startswith("gamma")
                  else rng.normal(0, 0.3, v.shape)).astype(np.float32)
              for k, v in variables["params"].items()}
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.startswith("moving_var")
                 else rng.normal(0, 0.3, v.shape)).astype(np.float32)
             for k, v in variables.get("batch_stats", {}).items()}
    return params, stats


@pytest.mark.parametrize("kind,groups,update", [
    ("batch_norm", 0, True),
    ("batch_norm", 0, False),
    ("batch_norm", 2, True),
    ("batch_norm", 2, False),
    ("instance_norm", 0, True),
])
def test_train_mode_domain_norm_matches(kind, groups, update):
    """Batch moments (biased, per group), output, and the moving statistics,
    which change only when the call asks for an update."""
    x = (np.random.RandomState(3).randn(4, 5, 5, 6) * 2 + 1).astype(np.float32)
    jmod = jlayers.DomainNorm(kind=kind, num_domains=2, num_groups=groups)
    ctx = jlayers.NormCtx(domain=1, train=True)
    params, stats = _randomized_norm_vars(jmod, x, ctx)
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    mutable = ["batch_stats"] if (update and stats) else False
    out = jmod.apply(variables, jnp.asarray(x), ctx, mutable=mutable)
    ref, new_vars = out if mutable else (out, {"batch_stats": stats})
    new_stats = jax.device_get(new_vars["batch_stats"]) if stats else {}

    mod = layers.DomainNorm(kind, 6, num_domains=2, num_groups=groups)
    mod.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    mod.train()
    y = mod(nchw(x), 1, update=update)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    for k, v in new_stats.items():
        np.testing.assert_allclose(getattr(mod, k).numpy(), v, atol=1e-6, rtol=0, err_msg=k)
    if kind == "batch_norm":
        changed = not np.array_equal(mod.moving_mean_1.numpy(), stats["moving_mean_1"])
        assert changed == update
        np.testing.assert_array_equal(mod.moving_mean_0.numpy(), stats["moving_mean_0"])


@pytest.mark.parametrize("equalized_lr", [False, True])
def test_eq_dense_matches(equalized_lr):
    x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    jmod = jlayers.EqDense(features=5, equalized_lr=equalized_lr)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = dict(params, bias=np.random.RandomState(1).randn(5).astype(np.float32))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = layers.EqDense(7, 5, equalized_lr=equalized_lr)
    mod.load_state_dict(state_dict_from_flax(params), strict=True)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), ref, atol=ATOL, rtol=0)
    gen = torch.Generator().manual_seed(0)
    mod.reset_parameters(gen)
    assert float(mod.kernel.detach().std()) == pytest.approx(1.0 if equalized_lr else 0.02, rel=0.5)


def _loss_cfgs(arch):
    kw = dict(architecture=arch, gan_weight=0.7, wgan_drift_loss_weight=0.1)
    return jlosses.GanLossConfig(**kw), losses.GanLossConfig(**kw)


@pytest.mark.parametrize("arch", losses.ARCHITECTURES)
def test_gan_losses_match(arch):
    jcfg, pcfg = _loss_cfgs(arch)
    rng = np.random.RandomState(2)
    fake, real = rng.randn(6, 1).astype(np.float32) * 3, rng.randn(6, 1).astype(np.float32) * 3
    ref_g = float(jlosses.generator_gan_loss(jcfg, jnp.asarray(fake)))
    assert float(losses.generator_gan_loss(pcfg, torch.from_numpy(fake))) == pytest.approx(
        ref_g, abs=ATOL)
    ref_d = jlosses.discriminator_gan_loss(jcfg, jnp.asarray(fake), jnp.asarray(real))
    out_d = losses.discriminator_gan_loss(pcfg, torch.from_numpy(fake), torch.from_numpy(real))
    assert set(out_d) == set(ref_d)
    for k in ref_d:
        assert float(out_d[k]) == pytest.approx(float(ref_d[k]), abs=ATOL), k


@pytest.mark.parametrize("arch", losses.ARCHITECTURES)
def test_gradient_penalty_matches_with_jax_draws(arch):
    """The same smooth critic in both frameworks; JAX's alpha and U(-1, 1)
    draws (split as gradient_penalty splits its key) are handed in."""
    jcfg, pcfg = _loss_cfgs(arch)
    rng = np.random.RandomState(4)
    real = rng.rand(3, 6, 6, 3).astype(np.float32)
    fake = rng.rand(3, 6, 6, 3).astype(np.float32)
    w = rng.randn(3, 2).astype(np.float32)
    v = rng.randn(2).astype(np.float32)

    def jdis(x):
        return jnp.mean(jnp.tanh(x @ w) @ v, axis=(1, 2))[:, None]

    def pdis(x):
        return torch.mean(torch.tanh(x @ torch.from_numpy(w)) @ torch.from_numpy(v),
                          dim=(1, 2))[:, None]

    key = jax.random.PRNGKey(9)
    ref = float(jlosses.gradient_penalty(jcfg, key, jdis, jnp.asarray(real), jnp.asarray(fake)))
    k_alpha, k_perturb = jax.random.split(key)
    alpha = np.array(jax.random.uniform(k_alpha, (3, 1, 1, 1), jnp.float32))
    noise = np.array(jax.random.uniform(k_perturb, real.shape, jnp.float32, -1.0, 1.0))
    out = losses.gradient_penalty(pcfg, pdis, torch.from_numpy(real), torch.from_numpy(fake),
                                  alpha=torch.from_numpy(alpha), noise=torch.from_numpy(noise))
    assert float(out.detach()) == pytest.approx(ref, abs=ATOL)
    if arch in ("dragan", "wgan_gp"):
        assert ref > 0
        drawn = losses.gradient_penalty(pcfg, pdis, torch.from_numpy(real), torch.from_numpy(fake),
                                        generator=torch.Generator().manual_seed(0))
        assert float(drawn.detach()) > 0


def test_perturbed_batch_uses_population_std():
    x = np.random.RandomState(5).rand(2, 4, 4, 3).astype(np.float32)
    noise = np.random.RandomState(6).uniform(-1, 1, x.shape).astype(np.float32)
    ref = x + 0.5 * np.std(x) * noise
    out = losses.perturbed_batch(torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_l1_and_cosine_losses_match():
    rng = np.random.RandomState(8)
    a, b = rng.randn(4, 9).astype(np.float32), rng.randn(4, 9).astype(np.float32)
    assert float(losses.l1_loss(torch.from_numpy(a), torch.from_numpy(b), 0.3)) == pytest.approx(
        float(jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b), 0.3)), abs=ATOL)
    assert float(losses.cosine_distance_loss(torch.from_numpy(a), torch.from_numpy(b), 2.0)) == \
        pytest.approx(float(jlosses.cosine_distance_loss(jnp.asarray(a), jnp.asarray(b), 2.0)),
                      abs=ATOL)


def _run_optimizers(cfg_kw, updates_per_step, n_steps=5):
    """Five updates of both factories from the same params and gradients."""
    rng = np.random.RandomState(11)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(n_steps)]
    tx = joptimizers.build_optimizer(joptimizers.OptimizerConfig(**cfg_kw), updates_per_step)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optimizers.build_optimizer(optimizers.OptimizerConfig(**cfg_kw), tparams,
                                     updates_per_step)
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in opt.names])
    return {k: np.asarray(v) for k, v in jparams.items()}, {k: p.detach().numpy()
                                                            for k, p in tparams.items()}


@pytest.mark.parametrize("updates_per_step", [1, 2])
@pytest.mark.parametrize("schedule", ["fixed", "exponential", "polynomial"])
@pytest.mark.parametrize("name", ["adam", "sgd", "momentum"])
def test_optimizer_factory_matches(name, schedule, updates_per_step):
    # decay_steps 2: the staircase and the polynomial ramp both move within
    # five updates, and a stretch of 2 moves them half as fast.
    kw = dict(optimizer=name, learning_rate=0.1, learning_rate_decay_type=schedule,
              learning_rate_decay_factor=0.5, decay_steps=2, end_learning_rate=0.01)
    ref, out = _run_optimizers(kw, updates_per_step)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_optimizer_chain_matches():
    """clip_by_global_norm -> weight decay -> adam -> frozen scopes."""
    kw = dict(optimizer="adam", learning_rate=0.1, weight_decay=0.05, clip_global_norm=1.5,
              frozen_scopes=("b",))
    ref, out = _run_optimizers(kw, 1)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _run_nested(cfg_kw, params, n_steps=5):
    """Five updates of both factories on a nested tree (the JAX side) and
    its dotted names (the port's): -> (JAX leaves, port leaves, port
    optimizer), keyed by dotted name."""
    flat = state_dict_from_flax(params)  # no 4-d leaves: no layout change
    rng = np.random.RandomState(13)
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
             for _ in range(n_steps)]
    cfg = dict(cfg_kw, learning_rate=0.1)
    tx = joptimizers.build_optimizer(joptimizers.OptimizerConfig(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for g in grads:
        jgrads = jax.tree_util.tree_map(jnp.asarray, _nest(g))
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    tparams = {k: torch.nn.Parameter(v.clone()) for k, v in flat.items()}
    opt = optimizers.build_optimizer(optimizers.OptimizerConfig(**cfg), tparams)
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in opt.names])
    ref = {k: v.numpy() for k, v in state_dict_from_flax(jax.device_get(jparams)).items()}
    return ref, {k: p.detach().numpy() for k, p in tparams.items()}, opt


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


SIDE = {"discriminator_s": {"prediction": {"kernel": np.ones((3, 2), np.float32),
                                           "bias": np.zeros(2, np.float32)}},
        "discriminator_t": {"block_4_conv0": {"conv": {"bias": np.ones(4, np.float32)}}}}


@pytest.mark.parametrize("name", ["adam", "sgd", "momentum"])
def test_frozen_whole_side_matches(name):
    """Every parameter of the side frozen (TwinGAN's D side under
    frozen_scopes=("discriminator",), its two networks sharing cfg.opt): no
    torch.optim is built, the updates are still counted, and nothing moves,
    as under optax's masked updates."""
    ref, out, opt = _run_nested({"optimizer": name, "frozen_scopes": ("discriminator",)}, SIDE)
    assert opt.opt is None and opt.count == 5 and not any(opt.trainable)
    start = state_dict_from_flax(SIDE)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(out[k], start[k].numpy(), err_msg=k)


NESTED = {"block_4_conv0": {"conv": {"kernel": np.full((3, 2), 0.5, np.float32),
                                     "bias": np.zeros(2, np.float32)}},
          "block_8_conv0": {"conv": {"kernel": np.full((2, 2), -0.5, np.float32)}},
          "b": np.ones(3, np.float32)}


@pytest.mark.parametrize("scope,frozen", [
    ("block_4_conv0.conv", ()),  # the dotted form is no JAX path: nothing frozen
    ("['block_4_conv0']['conv']", ("block_4_conv0.conv.kernel", "block_4_conv0.conv.bias")),
    ("['conv']['kernel']", ("block_4_conv0.conv.kernel", "block_8_conv0.conv.kernel")),
    ("['b']", ("b",)),
])
def test_frozen_scope_spanning_two_levels_matches(scope, frozen):
    ref, out, opt = _run_nested({"optimizer": "sgd", "frozen_scopes": (scope,)}, NESTED)
    assert sorted(n for n, t in zip(opt.names, opt.trainable) if not t) == sorted(frozen)
    start = state_dict_from_flax(NESTED)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert np.array_equal(ref[k], start[k].numpy()) == (k in frozen), k


@pytest.mark.parametrize("name", optimizers.HAND_UPDATES)
def test_unported_optimizers_raise(name):
    """The four optimizers that raised until their hand updates were ported
    now build and move a parameter (tests/test_torch_optimizers_extra.py
    holds them to optax); a name the factory does not know raises."""
    param = {"a": torch.nn.Parameter(torch.zeros(2))}
    opt = optimizers.build_optimizer(optimizers.OptimizerConfig(optimizer=name), param)
    opt.step([torch.ones(2)])
    assert opt.count == 1 and bool((param["a"] != 0).all())
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optimizers.build_optimizer(optimizers.OptimizerConfig(optimizer=name + "x"), param)


@pytest.mark.parametrize("step,loss", [(50, 0.9), (150, 0.9), (150, 0.2), (150, 3.0)])
def test_gdrop_state_matches(step, loss):
    ref = jstate.update_gdrop_state(jnp.float32(0.3), jnp.float32(loss), jnp.int32(step),
                                    0.2, 0.5, 2.0)
    out = state.update_gdrop_state(torch.tensor(0.3), torch.tensor(loss), step, 0.2, 0.5, 2.0)
    for a, b in zip(out, ref):
        assert float(a) == pytest.approx(float(b), abs=1e-7)


def test_polyak_update_matches():
    rng = np.random.RandomState(12)
    ema, params = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    ref = np.asarray(jstate.polyak_update({"w": jnp.asarray(ema)}, {"w": jnp.asarray(params)},
                                          0.9)["w"])
    tema = {"w": torch.from_numpy(ema.copy())}
    state.polyak_update(tema, {"w": torch.from_numpy(params)}, 0.9)
    np.testing.assert_allclose(tema["w"].numpy(), ref, atol=1e-7, rtol=0)
