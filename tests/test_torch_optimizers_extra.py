"""The port's hand-written rmsprop, adagrad, adadelta and ftrl against the
JAX package's optimizer factory (optax, and its own FTRL), in fp32 on the
CPU.

Five updates on identical gradients (drawn from a numpy seed) under the
exponential schedule with a staircase every two updates and a frozen
scope, with and without weight decay and clipping; parameters and every
slot after them within 1e-6 (absolute, 1e-6 relative: the same fp32
formulas, with rsqrt and pow taken by XLA and by ATen). The slots' state
paths are optax's, so a JAX optimizer state bridges into the port and
back unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from twingan_tpu.train import optimizers as joptimizers  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.train import optimizers  # noqa: E402

TOL = 1e-6
N_STEPS = 5
PARAMS = {"block_4_conv0": {"conv": {"kernel": np.linspace(-1, 1, 6, dtype=np.float32)
                                     .reshape(3, 2),
                                     "bias": np.array([0.3, -0.2], np.float32)}},
          "block_8_conv0": {"conv": {"kernel": np.full((2, 2), -0.5, np.float32)}},
          "prediction": {"bias": np.array([0.1, 0.0, -0.1], np.float32)}}
SCHEDULE = dict(learning_rate=0.05, learning_rate_decay_type="exponential", decay_steps=2,
                learning_rate_decay_factor=0.5)
# Each optimizer with its options away from their defaults, so that each
# one shows (ftrl's l1 and l2, the initial accumulators).
OPTIONS = {
    "rmsprop": dict(rmsprop_decay=0.8, rmsprop_momentum=0.7, opt_epsilon=1e-3),
    "adagrad": dict(adagrad_initial_accumulator_value=0.2),
    "adadelta": dict(adadelta_rho=0.9, opt_epsilon=1e-4),
    "ftrl": dict(ftrl_learning_rate_power=-0.5, ftrl_initial_accumulator_value=0.3,
                 ftrl_l1=0.01, ftrl_l2=0.02),
}
CHAINS = {"frozen": dict(frozen_scopes=("['block_8_conv0']",)),
          "decay, clip, frozen": dict(weight_decay=0.1, clip_global_norm=1.0,
                                      frozen_scopes=("['prediction']",))}


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def run(name, chain):
    """Five updates of both factories -> (JAX params, JAX optimizer state,
    port parameters, port optimizer)."""
    cfg = dict(SCHEDULE, optimizer=name, **OPTIONS[name], **CHAINS[chain])
    flat = bridge.state_dict_from_flax(PARAMS)  # no 4-d leaves: no layout change
    rng = np.random.RandomState(17)
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
             for _ in range(N_STEPS)]
    tx = joptimizers.build_optimizer(joptimizers.OptimizerConfig(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, PARAMS)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    tparams = {k: torch.nn.Parameter(v.clone()) for k, v in flat.items()}
    opt = optimizers.build_optimizer(optimizers.OptimizerConfig(**cfg), tparams)
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in opt.names])
    return jax.device_get(jparams), jax.device_get(opt_state), tparams, opt


def port_opt_flat(opt):
    """The port optimizer's count and slots at their optax state paths."""
    counts, slot_paths = optimizers.state_paths(opt.cfg)
    out = {c: np.asarray(opt.count, np.int32) for c in counts}
    for slot, tensors in opt.slots().items():
        for name, t in tensors.items():
            out[f"{slot_paths[slot]}/{name.replace('.', '/')}"] = t.numpy()
    return out


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("name", optimizers.HAND_UPDATES)
def test_five_updates_match_optax(name, chain):
    jparams, jstate, tparams, opt = run(name, chain)
    ref = {k: v.numpy() for k, v in bridge.state_dict_from_flax(jparams).items()}
    assert set(ref) == set(tparams)
    start = bridge.state_dict_from_flax(PARAMS)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=TOL, atol=TOL, err_msg=k)
        frozen = not opt.trainable[opt.names.index(k)]
        assert np.array_equal(p.detach().numpy(), start[k].numpy()) == frozen, k
    # Every slot of the JAX state, frozen parameters' included, at its path.
    jflat = bridge.flat_from_flax(jstate)
    got = port_opt_flat(opt)
    assert set(got) == set(jflat), sorted(set(got) ^ set(jflat))
    for k, v in jflat.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", optimizers.HAND_UPDATES)
def test_slots_bridge_in_and_out(name):
    """A JAX optimizer state mid-run loads into a fresh port optimizer
    (``load_slots`` at the ``state_paths``), the next update then matches
    optax's, and the loaded state reads back unchanged."""
    jparams, jstate, _, _ = run(name, "decay, clip, frozen")
    cfg = optimizers.OptimizerConfig(**dict(SCHEDULE, optimizer=name, **OPTIONS[name],
                                            **CHAINS["decay, clip, frozen"]))
    tparams = {k: torch.nn.Parameter(v) for k, v in
               bridge.state_dict_from_flax(jparams).items()}
    opt = optimizers.build_optimizer(cfg, tparams)
    jflat = {k: torch.from_numpy(np.array(v)) for k, v in bridge.flat_from_flax(jstate).items()}
    counts, slot_paths = optimizers.state_paths(cfg)
    opt.load_slots(int(jflat[counts[0]]), {
        slot: {n: jflat[f"{prefix}/{n.replace('.', '/')}"] for n in opt.names}
        for slot, prefix in slot_paths.items()})
    back = port_opt_flat(opt)
    assert set(back) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    g = {k: np.full(v.shape, 0.25, np.float32) for k, v in tparams.items()}
    tx = joptimizers.build_optimizer(joptimizers.OptimizerConfig(**cfg.__dict__))
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)),
                           jax.tree_util.tree_map(jnp.asarray, jstate),
                           jax.tree_util.tree_map(jnp.asarray, jparams))
    ref = bridge.state_dict_from_flax(jax.device_get(optax.apply_updates(jparams, updates)))
    opt.step([torch.from_numpy(g[k]) for k in opt.names])
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_state_paths_are_optax_layouts():
    """``state_paths`` names exactly the leaves of each optax state, every
    chain prefix included."""
    params = {"a": {"kernel": jnp.ones((2,))}}
    for name in optimizers.TORCH_OPTIMIZERS + optimizers.HAND_UPDATES:
        for chain in ({}, dict(weight_decay=0.1), CHAINS["decay, clip, frozen"]):
            cfg = dict(optimizer=name, **chain)
            jflat = bridge.flat_from_flax(
                joptimizers.build_optimizer(joptimizers.OptimizerConfig(**cfg)).init(params))
            counts, slots = optimizers.state_paths(optimizers.OptimizerConfig(**cfg))
            want = set(counts) | {f"{p}/a/kernel" for p in slots.values()}
            assert set(jflat) == want, (name, chain)
