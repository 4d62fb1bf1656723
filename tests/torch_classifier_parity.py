"""Shared parts of the classifier-zoo parity tests (``test_torch_zoo_*.py``).

Each network of the JAX ``NETWORKS`` is built in both packages at the
smallest input it takes; the same weights go into both: drawn by JAX from
one key over the tree ``jax.eval_shape`` gives for the Flax init (kernels
at Flax's truncated LeCun-normal scale, biases and norm scales away from
their init values, moving statistics away from 0 and 1, so that every leaf
counts), then bridged (``bridge.classifier_state_dict_from_flax``). One
draw for the whole tree keeps the JAX side cheap (a Flax init compiles one
generator per leaf).

- Eval mode, fp32: the logits and every end point, each within
  ``EVAL_RTOL`` of its own largest magnitude ((max abs diff) / (max abs of
  the reference)).
- Train mode, for the networks with batch norm: one forward in float64 on
  both sides (the JAX one under ``jax.enable_x64``), the logits and every
  updated moving statistic within ``TRAIN64_RTOL`` (measured: at most
  8.5e-8 on the logits, inception_v4, and 6.4e-11 on the statistics; the
  same ill conditioning as below, at float64's rounding). In fp32 a train-mode
  forward at batch 2 and 1-2 px deep maps normalizes by batch variances
  that E[x^2] - E[x]^2 (Flax's form, kept in the port) leaves to rounding:
  the two packages' fp32 logits measured up to 0.4 apart (relative) at
  inception_v4, 75 px, so fp32 would test the summation order, not the
  port. Networks without batch norm compare their fp32 train-mode logits
  within ``EVAL_RTOL``.
"""

import copy
import gc

import numpy as np
import torch

import jax
import jax.numpy as jnp

from twingan_tpu.models.classifiers import get_network_fn as jax_network

from twingan_tpu_torch import bridge
from twingan_tpu_torch.models.classifiers import get_network_fn as torch_network

NUM_CLASSES = 10
EVAL_RTOL = 1e-5
TRAIN64_RTOL = 1e-6
_TRUNC_STD = 0.87962566103423978


def jax_variables(net, hw: int, seed: int = 0) -> dict:
    """{"params": ..., "batch_stats": ...} of ``net`` (numpy leaves) drawn
    by JAX from ``seed``, one draw for the whole tree."""
    shapes = jax.eval_shape(lambda: net.init(
        {"params": jax.random.PRNGKey(0), "drop_path": jax.random.PRNGKey(0)},
        jnp.zeros((1, hw, hw, 3))))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    total = sum(int(np.prod(leaf.shape)) for _, leaf in leaves)
    k_normal, k_uniform = jax.random.split(jax.random.PRNGKey(seed))
    normal = np.asarray(jax.random.truncated_normal(k_normal, -2.0, 2.0, (total,)))
    uniform = np.asarray(jax.random.uniform(k_uniform, (total,)))
    out: dict = {}
    offset = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        n = int(np.prod(leaf.shape))
        z = normal[offset: offset + n].reshape(leaf.shape)
        u = uniform[offset: offset + n].reshape(leaf.shape)
        offset += n
        name = keys[-1]
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            value = z / np.sqrt(fan_in) / _TRUNC_STD
        elif name in ("scale", "var"):
            value = 0.5 + u
        else:  # bias, mean
            value = 0.1 * z
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[name] = value.astype(np.float32)
    return out


def images(batch: int, hw: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)


def rel_err(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    return float(np.max(np.abs(ours - theirs)) / max(np.max(np.abs(theirs)), 1e-30))


def build_pair(name: str, hw: int, seed: int = 0):
    """(JAX module, its variables, the port's network with the same
    weights, in eval mode)."""
    jnet = jax_network(name, NUM_CLASSES)
    variables = jax_variables(jnet, hw, seed)
    tnet = torch_network(name, NUM_CLASSES, image_hw=hw)
    tnet.load_state_dict(bridge.classifier_state_dict_from_flax(
        variables["params"], variables.get("batch_stats")), strict=True)
    return jnet, variables, tnet.eval()


def check_eval(jnet, variables, tnet, x: np.ndarray) -> dict:
    """Eval-mode logits and every end point; returns each one's error."""
    jl, jeps = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        tl, teps = tnet(torch.from_numpy(x))
    assert set(teps) == set(jeps), set(teps) ^ set(jeps)
    errs = {"logits": rel_err(tl.numpy(), jl)}
    errs.update({k: rel_err(teps[k].numpy(), jeps[k]) for k in jeps})
    assert max(errs.values()) <= EVAL_RTOL, errs
    return errs


def check_train(jnet, variables, tnet, x: np.ndarray, **call_kw) -> dict:
    """One train-mode forward: float64 on both sides where the network has
    batch statistics (logits and every updated statistic), else fp32
    logits. ``call_kw`` goes to both calls (NASNet's ``progress``);
    ``generator`` only to the port's."""
    generator = call_kw.pop("generator", None)
    tkw = dict(call_kw, **({"generator": generator} if generator is not None else {}))
    rngs = {"drop_path": jax.random.PRNGKey(5)}
    if not variables.get("batch_stats"):
        jl, _ = jax.jit(lambda v, a: jnet.apply(v, a, train=True, rngs=rngs, **call_kw))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            tl, _ = copy.deepcopy(tnet).train()(torch.from_numpy(x), **tkw)
        err = {"logits": rel_err(tl.numpy(), jl)}
        assert err["logits"] <= EVAL_RTOL, err
        return err
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (jl, _), upd = jax.jit(lambda v, a: jnet.apply(
            v, a, train=True, mutable=["batch_stats"], rngs=rngs, **call_kw))(
            v64, jnp.asarray(x, jnp.float64))
        jl, jstats = np.asarray(jl), jax.device_get(upd["batch_stats"])
    tnet = copy.deepcopy(tnet).double().train()
    with torch.no_grad():
        tl, _ = tnet(torch.from_numpy(x).double(), **tkw)
    _, stats = bridge.flax_from_classifier_state_dict(tnet.state_dict())
    errs = {"logits": rel_err(tl.numpy(), jl)}
    flat_j = jax.tree_util.tree_flatten_with_path(jstats)[0]
    ours = {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(stats)[0]}
    assert len(ours) == len(flat_j)
    errs["batch_stats"] = max(rel_err(ours[tuple(p.key for p in path)], leaf)
                              for path, leaf in flat_j)
    assert max(errs.values()) <= TRAIN64_RTOL, errs
    return errs


class PairCache:
    """The pair of the network under test, built once for its eval and
    train cases (parametrize them network by network) and dropped when the
    next network comes: the VGG-sized pairs take a GiB each."""

    def __init__(self, sizes: dict):
        self.sizes, self.name, self.pair = sizes, None, None

    def get(self, name: str):
        if name != self.name:
            self.name, self.pair = None, None
            gc.collect()
            self.pair = build_pair(name, self.sizes[name][0])
            self.name = name
        return self.pair


def cases(sizes: dict) -> list:
    """(name, mode) cases, each network's eval then train."""
    return [(n, m) for n in sizes for m in ("eval", "train")]


def run_case(cache: PairCache, name: str, mode: str, **call_kw) -> dict:
    hw, batch = cache.sizes[name]
    jnet, variables, tnet = cache.get(name)
    x = images(batch, hw)
    if mode == "eval":
        return check_eval(jnet, variables, tnet, x)
    return check_train(jnet, variables, tnet, x, **call_kw)
