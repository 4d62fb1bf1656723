#!/usr/bin/env python3
"""How far each package's float32 TwinGAN G step lands from float64.

    JAX_PLATFORMS=cpu python tools/twingan_step_rounding.py [--resolution 64] [--stable]

Runs one G step of the growing-stage parity tests' configuration
(``tests/test_torch_runner_twingan_growing.py``: batch norm, UNet, SAGAN
at 16 px, eq-lr, pixel norm, SGD, global step 3 of 10, so alpha 0.3) in
the JAX package and in the port, each in float32 and in float64, from the
same state and batch, and prints the largest gap between the post-step
generator-side parameters and moving statistics of each pair. Where the
two float64 runs agree to float64's rounding, the packages compute the
same function, and each float32 run's gap to float64 is its own rounding
error. ``--stable`` runs the stable stage instead (alpha 0).

Neither package has a float64 mode, and neither is edited for one:

- the JAX model is configured with ``dtype="float64"``, and inside
  ``float64_jax`` the ``jnp`` of the JAX modules on the step's path
  answers ``float32`` with float64 (their explicit casts and float32
  accumulators), with x64 enabled;
- inside ``float64_port`` the trainer built there makes its networks in
  float64 and computes in it, ``Tensor.float`` keeps float64, the
  trainer's input cast keeps float64, and minibatch stddev keeps float32's
  epsilon (1e-8; the port and the JAX package both take 1e-6 in other
  dtypes).

Runs on the CPU; it imports both packages, which the port never does.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_runner_twingan_growing as growing  # noqa: E402
import test_torch_twingan_step as base  # noqa: E402
from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import layers  # noqa: E402
from twingan_tpu_torch.ops import basic  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer  # noqa: E402


@contextlib.contextmanager
def float64_jax():
    import jax
    import jax.numpy as jnp

    from twingan_tpu.models import layers as jlayers
    from twingan_tpu.models import pggan as jpggan
    from twingan_tpu.ops import attention as jattention
    from twingan_tpu.ops import basic as jbasic
    from twingan_tpu.ops import norms as jnorms
    from twingan_tpu.train import base as jtrain_base
    from twingan_tpu.train import losses as jlosses
    from twingan_tpu.train import twingan_trainer as jtwingan

    class Float64Numpy(types.ModuleType):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    modules = (jlayers, jpggan, jattention, jbasic, jnorms, jtrain_base, jlosses, jtwingan)
    jax.config.update("jax_enable_x64", True)
    for m in modules:
        m.jnp = Float64Numpy("jnp")
    try:
        yield
    finally:
        for m in modules:
            m.jnp = jnp
        jax.config.update("jax_enable_x64", False)


@contextlib.contextmanager
def float64_port():
    default, float_, stddev = torch.get_default_dtype(), torch.Tensor.float, basic.minibatch_stddev
    torch.set_default_dtype(torch.float64)
    layers._DTYPES["float32"] = torch.float64
    torch.Tensor.float = torch.Tensor.double
    basic.minibatch_stddev = functools.partial(stddev, eps=1e-8)
    try:
        yield
    finally:
        torch.set_default_dtype(default)
        layers._DTYPES["float32"] = torch.float32
        torch.Tensor.float = float_
        basic.minibatch_stddev = stddev


def jax_g_step(res: int, stable: bool = False, float64: bool = False) -> dict[str, np.ndarray]:
    """The JAX G step's generator-side state after the step, in the port's
    layout, as float64 numpy."""
    import jax
    import jax.numpy as jnp

    jcfg, _ = configs(res, stable)
    if float64:
        jcfg = jcfg.replace(model=jcfg.model.replace(dtype="float64"))
    jtrainer = growing.JaxTwinGANTrainer(jcfg)
    jtrainer.gen_tx = base.recording_sgd(base.LR)
    jtrainer.dis_tx = base.recording_sgd(base.LR)
    state0, _, _, images = growing.initial_state(jtrainer, res)
    if stable:
        state0 = state0.replace(step=jnp.asarray(0, jnp.int32),
                                critic_step=jnp.asarray(0, jnp.int32))
    dtype = jnp.float64 if float64 else jnp.float32
    with float64_jax() if float64 else contextlib.nullcontext():
        cast = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda v: jnp.asarray(v, dtype) if jnp.issubdtype(v.dtype, jnp.floating) else v,
            jax.device_get(tree))
        state0 = state0.replace(params=cast(state0.params), model_state=cast(state0.model_state))
        batch = {"source": jnp.asarray(images[0], dtype), "target": jnp.asarray(images[1], dtype)}
        state1, _ = jtrainer.g_step(state0, batch, jax.random.PRNGKey(1))
        state1 = jax.device_get(state1)
    return {k: v.numpy().astype(np.float64) for k, v in bridge.train_state_dict(
        state1.params, state1.model_state, base.GEN_SIDE).items()}


def port_g_step(pcfg, params0, model_state0, batch_g, step: int,
                float64: bool = False) -> dict[str, np.ndarray]:
    """The port's G step from the JAX-layout ``params0``/``model_state0``:
    the generator-side state after the step, as float64 numpy."""
    with float64_port() if float64 else contextlib.nullcontext():
        trainer = TwinGANTrainer(pcfg, device="cpu")
        if float64:
            grow = trainer.growing_image
            trainer._images = lambda batch, alpha: tuple(
                grow(batch[k].to(torch.float64), alpha) for k in ("source", "target"))
        state = base._port_state(trainer, params0, model_state0, step, 2 * step)
        state, _ = trainer.g_step(state, {k: torch.from_numpy(v) for k, v in batch_g.items()})
        return {k: v.double().numpy() for k, v in state.nets.state_dict().items()
                if k.split(".", 1)[0] in base.GEN_SIDE}


def configs(res: int, stable: bool = False):
    jcfg, pcfg = growing.configs(res)
    if stable:
        jcfg = jcfg.replace(model=jcfg.model.replace(is_growing=False))
        pcfg = pcfg.replace(model=pcfg.model.replace(is_growing=False))
    return jcfg, pcfg


def largest_gap(a: dict, b: dict) -> tuple[float, str]:
    return max((float(np.abs(a[k] - b[k]).max()), k) for k in b)


def main(argv=None) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--stable", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    res, stable = args.resolution, args.stable
    jcfg, pcfg = configs(res, stable)
    _, params0, model_state0, images = growing.initial_state(growing.JaxTwinGANTrainer(jcfg), res)
    batch_g = {"source": images[0], "target": images[1]}
    step = 0 if stable else growing.START_STEP
    runs = {"jax float32": jax_g_step(res, stable),
            "jax float64": jax_g_step(res, stable, float64=True),
            "port float32": port_g_step(pcfg, params0, model_state0, batch_g, step),
            "port float64": port_g_step(pcfg, params0, model_state0, batch_g, step,
                                        float64=True)}
    print(f"{res} px, {'stable' if stable else 'growing, alpha 0.3'}: largest gap of the "
          "post-step generator-side state")
    for a, b in (("jax float64", "port float64"), ("jax float32", "jax float64"),
                 ("port float32", "port float64"), ("jax float32", "port float32")):
        gap, key = largest_gap(runs[a], runs[b])
        print(f"  {a:>12} vs {b:<12} {gap:.3e}  ({key})")


if __name__ == "__main__":
    main()
