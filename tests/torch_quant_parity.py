"""Shared parts of the W8A8 parity tests (``test_torch_quant_ops.py``,
``test_torch_quantize.py``, ``test_torch_export.py``).

One flipped rounding is a whole quantization step, and the two packages'
float32 activations differ in their last bits (XLA and ATen sum in other
orders), which can flip an int8 code. So the layers and models are held in
float64 on both sides, where the codes agree:

- ``float64_jax``: x64 on, and the ``jnp`` of the JAX modules on the
  translate path answers ``float32`` with float64 (their explicit casts
  and float32 parameters and accumulators), as
  ``tools/twingan_step_rounding.py`` does for the G step, plus the
  quantization modules (``ops/quant.py``, ``ops/fused_scale.py``,
  ``ops/sn.py``);
- ``float64_port``: the port's default dtype float64, its "float32"
  compute dtype float64, ``Tensor.float`` keeping float64, and kernel B4's
  argument check taking float64 (its plain version computes in x's type).

Neither package is edited for this.
"""

import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from twingan_tpu_torch.models import layers
from twingan_tpu_torch.ops import fused_conv


@contextlib.contextmanager
def float64_jax():
    import types

    from twingan_tpu.models import layers as jlayers
    from twingan_tpu.models import pggan as jpggan
    from twingan_tpu.ops import attention as jattention
    from twingan_tpu.ops import basic as jbasic
    from twingan_tpu.ops import fused_scale as jfused_scale
    from twingan_tpu.ops import norms as jnorms
    from twingan_tpu.ops import quant as jquant
    from twingan_tpu.ops import sn as jsn
    from twingan_tpu.train import base as jtrain_base
    from twingan_tpu.train import twingan_trainer as jtwingan

    class Float64Numpy(types.ModuleType):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    modules = (jlayers, jpggan, jattention, jbasic, jfused_scale, jnorms, jquant, jsn,
               jtrain_base, jtwingan)
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
    default, float_, check = torch.get_default_dtype(), torch.Tensor.float, fused_conv._check
    torch.set_default_dtype(torch.float64)
    layers._DTYPES["float32"] = torch.float64
    torch.Tensor.float = torch.Tensor.double
    # B4's plain version computes in x's type; its argument check takes the
    # kernel's float32 or bf16 only.
    fused_conv._check = lambda *ts: check(*(t.to(torch.float32) for t in ts))
    try:
        yield
    finally:
        torch.set_default_dtype(default)
        layers._DTYPES["float32"] = torch.float32
        torch.Tensor.float = float_
        fused_conv._check = check


def as_float64(tree):
    """Every floating leaf of a nested dict of arrays as float64 numpy."""
    if hasattr(tree, "items"):
        return {k: as_float64(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(np.float64) if np.issubdtype(arr.dtype, np.floating) else arr


def two_torch_threads():
    """A module fixture's body: two intra-op threads while the module runs
    (six test workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
