"""A ``torch.export`` program as TensorFlow ops: the SavedModel export.

``export.export_savedmodel`` writes the translate function as a TF
SavedModel by converting the program ``export_torch`` traces, not by
building the networks a second time: ``tf_function(program)`` walks the
program's graph in order and emits, for each target, the TF ops that
compute it, so the SavedModel computes exactly the function the port
exports. The program's parameters, buffers and lifted constants become
TF constants in the graph.

Tensors keep the program's layouts (NCHW between the layers); ops that TF
runs only in NHWC on the CPU (conv, average pool) transpose around the
call, and conv kernels go OIHW -> HWIO. The targets mapped
(``TF_OPS``) are those of the fp32 translate programs: ``aten`` conv2d,
the elementwise arithmetic, ``mean.dim``, ``square``, ``rsqrt``,
``tanh``, ``avg_pool2d``, ``upsample_nearest2d``, ``cat``, ``chunk``,
``permute``, ``reshape``, ``unsqueeze``, ``to.dtype``, ``sym_size`` (a
dynamic batch is ``tf.shape``'s first entry) and the no-ops (``detach``,
``_assert_tensor_metadata``, ``lift_fresh_copy``, ``contiguous``,
``getitem``), and the port's kernels as their plain versions in TF ops:
``twingan_tpu_torch::flash_attn_fwd`` (B1: softmax(f g^T) h with no
scale, and the rows' logsumexp) and ``::fused_conv`` (B4: conv3x3 SAME +
bias, leaky 0.2, pixel norm with epsilon 1e-6). Any other target raises
``NotImplementedError`` naming it; the int8 program's ``::conv_i8q`` is
one (the JAX package never exports an int8 SavedModel).

TensorFlow is imported inside the functions that need it; without it they
raise ``ImportError`` naming it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

LEAKY_SLOPE = 0.2
PIXEL_NORM_EPS = 1e-6


def _tf():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the SavedModel export needs tensorflow, which is not "
                          "installed") from e
    return tf


def target_name(target) -> str:
    """``aten.conv2d.default``, ``twingan_tpu_torch.fused_conv.default``,
    ``operator.getitem``: the key of ``TF_OPS``."""
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    if getattr(target, "__module__", None) in ("_operator", "operator"):
        return f"operator.{target.__name__}"
    return getattr(target, "__qualname__", str(target))


_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _nhwc(tf, x):
    return tf.transpose(x, [0, 2, 3, 1])


def _nchw(tf, x):
    return tf.transpose(x, [0, 3, 1, 2])


def _pair(v) -> list[int]:
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * 2 if len(v) == 1 else v


def _conv2d(tf, x, w, b=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    if groups != 1:
        raise NotImplementedError(f"aten.conv2d with groups={groups}")
    ph, pw = _pair(padding)
    y = tf.nn.conv2d(_nhwc(tf, x), tf.transpose(w, [2, 3, 1, 0]), strides=[1] + _pair(stride)
                     + [1], padding=[[0, 0], [ph, ph], [pw, pw], [0, 0]],
                     dilations=[1] + _pair(dilation) + [1])
    if b is not None:
        y = y + b
    return _nchw(tf, y)


def _avg_pool2d(tf, x, kernel_size, stride=(), padding=0, ceil_mode=False,
                count_include_pad=True, divisor_override=None):
    if any(_pair(padding)) or ceil_mode or divisor_override:
        raise NotImplementedError("aten.avg_pool2d with padding, ceil_mode or a divisor")
    k = _pair(kernel_size)
    s = _pair(stride) if stride else k
    return _nchw(tf, tf.nn.avg_pool2d(_nhwc(tf, x), k, s, "VALID"))


def _upsample_nearest2d(tf, x, output_size, scale_factors):
    """PyTorch's nearest at given scale factors: source index floor(dst /
    factor), clamped to the input."""
    if output_size is not None:
        raise NotImplementedError("aten.upsample_nearest2d.vec with an output size")
    for axis, factor in enumerate(scale_factors):
        n_in = int(x.shape[2 + axis])
        n_out = int(math.floor(n_in * factor))
        idx = np.minimum(np.floor(np.arange(n_out) * np.float32(1.0 / factor)).astype(np.int64),
                         n_in - 1)
        x = tf.gather(x, idx, axis=2 + axis)
    return x


def _chunk(tf, x, chunks, dim=0):
    n = int(x.shape[dim])
    size = -(-n // chunks)
    sizes = [size] * (n // size) + ([n % size] if n % size else [])
    return tf.split(x, sizes, axis=dim)


def _shape(tf, shape):
    """A shape list of ints and dynamic sizes (TF scalars)."""
    if all(isinstance(s, int) for s in shape):
        return list(shape)
    return tf.stack([tf.cast(s, tf.int32) for s in shape])


def _mean(tf, x, dim=None, keepdim=False, dtype=None):
    return tf.reduce_mean(x, axis=dim, keepdims=keepdim)


def _to_dtype(tf, x, dtype, non_blocking=False, copy=False, memory_format=None):
    return tf.cast(x, getattr(tf, _DTYPES[dtype]))


def _flash_attn_fwd(tf, f, g, h):
    """B1's plain version: (softmax(f g^T) h, logsumexp of the rows)."""
    scores = tf.matmul(tf.cast(f, tf.float32), tf.cast(g, tf.float32), transpose_b=True)
    o = tf.matmul(tf.nn.softmax(scores, axis=-1), tf.cast(h, tf.float32))
    return tf.cast(o, h.dtype), tf.reduce_logsumexp(scores, axis=-1)


def _fused_conv(tf, x, w9, b):
    """B4's plain version: conv3x3 SAME of NCHW x with the [9, Cin, Cout]
    taps (dy * 3 + dx), + b, leaky 0.2, pixel norm."""
    cin, cout = int(w9.shape[1]), int(w9.shape[2])
    y = tf.nn.conv2d(_nhwc(tf, tf.cast(x, tf.float32)), tf.reshape(w9, [3, 3, cin, cout]),
                     strides=1, padding=[[0, 0], [1, 1], [1, 1], [0, 0]]) + b
    y = tf.maximum(y * LEAKY_SLOPE, y)
    y = y * tf.math.rsqrt(tf.reduce_mean(tf.square(y), axis=-1, keepdims=True)
                          + PIXEL_NORM_EPS)
    return tf.cast(_nchw(tf, y), x.dtype)


def _noop(tf, x, *args, **kwargs):
    return x


def _nothing(tf, *args, **kwargs):
    return None


TF_OPS: dict[str, Callable] = {
    "aten.conv2d.default": _conv2d,
    "aten.avg_pool2d.default": _avg_pool2d,
    "aten.upsample_nearest2d.vec": _upsample_nearest2d,
    "aten.add.Tensor": lambda tf, a, b, alpha=1: a + b * alpha if alpha != 1 else a + b,
    "aten.sub.Tensor": lambda tf, a, b, alpha=1: a - b * alpha if alpha != 1 else a - b,
    "aten.rsub.Scalar": lambda tf, a, b, alpha=1: b - a * alpha if alpha != 1 else b - a,
    "aten.mul.Tensor": lambda tf, a, b: a * b,
    "aten.maximum.default": lambda tf, a, b: tf.maximum(a, b),
    "aten.mean.dim": _mean,
    "aten.square.default": lambda tf, x: tf.square(x),
    "aten.rsqrt.default": lambda tf, x: tf.math.rsqrt(x),
    "aten.tanh.default": lambda tf, x: tf.tanh(x),
    "aten.cat.default": lambda tf, xs, dim=0: tf.concat(list(xs), axis=dim),
    "aten.chunk.default": _chunk,
    "aten.permute.default": lambda tf, x, dims: tf.transpose(x, list(dims)),
    "aten.reshape.default": lambda tf, x, shape: tf.reshape(x, _shape(tf, shape)),
    "aten.unsqueeze.default": lambda tf, x, dim: tf.expand_dims(x, dim),
    "aten.to.dtype": _to_dtype,
    "aten.sym_size.int": lambda tf, x, dim: tf.shape(x)[dim],
    "aten.detach.default": _noop,
    "aten.detach_.default": _noop,
    "aten.lift_fresh_copy.default": _noop,
    "aten.contiguous.default": _noop,
    "aten._assert_tensor_metadata.default": _nothing,
    "operator.getitem": lambda tf, xs, i: xs[i],
    "twingan_tpu_torch.flash_attn_fwd.default": _flash_attn_fwd,
    "twingan_tpu_torch.fused_conv.default": _fused_conv,
}


def _constants(program) -> dict[str, np.ndarray]:
    """The program's lifted inputs (parameters, buffers, constants) by
    placeholder name, as numpy arrays."""
    sig = program.graph_signature
    sources = {**program.state_dict, **program.constants}
    out = {}
    for spec in sig.input_specs:
        if spec.target is not None:
            out[spec.arg.name] = sources[spec.target].detach().cpu().numpy()
    return out


def tf_function(program) -> Callable[[Any], Any]:
    """A Python function of TF tensors computing ``program`` (an
    ``ExportedProgram`` of one tensor input and one tensor output). Raises
    ``NotImplementedError`` naming the first target ``TF_OPS`` lacks, before
    any TF op is built."""
    graph = program.graph
    for node in graph.nodes:
        if node.op == "call_function" and target_name(node.target) not in TF_OPS:
            raise NotImplementedError(
                f"no TensorFlow mapping for {target_name(node.target)} (node {node.name}); "
                "the SavedModel export maps the fp32 translate program's targets only")
    constants = _constants(program)
    user_inputs = program.graph_signature.user_inputs
    if len(user_inputs) != 1:
        raise ValueError(f"the program takes {len(user_inputs)} inputs, not one")

    def fn(images):
        tf = _tf()
        env: dict[str, Any] = {}

        def value(a):
            if isinstance(a, torch.fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(value(v) for v in a)
            if isinstance(a, Mapping):
                return {k: value(v) for k, v in a.items()}
            return a

        for node in graph.nodes:
            if node.op == "placeholder":
                env[node.name] = (images if node.name == user_inputs[0]
                                  else tf.constant(constants[node.name]))
            elif node.op == "call_function":
                op = TF_OPS[target_name(node.target)]
                env[node.name] = op(tf, *value(node.args), **value(node.kwargs))
            elif node.op == "output":
                outs = value(node.args[0])
                return outs[0] if isinstance(outs, (list, tuple)) else outs
        raise ValueError("the program has no output")

    return fn


def save(program, output_dir: str, input_shape: list, input_name: str = "sources_ph") -> str:
    """Write ``program`` as a SavedModel with one ``serving_default``
    signature on a float32 input ``input_name`` of ``input_shape`` (None
    for a dynamic dimension). Returns ``output_dir``."""
    tf = _tf()
    fn = tf_function(program)
    module = tf.Module()
    module.f = tf.function(fn, autograph=False, input_signature=[
        tf.TensorSpec(input_shape, tf.float32, name=input_name)])
    tf.saved_model.save(module, output_dir,
                        signatures={"serving_default": module.f.get_concrete_function()})
    return output_dir

