"""Importer of reference TF1 TwinGAN checkpoints into the port's states.

Counterpart of ``twingan_tpu/infer/import_tf.py``, with its TF1 name map
and its report. TF1 variable names (the reference's scopes and slim's
defaults):
    encoder_content/from_rgb_256x256/Conv/weights
    encoder_content/encoder_block_128x128x256/Conv_1/BatchNorm/beta_s
    generator/block_8x8x256/Conv/weights
    generator/generator_to_rgb_256x256/Conv/weights
    discriminator_t/before_fc_1x1x256/Conv_1/biases
    discriminator_t/prediction/fully_connected/weights
Slim's conv scopes inside a block are Conv, Conv_1, ...; norms live under
<conv scope>/BatchNorm with the '_s'/'_t' domain postfix on each
parameter. ``map_var_name`` takes a TF name to (network, the Flax path in
the network, collection), and ``export_var_names`` gives every leaf of a
state its TF name, such that ``map_var_name`` lands back on the same leaf.

The mapping works on the JAX package's state dict, which the bridge gives
for any of the port's states (``bridge.flax_state_dict``: the Flax paths,
HWIO conv kernels, fc kernels [in, out], TF's layouts); the result goes
back through the bridge (HWIO -> OIHW), so one code path serves both
packages' naming. A value whose shape differs from its target's only by
dimensions of 1 is reshaped (TF keeps a spectral norm's ``u`` as [1, out],
the state [out]); any other difference is a ``shape_mismatch``.

Reading is apart from mapping: ``read_tf_checkpoint`` (TensorFlow,
imported inside it, where it is installed: the card's machine has none)
gives name -> array, and ``import_tf_arrays`` maps such a dict into a
state, so the mapping runs without TensorFlow. ``import_tf_checkpoint`` is
the two in one, the JAX function's signature.

Known divergence, as in the JAX package: for models trained with
use_larger_filter_at_rgb_layer, the growing stage's previous to_rgb kernel
here is min(7, (hw/2)/2) where the reference builds min(7, hw/2); such
checkpoints surface as ``shape_mismatch`` entries in the report.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from twingan_tpu_torch import bridge
from twingan_tpu_torch.train.state import GanTrainState, state_from_dict

REPORT_KEYS = ("mapped", "unmapped", "unmapped_in_scope", "missing_target", "shape_mismatch")
_SLOT_SUFFIXES = ("Adam", "Adam_1", "RMSProp", "RMSProp_1", "Momentum",
                  "ExponentialMovingAverage", "biased", "local_step")

# TF norm param -> our DomainNorm param stem.
_NORM_PARAMS = {
    "beta": "beta",
    "gamma": "gamma",
    "moving_mean": "moving_mean",
    "moving_variance": "moving_var",
    "renorm_mean": "renorm_mean",
    "renorm_mean_weight": "renorm_mean_weight",
    "renorm_stddev": "renorm_stddev",
    "renorm_stddev_weight": "renorm_stddev_weight",
}

_SCOPE_TO_NET = {
    "encoder_content": "encoder_content",
    "encoder_style": "encoder_style",
    "generator": "generator",
    "discriminator_s": "discriminator_s",
    "discriminator_t": "discriminator_t",
    "discriminator": "discriminator",
}


def _split_domain(name: str) -> Tuple[str, int]:
    """'beta_s' -> ('beta', 0); 'gamma_t' -> ('gamma', 1); 'beta' -> ('beta', 0)."""
    if name.endswith("_s"):
        return name[:-2], 0
    if name.endswith("_t"):
        return name[:-2], 1
    return name, 0


def _conditional_norm_param(rest, leaf) -> Optional[str]:
    """Conditional-norm FC params (libs/batch_norm.py:34-38,129-174): the
    beta/gamma come from fully_connected layers scoped 'beta<postfix>' /
    'gamma<postfix>' INSIDE the norm scope, so their variables look like
    .../BatchNorm/beta_s/weights. Returns our DomainNorm param name
    ('beta_fc_kernel_0', ...) or None."""
    if leaf not in ("weights", "biases") or len(rest) < 3:
        return None
    if not any(p in ("BatchNorm", "InstanceNorm") for p in rest[:-2]):
        return None
    stem, domain = _split_domain(rest[-2])
    if stem not in ("beta", "gamma"):
        return None
    kind = "kernel" if leaf == "weights" else "bias"
    return f"{stem}_fc_{kind}_{domain}"


def _style_route(net: str, path: tuple) -> tuple:
    """Our StyleEncoder nests an Encoder ('body') and an EncoderClassifier
    ('head'); the reference builds both inline under the encoder_style
    scope, so imported paths gain the submodule prefix here."""
    if net != "encoder_style":
        return path
    head = path[0].startswith(("before_fc", "prediction"))
    return ("head" if head else "body",) + path


def map_var_name(tf_name: str) -> Optional[Tuple[str, tuple, Optional[str]]]:
    """TF1 variable name -> (network key, our param path, collection).

    ``collection`` is None for trainable params, 'batch_stats' for norm
    moving statistics, 'spectral' for the power-iteration ``u`` vectors.
    Returns None for unmapped names (optimizer slots, counters, ...).
    """
    mapped = _map_var_name_flat(tf_name)
    if mapped is None:
        return None
    net, path, collection = mapped
    return net, _style_route(net, path), collection


def _map_var_name_flat(tf_name: str) -> Optional[Tuple[str, tuple, Optional[str]]]:
    tf_name = tf_name.split(":")[0]
    parts = tf_name.split("/")
    if parts[0] not in _SCOPE_TO_NET:
        return None
    net = _SCOPE_TO_NET[parts[0]]
    rest = parts[1:]
    if not rest:
        return None
    # Skip optimizer slot variables (.../Adam, .../RMSProp etc.).
    if rest[-1] in ("Adam", "Adam_1", "RMSProp", "RMSProp_1", "Momentum"):
        return None

    block = rest[0]
    leaf = rest[-1]

    # Self-attention module (reference pggan_utils.py:301-308 scope
    # 'self_attention_<hw>x<hw>x<c>' containing sa_f/sa_g/sa_h sn-convs and
    # the sa_gamma scalar from libs/self_attention.py:24-70).
    m = re.match(r"self_attention_(\d+)x\d+x\d+$", block)
    if m:
        layer = f"self_attention_{m.group(1)}"
        if leaf == "sa_gamma":
            return net, (layer, "sa_gamma"), None
        if len(rest) >= 2 and rest[1] in ("sa_f", "sa_g", "sa_h"):
            cond = _conditional_norm_param(rest[1:], leaf)
            if cond:
                return net, (layer, rest[1], "norm", cond), None
            if leaf == "weights":
                return net, (layer, rest[1], "conv", "kernel"), None
            if leaf == "biases":
                return net, (layer, rest[1], "conv", "bias"), None
            if leaf == "u":
                return net, (layer, rest[1], "conv", "u"), "spectral"
            # The sa convs sit inside the surrounding arg scope, so they
            # carry the norm too (BatchNorm/InstanceNorm sub-scope).
            if any(p in ("BatchNorm", "InstanceNorm") for p in rest[2:]):
                stem, domain = _split_domain(leaf)
                if stem in _NORM_PARAMS:
                    ours = f"{_NORM_PARAMS[stem]}_{domain}"
                    collection = (
                        "batch_stats"
                        if stem.startswith(("moving", "renorm")) else None
                    )
                    return net, (layer, rest[1], "norm", ours), collection
        return None

    # Scope name -> our layer prefix.
    m = re.match(r"(?:encoder_)?block_(\d+)x\d+(?:x\d+)?$", block)
    if m:
        layer = f"block_{m.group(1)}"
    else:
        m = re.match(r"(?:generator_)?to_rgb_(\d+)x\d+$", block)
        if m:
            layer = f"to_rgb_{m.group(1)}"
        else:
            m = re.match(r"from_rgb_(\d+)x\d+$", block)
            if m:
                layer = f"from_rgb_{m.group(1)}"
            else:
                m = re.match(r"before_fc_1x1x\d+$", block)
                if m:
                    layer = "before_fc"
                elif block == "prediction":
                    # prediction/fully_connected/{weights,biases,u}
                    if leaf == "weights":
                        return net, ("prediction", "kernel"), None
                    if leaf == "biases":
                        return net, ("prediction", "bias"), None
                    if leaf == "u":
                        return net, ("prediction", "u"), "spectral"
                    return None
                else:
                    return None

    # Resblock shortcut 1x1 conv (reference pggan_utils.py:334-342, scope
    # 'shortcut' inside the block scope; ours lives under <layer>_res).
    # from_rgb blocks carry one too (maybe_resblock in
    # discriminator/encoder from_rgb, nets/pggan.py:230,392) — without
    # this gate their shortcut weights would fall through to the Conv
    # scan and silently overwrite the from_rgb conv kernel.
    if "shortcut" in rest[1:] and layer.startswith(("block_", "from_rgb_")):
        if leaf == "weights":
            return net, (f"{layer}_res", "shortcut", "conv", "kernel"), None
        if leaf == "biases":
            return net, (f"{layer}_res", "shortcut", "conv", "bias"), None
        if leaf == "u":
            return net, (f"{layer}_res", "shortcut", "conv", "u"), "spectral"
        return None

    # Conv index inside the block: Conv -> conv0, Conv_1 -> conv1.
    conv_idx = 0
    norm_tail = None
    for p in rest[1:]:
        cm = re.match(r"Conv(?:_(\d+))?$", p)
        if cm:
            conv_idx = int(cm.group(1) or 0)
        elif p in ("BatchNorm", "InstanceNorm"):
            norm_tail = "norm"

    if layer.startswith(("to_rgb", "from_rgb")):
        layer_name = layer if layer.startswith("to_rgb") else f"{layer}_conv"
    else:
        layer_name = f"{layer}_conv{conv_idx}"

    cond = _conditional_norm_param(rest, leaf)
    if cond and norm_tail:
        return net, (layer_name, "norm", cond), None
    if leaf == "weights":
        return net, (layer_name, "conv", "kernel"), None
    if leaf == "biases":
        return net, (layer_name, "conv", "bias"), None
    if leaf == "u":
        return net, (layer_name, "conv", "u"), "spectral"
    stem, domain = _split_domain(leaf)
    if stem in _NORM_PARAMS and norm_tail:
        ours = f"{_NORM_PARAMS[stem]}_{domain}"
        collection = "batch_stats" if stem.startswith(("moving", "renorm")) else None
        return net, (layer_name, "norm", ours), collection
    return None


def _tree(state) -> dict:
    """A port state (``GanTrainState``), or a JAX-layout state dict, as the
    JAX package's state dict (``params``/``model_state`` by network)."""
    if isinstance(state, GanTrainState):
        return bridge.flax_state_dict(state)
    return state


def read_tf_checkpoint(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint, name -> array. Needs TensorFlow."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("reading a TF checkpoint needs tensorflow, which is not "
                          "installed") from e
    reader = tf.train.load_checkpoint(ckpt_path)
    return {name: np.asarray(reader.get_tensor(name))
            for name in reader.get_variable_to_shape_map()}


def map_tf_arrays(arrays: Mapping[str, Any], tree: dict, strict: bool = False):
    """Place the TF variables ``arrays`` (name -> array) at their leaves of
    ``tree``, a JAX-layout state dict, in place. Returns (tree, report),
    the report listing names under ``REPORT_KEYS``; ``strict`` raises
    ``ValueError`` when a name of a mapped network's scope found no leaf
    or a leaf took no value of its shape."""
    report = {k: [] for k in REPORT_KEYS}
    for tf_name in sorted(arrays):
        mapped = map_var_name(tf_name)
        if mapped is None:
            scope = tf_name.split("/")[0]
            leaf = tf_name.split(":")[0].split("/")[-1]
            if scope in _SCOPE_TO_NET and leaf not in _SLOT_SUFFIXES:
                # A model variable of a scope the map claims: leaving it
                # fresh would corrupt a fidelity import.
                report["unmapped_in_scope"].append(tf_name)
            else:
                report["unmapped"].append(tf_name)
            continue
        net, path, collection = mapped
        root = tree["params" if collection is None else "model_state"]
        cursor = root.get(net)
        if cursor is not None and collection is not None:
            cursor = cursor.get(collection)
        for key in path[:-1]:
            if cursor is None:
                break
            cursor = cursor.get(key)
        if cursor is None or path[-1] not in cursor:
            report["missing_target"].append(f"{tf_name} -> {net}/{'/'.join(path)}")
            continue
        value = np.asarray(arrays[tf_name])
        target_shape = tuple(np.shape(cursor[path[-1]]))
        if target_shape != value.shape:
            squeezed = tuple(d for d in value.shape if d != 1)
            if squeezed == tuple(d for d in target_shape if d != 1):
                value = value.reshape(target_shape)
            else:
                report["shape_mismatch"].append(f"{tf_name}: {value.shape} -> {target_shape}")
                continue
        cursor[path[-1]] = value
        report["mapped"].append(tf_name)
    if strict and (report["missing_target"] or report["shape_mismatch"]
                   or report["unmapped_in_scope"]):
        raise ValueError(f"import incomplete: {report}")
    return tree, report


def import_tf_arrays(arrays: Mapping[str, Any], state: GanTrainState, strict: bool = False):
    """``map_tf_arrays`` into a port train state, loaded in place on the
    state's device. Returns (state, report)."""
    tree, report = map_tf_arrays(arrays, bridge.flax_state_dict(state), strict)
    state_from_dict(state, bridge.torch_flat(bridge.flat_from_flax(tree)))
    return state, report


def import_tf_checkpoint(ckpt_path: str, state: GanTrainState, strict: bool = False):
    """Load a reference TF checkpoint into a port train state. Returns
    (state, report) with the JAX importer's report keys. Needs TensorFlow."""
    return import_tf_arrays(read_tf_checkpoint(ckpt_path), state, strict)


# --------------------------------------------------------------------------- #
# Inverse mapping: a state -> reference TF1 names, such that map_var_name
# lands every name back on its leaf.
# --------------------------------------------------------------------------- #

_NET_TO_SCOPE = {v: k for k, v in _SCOPE_TO_NET.items()}
_INV_NORM_PARAMS = {v: k for k, v in _NORM_PARAMS.items()}


def _tf_layer_scope(net: str, layer: str, tree: Dict) -> Optional[str]:
    """Our layer key -> reference variable_scope name (channel-suffixed).

    Block scopes embed their output channel count (nets/pggan.py:149,298);
    it is recovered from the block's conv1 kernel. Generator blocks are
    'block_...', encoder/discriminator blocks 'encoder_block_...'
    (the discriminator body reuses the encoder scope names, :298 vs :82).
    """
    m = re.match(r"block_(\d+)$", layer)
    if m:
        hw = m.group(1)
        c = np.shape(tree[f"block_{hw}_conv1"]["conv"]["kernel"])[-1]
        prefix = "" if net == "generator" else "encoder_"
        return f"{prefix}block_{hw}x{hw}x{c}"
    m = re.match(r"to_rgb_(\d+)$", layer)
    if m:
        return f"generator_to_rgb_{m.group(1)}x{m.group(1)}"
    m = re.match(r"from_rgb_(\d+)$", layer)
    if m:
        return f"from_rgb_{m.group(1)}x{m.group(1)}"
    m = re.match(r"self_attention_(\d+)$", layer)
    if m:
        hw = m.group(1)
        c = np.shape(tree[layer]["sa_h"]["conv"]["kernel"])[-1]
        return f"self_attention_{hw}x{hw}x{c}"
    if layer == "before_fc":
        c = np.shape(tree["before_fc_conv0"]["conv"]["kernel"])[-1]
        return f"before_fc_1x1x{c}"
    if layer == "prediction":
        return "prediction"
    return None


def _norm_tf_name(param: str, dual: bool) -> Optional[Tuple[str, Optional[str]]]:
    """Our norm param name -> (TF subpath under the norm scope, collection)."""
    m = re.match(r"(beta|gamma)_fc_(kernel|bias)_(\d)$", param)
    if m:
        stem, kind, d = m.groups()
        postfix = ("_s", "_t")[int(d)] if dual else ""
        leaf = "weights" if kind == "kernel" else "biases"
        return f"{stem}{postfix}/{leaf}", None
    m = re.match(r"(.+)_(\d)$", param)
    if not m:
        return None
    stem, d = m.groups()
    tf_stem = _INV_NORM_PARAMS.get(stem)
    if tf_stem is None:
        return None
    postfix = ("_s", "_t")[int(d)] if dual else ""
    collection = "batch_stats" if tf_stem.startswith(("moving", "renorm")) else None
    return f"{tf_stem}{postfix}", collection


def export_var_names(state) -> Dict[str, Tuple[str, tuple, Optional[str]]]:
    """Every exportable leaf of ``state`` (a port ``GanTrainState`` or a
    JAX-layout state dict) -> its reference TF1 variable name, as
    {tf_name: (net, path, collection)}. Leaves with no reference
    equivalent (the distillation heads) are skipped."""
    sd = _tree(state)
    out: Dict[str, Tuple[str, tuple, Optional[str]]] = {}
    for net, params in sd["params"].items():
        scope = _NET_TO_SCOPE.get(net)
        if scope is None:
            continue
        ms = sd.get("model_state", {}).get(net, {})
        subtrees = (
            [(("body",), params["body"], {k: v.get("body", {}) for k, v in ms.items()}),
             (("head",), params["head"], {k: v.get("head", {}) for k, v in ms.items()})]
            if net == "encoder_style"
            else [((), params, ms)]
        )
        for prefix, tree, mstate in subtrees:
            _export_tree(scope, net, prefix, tree, mstate, out)
    return out


def _export_tree(scope, net, prefix, tree, mstate, out):
    spectral = mstate.get("spectral", {})
    stats = mstate.get("batch_stats", {})

    def norm_is_batch(layer_dict_name):
        return layer_dict_name in stats

    for key in tree:
        base = re.sub(r"_conv\d$", "", key)
        base = re.sub(r"_res$", "", base)
        # from_rgb_8_conv -> from_rgb_8; before_fc_conv0 -> before_fc.
        m = re.match(r"(from_rgb_\d+|before_fc)", key)
        if m:
            base = m.group(1)
        tf_scope = _tf_layer_scope(net, base, tree)
        if tf_scope is None:
            continue

        if key == "prediction":
            for leaf, tf_leaf in (("kernel", "weights"), ("bias", "biases")):
                if leaf in tree[key]:
                    out[f"{scope}/prediction/fully_connected/{tf_leaf}"] = (
                        net, prefix + (key, leaf), None)
            if "prediction" in spectral and "u" in spectral["prediction"]:
                out[f"{scope}/prediction/fully_connected/u"] = (
                    net, prefix + ("prediction", "u"), "spectral")
            continue

        if base.startswith("self_attention"):
            for sub in ("sa_f", "sa_g", "sa_h"):
                _export_conv_layer(
                    scope, net, prefix, (key, sub), tree[key][sub],
                    spectral.get(key, {}).get(sub, {}),
                    stats.get(key, {}).get(sub, {}),
                    f"{tf_scope}/{sub}", out)
            out[f"{scope}/{tf_scope}/sa_gamma"] = (
                net, prefix + (key, "sa_gamma"), None)
            continue

        if key.endswith("_res"):
            sub = tree[key].get("shortcut", {}).get("conv", {})
            for leaf, tf_leaf in (("kernel", "weights"), ("bias", "biases")):
                if leaf in sub:
                    out[f"{scope}/{tf_scope}/shortcut/{tf_leaf}"] = (
                        net, prefix + (key, "shortcut", "conv", leaf), None)
            u = (spectral.get(key, {}).get("shortcut", {}).get("conv", {}))
            if "u" in u:
                out[f"{scope}/{tf_scope}/shortcut/u"] = (
                    net, prefix + (key, "shortcut", "conv", "u"), "spectral")
            continue

        m = re.match(r".*_conv(\d)$", key)
        conv_idx = int(m.group(1)) if m else 0
        tf_conv = "Conv" if conv_idx == 0 else f"Conv_{conv_idx}"
        _export_conv_layer(
            scope, net, prefix, (key,), tree[key],
            spectral.get(key, {}), stats.get(key, {}),
            f"{tf_scope}/{tf_conv}", out)


def _export_conv_layer(scope, net, prefix, path, layer, spectral, stats, tf_base, out):
    conv = layer.get("conv", {})
    for leaf, tf_leaf in (("kernel", "weights"), ("bias", "biases")):
        if leaf in conv:
            out[f"{scope}/{tf_base}/{tf_leaf}"] = (
                net, prefix + path + ("conv", leaf), None)
    if "u" in spectral.get("conv", {}):
        out[f"{scope}/{tf_base}/u"] = (
            net, prefix + path + ("conv", "u"), "spectral")
    norm = layer.get("norm", {})
    norm_stats = stats.get("norm", {})
    dual = any(k.endswith("_1") for k in list(norm) + list(norm_stats))
    kind = "BatchNorm" if norm_stats else "InstanceNorm"
    for param in norm:
        mapped = _norm_tf_name(param, dual)
        if mapped:
            out[f"{scope}/{tf_base}/{kind}/{mapped[0]}"] = (
                net, prefix + path + ("norm", param), None)
    for param in norm_stats:
        mapped = _norm_tf_name(param, dual)
        if mapped:
            out[f"{scope}/{tf_base}/{kind}/{mapped[0]}"] = (
                net, prefix + path + ("norm", param), "batch_stats")
