"""``infer/import_tf.py``: the port's TF1 checkpoint importer against the
JAX package's on one TF checkpoint.

One TwinGAN state at 16 px with every mapped feature on (batch renorm,
self-attention, residual blocks, spectral norm, conditional style norms,
the style encoder, UNet; max_channels 16), drawn in the port and carried
to JAX through ``bridge.flax_state_dict``. Two TF1 checkpoints are written
on the CPU (the ``SaveV2`` op of the ``tf.compat.v1`` Saver that
``tests/test_tf_parity.py`` writes them with), from the
``export_var_names`` names with seeded values, ``u`` kept as TF's [1, out]:

- a clean one: every exported name;
- a faulty one: most of them, plus an optimizer slot, a global step, a
  model variable no rule maps (``unmapped_in_scope``), a name whose leaf
  does not exist (``missing_target``) and one of the wrong shape
  (``shape_mismatch``).

Both packages import both checkpoints into the same state: the port's
state equals the bridged JAX state bit for bit, the reports are equal, and
``strict=True`` succeeds on the clean one and raises ``ValueError`` on the
faulty one in both. ``export_var_names`` gives the same names and leaves in
both, each mapping back to its leaf, and covers every parameter and
statistic of the five reference-scoped networks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("tensorflow")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.infer import import_tf as jimport  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.infer import import_tf  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

MODEL_KW = dict(resolution=16, max_channels=16, num_domains=2, norm_type="batch_renorm",
                do_self_attention=True, self_attention_hw=8, use_res_block=True,
                spectral_norm=True, style_dim=8)
TRAINER_KW = dict(use_style_embedding=True, style_embed_size=8, use_unet=True, batch_size=2)
NETS = ("encoder_content", "encoder_style", "generator", "discriminator_s", "discriminator_t")
FAULTS = {
    "generator/Adam": (3,),
    "global_step": (),
    "generator/mystery_scope/weights": (2, 2),
    "generator/block_4096x4096x16/Conv/weights": (3, 3, 16, 16),
}


def save_tf1_checkpoint(path, arrays):
    """A TF1 checkpoint of ``arrays`` under their names: the ``SaveV2`` op
    that a ``tf.compat.v1`` Saver runs, called eagerly (no graph or session
    to build)."""
    import tensorflow as tf

    prefix = str(path) + "/model.ckpt"
    names = sorted(arrays)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(arrays[n]) for n in names])
    return prefix


def leaf(sd, net, path, collection):
    node = sd["params" if collection is None else "model_state"][net]
    if collection is not None:
        node = node[collection]
    for k in path:
        node = node[k]
    return node


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("import_tf")
    ptrainer = TwinGANTrainer(TwinGANConfig(model=PGGANConfig(**MODEL_KW), **TRAINER_KW),
                              device="cpu")
    jtrainer = JaxTwinGANTrainer(JaxTwinGANConfig(model=JaxPGGANConfig(**MODEL_KW),
                                                  **TRAINER_KW))
    pstate = ptrainer.init_state(0)
    template = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    jstate = flax.serialization.from_state_dict(template, bridge.flax_state_dict(pstate))
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    names = jimport.export_var_names(jstate)
    sd = flax.serialization.to_state_dict(jstate)
    rs = np.random.RandomState(1)
    clean = {}
    for tf_name, (net, path, collection) in names.items():
        val = np.asarray(rs.rand(*np.shape(leaf(sd, net, path, collection))) + 0.25,
                         np.float32)
        clean[tf_name] = val.reshape(1, -1) if tf_name.endswith("/u") else val
    faulty = {k: v for i, (k, v) in enumerate(sorted(clean.items())) if i % 3}
    faulty.update({k: np.asarray(rs.rand(*shape), np.float32) for k, shape in FAULTS.items()})
    wrong = sorted(clean)[0]  # present in faulty (i == 0 is left out): give it a bad shape
    faulty[wrong] = np.zeros((7, 7), np.float32)
    paths = {"clean": save_tf1_checkpoint(root / "clean", clean),
             "faulty": save_tf1_checkpoint(root / "faulty", faulty)}
    return dict(ptrainer=ptrainer, jstate=jstate, names=names, sd=sd, clean=clean,
                paths=paths, wrong=wrong)


def port_state(setup):
    """A fresh port state holding the setup's weights."""
    return bridge.state_from_flax(setup["ptrainer"], setup["jstate"])


def test_export_var_names_match_and_map_back(setup):
    names = setup["names"]
    ours = import_tf.export_var_names(port_state(setup))
    assert ours == names
    assert len(names) > 150, len(names)
    for tf_name, target in names.items():
        assert import_tf.map_var_name(tf_name) == jimport.map_var_name(tf_name) == target
    covered = {(net, path) for net, path, _ in names.values()}
    sd = setup["sd"]
    missing = []
    for net in NETS:
        trees = [sd["params"][net]] + list(sd["model_state"].get(net, {}).values())
        for tree in trees:
            for key in bridge.flat_from_flax(tree):
                if (net, tuple(key.split("/"))) not in covered:
                    missing.append((net, key))
    assert not missing, missing[:10]


@pytest.mark.parametrize("which", ["clean", "faulty"])
def test_import_matches_jax_bit_for_bit(setup, which):
    path = setup["paths"][which]
    jnew, jreport = jimport.import_tf_checkpoint(path, jax.tree_util.tree_map(jnp.asarray,
                                                                              setup["jstate"]))
    pnew, preport = import_tf.import_tf_checkpoint(path, port_state(setup))
    assert preport == jreport
    assert set(preport) == set(import_tf.REPORT_KEYS)
    if which == "clean":
        assert len(preport["mapped"]) == len(setup["names"])
        assert not any(preport[k] for k in import_tf.REPORT_KEYS if k != "mapped")
    else:
        assert preport["unmapped"] == ["generator/Adam", "global_step"]
        assert preport["unmapped_in_scope"] == ["generator/mystery_scope/weights"]
        assert len(preport["missing_target"]) == 1
        assert len(preport["shape_mismatch"]) == 1
        assert preport["shape_mismatch"][0].startswith(f"{setup['wrong']}: (7, 7) -> ")
    want = bridge.flat_from_flax(jax.device_get(jnew))
    ours = bridge.flax_state_dict(pnew)
    got = bridge.flat_from_flax(ours)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if which == "clean":
        for tf_name, (net, tpath, collection) in setup["names"].items():
            np.testing.assert_array_equal(
                np.asarray(leaf(ours, net, tpath, collection)).ravel(),
                setup["clean"][tf_name].ravel(), err_msg=tf_name)


@pytest.mark.parametrize("which", ["clean", "faulty"])
def test_strict_import(setup, which):
    path = setup["paths"][which]
    jstate = jax.tree_util.tree_map(jnp.asarray, setup["jstate"])
    if which == "clean":
        _, jreport = jimport.import_tf_checkpoint(path, jstate, strict=True)
        _, preport = import_tf.import_tf_checkpoint(path, port_state(setup), strict=True)
        assert preport == jreport
    else:
        with pytest.raises(ValueError, match="import incomplete"):
            jimport.import_tf_checkpoint(path, jstate, strict=True)
        with pytest.raises(ValueError, match="import incomplete"):
            import_tf.import_tf_checkpoint(path, port_state(setup), strict=True)


def test_mapping_runs_without_tensorflow(setup):
    """``import_tf_arrays`` takes name -> array and needs no reader: the
    clean checkpoint's arrays land as the reader's do."""
    state, report = import_tf.import_tf_arrays(setup["clean"], port_state(setup), strict=True)
    read, _ = import_tf.import_tf_checkpoint(setup["paths"]["clean"], port_state(setup))
    assert len(report["mapped"]) == len(setup["names"])
    a = bridge.flat_from_flax(bridge.flax_state_dict(state))
    b = bridge.flat_from_flax(bridge.flax_state_dict(read))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert import_tf.read_tf_checkpoint(setup["paths"]["clean"]).keys() == setup["clean"].keys()
