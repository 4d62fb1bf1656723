"""``infer/export.py --format=savedmodel`` against the JAX package's
``export_savedmodel`` (``jax2tf``) on one 32 px stage.

The stage of ``tests/test_torch_export.py`` (``test_torch_quantize``'s
``pixel_norm_b4_route``: norm ``none`` with pixel norm, so that the
generator's blocks take kernel B4's op; SAGAN attention at 16 px, B1's
op; UNet), its weights drawn in the port and bridged. The port's CLI and
the JAX function each write a SavedModel with a dynamic batch, loaded back
through ``tf.saved_model.load``:

- both have one ``serving_default`` signature on a float32 input
  ``sources_ph`` [None, 32, 32, 3] and the same output key;
- both translate the same images, at batch 2 and at batches 1 and 3 (a
  polymorphic batch), within ``test_torch_export.py``'s float32 tolerance
  (rtol 1e-4, atol 2e-4); the port's SavedModel equals the port's eager
  translate within 1e-5 (TF's and PyTorch's CPU convs sum in their own
  order);
- the converter (``infer/savedmodel.py``) on the programs of the two other
  stages of ``test_torch_quantize`` (batch norm growing, fused-scale UNet;
  batch 3 through a dynamic batch) and on a static batch gives the eager
  translate within 1e-5, without a save;
- an unmapped target raises ``NotImplementedError`` naming it, and without
  TensorFlow the export raises ``ImportError`` naming it.
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")

from twingan_tpu.infer.export import export_savedmodel as jax_export_savedmodel  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.infer import export, savedmodel  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402

from test_torch_quantize import STEP, images, stage  # noqa: E402
from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

TOL = dict(rtol=1e-4, atol=2e-4)
EAGER_ATOL = 1e-5


def stage_inferer(root, kind):
    jcfg, state, pcfg, model = stage(kind)
    stage_dir = str(root / kind / "32")
    save_stage(stage_dir, pcfg, model.state_dict(), step=STEP)
    return jcfg, state, stage_dir, ImageInferer(stage_dir, device="cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("savedmodel")
    jcfg, state, stage_dir, inferer = stage_inferer(root, "pixel_norm_b4_route")
    port_dir = str(root / "port")
    export.main([f"--model_path={stage_dir}", f"--output_dir={port_dir}",
                 "--format=savedmodel", "--batch_size=0", "--device=cpu"])
    jax_inferer = types.SimpleNamespace(trainer=TwinGANTrainer(jcfg), state=state,
                                        image_hw=32, direction="s2t")
    jax_dir = jax_export_savedmodel(jax_inferer, str(root / "jax"), batch_size=0)
    return dict(inferer=inferer, port=tf.saved_model.load(port_dir),
                jax=tf.saved_model.load(jax_dir), root=root)


def serve(loaded, x):
    out = loaded.signatures["serving_default"](sources_ph=tf.constant(x))
    return {k: v.numpy() for k, v in out.items()}


def test_signature_is_the_jax_exports(saved):
    for name in ("port", "jax"):
        sig = saved[name].signatures
        assert list(sig) == ["serving_default"]
        args, kwargs = sig["serving_default"].structured_input_signature
        assert not args and list(kwargs) == ["sources_ph"]
        spec = kwargs["sources_ph"]
        assert spec.dtype == tf.float32 and spec.shape.as_list() == [None, 32, 32, 3]
    port_out = saved["port"].signatures["serving_default"].structured_outputs
    jax_out = saved["jax"].signatures["serving_default"].structured_outputs
    assert list(port_out) == list(jax_out)


@pytest.mark.parametrize("batch", [2, 1, 3])
def test_savedmodels_translate_alike(saved, batch):
    x = images(n=batch, seed=batch)
    ours, theirs = serve(saved["port"], x), serve(saved["jax"], x)
    assert ours.keys() == theirs.keys() and len(ours) == 1
    (key,) = ours
    assert ours[key].shape == (batch, 32, 32, 3) and ours[key].dtype == np.float32
    np.testing.assert_allclose(ours[key], theirs[key], **TOL)
    eager = saved["inferer"].translate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours[key], eager, rtol=0, atol=EAGER_ATOL)


@pytest.mark.parametrize("kind,batch_size", [("batch_norm_growing", 0),
                                             ("fused_scale_unet", 0),
                                             ("pixel_norm_b4_route", 2)])
def test_converter_computes_the_program(saved, kind, batch_size):
    inferer = (saved["inferer"] if kind == "pixel_norm_b4_route"
               else stage_inferer(saved["root"], kind)[-1])
    fn = savedmodel.tf_function(export.trace(inferer, batch_size))
    x = images(n=batch_size or 3, seed=10)
    eager = inferer.translate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(fn(tf.constant(x)).numpy(), eager, rtol=0, atol=EAGER_ATOL)


def test_unmapped_target_raises_naming_it():
    class Sine(torch.nn.Module):
        def forward(self, x):
            return torch.sin(x) * 2

    program = torch.export.export(Sine(), (torch.zeros(2, 3),))
    with pytest.raises(NotImplementedError, match="aten.sin.default"):
        savedmodel.tf_function(program)


def test_without_tensorflow_the_export_raises_naming_it(saved, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        export.export_savedmodel(saved["inferer"], str(saved["root"] / "none"))
