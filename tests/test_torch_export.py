"""``infer/export.py``: the port's ``torch.export`` of the translate
function against the JAX package's ``export_jax``.

One 32 px stage (norm ``none`` with pixel norm, so that the generator's
fp blocks take kernel B4's op; SAGAN attention at 16 px, kernel B1's op;
UNet), its weights drawn in the port and bridged:

- ``export_jax`` (given the JAX inferer's trainer, state, size and
  direction) and ``export_torch`` (an ``ImageInferer`` on the CPU), each
  loaded back (``load_jax``, ``load_torch``), translate the same images
  within ``tests/test_torch_translate.py``'s float32 tolerance (rtol 1e-4,
  atol 2e-4); their int8 programs within the flip tolerance of
  ``test_torch_quantize_serve.py`` (15 of 6144 values past the fp32
  tolerance here, 1.6e-2 at most);
- the exported graph calls the port's kernels as custom ops
  (``twingan_tpu_torch::flash_attn_fwd``, ``::fused_conv``; ``::conv_i8q``
  after calibration), and the loaded program equals the eager inferer bit
  for bit, in fp32 and in int8;
- the two ``params.npz`` files hold the same keys and values, the int8
  calibration's ``quant`` collection included (its abs-maxima within
  float32's rounding of each other);
- ``--format savedmodel`` raises where TensorFlow cannot be imported,
  naming it (``test_torch_savedmodel.py`` checks what it writes).
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.infer.export import export_jax, load_jax  # noqa: E402
from twingan_tpu.infer.quantize import calibrate as jax_calibrate  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.infer import export  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import save_stage  # noqa: E402

from test_torch_quantize import STEP, images, stage  # noqa: E402
from test_torch_quantize_serve import FP32_MAX_TOL, FP32_MEAN_TOL  # noqa: E402
from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

TOL = dict(rtol=1e-4, atol=2e-4)
AMAX_RTOL = 1e-5


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both packages' fp and int8 exports of one stage, loaded back."""
    root = tmp_path_factory.mktemp("export")
    jcfg, state, pcfg, model = stage("pixel_norm_b4_route")
    stage_dir = str(root / "32")
    save_stage(stage_dir, pcfg, model.state_dict(), step=STEP)
    x = images(seed=2)
    trainer = TwinGANTrainer(jcfg)
    jax_inferer = types.SimpleNamespace(trainer=trainer, state=state, image_hw=32,
                                        direction="s2t")
    q8, state_q = jax_calibrate(trainer, state, jnp.asarray(x))
    jax_q8 = types.SimpleNamespace(trainer=q8, state=state_q, image_hw=32, direction="s2t")
    out = {"x": x}
    for name, inf in (("fp", jax_inferer), ("int8", jax_q8)):
        path = export_jax(inf, str(root / f"jax_{name}"), batch_size=2)
        out[f"jax_{name}"] = np.asarray(load_jax(path)(jnp.asarray(x)))
        out[f"jax_{name}_npz"] = dict(np.load(str(root / f"jax_{name}" / "params.npz")))

    inferer = ImageInferer(stage_dir, device="cpu")
    q_inferer = ImageInferer(stage_dir, device="cpu", quantize=True)
    q_inferer.calibrate(torch.from_numpy(x))
    for name, inf in (("fp", inferer), ("int8", q_inferer)):
        path = export.export_torch(inf, str(root / f"torch_{name}"), batch_size=2)
        program = torch.export.load(path)
        out[f"ops_{name}"] = {str(n.target) for n in program.graph.nodes
                              if "twingan_tpu_torch" in str(n.target)}
        with torch.no_grad():
            out[f"torch_{name}"] = export.load_torch(path)(torch.from_numpy(x)).numpy()
        out[f"eager_{name}"] = inf.translate(torch.from_numpy(x)).numpy()
        out[f"torch_{name}_npz"] = dict(np.load(str(root / f"torch_{name}" / "params.npz")))
    out["stage_dir"] = stage_dir
    return out


def test_the_exported_programs_translate_as_jaxs(exported):
    assert exported["torch_fp"].shape == (2, 32, 32, 3)
    np.testing.assert_allclose(exported["torch_fp"], exported["jax_fp"], **TOL)
    # int8: an int8 code of the two packages' float32 activations may flip
    # (test_torch_quantize_serve.py), which moves the output by a
    # quantization step: held to that file's flip tolerance.
    want = exported["jax_int8"]
    diff = np.abs(exported["torch_int8"] - want) / (want.max() - want.min())
    assert diff.max() <= FP32_MAX_TOL and diff.mean() <= FP32_MEAN_TOL, (diff.max(),
                                                                          diff.mean())
    assert np.abs(exported["torch_int8"] - exported["torch_fp"]).max() > 1e-3


def test_the_graph_calls_the_kernels_and_equals_eager(exported):
    assert exported["ops_fp"] == {"twingan_tpu_torch.flash_attn_fwd.default",
                                  "twingan_tpu_torch.fused_conv.default"}
    assert exported["ops_int8"] == {"twingan_tpu_torch.flash_attn_fwd.default",
                                    "twingan_tpu_torch.conv_i8q.default"}
    for name in ("fp", "int8"):
        np.testing.assert_array_equal(exported[f"torch_{name}"], exported[f"eager_{name}"])


@pytest.mark.parametrize("name", ["fp", "int8"])
def test_params_npz_has_the_jax_keys_and_values(exported, name):
    ours, theirs = exported[f"torch_{name}_npz"], exported[f"jax_{name}_npz"]
    assert set(ours) == set(theirs)
    quant = [k for k in theirs if "/quant/" in k]
    assert (len(quant) > 20) == (name == "int8")
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        if k in quant:
            np.testing.assert_allclose(ours[k], v, rtol=AMAX_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_cli_exports_and_savedmodel_raises(exported, tmp_path, capsys, monkeypatch):
    """The CLI's torch export loads back equal to the eager inferer; its
    ``--format=savedmodel`` raises only where TensorFlow cannot be
    imported, naming it (``test_torch_savedmodel.py`` holds the SavedModel
    it writes to the JAX package's)."""
    out_dir = str(tmp_path / "cli")
    export.main([f"--model_path={exported['stage_dir']}", f"--output_dir={out_dir}",
                 "--batch_size=2", "--device=cpu"])
    assert "translate.pt2" in capsys.readouterr().out
    with torch.no_grad():
        got = export.load_torch(f"{out_dir}/translate.pt2")(torch.from_numpy(exported["x"]))
    np.testing.assert_array_equal(got.numpy(), exported["eager_fp"])
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        export.main([f"--model_path={exported['stage_dir']}", f"--output_dir={out_dir}",
                     "--format=savedmodel", "--device=cpu"])
