"""FID and the inception score with a trained classifier, the port's
against the JAX package's, on the CPU.

- The banked FID classifier ``artifacts/fid_classifier`` (cifarnet, 12
  labels, 32 px, a JAX Orbax train dir) converted by
  ``tools/orbax_to_torch_stage.py``: ``classifier_features_fn`` gives the
  JAX package's features within 1e-4 on 64 images at 32 px, and on 64 px
  images, which both resize to the classifier's 32 px (``jax.image.resize``
  antialiases when it shrinks; the port's resize is that formula).
- ``run_eval --mode=fid`` and ``--mode=inception_score`` with
  ``--classifier_path`` on the tiny TwinGAN stage of ``test_torch_evals.py``
  against the JAX CLI with the JAX train dir: FID within 1e-4 relative,
  the score within 1e-4; and the inception score of 40 distinct 16 px
  images (the tiny stage translates every image to about 0, which scores
  exactly 1.0 whatever the logits), which the classifier's logits take
  resized to 32 px: within 1e-4, its excess over 1 within 1e-3 relative.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_evals import (  # noqa: E402,F401
    assert_distinct_scores_agree,
    cli_args,
    eval_setup,
    read_score,
    score_the_sources,
)
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

from twingan_tpu.evals import metrics as jmetrics  # noqa: E402
from twingan_tpu.evals import run_eval as jrun_eval  # noqa: E402

from twingan_tpu_torch.evals import metrics, run_eval  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "fid_classifier")
FEATURES_ATOL = 1e-4
FID_RTOL = 1e-4
IS_ATOL = 1e-4


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch_stage", os.path.join(REPO, "tools", "orbax_to_torch_stage.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path_factory.mktemp("fid_classifier") / "port")
    assert tool.convert_classifier(ARTIFACT, out) == [1500]
    return out


@pytest.mark.parametrize("n,hw", [(64, 32), (16, 64)])
def test_banked_classifier_features_match_jax(converted, n, hw):
    images = np.random.RandomState(hw).rand(n, hw, hw, 3).astype(np.float32)
    theirs = np.asarray(jmetrics.classifier_features_fn(ARTIFACT)(jnp.asarray(images)))
    ours = metrics.classifier_features_fn(converted, device="cpu")(
        torch.from_numpy(images)).numpy()
    assert ours.shape == theirs.shape == (n, 192)
    assert np.abs(ours - theirs).max() <= FEATURES_ATOL


@pytest.mark.parametrize("mode,name", [("fid", "fid.txt"),
                                       ("inception_score", "inception_score.txt")])
def test_run_eval_with_a_classifier_matches_jax(eval_setup, converted, tmp_path, mode, name):
    root, jax_stage, port_stage = eval_setup
    jrun_eval.main(cli_args(root, mode, jax_stage, tmp_path / "jax")
                   + [f"--classifier_path={ARTIFACT}"])
    result = run_eval.main(cli_args(root, mode, port_stage, tmp_path / "port")
                           + [f"--classifier_path={converted}", "--device=cpu"])
    ours, theirs = read_score(tmp_path / "port" / name), read_score(tmp_path / "jax" / name)
    assert result["images"] == 8
    if mode == "fid":
        assert result["kind"] == "trained-classifier features"
        assert abs(ours[0] - theirs[0]) <= FID_RTOL * abs(theirs[0])
    else:
        assert abs(ours[0] - theirs[0]) <= IS_ATOL and abs(ours[1] - theirs[1]) <= IS_ATOL


def test_inception_score_with_a_classifier_on_distinct_images(eval_setup, converted, tmp_path,
                                                              monkeypatch):
    root, jax_stage, port_stage = eval_setup
    distinct, seen = score_the_sources(monkeypatch)
    jrun_eval.main(cli_args(root, "inception_score", jax_stage, tmp_path / "jax")
                   + distinct + [f"--classifier_path={ARTIFACT}"])
    result = run_eval.main(cli_args(root, "inception_score", port_stage, tmp_path / "port")
                           + distinct + [f"--classifier_path={converted}", "--device=cpu"])
    assert_distinct_scores_agree(result, seen["score"])
