"""The port's classifier CLI against the JAX one, on the CPU.

The JAX CLI trains 2 steps of lenet on synthetic data, with
``--labels_offset=1`` (7 label columns, a 6-way head), and
``tools/orbax_to_torch_stage.py`` converts its train dir. On that dir the
port's ``eval`` (AUC, precision, recall within 1e-6), ``tags`` (with a tag
lookup and a tag-group file: ``tags.txt`` line for line) and ``gradcam``
(the overlays within 1e-4) modes must give the JAX CLI's results: both
draw the same synthetic batches from ``np.random.RandomState(seed)``.
``eval`` on tagged PNG records (``TFRecordSource``, the vocabulary's
labels with the offset column dropped) matches too. The port's ``train``
mode writes a train dir (config snapshot, checkpoint, metrics log) that
its own ``eval`` mode restores, and ``eval`` refuses a dir without a
checkpoint.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.runner import classifier_runner as jcli  # noqa: E402
from twingan_tpu.train import classifier_trainer as jct  # noqa: E402

from twingan_tpu_torch.runner import classifier_runner as cli  # noqa: E402
from twingan_tpu_torch.train import classifier_trainer as ct  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--use_synthetic_data", "--seed=5", "--num_eval_batches=2", "--batch_size=4"]
TRAIN = ["--model_name=lenet", "--train_image_size=28", "--num_classes=7",
         "--labels_offset=1", "--max_number_of_steps=2", "--log_every_n_steps=1",
         "--learning_rate=0.001"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch_stage", os.path.join(REPO, "tools", "orbax_to_torch_stage.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("classifier_cli")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jcli.main(["--mode=train", f"--train_dir={jax_dir}"] + TRAIN + COMMON)
    tool = _tool()
    assert tool.is_classifier_dir(jax_dir)
    assert tool.convert_classifier(jax_dir, port_dir) == [2]
    lookup = root / "tags.txt"
    lookup.write_text("".join(f"tag_{i}\n" for i in range(7)), encoding="utf-8")
    groups = root / "groups.tsv"
    groups.write_text("".join(f"{i}\tname\t{2 if i < 3 else 3}\n" for i in range(6)),
                      encoding="utf-8")
    return root, jax_dir, port_dir, str(lookup), str(groups)


def test_eval_matches_jax(dirs, monkeypatch):
    _, jax_dir, port_dir, _, _ = dirs
    seen = {}
    orig = jct.ClassifierTrainer.evaluate

    def spy(self, *a, **kw):
        seen["metrics"] = orig(self, *a, **kw)
        return seen["metrics"]

    monkeypatch.setattr(jct.ClassifierTrainer, "evaluate", spy)
    jcli.main(["--mode=eval", f"--train_dir={jax_dir}"] + COMMON)
    ours = cli.main(["--mode=eval", f"--train_dir={port_dir}", "--device=cpu"] + COMMON)
    assert set(ours["metrics"]) == set(seen["metrics"]) == {
        "auc", "precision_at_thres", "recall_at_thres"}
    for k, v in seen["metrics"].items():
        assert ours["metrics"][k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("grouped", [False, True])
def test_tags_match_jax(dirs, grouped):
    root, jax_dir, port_dir, lookup, groups = dirs
    extra = [f"--tags_id_lookup_file={lookup}", "--tag_threshold=0.3"]
    if grouped:
        extra.append(f"--tags_group_file={groups}")
    out = root / f"tags_{grouped}"
    jcli.main(["--mode=tags", f"--train_dir={jax_dir}", f"--output_dir={out}/jax"]
              + extra + COMMON)
    result = cli.main(["--mode=tags", f"--train_dir={port_dir}", f"--output_dir={out}/port",
                       "--device=cpu"] + extra + COMMON)
    ours = open(result["path"]).read().splitlines()
    theirs = open(out / "jax" / "tags.txt").read().splitlines()
    assert ours == theirs
    assert result["images"] == 8
    if not grouped:
        assert ours and all("tag_0" not in line for line in ours)  # the offset column


def test_gradcam_matches_jax(dirs, monkeypatch):
    root, jax_dir, port_dir, _, _ = dirs
    seen = {}
    import twingan_tpu.utils.image_io as jio

    monkeypatch.setattr(jio, "save_image_grid",
                        lambda path, images, *a, **kw: seen.setdefault("jax", np.asarray(images)))
    jcli.main(["--mode=gradcam", f"--train_dir={jax_dir}", "--gradcam_layer=conv2",
               f"--output_dir={root}/cam_jax"] + COMMON)
    result = cli.main(["--mode=gradcam", f"--train_dir={port_dir}", "--gradcam_layer=conv2",
                       f"--output_dir={root}/cam_port", "--device=cpu"] + COMMON)
    assert os.path.isfile(result["path"])
    np.testing.assert_allclose(result["overlays"], seen["jax"], atol=1e-4)


def test_eval_on_tagged_records_matches_jax(dirs, monkeypatch):
    """Real data: tagged PNG records (``convert_tagged_images``) read by
    ``TFRecordSource``, the danbooru eval preprocessing, the vocabulary's
    multi-hot labels with the offset's first column dropped."""
    from PIL import Image

    from twingan_tpu.data import converters as jconverters

    root, jax_dir, port_dir, lookup, _ = dirs
    images = root / "tagged"
    images.mkdir(exist_ok=True)
    rng = np.random.RandomState(2)
    lines = []
    for i in range(12):
        Image.fromarray(rng.randint(0, 256, (30, 26, 3)).astype(np.uint8)).save(
            str(images / f"{i}.png"))
        lines.append(f"{i}.png\t" + ",".join(f"tag_{j}" for j in range(7) if rng.rand() < 0.4))
    (root / "tagged.tsv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    records = str(root / "records")
    jconverters.convert_tagged_images(str(images), str(root / "tagged.tsv"), records,
                                      num_shards=2)
    seen = {}
    orig = jct.ClassifierTrainer.evaluate

    def spy(self, state, batches, *a, **kw):
        seen["labels"] = np.concatenate([np.asarray(b["labels"]) for b in batches])
        seen["metrics"] = orig(self, state, batches, *a, **kw)
        return seen["metrics"]

    monkeypatch.setattr(jct.ClassifierTrainer, "evaluate", spy)
    flags = [f"--dataset_dir={records}", f"--tags_id_lookup_file={lookup}",
             "--preprocessing_name=danbooru", "--seed=5", "--num_eval_batches=2"]
    jcli.main(["--mode=eval", f"--train_dir={jax_dir}"] + flags)
    ours = cli.main(["--mode=eval", f"--train_dir={port_dir}", "--device=cpu"] + flags)
    assert seen["labels"].shape == (8, 6) and seen["labels"].sum() > 0
    for k, v in seen["metrics"].items():
        assert ours["metrics"][k] == pytest.approx(v, abs=1e-6), k


def test_port_train_dir_restores(dirs):
    root, _, _, _, _ = dirs
    train_dir = str(root / "port_train")
    result = cli.main(["--mode=train", f"--train_dir={train_dir}", "--device=cpu"]
                      + TRAIN + COMMON)
    assert result["step"] == 2 and len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    with open(os.path.join(train_dir, "config.json")) as f:
        snapshot = json.load(f)
    assert snapshot["num_classes"] == 6 and snapshot["labels_offset"] == 1
    assert os.path.isfile(os.path.join(train_dir, "logs", "metrics.jsonl"))
    cfg = cli.load_config_snapshot(train_dir)
    trainer, state = cli.load_trained_classifier(train_dir, device="cpu")
    assert trainer.cfg == cfg and state.step == 2 and state.opt.count == 2
    saved = torch.load(os.path.join(train_dir, "ckpt-2", "state.pt"), weights_only=True)
    for k, v in ct.classifier_state_to_dict(state).items():
        assert torch.equal(v, saved[k]), k
    evaluated = cli.main(["--mode=eval", f"--train_dir={train_dir}", "--device=cpu"] + COMMON)
    assert all(np.isfinite(list(evaluated["metrics"].values())))
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        cli.main(["--mode=eval", f"--train_dir={root / 'empty'}", "--device=cpu"] + COMMON)


def test_parser_keeps_every_jax_flag():
    ours = [a.dest for a in cli.build_parser()._actions if a.dest != "help"]
    theirs = [a.dest for a in jcli.build_parser()._actions if a.dest != "help"]
    assert ours == theirs + ["device"]
    assert jax.devices()[0].platform == "cpu"
