"""The port's evaluation metrics and its ``run_eval`` CLI against the JAX
package's, on the CPU.

- ``laplacian_pyramid`` within 1e-6;
- both SWD paths (one-shot and chunked), with the JAX package's own draws
  re-derived from its key and injected (``JaxDraws``), within 1e-4
  relative: the sorts and the std reductions run in another order;
- SSIM and MS-SSIM within 1e-5;
- ``swd_eval``'s table and file text, ``msssim_eval``, ``pairwise_msssim``,
  ``frechet_distance`` (1e-6), ``activation_statistics``, ``fid`` and
  ``inception_score`` over a given features or logits function;
- ``run_eval`` modes ``loss``, ``swd``, ``msssim`` and ``output`` on a tiny
  stage dir written by the JAX package and converted with
  ``tools/orbax_to_torch_stage.py``, against the JAX CLI on the same data
  (``loss`` on synthetic batches: the JAX CLI's loss mode hands a real
  dataset's filename strings to ``jnp.asarray``, which raises);
  ``eval_debug`` writes its gallery;
- ``inception_pool_features_fn`` on the JAX package's InceptionV3 weights
  bridged (within 1e-5 of the largest feature), and its own draws; the
  ``fid`` and ``inception_score`` modes without a classifier against the
  JAX CLI with those weights and the JAX random head injected (FID within
  1e-4 relative, the score within 1e-4). The JAX InceptionV3's ``init``
  returns weights drawn by ``jax.random`` in one call (see
  ``tests/torch_classifier_parity.py``): its own per-leaf init compiles
  for half a minute. ``test_torch_evals_fid.py`` has the modes with
  ``--classifier_path``.
"""

import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

from twingan_tpu.data import converters as jconverters  # noqa: E402
from twingan_tpu.evals import metrics as jmetrics  # noqa: E402
from twingan_tpu.evals import run_eval as jrun_eval  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.runner.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from twingan_tpu.runner.checkpoint import save_config_snapshot  # noqa: E402
from twingan_tpu.runner.stage_runner import RunConfig as JaxRunConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch.evals import metrics, run_eval  # noqa: E402
from twingan_tpu_torch.ops import msssim, swd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSWD = __import__("twingan_tpu.ops.swd", fromlist=["swd"])
JMSSSIM = __import__("twingan_tpu.ops.msssim", fromlist=["msssim"])
SWD_RTOL = 1e-4


class JaxDraws(swd.SWDDraws):
    """The JAX package's draws for ``key``: each tag of ``ops/swd.py`` maps
    to the key the JAX function derives for the same draw."""

    def __init__(self, key, repeats: int = 4):
        self.key, self.repeats = key, repeats

    def _key(self, tag):
        kind = tag[0]
        if kind in ("patch", "dirs"):
            level_keys = jax.random.split(jax.random.fold_in(self.key, tag[1]), 4)
            if kind == "patch":
                return level_keys[0 if tag[2] == "real" else 1]
            base = level_keys[2 if tag[2] == "rr" else 3]
            return jax.random.split(base, self.repeats)[tag[3]]
        if kind == "chunk_patch":
            _, set_i, lo, li = tag
            return jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                self.key, set_i), lo), li)
        _, li, which, rep = tag  # chunk_dirs
        pair = jax.random.split(jax.random.fold_in(jax.random.fold_in(self.key, 1000 + li), rep))
        return pair[0 if which == "rr" else 1]

    def positions(self, tag, b, h, w, p):
        ky, kx = jax.random.split(self._key(tag))
        ys = jax.random.randint(ky, (b, p), 0, h - swd.PATCH_SIZE + 1)
        xs = jax.random.randint(kx, (b, p), 0, w - swd.PATCH_SIZE + 1)
        return torch.from_numpy(np.asarray(ys)).long(), torch.from_numpy(np.asarray(xs)).long()

    def directions(self, tag, dim, proj):
        return torch.from_numpy(np.asarray(jax.random.normal(self._key(tag), (dim, proj),
                                                             jnp.float32)))


def image_sets(n=8, hw=32, seed=0):
    rng = np.random.RandomState(seed)
    real = rng.rand(n, hw, hw, 3).astype(np.float32)
    fake = np.clip(real[::-1] * 0.7 + 0.3 * rng.rand(n, hw, hw, 3), 0, 1).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("hw,min_res", [(32, 16), (64, 16), (20, 8)])
def test_laplacian_pyramid(hw, min_res):
    real, _ = image_sets(3, hw)
    ours = swd.laplacian_pyramid(torch.from_numpy(real), min_res)
    theirs = JSWD.laplacian_pyramid(jnp.asarray(real), min_res)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw,seed", [(32, 0), (64, 3)])
def test_swd_with_jax_draws(hw, seed):
    real, fake = image_sets(8, hw, seed)
    key = jax.random.PRNGKey(seed)
    theirs = np.asarray(JSWD.sliced_wasserstein_distance(key, jnp.asarray(real),
                                                         jnp.asarray(fake)))
    ours = swd.sliced_wasserstein_distance(torch.from_numpy(real), torch.from_numpy(fake),
                                           draws=JaxDraws(key)).numpy()
    assert ours.shape == theirs.shape == (int(np.log2(hw // 16)) + 1, 2)
    np.testing.assert_allclose(ours, theirs, rtol=SWD_RTOL, atol=0)


def test_swd_chunked_with_jax_draws():
    real, fake = image_sets(10, 32, 5)
    key = jax.random.PRNGKey(11)
    theirs = JSWD.sliced_wasserstein_distance_chunked(key, real, fake, chunk=4)
    ours = swd.sliced_wasserstein_distance_chunked(real, fake, chunk=4, draws=JaxDraws(key),
                                                   device="cpu")
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (2, 2)
    np.testing.assert_allclose(ours, theirs, rtol=SWD_RTOL, atol=0)


def test_swd_default_draws_are_seeded_and_device_free():
    real, fake = image_sets(4, 16, 1)
    a = swd.sliced_wasserstein_distance(torch.from_numpy(real), torch.from_numpy(fake), seed=3)
    b = swd.sliced_wasserstein_distance(torch.from_numpy(real), torch.from_numpy(fake), seed=3)
    c = swd.sliced_wasserstein_distance(torch.from_numpy(real), torch.from_numpy(fake), seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ys, xs = swd.SWDDraws(3).positions(("patch", 0, "real"), 2, 16, 16, 5)
    assert ys.device.type == "cpu" and int(ys.max()) <= 9 and int(xs.min()) >= 0


@pytest.mark.parametrize("hw,max_val", [(64, 1.0), (32, 255.0), (9, 1.0)])
def test_ssim_and_msssim(hw, max_val):
    real, fake = image_sets(4, hw, 2)
    real, fake = real * max_val, fake * max_val
    s, cs = msssim.ssim(torch.from_numpy(real), torch.from_numpy(fake), max_val=max_val)
    js, jcs = JMSSSIM.ssim(jnp.asarray(real), jnp.asarray(fake), max_val=max_val)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), atol=1e-5, rtol=0)
    levels = 5 if hw >= 32 else 2
    ours = float(msssim.msssim(torch.from_numpy(real), torch.from_numpy(fake), max_val=max_val,
                               levels=levels))
    theirs = float(JMSSSIM.msssim(jnp.asarray(real), jnp.asarray(fake), max_val=max_val,
                                  levels=levels))
    assert abs(ours - theirs) <= 1e-5
    same = float(msssim.msssim(torch.from_numpy(real), torch.from_numpy(real), max_val=max_val,
                               levels=levels))
    assert abs(same - 1.0) <= 1e-5


def read_swd_file(path):
    lines = open(path).read().splitlines()
    rows = [line.split("\t") for line in lines[2:]]
    return lines[:2], [r[0] for r in rows], np.array([[float(x) for x in r[1:]] for r in rows])


@pytest.mark.parametrize("n,hw", [(8, 32), (6, 8)])
def test_swd_eval_table_and_file(tmp_path, n, hw):
    real, fake = image_sets(n, hw, 4)
    batches = lambda x: [x[i: i + 3] for i in range(0, len(x), 3)]  # noqa: E731
    key = jax.random.PRNGKey(7)
    theirs = jmetrics.swd_eval(key, batches(real), batches(fake), num_images=n,
                               save_path=str(tmp_path / "jax.txt"))
    ours = metrics.swd_eval(7, batches(real), batches(fake), num_images=n,
                            save_path=str(tmp_path / "port.txt"), device="cpu",
                            draws=JaxDraws(key))
    if hw < 16:
        assert ours is None and theirs is None
        return
    assert list(ours) == list(theirs)
    np.testing.assert_allclose(np.array(list(ours.values())), np.array(list(theirs.values())),
                               rtol=SWD_RTOL)
    head, res, vals = read_swd_file(str(tmp_path / "port.txt"))
    jhead, jres, jvals = read_swd_file(str(tmp_path / "jax.txt"))
    assert head == jhead and res == jres == ["32", "16", "Average"]
    np.testing.assert_allclose(vals, jvals, rtol=SWD_RTOL, atol=1e-6)


def test_swd_eval_takes_the_chunked_path_over_its_threshold(monkeypatch):
    real, fake = image_sets(8, 16, 6)
    monkeypatch.setattr(metrics, "SWD_CHUNKED_BYTES", real.nbytes - 1)
    seen = {}
    orig = metrics.sliced_wasserstein_distance_chunked

    def spy(*a, **kw):
        seen["chunked"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(metrics, "sliced_wasserstein_distance_chunked", spy)
    key = jax.random.PRNGKey(2)
    ours = metrics.swd_eval(2, [real], [fake], num_images=8, device="cpu", draws=JaxDraws(key))
    assert seen["chunked"]
    theirs = JSWD.sliced_wasserstein_distance_chunked(key, real, fake) * 1e3
    np.testing.assert_allclose(np.array(list(ours.values())), theirs, rtol=SWD_RTOL)


def test_msssim_evals_match():
    real, fake = image_sets(7, 32, 8)
    batches = [real[:3], real[3:], fake[:1]]
    assert abs(metrics.msssim_eval(batches, device="cpu") - jmetrics.msssim_eval(batches)) <= 1e-5
    assert abs(metrics.msssim_eval(batches, num_images=2, device="cpu")
               - jmetrics.msssim_eval(batches, num_images=2)) <= 1e-5
    assert np.isnan(metrics.msssim_eval([fake[:1]], device="cpu"))
    assert abs(metrics.pairwise_msssim(real, fake, device="cpu")
               - jmetrics.pairwise_msssim(real, fake)) <= 1e-5


def test_frechet_distance_and_fid():
    rng = np.random.RandomState(9)
    a, b = rng.randn(50, 6), rng.randn(40, 6) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    assert abs(metrics.frechet_distance(*args) - jmetrics.frechet_distance(*args)) <= 1e-6
    w = rng.randn(12, 5).astype(np.float32)
    real, fake = image_sets(6, 2, 3)
    flat = lambda x: np.asarray(x).reshape(len(x), -1) @ w  # noqa: E731
    ours = metrics.fid(lambda x: torch.from_numpy(flat(x.numpy())), [real[:3], real[3:]],
                       [fake], device="cpu")
    theirs = jmetrics.fid(flat, [real[:3], real[3:]], [fake])
    assert abs(ours - theirs) <= 1e-4 * max(1.0, abs(theirs))
    mu, sig = metrics.activation_statistics(lambda x: x.reshape(len(x), -1), [real], "cpu")
    jmu, jsig = jmetrics.activation_statistics(lambda x: x.reshape(len(x), -1), [real])
    np.testing.assert_allclose(mu, jmu, atol=1e-6)
    np.testing.assert_allclose(sig, jsig, atol=1e-6)
    logits = lambda x: np.asarray(x).reshape(len(x), -1)[:, :7] * 4.0  # noqa: E731
    imgs = [rng.rand(5, 2, 2, 3).astype(np.float32) for _ in range(4)]
    ours = metrics.inception_score(lambda x: logits(x.numpy()), imgs, splits=3, device="cpu")
    theirs = jmetrics.inception_score(logits, imgs, splits=3)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


FEATURES_RTOL = 1e-5
FID_RTOL = 1e-4
IS_ATOL = 1e-4
IS_DISTINCT_MIN = 1e-3
IS_EXCESS_RTOL = 1e-3


@pytest.fixture(scope="module")
def inception_weights():
    """JAX-drawn InceptionV3 (1 class, 75 px) variables and their bridge."""
    import torch_classifier_parity as parity

    from twingan_tpu.models.inception import InceptionV3
    from twingan_tpu_torch import bridge

    variables = parity.jax_variables(InceptionV3(num_classes=1), 75)
    return variables, bridge.classifier_state_dict_from_flax(variables["params"],
                                                              variables["batch_stats"])


def test_classifier_features_wait_for_a14(inception_weights, monkeypatch):
    """The FID feature function that waited for the classifier zoo (A14):
    the JAX function and the port's on the same weights, then the port's
    own draws (fixed by the seed, other for another seed, not collapsed)."""
    from twingan_tpu.models.inception import InceptionV3

    variables, weights = inception_weights
    monkeypatch.setattr(InceptionV3, "init", lambda self, *a, **kw: variables)
    real, _ = image_sets(6, 16)
    theirs = np.asarray(jmetrics.inception_pool_features_fn(image_hw=16, seed=0)(
        jnp.asarray(real)))
    ours = metrics.inception_pool_features_fn(16, 0, weights=weights, device="cpu")(
        torch.from_numpy(real)).numpy()
    assert ours.shape == theirs.shape == (6, 256)
    assert np.abs(ours - theirs).max() <= FEATURES_RTOL * np.abs(theirs).max()
    own = [metrics.inception_pool_features_fn(16, s, device="cpu")(torch.from_numpy(real))
           for s in (0, 0, 1)]
    assert torch.equal(own[0], own[1]) and not torch.allclose(own[0], own[2])
    assert float(own[0].std(dim=0).mean()) > 1e-6


def test_streaming_loss_eval_skips_strings():
    batches = [{"x": np.full(2, float(i)), "name": np.asarray([b"a", b"b"])} for i in range(4)]
    seen = []

    def loss_fn(batch):
        seen.append(set(batch))
        return {"mean": batch["x"].mean()}

    assert metrics.streaming_loss_eval(loss_fn, batches, num_batches=3) == {"mean": 1.0}
    assert seen == [{"x"}] * 3


# ---------------------------------------------------------------------- #
# run_eval against the JAX CLI

EVAL_HW = 16


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """A 16 px TwinGAN stage written by the JAX package (fresh weights, a
    Polyak average), its conversion, and tfrecord shards of two domains."""
    root = tmp_path_factory.mktemp("run_eval")
    cfg = JaxTwinGANConfig(model=JaxPGGANConfig(resolution=EVAL_HW, max_channels=8,
                                                num_domains=2),
                           batch_size=4, use_unet=True, moving_average_decay=0.9)
    trainer = JaxTwinGANTrainer(cfg)
    state = trainer.init_state(jax.random.PRNGKey(3))
    jax_stage = str(root / "jax" / str(EVAL_HW))
    JaxCheckpointManager(jax_stage).save(5, state.replace(step=5))
    save_config_snapshot(jax_stage, {"run": JaxRunConfig(num_devices=1, start_hw=EVAL_HW,
                                                         max_hw=EVAL_HW), "trainer": cfg})
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch_stage", os.path.join(REPO, "tools", "orbax_to_torch_stage.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    port_stage = str(root / "port" / str(EVAL_HW))
    tool.convert_stage(jax_stage, port_stage)
    rng = np.random.RandomState(0)
    for dom in ("a", "b"):
        imgs = root / f"imgs_{dom}"
        imgs.mkdir()
        for i in range(10):
            h, w = (24, 24) if i % 2 else (30, 20)
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
                str(imgs / f"{i}.png"))
        jconverters.convert_image_folder(str(imgs), str(root / f"rec_{dom}"), num_shards=2)
    return root, jax_stage, port_stage


def cli_args(root, mode, stage, out, synthetic=False):
    args = [f"--mode={mode}", f"--model_path={stage}", f"--eval_dir={out}", "--batch_size=4",
            "--num_images=8", "--swd_num_images=8", "--seed=3"]
    if synthetic:
        return args + ["--use_synthetic_data"]
    return args + [f"--dataset_dir={root / 'rec_a'}", f"--target_dataset_dir={root / 'rec_b'}"]


def test_run_eval_loss_matches_jax(eval_setup, tmp_path):
    root, jax_stage, port_stage = eval_setup
    jrun_eval.main(cli_args(root, "loss", jax_stage, tmp_path / "jax", synthetic=True))
    result = run_eval.main(cli_args(root, "loss", port_stage, tmp_path / "port", synthetic=True)
                           + ["--device=cpu"])

    def read(path):
        return {k: float(v) for k, v in (line.split("\t") for line in open(path))}

    ours, theirs = read(tmp_path / "port" / "eval_losses.txt"), read(
        tmp_path / "jax" / "eval_losses.txt")
    assert set(ours) == set(theirs) and "generator_loss" in ours
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-4 * max(1.0, abs(theirs[k])), k
    assert set(result["losses"]) == set(ours)


def test_run_eval_swd_matches_jax(eval_setup, tmp_path, monkeypatch):
    root, jax_stage, port_stage = eval_setup
    monkeypatch.setattr(metrics, "SWDDraws", lambda seed: JaxDraws(jax.random.PRNGKey(seed)))
    jrun_eval.main(cli_args(root, "swd", jax_stage, tmp_path / "jax"))
    result = run_eval.main(cli_args(root, "swd", port_stage, tmp_path / "port")
                           + ["--device=cpu"])
    name = "swd_eval_step_0_8_images.txt"
    head, res, vals = read_swd_file(tmp_path / "port" / name)
    jhead, jres, jvals = read_swd_file(tmp_path / "jax" / name)
    assert head == jhead and res == jres == ["16", "Average"]
    np.testing.assert_allclose(vals, jvals, rtol=SWD_RTOL, atol=1e-5)
    assert list(result["table"]) == [EVAL_HW]


def test_run_eval_msssim_matches_jax(eval_setup, tmp_path, monkeypatch):
    root, jax_stage, port_stage = eval_setup
    seen = {}
    for name in ("msssim_eval", "pairwise_msssim"):
        orig = getattr(jrun_eval, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen[_name] = _orig(*a, **kw)
            return seen[_name]

        monkeypatch.setattr(jrun_eval, name, spy)
    jrun_eval.main(cli_args(root, "msssim", jax_stage, tmp_path / "jax"))
    result = run_eval.main(cli_args(root, "msssim", port_stage, tmp_path / "port")
                           + ["--device=cpu"])
    assert result["images"] == 8
    assert abs(result["fidelity"] - seen["pairwise_msssim"]) <= 1e-5
    assert abs(result["diversity"] - seen["msssim_eval"]) <= 1e-5


def test_run_eval_output_matches_jax(eval_setup, tmp_path):
    root, jax_stage, port_stage = eval_setup
    jrun_eval.main(cli_args(root, "output", jax_stage, tmp_path / "jax"))
    result = run_eval.main(cli_args(root, "output", port_stage, tmp_path / "port")
                           + ["--device=cpu"])

    def read(path):
        rows = list(csv.reader(open(path)))
        return [r[0] for r in rows], np.array([[float(x) for x in r[1:]] for r in rows])

    names, vals = read(tmp_path / "port" / "embeddings.csv")
    jnames, jvals = read(tmp_path / "jax" / "embeddings.csv")
    assert names == jnames and len(names) == result["images"] == 8
    np.testing.assert_allclose(vals, jvals, atol=1e-5, rtol=1e-4)


def read_score(path):
    return [float(v) for v in open(path).read().split("\t")[1:-1] if " " not in v]


IS_IMAGES = 40


def score_the_sources(monkeypatch):
    """Both CLIs' translations replaced by their sources. The tiny stage
    translates every image to about 0 (1e-7), and a set of one image scores
    exactly 1.0 whatever its logits: the scoring itself is held on
    ``IS_IMAGES`` distinct synthetic images (4 a split), which the two CLIs
    draw alike. Returns the flags, and the dict where the JAX CLI's score
    lands unrounded (its file has 6 decimals)."""
    from twingan_tpu_torch.infer.translate import ImageInferer

    monkeypatch.setattr(JaxTwinGANTrainer, "translate",
                        lambda self, state, images, *a, **kw: images)
    monkeypatch.setattr(ImageInferer, "translate", lambda self, x, *a, **kw: x)
    seen, orig = {}, jmetrics.inception_score

    def spy(*a, **kw):
        seen["score"] = orig(*a, **kw)
        return seen["score"]

    monkeypatch.setattr(jmetrics, "inception_score", spy)
    return ["--use_synthetic_data", f"--num_images={IS_IMAGES}"], seen


def assert_distinct_scores_agree(result, theirs):
    """The port's (score, std) against the JAX CLI's, on distinct images:
    within IS_ATOL, and the score's excess over 1 within IS_EXCESS_RTOL of
    the JAX one's, which is itself over IS_DISTINCT_MIN."""
    excess = theirs[0] - 1.0
    assert result["images"] == IS_IMAGES and excess > IS_DISTINCT_MIN
    assert abs(result["inception_score"] - theirs[0]) <= min(IS_ATOL, IS_EXCESS_RTOL * excess)
    assert abs(result["inception_score_std"] - theirs[1]) <= IS_ATOL


def test_run_eval_gallery_and_the_modes_that_wait(eval_setup, inception_weights, tmp_path,
                                                 monkeypatch):
    """``eval_debug``'s gallery, and the two modes that waited for the
    classifier zoo (A14), ``fid`` and ``inception_score`` without a
    classifier, against the JAX CLI on the same InceptionV3 weights and IS
    head; then the port's own draws: a score that has not collapsed to 1."""
    from twingan_tpu.models.inception import InceptionV3

    root, jax_stage, port_stage = eval_setup
    result = run_eval.main(cli_args(root, "eval_debug", port_stage, tmp_path) + ["--device=cpu"])
    assert os.path.exists(result["path"])
    assert len([n for n in os.listdir(os.path.dirname(result["path"]))
                if n.endswith(".jpg")]) == 12
    variables, weights = inception_weights
    monkeypatch.setattr(InceptionV3, "init", lambda self, *a, **kw: variables)
    head = np.asarray(jax.random.normal(jax.random.PRNGKey(3 + 1), (256, 1000))) / np.sqrt(
        np.float32(256))
    for mode, name in (("fid", "fid.txt"), ("inception_score", "inception_score.txt")):
        jrun_eval.main(cli_args(root, mode, jax_stage, tmp_path / "jax"))
        result = run_eval.main(cli_args(root, mode, port_stage, tmp_path / "port")
                               + ["--device=cpu"], inception_weights=weights,
                               is_head=torch.from_numpy(head))
        ours, theirs = read_score(tmp_path / "port" / name), read_score(tmp_path / "jax" / name)
        assert result["images"] == 8 and len(ours) == len(theirs) == (1 if mode == "fid" else 2)
        if mode == "fid":
            assert abs(result["fid"] - theirs[0]) <= FID_RTOL * abs(theirs[0])
            assert "given weights" in result["kind"]
        else:
            assert abs(result["inception_score"] - theirs[0]) <= IS_ATOL
            assert abs(result["inception_score_std"] - theirs[1]) <= IS_ATOL
    own = run_eval.main(cli_args(root, "fid", port_stage, tmp_path / "own") + ["--device=cpu"])
    assert np.isfinite(own["fid"]) and "own draws from seed 3" in own["kind"]
    # The scores above are 1.0 in both packages (see score_the_sources):
    # the random head's logits of distinct images, then the port's own
    # weights and head, neither collapsed to 1.
    distinct, seen = score_the_sources(monkeypatch)
    jrun_eval.main(cli_args(root, "inception_score", jax_stage, tmp_path / "jax_d") + distinct)
    result = run_eval.main(cli_args(root, "inception_score", port_stage, tmp_path / "port_d")
                           + distinct + ["--device=cpu"], inception_weights=weights,
                           is_head=torch.from_numpy(head))
    assert_distinct_scores_agree(result, seen["score"])
    own = run_eval.main(cli_args(root, "inception_score", port_stage, tmp_path / "own_d")
                        + distinct + ["--device=cpu"])
    assert own["inception_score"] > 1.0 + IS_DISTINCT_MIN
    assert [a.dest for a in run_eval.build_parser()._actions if a.dest != "help"][:-1] == [
        "mode", "model_path", "classifier_path", "eval_dir", "dataset_name", "dataset_dir",
        "target_dataset_name", "target_dataset_dir", "dataset_split_name",
        "use_synthetic_data", "resize_mode", "batch_size", "num_images", "swd_num_images",
        "swd_save_images", "output_single_file_name", "seed"]
