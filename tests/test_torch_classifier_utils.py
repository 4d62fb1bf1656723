"""The classifiers' helpers against the JAX package's, on the CPU:
``utils/misc.py`` whole, every entry of the preprocessing factory (eval
mode, and training mode with the JAX function's own draws re-derived from
its key and handed to the port's deterministic part), the postprocessing
map, and Grad-CAM (``grad_cam`` and ``ClassifierTrainer.grad_cam_images``)
on cifarnet with bridged weights, the heatmaps within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_classifier_parity as parity  # noqa: E402
from test_torch_runner_data import B, jax_draws  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.data import preprocessing_factory as jpf  # noqa: E402
from twingan_tpu.models.grad_cam import grad_cam as jax_grad_cam  # noqa: E402
from twingan_tpu.train.classifier_trainer import ClassifierConfig as JaxConfig  # noqa: E402
from twingan_tpu.train.classifier_trainer import ClassifierState as JaxState  # noqa: E402
from twingan_tpu.train.classifier_trainer import ClassifierTrainer as JaxTrainer  # noqa: E402
from twingan_tpu.utils import misc as jmisc  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.data import preprocess as ppre  # noqa: E402
from twingan_tpu_torch.data import preprocessing_factory as pf  # noqa: E402
from twingan_tpu_torch.models.grad_cam import grad_cam, impose_mask_on_image  # noqa: E402
from twingan_tpu_torch.train.classifier_trainer import (  # noqa: E402
    ClassifierConfig,
    ClassifierTrainer,
)
from twingan_tpu_torch.utils import misc  # noqa: E402

ATOL = 1e-5
CAM_ATOL = 1e-5


def test_safe_one_hot_and_heatmap():
    labels = np.array([[0, 3, -1], [5, 2, 9]])
    np.testing.assert_array_equal(misc.safe_one_hot_encoding(torch.from_numpy(labels), 5),
                                  jmisc.safe_one_hot_encoding(jnp.asarray(labels), 5))
    gray = np.linspace(-0.2, 1.2, 24, dtype=np.float32).reshape(2, 3, 4, 1)
    for bgr in (False, True):
        np.testing.assert_allclose(misc.grayscale_to_heatmap(torch.from_numpy(gray), bgr),
                                   jmisc.grayscale_to_heatmap(jnp.asarray(gray), bgr),
                                   atol=1e-7)
        np.testing.assert_allclose(misc.grayscale_to_heatmap(torch.from_numpy(gray[..., 0]), bgr),
                                   jmisc.grayscale_to_heatmap(jnp.asarray(gray[..., 0]), bgr),
                                   atol=1e-7)


def test_random_patches_with_jax_draws():
    images = parity.images(3, 9)
    key = jax.random.PRNGKey(4)
    theirs = jmisc.get_random_patches(key, jnp.asarray(images), 4, 5)
    kb, ky, kx = jax.random.split(key, 3)
    origins = tuple(np.asarray(jax.random.randint(k, (5,), 0, hi))
                    for k, hi in ((kb, 3), (ky, 6), (kx, 6)))
    ours = misc.get_random_patches(torch.from_numpy(images), 4, 5, origins=origins)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    drawn = misc.get_random_patches(torch.from_numpy(images), 4, 7,
                                    generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (7, 4, 4, 3)


def test_dicts_tags_groups_and_boxes(tmp_path):
    nested = {"gen": {"output": 1, "code": 2}, "dis": {"logits": 3}}
    assert misc.combine_dicts(nested) == jmisc.combine_dicts(nested)
    path = tmp_path / "tags.tsv"
    path.write_text("0\tred_hair\t2\n\n1\tblue_eyes\t3\n4\tsmile\t7\n", encoding="utf-8")
    for cols in ((0, 2), (0, None), (None, 1)):
        assert misc.get_tags_dict(str(path), *cols) == jmisc.get_tags_dict(str(path), *cols)
    groups = {0: "2", 1: "2", 2: "3", 3: "3", 4: "7"}
    for labels in ([0.9, 0.3, 0.1, 0.8, 0.6], [0.9, 0.3, 0.1, 0.2, 0.6],
                   [0.1, 0.2, 0.7, 0.8, 0.9]):
        for thr in (0.25, 0.5):
            assert (misc.process_anime_face_labels(labels, thr, groups)
                    == jmisc.process_anime_face_labels(labels, thr, groups))
    boxes = [(0, 0, 4, 4), (2, 2, 6, 6), (1, 1, 3, 3), (5, 5, 5, 5)]
    for a in boxes:
        for b in boxes:
            assert misc.box_iou(a, b) == jmisc.box_iou(a, b)
            assert misc.box_contains(a, b) == jmisc.box_contains(a, b)
    for t in (-3, 0, 7, 40):
        assert misc.find_boundary(lambda v: v >= t, 0, 30) == jmisc.find_boundary(
            lambda v: v >= t, 0, 30)


def _torch_draws(j):
    """JAX draws as the factory's ``AugmentDraws`` (flip as [B] bool)."""
    return ppre.AugmentDraws(torch.as_tensor(np.asarray(j["ys"])),
                             torch.as_tensor(np.asarray(j["xs"])),
                             torch.as_tensor(np.asarray(j["flip"]).reshape(-1)),
                             j.get("ordering", 0), j.get("color", ()))


def _crop_flip_draws(key, b, span):
    k_crop, k_flip = key
    ky, kx = jax.random.split(k_crop)
    return {"ys": jax.random.randint(ky, (b,), 0, span),
            "xs": jax.random.randint(kx, (b,), 0, span),
            "flip": jax.random.uniform(k_flip, (b, 1, 1, 1)) < 0.5}


def inception_draws(key, b, hw, fast_mode):
    """The JAX ``inception`` training function's draws from ``key``."""
    k_crop, k_flip, k_sel, k_col = jax.random.split(key, 4)
    crop = max(1, int(hw * 0.8))
    draws = _crop_flip_draws((k_crop, k_flip), b, hw - crop + 1)
    ordering = int(jax.random.randint(k_sel, (), 0, 2 if fast_mode else 4))
    keys = jax.random.split(k_col, 4)
    ops = ppre.ORDERINGS[fast_mode][ordering]
    draws["ordering"] = ordering
    draws["color"] = tuple(torch.as_tensor(np.asarray(jax.random.uniform(
        keys[i], (b,), minval=ppre.COLOR_RANGES[op][0], maxval=ppre.COLOR_RANGES[op][1])))
        for i, op in enumerate(ops))
    return draws


PREPROCESSING_CASES = [
    ("inception", 24, dict()), ("inception", 24, dict(fast_mode=False)),
    ("vgg", 20, dict()), ("vgg", 20, dict(resize_side=26)),
    ("cifarnet", 16, dict()), ("cifarnet", 16, dict(padding=2)),
    ("lenet", 12, dict()), ("danbooru", 16, dict()),
    ("danbooru", 16, dict(do_random_cropping=True, fast_mode=False)),
]


@pytest.mark.parametrize("name,out_hw,kw", PREPROCESSING_CASES)
@pytest.mark.parametrize("training", [False, True])
def test_preprocessing_matches_jax(name, out_hw, kw, training):
    """Eval mode; training mode on the JAX draws. The inception case's
    random colour ordering is drawn from its key: seeds 0-3 cover both fast
    orderings."""
    hw = 30 if name != "danbooru" else 20
    x = (parity.images(B, hw) + 1.0) / 2.0
    for seed in range(4 if name == "inception" and training else 1):
        key = jax.random.PRNGKey(seed)
        theirs = np.asarray(jpf.get_preprocessing(name, out_hw, training, **kw)(
            key, jnp.asarray(x)))
        fn = pf.get_preprocessing(name, out_hw, training, **kw)
        draws = None
        if training and name == "inception":
            draws = _torch_draws(inception_draws(key, B, hw, kw.get("fast_mode", True)))
        elif training and name == "vgg":
            side = kw.get("resize_side") or int(out_hw * 1.145)
            draws = _torch_draws(_crop_flip_draws(jax.random.split(key), B, side - out_hw + 1))
        elif training and name == "cifarnet":
            span = hw + 2 * kw.get("padding", 4) - out_hw + 1
            draws = _torch_draws(_crop_flip_draws(jax.random.split(key), B, span))
        elif training and name == "danbooru":
            draws = jax_draws(key, fn.cfg, x.shape)
        ours = fn(torch.from_numpy(x), draws=draws) if training and name != "lenet" else fn(
            torch.from_numpy(x))
        np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL * max(1.0, np.abs(
            theirs).max()))
    if training and name != "lenet":
        drawn = fn(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
        assert drawn.shape == theirs.shape and torch.isfinite(drawn).all()


def test_postprocessing_matches_jax():
    x = parity.images(2, 6) * 200.0
    for name in ("danbooru", "inception", "vgg", "unknown"):
        np.testing.assert_allclose(pf.get_postprocessing(name)(torch.from_numpy(x)),
                                   jpf.get_postprocessing(name)(jnp.asarray(x)), atol=1e-6)
    with pytest.raises(ValueError, match="unknown preprocessing"):
        pf.get_preprocessing("nope", 8)


@pytest.fixture(scope="module")
def cifarnet_pair():
    return parity.build_pair("cifarnet", 32)


@pytest.mark.parametrize("layer,class_index", [("conv2", None), ("conv2", 3),
                                               ("conv2", np.array([1, 7, 0]))])
def test_grad_cam_matches_jax(cifarnet_pair, layer, class_index):
    jnet, variables, tnet = cifarnet_pair
    x = (parity.images(3, 32) + 1.0) / 2.0
    theirs = jax_grad_cam(lambda im, probes=None: jnet.apply(variables, im, probes=probes),
                          jnp.asarray(x), layer, class_index)
    ours = grad_cam(lambda im, probes=None: tnet(im, probes=probes), torch.from_numpy(x),
                    layer, class_index)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=CAM_ATOL)
    assert float(ours.max()) > 0.5
    with pytest.raises(ValueError, match="spatial"):
        grad_cam(lambda im, probes=None: tnet(im, probes=probes), torch.from_numpy(x),
                 "PreLogits")
    overlay = impose_mask_on_image(torch.from_numpy(x), ours, 0.3)
    from twingan_tpu.models.grad_cam import impose_mask_on_image as jax_impose

    np.testing.assert_allclose(overlay.numpy(), jax.vmap(lambda i, m: jax_impose(i, m, 0.3))(
        jnp.asarray(x), jnp.asarray(ours.numpy())), atol=1e-6)


def test_grad_cam_images_matches_jax(cifarnet_pair):
    jnet, variables, _ = cifarnet_pair
    jtrainer = JaxTrainer(JaxConfig(network="cifarnet", num_classes=parity.NUM_CLASSES,
                                    image_hw=32))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      model_state={}, opt_state=jtrainer.tx.init(variables["params"]))
    trainer = ClassifierTrainer(ClassifierConfig(network="cifarnet",
                                                 num_classes=parity.NUM_CLASSES, image_hw=32),
                                device="cpu")
    state = bridge.classifier_state_from_flax(trainer, jax.device_get(jstate))
    x = (parity.images(2, 32) + 1.0) / 2.0
    theirs = jtrainer.grad_cam_images(jstate, jnp.asarray(x), "conv2")
    ours = trainer.grad_cam_images(state, x, "conv2")
    np.testing.assert_allclose(ours, theirs, atol=CAM_ATOL)
