"""``ClassifierTrainer`` against the JAX package's, on the CPU.

- One ``train_step`` from the same bridged state, in float64 on both sides
  (the JAX step under ``jax.enable_x64``): cifarnet (its local response
  norms) with rmsprop, and resnet_v2_50 at 64 px (batch norm in train mode)
  with adam, both at the CLI's weight decay of 4e-5. The loss within
  ``LOSS_RTOL`` (measured 2e-14); the moving statistics and the optimizer
  state (counts and slots at optax's paths) each within ``LEAF_RTOL`` of
  its own largest magnitude (measured 2.7e-12); every updated parameter,
  and rmsprop's trace (which is the update), within ``UPDATE_RTOL`` of the
  update's largest magnitude (measured 3.2e-7, resnet_v2_50: the first
  adam update is lr * g / (|g| + eps), which turns the rounding of a
  gradient near eps into a share of the update). In fp32 the same step
  differs by whole updates (2 lr) where a near-zero gradient's rounding
  flips its sign, so fp32 would test the summation order.
- ``evaluate`` (AUC with ties, precision and recall, the PR-curve file),
  ``predict``, ``embed`` and ``write_tags`` with a tag-group file, fp32;
  the losses with label smoothing, sigmoid and softmax.
- The whole state bridged to the JAX layout and back is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.serialization  # noqa: E402
import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.train import classifier_trainer as jct  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.train import classifier_trainer as ct  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig, build_optimizer  # noqa: E402

LOSS_RTOL = 1e-12
LEAF_RTOL = 1e-10
UPDATE_RTOL = 1e-6
NUM_CLASSES = 12


def jax_state(jtrainer, network, hw, dtype=jnp.float32):
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                       parity.jax_variables(jtrainer.model, hw))
    params = variables["params"]
    model_state = {"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else {}
    return jct.ClassifierState(step=jnp.zeros((), jnp.int32), params=params,
                               model_state=model_state, opt_state=jtrainer.tx.init(params))


def configs(network, hw, optimizer, lr, batch, label_smoothing=0.1):
    kw = dict(network=network, num_classes=NUM_CLASSES, image_hw=hw, batch_size=batch,
              label_smoothing=label_smoothing)
    jopt = JaxOptimizerConfig(optimizer=optimizer, learning_rate=lr, weight_decay=4e-5)
    opt = OptimizerConfig(optimizer=optimizer, learning_rate=lr, weight_decay=4e-5)
    return jct.ClassifierConfig(**kw, opt=jopt), ct.ClassifierConfig(**kw, opt=opt)


def flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("network,hw,optimizer,lr,batch", [
    ("cifarnet", 32, "rmsprop", 0.01, 4),
    ("resnet_v2_50", 64, "adam", 0.003, 4),
])
def test_train_step_matches_jax(network, hw, optimizer, lr, batch):
    # No label smoothing here: both losses smooth the labels in fp32, which
    # float64 would see (test_softmax_loss_and_label_smoothing checks it).
    jcfg, cfg = configs(network, hw, optimizer, lr, batch, label_smoothing=0.0)
    jtrainer = jct.ClassifierTrainer(jcfg)
    trainer = ct.ClassifierTrainer(cfg, device="cpu")
    rng = np.random.RandomState(0)
    batch_np = {"image": rng.rand(batch, hw, hw, 3), "labels": rng.rand(batch, NUM_CLASSES) > 0.7}
    with jax.enable_x64(True):
        jstate0 = jax.device_get(jax_state(jtrainer, network, hw, jnp.float64))
        jnew, jm = jtrainer.train_step(jax.tree_util.tree_map(jnp.asarray, jstate0),
                                       {k: jnp.asarray(v, jnp.float64)
                                        for k, v in batch_np.items()})
        theirs = flat(flax.serialization.to_state_dict(jax.device_get(jnew)))
        jloss = float(jm["loss"])
    fresh = trainer.init_state(0)
    fresh.net.double()
    fresh.opt = build_optimizer(cfg.opt, dict(fresh.net.named_parameters()))
    state = ct.classifier_state_from_dict(
        fresh, bridge.classifier_torch_flat(bridge.flat_from_flax(jstate0)))
    before = flat(flax.serialization.to_state_dict(jstate0))
    state, m = trainer.train_step(state, {k: v.astype(np.float64) for k, v in batch_np.items()})
    ours = flat(bridge.flax_classifier_state_dict(state))
    assert set(ours) == set(theirs)
    assert abs(float(m["loss"]) - jloss) <= LOSS_RTOL * abs(jloss)
    assert state.step == int(jnew.step) == 1
    for k, v in theirs.items():
        assert np.shape(ours[k]) == np.shape(v), (k, np.shape(ours[k]), np.shape(v))
        if k.startswith("params/") or "/trace/" in k:
            err = np.abs(ours[k] - v).max() / max(np.abs(v - before[k]).max(), 1e-30)
            assert err <= UPDATE_RTOL, (k, err)
        else:
            err = parity.rel_err(ours[k], v) if np.abs(v).max() > 0 else np.abs(ours[k]).max()
            assert err <= LEAF_RTOL, (k, err)
    assert any(k.startswith("model_state/") for k in ours) == network.startswith("resnet")


@pytest.fixture(scope="module")
def cifarnet_states():
    jcfg, cfg = configs("cifarnet", 32, "rmsprop", 0.01, 4)
    jtrainer = jct.ClassifierTrainer(jcfg)
    jstate = jax.device_get(jax_state(jtrainer, "cifarnet", 32))
    trainer = ct.ClassifierTrainer(cfg, device="cpu")
    return jtrainer, jstate, trainer, bridge.classifier_state_from_flax(trainer, jstate)


def test_state_round_trips_through_the_jax_layout(cifarnet_states):
    _, jstate, trainer, state = cifarnet_states
    tree = bridge.flax_classifier_state_dict(state)
    theirs = flat(flax.serialization.to_state_dict(jstate))
    ours = flat(tree)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v)
    again = bridge.classifier_state_from_flax(trainer, tree)
    for k, v in ct.classifier_state_to_dict(again).items():
        assert torch.equal(v, ct.classifier_state_to_dict(state)[k]), k


def test_evaluate_predict_embed_and_tags(cifarnet_states, tmp_path):
    jtrainer, jstate, trainer, state = cifarnet_states
    rng = np.random.RandomState(3)
    batches = [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
                "labels": (rng.rand(4, NUM_CLASSES) > 0.6).astype(np.float32)}
               for _ in range(3)]
    ours = trainer.evaluate(state, batches, pr_curve_path=str(tmp_path / "p" / "pr.txt"))
    theirs = jtrainer.evaluate(jstate, batches, pr_curve_path=str(tmp_path / "j" / "pr.txt"))
    for k in theirs:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-6), k
    assert (tmp_path / "p" / "pr.txt").read_text() == (tmp_path / "j" / "pr.txt").read_text()
    scores = np.array([0.1, 0.4, 0.4, 0.8, 0.8, 0.3])
    labels = np.array([0, 1, 0, 1, 0, 1])
    assert ct._auc(scores, labels) == jct._auc(scores, labels)
    assert ct._auc(scores, np.zeros(6)) == 0.5
    images = batches[0]["image"]
    np.testing.assert_allclose(trainer.predict(state, images).numpy(),
                               jtrainer.predict(jstate, jnp.asarray(images)), atol=1e-6)
    np.testing.assert_allclose(trainer.embed(state, images, "PreLogits").numpy(),
                               jtrainer.embed(jstate, jnp.asarray(images), "PreLogits"),
                               atol=1e-5)
    names = [f"tag{i}" for i in range(NUM_CLASSES)]
    groups = {i: ("2" if i < 4 else "3" if i < 8 else "5") for i in range(NUM_CLASSES)}
    for g, thr in ((None, 0.4), (groups, 0.3)):
        trainer.write_tags(state, images, [f"img{i}" for i in range(4)], names,
                           str(tmp_path / "p" / "tags.txt"), threshold=thr, top_k=3,
                           labels_id_to_group=g)
        jtrainer.write_tags(jstate, images, [f"img{i}" for i in range(4)], names,
                            str(tmp_path / "j" / "tags.txt"), threshold=thr, top_k=3,
                            labels_id_to_group=g)
    lines = (tmp_path / "p" / "tags.txt").read_text().splitlines()
    assert lines == (tmp_path / "j" / "tags.txt").read_text().splitlines() and lines


def test_softmax_loss_and_label_smoothing():
    for multi in (True, False):
        jtrainer = jct.ClassifierTrainer(jct.ClassifierConfig(
            network="lenet", num_classes=5, multi_label=multi, label_smoothing=0.2))
        trainer = ct.ClassifierTrainer(ct.ClassifierConfig(
            network="lenet", num_classes=5, multi_label=multi, label_smoothing=0.2),
            device="cpu")
        rng = np.random.RandomState(1)
        logits = rng.randn(3, 5).astype(np.float32) * 4
        labels = (rng.rand(3, 5) > 0.5).astype(np.float32)
        assert float(trainer._loss(torch.from_numpy(logits), torch.from_numpy(labels))) == \
            pytest.approx(float(jtrainer._loss(jnp.asarray(logits), jnp.asarray(labels))),
                          rel=1e-6)
