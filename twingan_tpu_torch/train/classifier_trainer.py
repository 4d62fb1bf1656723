"""Multi-label image classifier trainer.

Counterpart of ``twingan_tpu/train/classifier_trainer.py``: the trainer of
the illust2vec and inception taggers whose embeddings feed TwinGAN
distillation, and of the classifiers FID is scored with.

- ``ClassifierConfig`` field for field (so the JAX ``config.json`` loads);
- ``train_step``: sigmoid (multi-label) or softmax cross-entropy with label
  smoothing, plus 0.4 x the auxiliary head's loss where the network has one
  (NASNet), the optimizer of ``train/optimizers.py`` (coupled weight decay,
  every optimizer, frozen scopes). The network runs in train mode, so its
  batch norms normalize with the batch moments and move their statistics,
  as the JAX step's mutable ``batch_stats``; NASNet's drop path ramps with
  step / ``total_steps`` and draws from a generator seeded by the config's
  seed and the step;
- ``predict`` (sigmoid or softmax of the eval-mode logits), ``embed``;
- ``evaluate``: AUC (exact, by the rank statistic with midranks for ties),
  precision and recall at a threshold, and the PR-curve file;
- ``write_tags``: top-k tags per image, optionally through the mutually
  exclusive tag-group filter;
- ``grad_cam_images``: Grad-CAM heat overlays.

The state is ``ClassifierState``: the network (parameters and moving
statistics in place), its ``Optimizer`` and the step. ``classifier_state_
to_dict`` lays it out flat under the JAX state dict's paths (``step``,
``params/...``, ``model_state/batch_stats/...``, ``opt_state/...`` as optax
lays the chain out; the port's tensor layouts), which checkpoints and the
bridge use.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.classifiers import get_network_fn, reset_parameters
from twingan_tpu_torch.models.grad_cam import grad_cam, impose_mask_on_image
from twingan_tpu_torch.train.base import resolve_device, step_generator
from twingan_tpu_torch.train.optimizers import (
    Optimizer,
    OptimizerConfig,
    build_optimizer,
    state_paths,
)
from twingan_tpu_torch.utils.misc import process_anime_face_labels

# A network's buffers: the batch norms' moving statistics (Flax batch_stats).
STATS_LEAVES = ("mean", "var")


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    network: str = "illust2vec"
    num_classes: int = 1539
    multi_label: bool = True
    # Dropped leading label columns: num_classes is already reduced; the
    # offset is kept so eval and tags modes realign labels and names.
    labels_offset: int = 0
    image_hw: int = 224
    batch_size: int = 32
    label_smoothing: float = 0.0
    seed: int = 0
    # Drop path's ramp horizon: progress = step / total_steps.
    total_steps: int = 250000
    opt: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(optimizer="rmsprop", learning_rate=0.01,
                                                learning_rate_decay_type="exponential"))


@dataclasses.dataclass
class ClassifierState:
    net: nn.Module
    opt: Optimizer
    step: int = 0


def _flat_path(key: str) -> str:
    """A network ``state_dict`` key -> its path in the JAX state dict."""
    group = "model_state/batch_stats" if key.rsplit(".", 1)[-1] in STATS_LEAVES else "params"
    return f"{group}/{key.replace('.', '/')}"


def classifier_state_to_dict(state: ClassifierState) -> dict[str, torch.Tensor]:
    """The whole state as a flat dict keyed by JAX state-dict paths."""
    out = {_flat_path(k): t for k, t in state.net.state_dict().items()}
    counts, slot_paths = state_paths(state.opt.cfg)
    for path in counts:
        out[f"opt_state/{path}"] = torch.tensor(state.opt.count, dtype=torch.int32)
    for slot, tensors in state.opt.slots().items():
        for name, t in tensors.items():
            out[f"opt_state/{slot_paths[slot]}/{name.replace('.', '/')}"] = t
    out["step"] = torch.tensor(state.step, dtype=torch.int32)
    return out


@torch.no_grad()
def classifier_state_from_dict(state: ClassifierState, flat) -> ClassifierState:
    """Load a flat dict of ``classifier_state_to_dict``'s form into
    ``state`` in place; every key the state has must be there."""
    sd = state.net.state_dict()
    state.net.load_state_dict({k: flat[_flat_path(k)] for k in sd}, strict=True)
    counts, slot_paths = state_paths(state.opt.cfg)
    slots = {slot: {name: flat[f"opt_state/{prefix}/{name.replace('.', '/')}"]
                    for name in state.opt.names}
             for slot, prefix in slot_paths.items()}
    state.opt.load_slots(int(flat[f"opt_state/{counts[0]}"]), slots)
    state.step = int(flat["step"])
    return state


class ClassifierTrainer:
    def __init__(self, cfg: ClassifierConfig, device: Optional[str | torch.device] = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0) -> ClassifierState:
        """A fresh network, its parameters drawn from ``seed`` (on the CPU,
        so every device gets the same numbers), and its optimizer."""
        net = get_network_fn(self.cfg.network, self.cfg.num_classes, image_hw=self.cfg.image_hw)
        reset_parameters(net, torch.Generator().manual_seed(int(seed)))
        net.to(self.device)
        return ClassifierState(net, build_optimizer(self.cfg.opt, dict(net.named_parameters())))

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        labels = labels.float()
        if cfg.label_smoothing:
            labels = labels * (1 - cfg.label_smoothing) + 0.5 * cfg.label_smoothing
        if cfg.multi_label:
            return torch.mean(-labels * F.logsigmoid(logits)
                              - (1.0 - labels) * F.logsigmoid(-logits))
        return torch.mean(-torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1))

    def _batch_tensor(self, x) -> torch.Tensor:
        """A batch leaf on the device; floating point kept as it is."""
        t = torch.as_tensor(x).to(self.device)
        return t if t.is_floating_point() else t.float()

    def train_step(self, state: ClassifierState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        """One update on ``batch`` ({"image": NHWC, "labels": [B, classes]});
        returns (state, {"loss": 0-dim tensor})."""
        net = state.net.train()
        kw = {}
        if "progress" in inspect.signature(type(net).forward).parameters:  # NASNet
            kw["progress"] = torch.tensor(state.step, dtype=torch.float32) / max(
                self.cfg.total_steps, 1)
            kw["generator"] = generator or step_generator(self.cfg.seed, state.step,
                                                          self.device)
        logits, eps = net(self._batch_tensor(batch["image"]), **kw)
        labels = self._batch_tensor(batch["labels"])
        loss = self._loss(logits, labels)
        if "AuxLogits" in eps:
            loss = loss + 0.4 * self._loss(eps["AuxLogits"], labels)
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        state.opt.step([torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)])
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def predict(self, state: ClassifierState, images) -> torch.Tensor:
        logits, _ = state.net.eval()(self._batch_tensor(images))
        return torch.sigmoid(logits) if self.cfg.multi_label else torch.softmax(logits, -1)

    @torch.no_grad()
    def embed(self, state: ClassifierState, images, layer: str = "encode") -> torch.Tensor:
        """The distillation embedding (the pre-logit ``encode`` end point)."""
        _, eps = state.net.eval()(self._batch_tensor(images))
        return eps[layer]

    def evaluate(self, state: ClassifierState, batches: Iterable[Dict[str, np.ndarray]],
                 threshold: float = 0.5, pr_curve_path: Optional[str] = None,
                 num_pr_thresholds: int = 21) -> Dict[str, float]:
        """AUC, precision and recall at ``threshold`` over every label."""
        scores_all, labels_all = [], []
        for batch in batches:
            scores_all.append(self.predict(state, batch["image"]).cpu().numpy())
            labels_all.append(np.asarray(batch["labels"]))
        scores = np.concatenate(scores_all).reshape(-1)
        labels = np.concatenate(labels_all).reshape(-1)
        pred = scores >= threshold
        tp = float(np.sum(pred & (labels > 0.5)))
        precision = tp / max(float(np.sum(pred)), 1.0)
        recall = tp / max(float(np.sum(labels > 0.5)), 1.0)
        if pr_curve_path:
            os.makedirs(os.path.dirname(os.path.abspath(pr_curve_path)), exist_ok=True)
            with open(pr_curve_path, "w") as f:
                f.write("threshold\tprecision\trecall\n")
                for t in np.linspace(0.0, 1.0, num_pr_thresholds):
                    p_ = scores >= t
                    tp_ = float(np.sum(p_ & (labels > 0.5)))
                    f.write(f"{t:.3f}\t{tp_ / max(float(np.sum(p_)), 1.0):.6f}"
                            f"\t{tp_ / max(float(np.sum(labels > 0.5)), 1.0):.6f}\n")
        return {"auc": _auc(scores, labels), "precision_at_thres": precision,
                "recall_at_thres": recall}

    def write_tags(self, state: ClassifierState, images, filenames: Sequence[str],
                   tag_names: Sequence[str], out_path: str, threshold: float = 0.25,
                   top_k: int = 10, labels_id_to_group: Optional[dict] = None) -> str:
        """Append one line per image to ``out_path``: its name and its top-k
        tags above ``threshold``; images with none are skipped. With
        ``labels_id_to_group`` only the best label of each group survives,
        and nothing is written unless hair and eye colour both clear the
        threshold."""
        probs = self.predict(state, images).cpu().numpy()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "a") as f:
            for name, p in zip(filenames, probs):
                if labels_id_to_group is not None:
                    p = np.asarray(process_anime_face_labels(p, threshold, labels_id_to_group))
                order = np.argsort(-p)[:top_k]
                tags = [tag_names[i] for i in order if p[i] >= threshold]
                if not tags:
                    continue
                f.write(f"{name}\t{','.join(tags)}\n")
        return out_path

    def grad_cam_images(self, state: ClassifierState, images, layer: str,
                        class_index: Optional[int] = None) -> np.ndarray:
        """Grad-CAM heat overlays of ``images`` (NHWC in [0, 1]) at end
        point ``layer``."""
        net = state.net.eval()
        images = self._batch_tensor(images)
        masks = grad_cam(lambda imgs, probes=None: net(imgs, probes=probes), images, layer,
                         class_index)
        return impose_mask_on_image(images, masks).cpu().numpy()


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic (midranks for score ties)."""
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    allscores = np.concatenate([pos, neg])
    order = np.argsort(allscores)
    sorted_scores = allscores[order]
    ranks_sorted = np.arange(1, len(allscores) + 1, dtype=np.float64)
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks_sorted[i: j + 1] = ranks_sorted[i: j + 1].mean()
        i = j + 1
    ranks = np.empty(len(allscores), dtype=np.float64)
    ranks[order] = ranks_sorted
    r_pos = ranks[: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))
