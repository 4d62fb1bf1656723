"""Dataset registry: feature schemas + decoders for every reference dataset.

Counterpart of ``twingan_tpu/data/datasets.py``, every schema, decoder and
``DATASETS`` entry the same. Decoded items use the reference's item names
(source/target/conditional_labels/filename/label_text/embedding/landmarks).

Decoding happens on the host. It differs from the JAX package in one way:
PNG is decoded by ``data/png.py`` (the card's machine has no PIL), to the
same bytes as PIL's ``convert("RGB")``; JPEG still needs PIL, imported
inside ``_decode_image``, which raises ``ImportError`` saying so where PIL
is missing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from twingan_tpu_torch.data.example import decode_example
from twingan_tpu_torch.utils.image_io import decode_image


def _decode_image(data: bytes, fmt: bytes | str = b"jpeg") -> np.ndarray:
    """Encoded image -> uint8 [H, W, 3] (``utils/image_io.decode_image``:
    PNG without PIL whatever ``fmt`` says, anything else through PIL)."""
    fmt = fmt.decode() if isinstance(fmt, (bytes, bytearray)) else fmt
    if fmt == "raw":
        raise ValueError("raw format needs explicit shape; handled by the dataset")
    return decode_image(data, fmt)


class Vocabulary:
    """Tag-name -> id lookup for one/multi-hot labels (reference
    dataset_utils.OneHotLabelTensor + tags id lookup files)."""

    def __init__(self, tags: list[str]):
        self.tags = list(tags)
        self.index = {t: i for i, t in enumerate(self.tags)}

    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\n") for line in f if line.strip()])

    def one_hot(self, label_text: str, num_classes: int, separator: str = ",") -> np.ndarray:
        out = np.zeros((num_classes,), np.float32)
        for tag in label_text.split(separator):
            tag = tag.strip()
            idx = self.index.get(tag)
            if idx is not None and idx < num_classes:
                out[idx] = 1.0
        return out


@dataclasses.dataclass
class DatasetSpec:
    """One registered dataset: schema + decode fn + bookkeeping
    (reference slim Dataset fields: items_used, items_need_preprocessing,
    num_classes, has_source)."""

    name: str
    decode: Callable[[memoryview, "DatasetSpec"], Dict[str, np.ndarray]]
    items_used: tuple
    items_need_preprocessing: tuple
    num_classes: int = 0
    has_source: bool = True
    vocab: Optional[Vocabulary] = None
    use_target: bool = False  # image_only: route image to 'target' not 'source'
    # Feature key holding the encoded image (reference image_only_key_name,
    # datasets/image_only.py:41 — records written by third-party tools may
    # use a non-standard key).
    image_key: str = "image/encoded"

    def parse(self, payload: memoryview) -> Dict[str, np.ndarray]:
        return self.decode(payload, self)


# ------------------------------------------------------------------ #
# Per-dataset decoders
# ------------------------------------------------------------------ #

def _decode_image_only(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    img = _decode_image(ex[spec.image_key][0], ex.get("image/format", [b"jpeg"])[0])
    key = "target" if spec.use_target else "source"
    out = {key: img}
    if "image/filename" in ex:
        out["filename"] = np.asarray(ex["image/filename"][0])
    return out


def _decode_anime_faces(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    img = _decode_image(ex["image/encoded"][0], ex.get("image/format", [b"jpeg"])[0])
    label_text = bytes(ex.get("image/class/text", [b""])[0]).decode("utf-8")
    out = {
        # Reference: 'target' if FLAGS.dataset_use_target else 'source'
        # (datasets/anime_faces.py:95) — as 'target', the image is the GAN's
        # real-data distribution and the generator input stays noise.
        "target" if spec.use_target else "source": img,
        "label_text": np.asarray(label_text),
        "filename": np.asarray(ex.get("image/filename", [b""])[0]),
    }
    if spec.vocab is not None:
        out["conditional_labels"] = spec.vocab.one_hot(label_text, spec.num_classes)
    elif "image/class/label" in ex:
        hot = np.zeros((spec.num_classes,), np.float32)
        labels = np.asarray(ex["image/class/label"])
        # Out-of-range ids are DROPPED (all-zero row), matching the
        # reference's safe_one_hot_encoding (util_misc.py:89-101) — clipping
        # would silently train the boundary class.
        valid = labels[(labels >= 0) & (labels < spec.num_classes)]
        hot[valid] = 1.0
        out["conditional_labels"] = hot
    return out


def _decode_celeba(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    img = _decode_image(ex["image/encoded"][0], ex.get("image/format", [b"jpeg"])[0])
    out = {
        "target" if spec.use_target else "source": img,
        "conditional_labels": ex["image/attribs"].astype(np.float32),
        "landmarks": ex["image/landmarks"],
        "filename": np.asarray(ex.get("image/filename", [b""])[0]),
    }
    if "image/embedding" in ex:
        out["embedding"] = ex["image/embedding"]
    if "image/features/facial_features" in ex:
        out["dlib_landmarks"] = ex["image/features/facial_features"]
    return out


def _decode_image_pair(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    fmt = ex.get("image/format", [b"png"])[0]
    return {
        "source": _decode_image(ex["image/encoded_source"][0], fmt),
        "target": _decode_image(ex["image/encoded_target"][0], fmt),
    }


def _decode_svhn(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    fmt = ex.get("image/format", [b"raw"])[0]
    if bytes(fmt) == b"raw":
        img = np.frombuffer(bytes(ex["image/encoded"][0]), np.uint8).reshape(32, 32, 3)
    else:
        img = _decode_image(ex["image/encoded"][0], fmt)
    label = int(ex.get("image/class/label", np.zeros(1, np.int64))[0])
    hot = np.zeros((spec.num_classes,), np.float32)
    hot[label % spec.num_classes] = 1.0
    out = {"image": img, "label": np.int64(label), "conditional_labels": hot}
    out["target" if spec.use_target else "source"] = img
    return out


def _decode_danbooru(payload, spec: DatasetSpec):
    ex = decode_example(payload)
    img = _decode_image(ex["image/encoded"][0], ex.get("image/format", [b"jpeg"])[0])
    label_text = bytes(ex.get("image/class/text", [b""])[0]).decode("utf-8")
    out = {"source": img, "label_text": np.asarray(label_text)}
    if spec.vocab is not None:
        out["target"] = spec.vocab.one_hot(label_text, spec.num_classes)
    elif "image/class/label" in ex:
        hot = np.zeros((spec.num_classes,), np.float32)
        labels = np.asarray(ex["image/class/label"])
        # Out-of-range ids are DROPPED (all-zero row), matching the
        # reference's safe_one_hot_encoding (util_misc.py:89-101) — clipping
        # would silently train the boundary class.
        valid = labels[(labels >= 0) & (labels < spec.num_classes)]
        hot[valid] = 1.0
        out["target"] = hot
    return out


DATASETS: Dict[str, dict] = {
    "image_only": dict(
        decode=_decode_image_only,
        items_used=("source", "filename"),
        items_need_preprocessing=("source",),
    ),
    "anime_faces": dict(
        decode=_decode_anime_faces,
        items_used=("source", "conditional_labels", "filename", "label_text"),
        items_need_preprocessing=("source", "conditional_labels"),
        num_classes=51,
    ),
    "celeba": dict(
        decode=_decode_celeba,
        items_used=("conditional_labels", "source", "landmarks", "filename"),
        items_need_preprocessing=("conditional_labels", "source"),
        num_classes=40,
    ),
    "celeba_facenet": dict(
        decode=_decode_celeba,
        items_used=("conditional_labels", "source", "landmarks", "filename", "embedding"),
        items_need_preprocessing=("conditional_labels", "source"),
        num_classes=40,
    ),
    "danbooru_2_illust2vec": dict(
        decode=_decode_danbooru,
        items_used=("source", "target", "label_text"),
        items_need_preprocessing=("source", "target"),
        num_classes=1539,
    ),
    "image_pair": dict(
        decode=_decode_image_pair,
        items_used=("source", "target"),
        items_need_preprocessing=("source", "target"),
    ),
    "svhn": dict(
        decode=_decode_svhn,
        items_used=("image", "label", "source", "target", "conditional_labels"),
        items_need_preprocessing=("image", "label", "source", "target", "conditional_labels"),
        num_classes=10,
    ),
}


def get_dataset(
    name: str,
    num_classes: int = 0,
    vocab_file: Optional[str] = None,
    use_target: bool = False,
    image_key: str = "image/encoded",
) -> DatasetSpec:
    """Factory (reference dataset_factory.get_dataset with size/class
    overrides via flags; ``image_key`` = image_only_key_name)."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    info = DATASETS[name]
    vocab = Vocabulary.from_file(vocab_file) if vocab_file else None
    return DatasetSpec(
        name=name,
        decode=info["decode"],
        items_used=tuple(info["items_used"]),
        items_need_preprocessing=tuple(info["items_need_preprocessing"]),
        num_classes=num_classes or info.get("num_classes", 0),
        vocab=vocab,
        use_target=use_target,
        image_key=image_key,
    )
