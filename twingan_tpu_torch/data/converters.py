"""Offline dataset converters: image folders / CelebA / SVHN / pairs ->
sharded TFRecords.

A copy of ``twingan_tpu/data/converters.py``: for the same input folder
every converter writes shards byte-identical to the JAX package's. PIL
(image files) and cv2 (the blur filter) are imported inside the functions
that need them, so the module imports on a machine without them. A dataset
meant for such a machine is converted with ``encode_format="png"``: its
PNG records decode there without PIL (``data/png.py``), JPEG ones do not.
The faces converter crops with the port's face detector
(``serve/face_detection.py``); with ``encode_format="png"`` and PNG
sources it runs without PIL.

Reference parity: datasets/convert_general_image_data.py (threaded sharded
writer base with size/ratio filters), convert_image_only.py,
convert_celeba.py (partition-file driven), download_and_convert_svhn.py
(.mat -> raw records; download is out of scope in this offline environment —
point it at a local .mat). Output shards follow the reference's naming
'%s_%s_%05d-of-%05d.tfrecord'.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
from typing import Callable, Optional

import numpy as np

from twingan_tpu_torch.data.example import encode_example
from twingan_tpu_torch.data.tfrecord import TFRecordWriter

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_images(root: str) -> list[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.join(dirpath, n))
    return sorted(out)


def shard_path(out_dir: str, dataset_name: str, split: str, shard: int, num_shards: int) -> str:
    return os.path.join(
        out_dir, f"{dataset_name}_{split}_{shard:05d}-of-{num_shards:05d}.tfrecord"
    )


def blur_score(image: np.ndarray) -> float:
    """Variance of the Laplacian — the reference's blur detector
    (datasets/dataset_utils.py:196-200); higher = sharper."""
    import cv2

    gray = (image @ np.asarray([0.299, 0.587, 0.114], np.float32)).astype(np.float32)
    return float(cv2.Laplacian(gray, cv2.CV_32F).var())


def _load_and_filter(
    path: str,
    min_hw: int = 0,
    max_ratio: float = 0.0,
    encode_format: str = "jpeg",
    min_sharpness: float = 0.0,
    max_hw: int = 0,
    preprocess_hw: int = 0,
    preprocess_mode: str = "PAD",
) -> Optional[dict]:
    """Reads, filters (min/max size / aspect ratio / blur like the reference
    base converter's allowed_min_hw / allowed_max_hw / allowed_hw_ratio,
    convert_general_image_data.py:36-320), optionally resizes at convert
    time (reference do_preprocessing + preprocessing_hw,
    convert_general_image_data.py:63,168 — trades fidelity for storage and
    train-time decode cost), and re-encodes one image. Returns a feature
    dict or None."""
    from PIL import Image as PILImage

    try:
        img = PILImage.open(path)
        img = img.convert("RGB")
    except Exception:
        return None
    w, h = img.size
    if min_hw and min(h, w) < min_hw:
        return None
    if max_hw and max(h, w) > max_hw:
        return None
    if max_ratio and max(h, w) / max(min(h, w), 1) > max_ratio:
        return None
    if min_sharpness and blur_score(np.asarray(img, np.float32)) < min_sharpness:
        return None
    if preprocess_hw:
        from twingan_tpu_torch.data.preprocess import host_resize_uint8

        img = PILImage.fromarray(host_resize_uint8(
            np.asarray(img, np.uint8), preprocess_mode, preprocess_hw))
    buf = io.BytesIO()
    img.save(buf, format="JPEG" if encode_format == "jpeg" else "PNG", quality=95)
    return {
        "image/encoded": buf.getvalue(),
        "image/format": encode_format.encode(),
        "image/filename": os.path.basename(path).encode(),
    }


def convert_image_folder(
    image_dir: str,
    out_dir: str,
    dataset_name: str = "image_only",
    split: str = "train",
    num_shards: int = 4,
    min_hw: int = 0,
    max_ratio: float = 0.0,
    min_sharpness: float = 0.0,
    num_threads: int = 4,
    extra_features: Optional[Callable[[str], Optional[dict]]] = None,
    max_hw: int = 0,
    preprocess_hw: int = 0,
    preprocess_mode: str = "PAD",
    encode_format: str = "jpeg",
) -> int:
    """Folder of images -> image_only-schema shards. Returns record count.
    ``encode_format`` ("jpeg", the JAX converter's only choice, or "png")
    is how each record stores its image; PNG records decode without PIL."""
    paths = list_images(image_dir)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    per_shard = max(1, (len(paths) + num_shards - 1) // num_shards)
    with cf.ThreadPoolExecutor(num_threads) as pool:
        for shard in range(num_shards):
            chunk = paths[shard * per_shard : (shard + 1) * per_shard]
            if not chunk and shard > 0:
                continue
            with TFRecordWriter(shard_path(out_dir, dataset_name, split, shard, num_shards)) as w:
                for src_path, feats in zip(chunk, pool.map(
                    lambda p: _load_and_filter(p, min_hw, max_ratio,
                                               encode_format=encode_format,
                                               min_sharpness=min_sharpness,
                                               max_hw=max_hw,
                                               preprocess_hw=preprocess_hw,
                                               preprocess_mode=preprocess_mode),
                    chunk
                )):
                    if feats is None:
                        continue
                    if extra_features is not None:
                        # Full source path (list_images walks recursively;
                        # the basename alone cannot be re-joined for nested
                        # folders). Callers keying on file NAMES derive the
                        # basename themselves.
                        extra = extra_features(src_path)
                        if extra is None:
                            continue
                        feats.update(extra)
                    w.write(encode_example(feats))
                    count += 1
    return count


def convert_celeba(
    image_dir: str,
    out_dir: str,
    partition_file: str,
    attrib_file: Optional[str] = None,
    landmark_file: Optional[str] = None,
    split: str = "train",
    num_shards: int = 4,
    dataset_name: str = "celeba",
) -> int:
    """CelebA with list_eval_partition.txt (0=train 1=validation 2=test),
    optional list_attr_celeba.txt (40 attribs) and landmark file."""
    split_id = {"train": 0, "validation": 1, "test": 2}[split]
    wanted = set()
    with open(partition_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2 and int(parts[1]) == split_id:
                wanted.add(parts[0])

    attribs: dict = {}
    if attrib_file:
        with open(attrib_file) as f:
            lines = f.read().splitlines()
        # Format: count line, header line, then 'name v1 ... v40'.
        for line in lines[2:]:
            parts = line.split()
            if len(parts) >= 41:
                attribs[parts[0]] = np.asarray(
                    [(1 if int(v) > 0 else 0) for v in parts[1:41]], np.int64
                )
    landmarks: dict = {}
    if landmark_file:
        with open(landmark_file) as f:
            lines = f.read().splitlines()
        for line in lines[2:]:
            parts = line.split()
            if len(parts) >= 11:
                landmarks[parts[0]] = np.asarray([float(v) for v in parts[1:11]], np.float32)

    def extra(path: str) -> Optional[dict]:
        filename = os.path.basename(path)  # partition/attrib files key on names
        if filename not in wanted:
            return None
        feats = {
            "image/attribs": attribs.get(filename, np.zeros(40, np.int64)),
            "image/landmarks": landmarks.get(filename, np.zeros(10, np.float32)),
        }
        return feats

    return convert_image_folder(
        image_dir, out_dir, dataset_name=dataset_name, split=split,
        num_shards=num_shards, extra_features=extra,
    )


def convert_svhn(mat_path: str, out_dir: str, split: str = "train", num_shards: int = 1) -> int:
    """SVHN .mat -> raw-format records (download_and_convert_svhn.py without
    the download: no network egress here)."""
    from scipy.io import loadmat

    data = loadmat(mat_path)
    images = np.transpose(data["X"], (3, 0, 1, 2))  # HWCN -> NHWC
    labels = data["y"].reshape(-1).astype(np.int64) % 10  # label 10 means digit 0
    os.makedirs(out_dir, exist_ok=True)
    n = len(images)
    per_shard = max(1, (n + num_shards - 1) // num_shards)
    count = 0
    for shard in range(num_shards):
        lo, hi = shard * per_shard, min((shard + 1) * per_shard, n)
        with TFRecordWriter(shard_path(out_dir, "svhn", split, shard, num_shards)) as w:
            for i in range(lo, hi):
                w.write(
                    encode_example(
                        {
                            "image/encoded": images[i].tobytes(),
                            "image/format": b"raw",
                            "image/class/label": np.asarray([labels[i]], np.int64),
                        }
                    )
                )
                count += 1
    return count


def convert_image_pairs(
    source_dir: str,
    target_dir: str,
    out_dir: str,
    split: str = "train",
    num_shards: int = 4,
    dataset_name: str = "image_pair",
) -> int:
    """Paired images matched by filename (pix2pix-style image_pair schema)."""
    src = {os.path.basename(p): p for p in list_images(source_dir)}
    tgt = {os.path.basename(p): p for p in list_images(target_dir)}
    names = sorted(set(src) & set(tgt))
    os.makedirs(out_dir, exist_ok=True)
    per_shard = max(1, (len(names) + num_shards - 1) // num_shards)
    count = 0
    for shard in range(num_shards):
        chunk = names[shard * per_shard : (shard + 1) * per_shard]
        if not chunk and shard > 0:
            continue
        with TFRecordWriter(shard_path(out_dir, dataset_name, split, shard, num_shards)) as w:
            for name in chunk:
                a = _load_and_filter(src[name], encode_format="png")
                b = _load_and_filter(tgt[name], encode_format="png")
                if a is None or b is None:
                    continue
                w.write(
                    encode_example(
                        {
                            "image/encoded_source": a["image/encoded"],
                            "image/encoded_target": b["image/encoded"],
                            "image/format": b"png",
                            "image/filename": name.encode(),
                        }
                    )
                )
                count += 1
    return count


def convert_faces_from_images(
    image_dir: str,
    out_dir: str,
    dataset_name: str = "anime_faces",
    split: str = "train",
    num_shards: int = 4,
    min_face_hw: int = 48,
    tags_fn: Optional[Callable[[str], str]] = None,
    safe_only: bool = False,
    unsafe_only: bool = False,
    encode_format: str = "jpeg",
) -> int:
    """Detect + crop faces from raw photos into image records.

    Reference parity: datasets/convert_anime_faces_from_object_detection.py
    (crops faces from detection tfrecords with empirical box expansion). The
    external detection tfrecords are replaced by the framework's own face
    detector (serve/face_detection.py) with the same expansion ratios.
    ``tags_fn(filename) -> 'tag1,tag2'`` optionally attaches the
    anime_faces-style class text. safe_only / unsafe_only keep only images
    whose danbooru-style filename rating is 's' / is not 's' (reference
    do_safe_only/do_unsafe_only, :40-42,218 — it keys on the name prefix).
    ``encode_format`` ("jpeg", the JAX converter's only choice, or "png")
    is how each crop is stored; PNG is encoded without PIL.
    """
    from twingan_tpu_torch.data.png import encode_png
    from twingan_tpu_torch.serve.face_detection import FaceDetector
    from twingan_tpu_torch.utils.image_io import imread_rgb

    if encode_format not in ("jpeg", "png"):
        raise ValueError(f"encode_format must be 'jpeg' or 'png', not {encode_format!r}")
    detector = FaceDetector(max_faces=16)
    paths = list_images(image_dir)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    per_shard = max(1, (len(paths) + num_shards - 1) // num_shards)
    for shard in range(num_shards):
        chunk = paths[shard * per_shard : (shard + 1) * per_shard]
        if not chunk and shard > 0:
            continue
        with TFRecordWriter(shard_path(out_dir, dataset_name, split, shard, num_shards)) as w:
            for path in chunk:
                if safe_only or unsafe_only:
                    is_safe = os.path.basename(path).startswith("s")
                    if (safe_only and not is_safe) or (unsafe_only and is_safe):
                        continue
                try:
                    img = imread_rgb(path)
                except ImportError:
                    raise  # a JPEG source without PIL: say so, do not skip it
                except Exception:  # noqa: BLE001 - unreadable files are skipped
                    continue
                for i, (x0, y0, x1, y1) in enumerate(detector.detect(img)):
                    if x1 - x0 < min_face_hw:
                        continue
                    crop = img[y0:y1, x0:x1]
                    if encode_format == "png":
                        encoded = encode_png(crop)
                    else:
                        from PIL import Image as PILImage

                        buf = io.BytesIO()
                        PILImage.fromarray(crop).save(buf, format="JPEG", quality=95)
                        encoded = buf.getvalue()
                    feats = {
                        "image/encoded": encoded,
                        "image/format": encode_format.encode(),
                        "image/filename": f"{os.path.basename(path)}_{i}".encode(),
                    }
                    if tags_fn is not None:
                        feats["image/class/text"] = tags_fn(os.path.basename(path)).encode()
                    w.write(encode_example(feats))
                    count += 1
    return count


def convert_tagged_images(
    image_dir: str,
    tags_file: str,
    out_dir: str,
    dataset_name: str = "danbooru_2_illust2vec",
    split: str = "train",
    num_shards: int = 4,
    separator: str = "\t",
) -> int:
    """Images + a filename->tags map file -> tagged records
    (reference convert_danbooru_data.py with its tags.xml vocabulary; the
    map file is 'filename<TAB>tag1,tag2' per line).
    """
    tags: dict[str, str] = {}
    with open(tags_file, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(separator)
            if len(parts) >= 2:
                tags[parts[0]] = parts[1]

    def extra(path: str) -> Optional[dict]:
        filename = os.path.basename(path)  # tags file keys on file names
        if filename not in tags:
            return None
        return {"image/class/text": tags[filename].encode()}

    return convert_image_folder(
        image_dir, out_dir, dataset_name=dataset_name, split=split,
        num_shards=num_shards, extra_features=extra,
    )


# Danbooru tag-type codes (reference danbooru_utils.py:25-31).
_DANBOORU_AUTHOR_TYPE = 1
_DANBOORU_META_TYPE = 5
_DANBOORU_GENERAL_TYPE = 0
_DANBOORU_NSFW_RATINGS = ("s", "q", "e")


def parse_tags_xml(tags_file: str) -> tuple[list, dict]:
    """Danbooru tags.xml -> (tags, name->index) with the reference's exact
    vocabulary construction (danbooru_utils.py:55-68): three NSFWRating_*
    pseudo-tags first, then every <tag> except author/meta types, each as
    (type, ambiguous, count, name, id)."""
    import xml.etree.ElementTree

    root = xml.etree.ElementTree.parse(tags_file).getroot()
    tags = [
        (_DANBOORU_GENERAL_TYPE, "false", 0, "NSFWRating_" + r, int(1e10) + i)
        for i, r in enumerate(_DANBOORU_NSFW_RATINGS)
    ]
    for tag in root.findall("tag"):
        t = int(tag.get("type"))
        if t not in (_DANBOORU_AUTHOR_TYPE, _DANBOORU_META_TYPE):
            tags.append((t, tag.get("ambiguous"), int(tag.get("count")),
                         tag.get("name"), int(tag.get("id"))))
    return tags, {t[3]: i for i, t in enumerate(tags)}


def parse_danbooru_file_name(file_name: str) -> tuple[str, str, list]:
    """'<rating> - <id>.<ext>' + sidecar '<file>.txt' of one tag per line ->
    (nsfw_rating, id, tags incl. the NSFWRating_* pseudo-tag); reference
    danbooru_utils.parse_file_name (:36-52)."""
    base, _ = os.path.splitext(os.path.basename(file_name))
    parts = base.split(" - ")
    if len(parts) != 2:
        raise ValueError(f"danbooru file name has illegal format: {file_name}")
    nsfw_rating, image_id = parts
    with open(file_name + ".txt", encoding="utf-8") as f:
        tags = [line.rstrip("\n") for line in f]
    tags.append("NSFWRating_" + nsfw_rating)
    return nsfw_rating, image_id, tags


def _danbooru_scan(image_dir: str) -> dict:
    """One pass over the dump: {path: (rating, in-file tags)} for every
    well-formed '<rating> - <id>.<ext>' image with a readable sidecar."""
    out = {}
    for path in list_images(image_dir):
        try:
            rating, _, tags = parse_danbooru_file_name(path)
        except (ValueError, OSError):
            continue  # reference skips malformed entries
        out[path] = (rating, tags)
    return out


def convert_danbooru_folder(
    image_dir: str,
    tags_xml: str,
    out_dir: str,
    dataset_name: str = "danbooru_2_illust2vec",
    split: str = "train",
    num_shards: int = 4,
    safe_only: bool = False,
    unsafe_only: bool = False,
    max_num_labels: int = 0,
    **folder_kw,
) -> int:
    """Danbooru dump ('<rating> - <id>.jpg' + per-image .txt tag sidecars +
    tags.xml vocabulary) -> tagged records, keeping only tags present in the
    vocabulary (reference convert_danbooru_data.py:141-170). The vocabulary
    order doubles as the label index space (write it with
    write_tags_vocab).

    safe_only / unsafe_only filter by the filename's NSFW rating (reference
    do_safe_only/do_unsafe_only, convert_anime_faces_from_object_detection
    .py:40-42,218: keep only 's'-rated images, or only non-'s').
    max_num_labels restricts the kept tags to the dataset's most common N
    (reference _process_tags, convert_danbooru_data.py:91-118) — build the
    matching label file with most_common_tags + write order.
    ``**folder_kw`` forwards the base-converter knobs (min_hw/max_hw/
    max_ratio/min_sharpness/preprocess_hw/...) — the reference danbooru
    converter inherits them from GeneralImageDataConverter
    (convert_danbooru_data.py:54)."""
    _, name_to_index = parse_tags_xml(tags_xml)
    scanned = _danbooru_scan(image_dir)
    keep: Optional[set] = None
    if max_num_labels:
        keep = set(_most_common_from_scan(scanned, name_to_index, max_num_labels))

    def extra(path: str) -> Optional[dict]:
        entry = scanned.get(path)
        if entry is None:
            return None
        rating, tags = entry
        if safe_only and rating != "s":
            return None
        if unsafe_only and rating == "s":
            return None
        kept = [t for t in tags if t in name_to_index
                and (keep is None or t in keep)]
        if not kept:
            return None
        return {"image/class/text": ",".join(kept).encode()}

    return convert_image_folder(
        image_dir, out_dir, dataset_name=dataset_name, split=split,
        num_shards=num_shards, extra_features=extra, **folder_kw,
    )


def _most_common_from_scan(
    scanned: dict, name_to_index: dict, max_num_labels: int
) -> list[str]:
    import collections

    counts: collections.Counter = collections.Counter()
    for _, tags in scanned.values():
        counts.update(t for t in tags if t in name_to_index)
    ordered = ["NSFWRating_" + r for r in _DANBOORU_NSFW_RATINGS]
    ordered += [t for t, _ in counts.most_common() if t not in set(ordered)]
    return ordered[:max_num_labels]


def most_common_tags(
    image_dir: str, tags_xml: str, max_num_labels: int
) -> list[str]:
    """The dataset's most common in-vocabulary tags, NSFWRating_* pseudo-tags
    first, capped at max_num_labels (reference _process_tags ordering,
    convert_danbooru_data.py:91-118; the reference additionally reserves
    label index 0 as background — our vocab files are pure line-index
    spaces, so callers wanting that reservation prepend a line)."""
    _, name_to_index = parse_tags_xml(tags_xml)
    return _most_common_from_scan(
        _danbooru_scan(image_dir), name_to_index, max_num_labels)


def write_tags_vocab(tags_xml: str, out_file: str) -> int:
    """Write the tags.xml vocabulary as the one-label-per-line file the
    runner's vocab_file option consumes (reference labels.txt files,
    datasets/dataset_utils.py:113-162)."""
    tags, _ = parse_tags_xml(tags_xml)
    with open(out_file, "w", encoding="utf-8") as f:
        for t in tags:
            f.write(t[3] + "\n")
    return len(tags)
