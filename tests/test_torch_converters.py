"""The port's dataset converters against the JAX package's: for the same
input folder each writes shards byte-identical to the JAX converter's (an
image folder of JPEG and PNG files, with the size and ratio filters and
with a resize at convert time; image pairs; SVHN from a ``.mat`` made with
scipy; tagged images; a danbooru dump with its tags.xml; CelebA; faces
cropped from a folder holding the faces image, with JPEG records, the
safe/unsafe filters and tags). PNG records written with
``encode_format="png"`` decode without PIL to the image PIL decodes, and
the faces converter's PNG crops to the JAX detector's crops.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from scipy.io import savemat  # noqa: E402

from twingan_tpu.data import converters as jconverters  # noqa: E402

from twingan_tpu_torch.data import converters, datasets  # noqa: E402
from twingan_tpu_torch.data.example import decode_example  # noqa: E402
from twingan_tpu_torch.data.tfrecord import TFRecordReader, list_shards  # noqa: E402


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv")
    rng = np.random.RandomState(0)
    imgs = root / "imgs"
    (imgs / "nested").mkdir(parents=True)
    for i in range(9):
        h, w = ((24, 24), (30, 18), (12, 40))[i % 3]
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        sub = imgs / "nested" if i == 4 else imgs
        Image.fromarray(arr).save(str(sub / f"s - {i}.{'png' if i % 2 else 'jpg'}"))
    (imgs / "notes.txt").write_text("not an image")
    return root


def shard_bytes(out_dir):
    names = sorted(os.listdir(out_dir))
    assert names, out_dir
    return {n: open(os.path.join(out_dir, n), "rb").read() for n in names}


def same_shards(tmp_path, run):
    """run(package, out_dir) -> count, once with each package."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    count = run(converters, a)
    assert count == run(jconverters, b)
    assert shard_bytes(a) == shard_bytes(b)
    return a, count


@pytest.mark.parametrize("kw", [
    dict(), dict(num_shards=2), dict(min_hw=20), dict(max_ratio=1.5), dict(max_hw=28),
    dict(preprocess_hw=16), dict(preprocess_hw=20, preprocess_mode="CROP"),
], ids=["plain", "2-shards", "min-hw", "max-ratio", "max-hw", "resize-pad", "resize-crop"])
def test_image_folder_shards_are_identical(tmp_path, folder, kw):
    _, count = same_shards(tmp_path, lambda pkg, out: pkg.convert_image_folder(
        str(folder / "imgs"), out, num_threads=2, **kw))
    assert count > 0


def test_png_records_decode_without_pil_to_what_pil_decodes(tmp_path, folder):
    out = str(tmp_path / "png")
    count = converters.convert_image_folder(str(folder / "imgs"), out, encode_format="png",
                                            num_shards=1)
    spec = datasets.get_dataset("image_only")
    paths = converters.list_images(str(folder / "imgs"))
    for payload, path in zip(TFRecordReader(list_shards(out, "train")[0]), paths):
        assert decode_example(payload)["image/format"] == [b"png"]
        np.testing.assert_array_equal(spec.parse(payload)["source"],
                                      np.asarray(Image.open(path).convert("RGB")))
    assert count == len(paths)


def test_image_pair_shards_are_identical(tmp_path):
    rng = np.random.RandomState(1)
    for d in ("src", "tgt"):
        (tmp_path / d).mkdir()
    for i in range(5):
        Image.fromarray(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(
            str(tmp_path / "src" / f"p{i}.png"))
        if i != 2:
            Image.fromarray(rng.randint(0, 256, (16, 20, 3)).astype(np.uint8)).save(
                str(tmp_path / "tgt" / f"p{i}.jpg" if i == 3 else tmp_path / "tgt" / f"p{i}.png"))
    same_shards(tmp_path, lambda pkg, out: pkg.convert_image_pairs(
        str(tmp_path / "src"), str(tmp_path / "tgt"), out, num_shards=2))


def test_svhn_shards_are_identical(tmp_path):
    rng = np.random.RandomState(2)
    mat = str(tmp_path / "train_32x32.mat")
    savemat(mat, {"X": rng.randint(0, 256, (32, 32, 3, 11)).astype(np.uint8),
                  "y": (np.arange(11) % 10 + 1).reshape(-1, 1)})
    same_shards(tmp_path, lambda pkg, out: pkg.convert_svhn(mat, out, num_shards=3))


def test_tagged_shards_are_identical(tmp_path, folder):
    tags = tmp_path / "tags.tsv"
    tags.write_text("s - 0.jpg\tred,blue\ns - 3.png\tgreen\nmissing.png\tx\n")
    same_shards(tmp_path, lambda pkg, out: pkg.convert_tagged_images(
        str(folder / "imgs"), str(tags), out, num_shards=1))


def test_danbooru_shards_are_identical(tmp_path, folder):
    xml = tmp_path / "tags.xml"
    xml.write_text('<?xml version="1.0"?><tags>'
                   '<tag type="0" ambiguous="false" count="5" name="red" id="1"/>'
                   '<tag type="1" ambiguous="false" count="2" name="artist" id="2"/>'
                   '<tag type="0" ambiguous="false" count="3" name="blue" id="3"/>'
                   '</tags>')
    for i in range(9):
        ext = "png" if i % 2 else "jpg"
        sub = folder / "imgs" / "nested" if i == 4 else folder / "imgs"
        (sub / f"s - {i}.{ext}.txt").write_text("red\nartist\n" + ("blue\n" if i % 3 else ""))
    for kw in (dict(), dict(safe_only=True), dict(max_num_labels=2), dict(min_hw=20)):
        sub = tmp_path / "_".join(f"{k}{v}" for k, v in kw.items()) if kw else tmp_path / "all"
        sub.mkdir()
        same_shards(sub, lambda pkg, out: pkg.convert_danbooru_folder(
            str(folder / "imgs"), str(xml), out, num_shards=2, **kw))
    assert converters.most_common_tags(str(folder / "imgs"), str(xml), 3) == \
        jconverters.most_common_tags(str(folder / "imgs"), str(xml), 3)
    assert converters.write_tags_vocab(str(xml), str(tmp_path / "v1")) == \
        jconverters.write_tags_vocab(str(xml), str(tmp_path / "v2"))
    assert (tmp_path / "v1").read_text() == (tmp_path / "v2").read_text()


def test_celeba_shards_are_identical(tmp_path, folder):
    names = [os.path.basename(p) for p in converters.list_images(str(folder / "imgs"))]
    part = tmp_path / "partition.txt"
    part.write_text("".join(f"{n} {i % 3}\n" for i, n in enumerate(names)).replace(
        "s - ", "s_-_"))
    # CelebA names have no spaces: the partition file splits on whitespace.
    for i, n in enumerate(names):
        src = converters.list_images(str(folder / "imgs"))[i]
        os.makedirs(tmp_path / "celeba_imgs", exist_ok=True)
        Image.open(src).save(str(tmp_path / "celeba_imgs" / n.replace("s - ", "s_-_")))
    attrs = tmp_path / "attrs.txt"
    attrs.write_text(f"{len(names)}\nhdr\n" + "".join(
        n.replace("s - ", "s_-_") + " " + " ".join("1" if (i + k) % 2 else "-1"
                                                  for k in range(40)) + "\n"
        for i, n in enumerate(names)))
    for split in ("train", "validation"):
        sub = tmp_path / split
        sub.mkdir()
        same_shards(sub, lambda pkg, out: pkg.convert_celeba(
            str(tmp_path / "celeba_imgs"), out, str(part), str(attrs), split=split,
            num_shards=2))


def test_faces_converter_waits_for_the_detector(tmp_path, folder):
    """The converter runs the detector on every image: on a folder of noise
    it finds no face and writes the JAX converter's empty shards."""
    _, count = same_shards(tmp_path, lambda pkg, out: pkg.convert_faces_from_images(
        str(folder / "imgs"), out, num_shards=2, min_face_hw=8))
    assert count == 0
    with pytest.raises(ValueError, match="encode_format"):
        converters.convert_faces_from_images(str(folder / "imgs"), str(tmp_path / "x"),
                                             encode_format="gif")


@pytest.fixture(scope="module")
def faces_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("faces")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "tests", "data", "real_faces_gallery.png"), "rb") as f:
        data = f.read()
    for name in ("s - gallery.png", "e - gallery.png"):
        (root / name).write_bytes(data)
    Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(str(root / "s - blank.jpg"))
    return root


@pytest.mark.parametrize("kw,expected", [
    (dict(), 20),  # 10 faces in each gallery, none in the blank image
    (dict(safe_only=True, min_face_hw=66), 8),  # two crops are narrower
    (dict(unsafe_only=True, tags_fn=lambda n: f"tag,{n[0]}"), 10),
])
def test_faces_converter_matches_jax(tmp_path, faces_folder, kw, expected):
    _, count = same_shards(tmp_path, lambda pkg, out: pkg.convert_faces_from_images(
        str(faces_folder), out, num_shards=2, **kw))
    assert count == expected


def test_faces_converter_png_records_are_the_jax_crops(tmp_path, faces_folder):
    from twingan_tpu.serve.face_detection import FaceDetector as JaxFaceDetector

    out = str(tmp_path / "png")
    count = converters.convert_faces_from_images(str(faces_folder), out, num_shards=1,
                                                 safe_only=True, encode_format="png")
    img = np.asarray(Image.open(str(faces_folder / "s - gallery.png")).convert("RGB"))
    crops = [img[y0:y1, x0:x1] for x0, y0, x1, y1 in JaxFaceDetector(max_faces=16).detect(img)
             if x1 - x0 >= 48]
    records = [decode_example(r) for shard in list_shards(out, "train")
               for r in TFRecordReader(shard)]
    assert count == len(records) == len(crops) == 10
    for rec, crop in zip(records, crops):
        assert rec["image/format"] == [b"png"]
        np.testing.assert_array_equal(datasets._decode_image(rec["image/encoded"][0], b"png"),
                                      crop)


def test_list_images_and_shard_names_match(folder):
    assert converters.list_images(str(folder / "imgs")) == jconverters.list_images(
        str(folder / "imgs"))
    assert converters.shard_path("/d", "faces", "train", 3, 8) == jconverters.shard_path(
        "/d", "faces", "train", 3, 8)
    parsed = converters.parse_danbooru_file_name
    with pytest.raises(ValueError):
        parsed("/d/badname.jpg")
