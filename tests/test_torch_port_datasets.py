"""The port's datasets, loading and configs against the JAX package's on the
same files: the PNG reader against PIL, SimpleDataset on data/,
StorySalonDataset on a tree from scripts/make_synth_storysalon.py plus a
PDF-source story (both splits, two seeds, set_epoch, the CFG dropout),
the COCO datasets on a scripts/make_synth_coco.py tree, `collate` and the
DataLoader with a tokenizer, TrainConfig.from_yaml on every configs/*.yml
and numpy_to_pil. Images equal bit for bit (the JAX package's and the
port's C++ normalize_u8 agree exactly)."""
import dataclasses
import glob
import io
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from chip_smoke import write_bpe_files
from storygen_tpu import configs as jax_configs
from storygen_tpu import pipeline as jax_pipeline
from storygen_tpu.data import datasets as J
from storygen_tpu.data import loader as jax_loader
from storygen_tpu_torch import configs as port_configs
from storygen_tpu_torch import pipeline as port_pipeline
from storygen_tpu_torch.data import datasets as P
from storygen_tpu_torch.data import loader as port_loader
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.utils.image import (SIGNATURE, _chunk, decode_png,
                                            png_size, read_png, write_png)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_samples_equal(ours: dict, ref: dict):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def _synth(script: str, root: str, *args: str) -> str:
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", script),
                    "--root", root, *args], check=True, capture_output=True)
    return root


@pytest.fixture(scope="module")
def salon(tmp_path_factory):
    """3 video stories of 5 frames at 64 px (the last held out) and one
    PDF-source ("Bloom") story of 4 frames at 48 px, in the test split when
    named in PDF_test_set.txt."""
    root = str(tmp_path_factory.mktemp("salon"))
    _synth("make_synth_storysalon.py", root, "--stories", "3", "--frames",
           "5", "--size", "64", "--test-stories", "1")
    rs = np.random.RandomState(3)
    for sub in ("Image_inpainted", "Mask", "Text/Caption"):
        os.makedirs(os.path.join(root, sub, "Bloom", "b001"))
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, (48, 48, 3), np.uint8)).save(
            os.path.join(root, "Image_inpainted", "Bloom", "b001",
                         f"{i}.png"))
        Image.fromarray(rs.randint(0, 256, (48, 48), np.uint8)).save(
            os.path.join(root, "Mask", "Bloom", "b001", f"{i}.png"))
        with open(os.path.join(root, "Text", "Caption", "Bloom", "b001",
                               f"{i}.txt"), "w") as f:
            f.write(f"page {i} of the bloom story")
    return root


# ----------------------------------------------------------------- PNG


def _filtered_png(a: np.ndarray, color: int, kinds,
                  interlace: int = 0) -> bytes:
    """An 8-bit PNG of `a` (H, W, C) whose row y uses filter kinds[y]."""
    h, w, c = a.shape
    x = a.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [np.zeros_like(cur), left, up, (left + up) >> 1,
                paeth][kinds[y]]
        rows.append(bytes([kinds[y]]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, interlace)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,color,channels", [
    ("L", 0, 1), ("RGB", 2, 3), ("LA", 4, 2), ("RGBA", 6, 4)])
def test_read_png_every_filter_equals_pil(mode, color, channels):
    rs = np.random.RandomState(channels)
    a = rs.randint(0, 256, (13, 9, channels)).astype(np.uint8)
    data = _filtered_png(a, color, [y % 5 for y in range(13)])
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (13, 9, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"optimize": True},
                                {"compress_level": 1}])
def test_read_png_of_pil_files(tmp_path, kw):
    """PIL's own encoder (adaptive filters) for every colour type, a
    palette image among them."""
    rs = np.random.RandomState(0)
    small = rs.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    rgb = np.asarray(Image.fromarray(small).resize((61, 47),
                                                   Image.BILINEAR))
    images = [Image.fromarray(rgb), Image.fromarray(rgb).convert("L"),
              Image.fromarray(rgb).convert("LA"),
              Image.fromarray(rgb).convert("RGBA"),
              Image.fromarray(rgb).quantize(40)]
    for i, img in enumerate(images):
        path = str(tmp_path / f"{i}.png")
        img.save(path, **kw)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_png(path), want, err_msg=img.mode)
        assert png_size(path) == (61, 47)


def test_read_png_round_trips_the_writer(tmp_path):
    a = np.random.RandomState(1).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)
    write_png(str(tmp_path / "a.png"), a)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), a)


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    a = np.zeros((4, 4), np.uint16)
    Image.fromarray(a).save(str(tmp_path / "deep.png"))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(str(tmp_path / "deep.png"))
    with pytest.raises(ValueError, match="interlace 1"):
        decode_png(_filtered_png(np.zeros((2, 2, 3), np.uint8), 2, [0, 0],
                                 interlace=1))
    good = _filtered_png(np.zeros((2, 2, 3), np.uint8), 2, [0, 0])
    with pytest.raises(ValueError, match="corrupt"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])


def _without_pil(monkeypatch):
    """`from PIL import Image` raises ImportError from here on, as on a
    host without PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_load_rgb_without_pil(tmp_path, monkeypatch):
    """Without PIL, a PNG of the target size goes through read_png (one it
    cannot decode raises ValueError, never reaching another decoder) and
    anything else raises ImportError."""
    Image.fromarray(np.zeros((16, 16), np.uint16)).save(
        str(tmp_path / "deep16.png"))
    _without_pil(monkeypatch)
    with pytest.raises(ValueError, match="bit depth 16"):
        P.load_rgb(str(tmp_path / "deep16.png"), 16)
    with pytest.raises(ImportError):
        P.load_rgb(str(tmp_path / "deep16.png"), 8)


@pytest.mark.parametrize("size", [512, 96])
def test_simple_dataset_without_pil_equals_jax(monkeypatch, size):
    """data/'s 512 px PNGs read by read_png equal the JAX package's PIL
    decode; a size that needs a resize needs PIL."""
    root = os.path.join(REPO, "data")
    ref = J.SimpleDataset(root, size)
    want = [ref[i] for i in range(len(ref))]
    _without_pil(monkeypatch)
    ours = P.SimpleDataset(root, size)
    for i, w in enumerate(want):
        if size == 512:
            assert_samples_equal(ours[i], w)
        else:
            with pytest.raises(ImportError):
                ours[i]


# ------------------------------------------------------------- datasets


@pytest.mark.parametrize("size", [512, 96])
def test_simple_dataset_on_data(size):
    """data/ holds 512 px PNGs, read at their own size and resized to
    96."""
    root = os.path.join(REPO, "data")
    ours, ref = P.SimpleDataset(root, size), J.SimpleDataset(root, size)
    assert len(ours) == len(ref) == 2
    for i in range(len(ref)):
        assert_samples_equal(ours[i], ref[i])


@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 7),
                                        ("test", 0)])
def test_storysalon_equals_jax(salon, split, seed):
    kw = dict(seed=seed)
    ours = P.StorySalonDataset(salon, split, size=64, **kw)
    ref = J.StorySalonDataset(salon, split, size=64, **kw)
    assert ours.samples == ref.samples and len(ours) > 0
    if split == "test":  # the video story held out in the root's list
        assert all("synth002" in s[0][0] for s in ours.samples)
    for epoch in (0, 3):
        ours._rng.set_epoch(epoch)
        ref._rng.set_epoch(epoch)
        for i in range(len(ref)):
            assert_samples_equal(ours[i], ref[i])


def test_storysalon_pdf_split_and_normalize_refs(salon, tmp_path):
    """A PDF story read at 48 px (its own size: no PIL) and at 64 px (PIL),
    moved to the test split by PDF_test_set.txt; refs in [-1, 1]."""
    root = str(tmp_path / "salon")
    shutil.copytree(salon, root)
    with open(os.path.join(root, "PDF_test_set.txt"), "w") as f:
        f.write("b001\n")
    for size in (48, 64):
        ours = P.StorySalonDataset(root, "test", size=size,
                                   normalize_refs=True)
        ref = J.StorySalonDataset(root, "test", size=size,
                                  normalize_refs=True)
        # b001's one window and the held-out video story's two
        assert ours.samples == ref.samples and len(ours) == 3
        for i in range(len(ref)):
            assert_samples_equal(ours[i], ref[i])
    assert not any("b001" in s[0][0] for s in
                   P.StorySalonDataset(root, "train").samples)


@pytest.mark.parametrize("dataset", ["storysalon", "coco"])
def test_cfg_dropout_draws_equal_jax(monkeypatch, salon, tmp_path, dataset):
    """The dropout of 2,000 (epoch, item) draws: the same rows in both
    packages, at rates 5% (prompt) and 10% (refs) within 5 binomial sd.
    Image loading is stubbed out in both packages (the draws do not read
    pixels)."""
    if dataset == "storysalon":
        for mod in (J, P):
            monkeypatch.setattr(mod, "_load_image",
                                lambda p, s=512: np.ones((4, 4, 3),
                                                         np.float32))
            monkeypatch.setattr(mod, "_load_mask",
                                lambda p, s=512: np.ones((4, 4, 1),
                                                         np.float32))
        ours = P.StorySalonDataset(salon, "train", seed=11)
        ref = J.StorySalonDataset(salon, "train", seed=11)
    else:
        root = _synth("make_synth_coco.py", str(tmp_path / "coco"),
                      "--images", "2", "--size", "32")
        ours = P.COCOMultiSegDataset(root, size=16, augment=False, seed=11)
        ref = J.COCOMultiSegDataset(root, size=16, augment=False, seed=11)
    n = 0
    dropped = np.zeros(2)
    epochs = 2000 // len(ref) + 1
    for epoch in range(epochs):
        ours._rng.set_epoch(epoch)
        ref._rng.set_epoch(epoch)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a["prompt"] == b["prompt"]
            assert a["ref_prompts"] == b["ref_prompts"]
            np.testing.assert_array_equal(a["ref_images"], b["ref_images"])
            dropped += [a["prompt"] == "",
                        not np.asarray(a["ref_images"]).any()]
            n += 1
    for got, rate in zip(dropped / n, (0.05, 0.1)):
        assert abs(got - rate) <= 5 * np.sqrt(rate * (1 - rate) / n), got


def test_coco_datasets_equal_jax(tmp_path):
    """Train (augmented, dropout) and val (caption folder) on a synthetic
    COCO tree, two seeds."""
    root = _synth("make_synth_coco.py", str(tmp_path / "coco"), "--images",
                  "4", "--size", "64")
    # val2017 from the same images and annotations
    shutil.copytree(os.path.join(root, "train2017"),
                    os.path.join(root, "val2017"))
    for kind in ("instances", "captions"):
        shutil.copy(os.path.join(root, "annotations",
                                 f"{kind}_train2017.json"),
                    os.path.join(root, "annotations", f"{kind}_val2017.json"))
    caps = tmp_path / "captions"
    caps.mkdir()
    (caps / "000000000001.txt").write_text("a caption from the folder")
    for seed in (0, 5):
        ours = P.COCOMultiSegDataset(root, size=48, seed=seed)
        ref = J.COCOMultiSegDataset(root, size=48, seed=seed)
        for i in range(len(ref)):
            assert_samples_equal(ours[i], ref[i])
        ours = P.COCOValMultiSegDataset(root, caption_dir=str(caps), size=48,
                                        seed=seed)
        ref = J.COCOValMultiSegDataset(root, caption_dir=str(caps), size=48,
                                       seed=seed)
        for i in range(len(ref)):
            assert_samples_equal(ours[i], ref[i])
    assert ours[1]["prompt"] == "a caption from the folder"


# -------------------------------------------------------- loading, configs


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tok"))
    write_bpe_files(root, ["synthetic story frame: a red circle moves "
                           "across a gradient field"], 60)
    return root


def _as_jax_ids(batch: dict) -> dict:
    """The port's ids are int64, the JAX package's int32."""
    return {k: (v.astype(np.int32) if k.endswith("input_ids") else v)
            for k, v in batch.items()}


def test_collate_and_loader_with_a_tokenizer_equal_jax(salon, tok_dir):
    tok = Tokenizer(tok_dir)
    ours = P.StorySalonDataset(salon, "train", size=64, seed=2)
    ref = J.StorySalonDataset(salon, "train", size=64, seed=2)
    samples = [ref[i] for i in range(3)]
    got = port_loader.collate(samples, tok)
    want = jax_loader.collate(samples, tok)
    assert got["input_ids"].dtype == np.int64
    assert got["ref_input_ids"].shape == (3, 3, 77)
    assert_samples_equal(_as_jax_ids(got), want)
    # without one, prompts pass through
    assert port_loader.collate(samples)["ref_prompts"] == \
        jax_loader.collate(samples)["ref_prompts"]
    it_ours = iter(port_loader.DataLoader(ours, 2, tok, seed=4,
                                          num_threads=2))
    it_ref = iter(jax_loader.DataLoader(ref, 2, tokenizer=tok, seed=4,
                                        num_threads=1))
    for _ in range(5):  # more than an epoch: set_epoch reaches the dropout
        assert_samples_equal(_as_jax_ids(next(it_ours)), next(it_ref))
    it_ours.close()
    it_ref.close()


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yml"))), ids=os.path.basename)
def test_from_yaml_equals_jax(path):
    ours = port_configs.TrainConfig.from_yaml(path)
    ref = jax_configs.TrainConfig.from_yaml(path)
    names = {f.name for f in dataclasses.fields(ours)}
    shared = names & {f.name for f in dataclasses.fields(ref)}
    assert names - shared == set()  # every port field is a JAX field
    for name in sorted(shared):
        assert getattr(ours, name) == getattr(ref, name), name
    assert isinstance(ours.mesh_shape, tuple)
    assert ours.mesh_devices == int(np.prod(ref.mesh_shape))


def test_train_config_mesh_needs_a_device():
    with pytest.raises(ValueError, match="mesh_shape"):
        port_configs.TrainConfig(mesh_shape=(2, 0))


def test_numpy_to_pil_equals_jax():
    """Pixels equal the JAX package's, the module function's and the
    method's, on values a little either side of every half step of 1/255
    (where rounding and truncation differ) with the three channels
    distinct (where a channel swap shows)."""
    half = (np.arange(255) + 0.5) / 255
    rs = np.random.RandomState(0)
    values = np.concatenate([half - 1e-4, half + 1e-4, [0.0, 1.0],
                             rs.rand(2 * 255 * 3 - 512)])
    images = rs.permutation(values).reshape(2, 15, 17, 3).astype(np.float32)
    want = (images * 255).round().astype(np.uint8)
    assert (want != (images * 255).astype(np.uint8)).mean() > 0.3
    ref = jax_pipeline.numpy_to_pil(images)
    for ours in (port_pipeline.numpy_to_pil(images),
                 port_pipeline.StoryGenPipeline.numpy_to_pil(images)):
        assert len(ours) == len(ref) == 2
        for a, b, w in zip(ours, ref, want):
            assert a.mode == b.mode == "RGB" and a.size == b.size == (17, 15)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a), w)
