"""The port's data tooling (storygen_tpu_torch/data_process/ but inpaint,
and scripts/build_dataset.py) against the JAX package's on the same
inputs, those of tests/test_data_process.py, test_detectors.py,
test_extract_video.py and test_caption.py: parsed cues, keyframes,
duplicate indices, masks, DTW paths, prompts, text boxes, captions and
the files written are equal. build_dataset.main runs with --device cpu on
a cv2-written video and writes the JAX script's tree; a frame that the
person detector rejects leaves the story before the caption stage."""
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

from storygen_tpu.data_process import align as J_align  # noqa: E402
from storygen_tpu.data_process import caption as J_caption  # noqa: E402
from storygen_tpu.data_process import dedup as J_dedup  # noqa: E402
from storygen_tpu.data_process import detectors as J_det  # noqa: E402
from storygen_tpu.data_process import extract as J_extract  # noqa: E402
from storygen_tpu.data_process import masking as J_masking  # noqa: E402
from storygen_tpu_torch.data_process import (align, caption, dedup,  # noqa
                                             detectors, extract, masking)
from storygen_tpu_torch.scripts import build_dataset  # noqa: E402
from tests.test_caption import tiny_blip_ckpt  # noqa: E402,F401
from tests.test_data_process import TestVTT  # noqa: E402
from tests.test_detectors import _text_image  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = Path(p).read_bytes()
    return out


def _video(path, shots=((255, 0, 0), (0, 255, 0), (0, 0, 255)), size=64,
           frames=20):
    """tests/test_extract_video.py's video: distinct colours per shot."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                        (size, size))
    if not w.isOpened():
        pytest.skip("no video codec available")
    rng = np.random.RandomState(0)
    for color in shots:
        base = np.zeros((size, size, 3), np.uint8)
        base[:] = color
        for _ in range(frames):
            w.write(np.clip(base.astype(int) + rng.randint(-5, 5, base.shape),
                            0, 255).astype(np.uint8))
    w.release()
    return path


VTT_MORE = """WEBVTT
Kind: captions

NOTE a comment

00:00:00.000 --> 00:00:01.000 align:start position:0%
<00:00:00.100><c>The</c> fox
00:00:01.000 --> 00:00:02.000
The fox
00:01:02,500 --> 00:01:04,000
found a lantern. It glowed!
"""


@pytest.mark.parametrize("text", [TestVTT.VTT, VTT_MORE])
def test_vtt_equal(text):
    assert extract.parse_vtt(text) == J_extract.parse_vtt(text)
    assert extract.clean_vtt(text) == J_extract.clean_vtt(text)
    assert extract.vtt_to_transcript(text) == J_extract.vtt_to_transcript(
        text)
    line = "a <c>b</c> <00:00:01.000>c"
    assert extract.remove_tags(line) == J_extract.remove_tags(line)


def test_keyframes_equal(tmp_path):
    path = _video(str(tmp_path / "story.avi"))
    kw = dict(threshold=18.0, stride=2, min_gap=5)
    keys = extract.diff_keyframe_indices(path, **kw)
    assert keys == J_extract.diff_keyframe_indices(path, **kw)
    assert len(keys) == 3
    for stamps in (True, False):
        got = extract.extract_keyframes(path, str(tmp_path / f"p{stamps}"),
                                        stamps)
        want = J_extract.extract_keyframes(path, str(tmp_path / f"j{stamps}"),
                                           stamps)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        assert _tree(tmp_path / f"p{stamps}") == _tree(tmp_path /
                                                       f"j{stamps}")


def test_dedup_equal(tmp_path):
    e = np.random.RandomState(0).randn(12, 5).astype(np.float32)
    e[4] = e[5] * 1.01
    e[8] = e[9] + 0.01
    for thr in (0.75, 0.5, 0.99):
        assert dedup.find_duplicates(e, thr) == J_dedup.find_duplicates(
            e, thr)
    batch = np.random.RandomState(1).rand(3, 40, 56, 3).astype(np.float32)
    np.testing.assert_array_equal(dedup.classical_embedder()(batch),
                                  J_dedup.classical_embedder()(batch))
    # tests/test_caption.py's frames: a ramp, its near-duplicate, stripes
    yy, xx = np.mgrid[0:224, 0:224]
    base = np.stack([(xx * 255 / 224)] * 3, -1).astype(np.uint8)
    other = np.stack([((yy // 28) % 2) * 255] * 3, -1).astype(np.uint8)
    frames = [base, np.clip(base + 1, 0, 255).astype(np.uint8), other]
    for side in ("p", "j"):
        (tmp_path / side).mkdir()
        for i, arr in enumerate(frames):
            Image.fromarray(arr).save(tmp_path / side / f"{i}.png")
    paths = {s: [str(tmp_path / s / f"{i}.png") for i in range(3)]
             for s in "pj"}
    got = dedup.dedup_frames(paths["p"], dedup.classical_embedder(), 0.95,
                             delete=True)
    want = J_dedup.dedup_frames(paths["j"], J_dedup.classical_embedder(),
                                0.95, delete=True)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["1.png", "2.png"]
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_default_embedder_is_classical_without_dino_cache(tmp_path,
                                                          monkeypatch):
    """Nothing is fetched: without DINO in torch.hub's cache the default
    is the classical embedder, on any device."""
    monkeypatch.setattr(torch.hub, "load", lambda *a, **k: pytest.fail(
        "torch.hub.load called without a cache"))
    torch_hub_dir = torch.hub.get_dir()
    torch.hub.set_dir(str(tmp_path))
    try:
        with pytest.raises(FileNotFoundError, match="torch.hub's cache"):
            dedup.dino_embedder()
        (tmp_path / dedup.DINO_REPO).mkdir()
        with pytest.raises(FileNotFoundError, match=dedup.DINO_WEIGHTS):
            dedup.dino_embedder(device="cpu")
        fn = dedup.default_embedder()
    finally:
        torch.hub.set_dir(torch_hub_dir)
    batch = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(fn(batch),
                                  J_dedup.classical_embedder()(batch))


def test_masking_equal(tmp_path):
    shape = (37, 53)
    boxes = [(2.5, 3.2, 10.7, 20.1), (-4, 30, 60, 40.5), (50, 0, 53, 37)]
    for pad in (0, 3):
        np.testing.assert_array_equal(
            masking.boxes_to_mask(shape, boxes, pad),
            J_masking.boxes_to_mask(shape, boxes, pad))
    assert masking.person_area_ratio(shape, boxes) == \
        J_masking.person_area_ratio(shape, boxes)
    img = _text_image()
    text = detectors.classical_text_detector()
    for person in (None, lambda im: [(0, 0, 40, 30)],
                   lambda im: [(0, 0, 320, 150)]):
        got = masking.build_frame_mask(img, person, text)
        want = J_masking.build_frame_mask(img, person, text)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)

    def person(im):  # stamped frames are dominated by a person
        return [(0, 0, 320, 200)] if im[0, 0, 0] == 255 else [(5, 5, 9, 9)]
    for side in ("p", "j"):
        d = tmp_path / side / "img"
        d.mkdir(parents=True)
        for name, stamp in (("a.png", False), ("b.png", True),
                            ("c.jpg", False), ("note.txt", False)):
            im = _text_image(text=name.upper())
            if stamp:
                im[0, 0] = 255
            if name.endswith(".txt"):
                (d / name).write_text("not a frame")
            else:
                Image.fromarray(im).save(d / name)
    got = masking.process_directory(
        str(tmp_path / "p" / "img"), str(tmp_path / "p" / "mask"), person,
        text, delete_rejected=True)
    want = J_masking.process_directory(
        str(tmp_path / "j" / "img"), str(tmp_path / "j" / "mask"), person,
        text, delete_rejected=True)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["a.png", "c.jpg"]
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_text_detector_boxes_equal():
    rs = np.random.RandomState(3)
    images = [_text_image(), _text_image(w=400, h=240, text="THE END"),
              np.full((200, 320, 3), 90, np.uint8),
              rs.randint(0, 256, (120, 160, 3)).astype(np.uint8)]
    port, ref = detectors.classical_text_detector(), \
        J_det.classical_text_detector()
    for im in images:
        assert port(im) == ref(im)
    assert port(images[0])
    assert callable(detectors.default_text_detector())


def test_align_equal():
    rs = np.random.RandomState(4)
    text = "One. Two!  Three? And four... five"
    assert align.split_sentences(text) == J_align.split_sentences(text)
    for n, m, tp in ((4, 4, 0.0), (7, 3, 0.1), (3, 6, 0.5), (1, 2, 0.1)):
        f, s = rs.randn(n, 5), rs.randn(m, 5)
        path = align.dtw_align(f, s, time_penalty=tp)
        assert path == J_align.dtw_align(f, s, time_penalty=tp)
        times = np.sort(rs.rand(n)) * 10
        assert align.dtw_align(f, s, times, tp) == J_align.dtw_align(
            f, s, times, tp)
        assert align.frames_to_sentences(path, n) == \
            J_align.frames_to_sentences(path, n)
    assert align.dtw_align(np.zeros((0, 5)), rs.randn(2, 5)) == []
    frames = [np.full((4, 4, 3), v, np.float32) for v in (0.1, 0.5, 0.9)]

    def image_embed(b):
        return b.reshape(len(b), -1)[:, :2]

    def text_embed(texts):
        return np.array([[0.1, 0.3] if "fox" in x else [0.9, 0.2]
                         for x in texts], np.float32)

    story = "The fox ran. The bear slept. the fox woke"
    for ocr in (None, lambda im: "fox" if im[0, 0, 0] > 0.4 else ""):
        assert align.align_story(frames, story, image_embed, text_embed,
                                 ocr=ocr, punctuate=str.capitalize) == \
            J_align.align_story(frames, story, image_embed, text_embed,
                                ocr=ocr, punctuate=str.capitalize)


def test_caption_equal(tmp_path):
    for ctx in ([], ["a"], ["a", "b", "c", "d"]):
        for n in (1, 3):
            assert caption.build_prompt(ctx, max_context=n) == \
                J_caption.build_prompt(ctx, max_context=n)
    for side in ("p", "j"):
        (tmp_path / side).mkdir()
        for i in range(3):
            Image.fromarray(np.full((16, 16, 3), 50 * i, np.uint8)).save(
                tmp_path / side / f"{i:05d}.png")
    prompts = {"p": [], "j": []}

    def model(side):
        def fn(img, prompt):
            prompts[side].append(prompt)
            return f" caption {len(prompts[side])} of {img.size} \n"
        return fn
    for side, mod in (("p", caption), ("j", J_caption)):
        frames = sorted(str(p) for p in (tmp_path / side).glob("*.png"))
        caps = mod.caption_story(frames, model(side),
                                 out_dir=str(tmp_path / side / "caps"),
                                 max_context=2)
        assert caps[-1] == "caption 3 of (16, 16)"
    assert prompts["p"] == prompts["j"]
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_hf_captioner_equal(tiny_blip_ckpt, monkeypatch):  # noqa: F811
    """The tiny random BLIP of tests/test_caption.py through both
    adapters on the CPU: the same greedy captions. Without a card and
    without device="cpu" the port's refuses."""
    port = caption.hf_captioner(tiny_blip_ckpt, max_new_tokens=5,
                                device="cpu")
    ref = J_caption.hf_captioner(tiny_blip_ckpt, max_new_tokens=5)
    for v in (0, 200):
        img = Image.fromarray(np.full((32, 32, 3), v, np.uint8))
        for prompt in ("the story", "a"):
            assert port(img, prompt) == ref(img, prompt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caption.hf_captioner(tiny_blip_ckpt)


def _jax_build_dataset(argv, monkeypatch):
    """scripts/build_dataset.py's main() in process, its DINO embedder
    unavailable (nothing is fetched), as without a torch.hub cache."""
    def no_dino(*a, **k):
        raise FileNotFoundError("no DINO in torch.hub's cache")
    monkeypatch.setattr(J_dedup, "dino_embedder", no_dino)
    spec = importlib.util.spec_from_file_location(
        "jax_build_dataset", REPO / "scripts" / "build_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["build_dataset.py", *argv])
    mod.main()


def _salon_video(videos):
    """tests/test_detectors.py's video: two shots with overlay text."""
    videos.mkdir()
    w = cv2.VideoWriter(str(videos / "story1.avi"),
                        cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (320, 200))
    if not w.isOpened():
        pytest.skip("no video codec available")
    rng = np.random.RandomState(0)
    for shot, color in enumerate(((120, 40, 40), (40, 120, 40))):
        base = np.full((200, 320, 3), color, np.uint8)
        cv2.putText(base, f"SCENE NUMBER {shot}", (10, 170),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (235, 235, 235), 2)
        for _ in range(20):
            w.write(np.clip(base.astype(int) + rng.randint(-4, 4, base.shape),
                            0, 255).astype(np.uint8))
    w.release()
    (videos / "story1.vtt").write_text(TestVTT.VTT)


def test_build_dataset_writes_the_jax_tree(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    videos = tmp_path / "videos"
    _salon_video(videos)
    stages = "extract,dedup,mask,align"
    for out, run in (("jax", _jax_build_dataset), ("port", None)):
        argv = ["--videos", str(videos), "--out", str(tmp_path / out),
                "--stages", stages]
        if run:
            run(argv, monkeypatch)
        else:
            build_dataset.main(argv + ["--device", "cpu"])
    logs = capsys.readouterr().out
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert any(k.startswith("mask/story1/") for k in tree)
    assert logs.count("transcript ready") == 2


def test_build_dataset_needs_a_card_unless_asked_for_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--videos", str(tmp_path), "--out", str(tmp_path / "out")]
    assert build_dataset.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dataset.main(argv)
    build_dataset.main(argv + ["--device", "cpu"])


def test_build_dataset_rejected_frame_leaves_before_captions(tmp_path,
                                                             monkeypatch):
    """A frame that the person detector rejects is deleted by the mask
    stage and is not captioned (the JAX script still passes it to the
    caption stage, which fails to open it)."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    videos = tmp_path / "videos"
    _salon_video(videos)

    def person(im):  # the second shot (green) is all person
        return [(0, 0, 320, 200)] if im[10, 10, 1] > 100 else []
    seen = []

    def captioner(ckpt, device=None):
        assert ckpt == "blip" and device == torch.device("cpu")

        def fn(img, prompt):
            seen.append(img.size)
            return "a caption"
        return fn
    monkeypatch.setattr(detectors, "default_person_detector",
                        lambda **kw: person)
    monkeypatch.setattr(caption, "hf_captioner", captioner)
    out = tmp_path / "out"
    build_dataset.main(["--videos", str(videos), "--out", str(out),
                        "--stages", "extract,mask,caption", "--caption_ckpt",
                        "blip", "--device", "cpu"])
    frames = sorted(os.listdir(out / "image_inpainted_finally_checked" /
                               "story1"))
    caps = sorted(os.listdir(out / "Text" / "Caption" / "story1"))
    masks = sorted(os.listdir(out / "mask" / "story1"))
    assert len(frames) == 1 and len(seen) == 1
    assert caps == [frames[0].replace(".png", ".txt")]
    assert masks == frames
