"""The port's YOLOv7 (storygen_tpu_torch/detection/yolov7.py) against the
JAX package's, at scaled_spec(0.125) and 64-128 px, fp32: one seeded
upstream train-form state_dict (tests/test_yolov7.py's torch mirror)
through both importers, the head maps and decode_boxes within 1e-4
relative, the NMS on one decoded tensor with distinct scores keeping the
same boxes in the same order, letterbox, load_torch_state of a pickled
mirror whose classes are gone, the flax converter, the detectors' chain
and the person detector on the CPU."""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.detection import yolov7 as J
from storygen_tpu_torch.detection import yolov7 as P
from tests.test_yolov7 import (TConv, TDetect, TImplicit, TorchYOLOv7,
                               TRepConv, TSPPCSPC, _randomize_bn)

WIDTH = 0.125
NC = 6
RTOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    """The mirror's seeded state_dict, folded by both importers."""
    torch.manual_seed(0)
    spec = P.scaled_spec(WIDTH)
    mirror = TorchYOLOv7(spec, NC).eval()
    _randomize_bn(mirror)
    state = {k: v.numpy() for k, v in mirror.state_dict().items()}
    jax_vars = J.import_yolov7_params(state, spec=spec, num_classes=NC)
    model = P.YOLOv7(spec, NC)
    model.load_state_dict(P.import_yolov7_params(state, spec=spec,
                                                 num_classes=NC), strict=True)
    return spec, mirror, jax_vars, model.eval()


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_importers_agree_bit_for_bit(weights):
    """The port's fold equals the JAX package's (HWIO -> OIHW), and the
    flax converter gives the same state_dict."""
    spec, _, jax_vars, model = weights
    sd = model.state_dict()
    conv = P.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jax_vars))
    assert set(conv) == set(sd)
    for k in sd:
        assert torch.equal(conv[k], sd[k]), k
    assert np.array_equal(
        np.asarray(jax_vars["params"]["m51"]["cv3"]["kernel"]),
        sd["layers.m51.cv3.weight"].permute(2, 3, 1, 0).numpy())


def test_head_maps_and_decode_match_jax(weights):
    spec, mirror, jax_vars, model = weights
    x = np.random.RandomState(1).rand(2, 128, 96, 3).astype(np.float32)
    j_maps = J.YOLOv7(spec=spec, num_classes=NC).apply(jax_vars,
                                                       jnp.asarray(x))
    with torch.no_grad():
        p_maps = model(torch.from_numpy(x))
        t_maps = mirror(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(p_maps) == 3
    for j, p, t in zip(j_maps, p_maps, t_maps):
        assert p.shape == j.shape
        assert _rel(p, j) <= RTOL
        assert _rel(p, t.permute(0, 2, 3, 1)) <= RTOL  # the train form
    j_dec = J.decode_boxes(j_maps, num_classes=NC)
    p_dec = P.decode_boxes(p_maps, num_classes=NC)
    assert p_dec.shape == j_dec.shape == (2, 3 * (16 * 12 + 8 * 6 + 4 * 3),
                                          NC + 5)
    assert _rel(p_dec, j_dec) <= RTOL


def _decoded(seed=2, n=900, nc=NC):
    """A decoded tensor with distinct scores: clustered boxes, so that
    NMS suppresses, over several classes."""
    rs = np.random.RandomState(seed)
    centres = rs.rand(12, 2) * 200
    xy = centres[rs.randint(0, 12, n)] + rs.randn(n, 2) * 6
    wh = 20 + rs.rand(n, 2) * 40
    return np.concatenate([xy, wh, rs.rand(n, 1 + nc)], 1).astype(np.float32)


@pytest.mark.parametrize("conf,iou,max_det,cls", [
    (0.25, 0.45, 300, None), (0.05, 0.3, 100, None), (0.25, 0.45, 300, 0),
    (0.0, 0.6, 1000, 2)])
def test_nms_keeps_jax_boxes_in_order(conf, iou, max_det, cls):
    pred = _decoded()
    scores = (pred[:, 5:] * pred[:, 4:5]).max(-1)
    assert len(np.unique(scores)) == len(scores)  # distinct: no tie order
    jb = J.nms_jax(jnp.asarray(pred), conf_thres=conf, iou_thres=iou,
                   max_det=max_det, class_filter=cls)
    pb = P.nms(torch.from_numpy(pred), conf_thres=conf, iou_thres=iou,
               max_det=max_det, class_filter=cls)
    jv, pv = np.asarray(jb[3]), pb[3].numpy()
    assert pb[0].shape == (min(max_det, len(pred)), 4)
    assert 0 < pv.sum() < (np.asarray(jb[1]) > 0).sum()  # some suppressed
    np.testing.assert_array_equal(pv, jv)
    for j, p in zip(jb[:3], pb[:3]):
        np.testing.assert_array_equal(p.numpy()[pv], np.asarray(j)[jv])


def test_letterbox_identical():
    rs = np.random.RandomState(3)
    for shape, size in (((100, 300, 3), 320), ((512, 512, 3), 640),
                        ((77, 51, 3), 64)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        out_p, r_p, pad_p = P.letterbox(img, size)
        out_j, r_j, pad_j = J.letterbox(img, size)
        np.testing.assert_array_equal(out_p, out_j)
        assert (r_p, pad_p) == (r_j, pad_j)


def test_load_torch_state_of_a_pickled_module(tmp_path, weights):
    """An official-release-style checkpoint: {"model": nn.Module} whose
    classes cannot be imported when it is read."""
    _, mirror, _, _ = weights
    classes = (TorchYOLOv7, TConv, TRepConv, TSPPCSPC, TDetect, TImplicit)
    homes = [c.__module__ for c in classes]
    mod = types.ModuleType("yolov7_port_ephemeral")
    sys.modules[mod.__name__] = mod
    for cls in classes:
        setattr(mod, cls.__name__, cls)
        cls.__module__ = mod.__name__
    path = str(tmp_path / "ckpt.pt")
    try:
        torch.save({"model": mirror}, path)
    finally:
        del sys.modules[mod.__name__]
        for cls, home in zip(classes, homes):
            cls.__module__ = home
    state = P.load_torch_state(path)
    want = J.load_torch_state(path)
    assert set(state) == set(want) >= set(mirror.state_dict())
    for k in want:
        np.testing.assert_array_equal(state[k], want[k])
    torch.save(mirror.state_dict(), str(tmp_path / "plain.pt"))
    plain = P.load_torch_state(str(tmp_path / "plain.pt"))
    assert all(np.array_equal(plain[k], state[k]) for k in plain)


def test_detectors_chain_without_weights():
    from storygen_tpu_torch.data_process import detectors
    assert detectors.yolov7_person_detector("/nonexistent.pt") is None
    assert detectors.yolo_person_detector("/nonexistent.pt") is None
    assert detectors.default_person_detector(
        yolo_weights="/nonexistent.pt") is None
    assert detectors.default_person_detector() is None


def test_person_detector_on_the_cpu(tmp_path):
    """yolov7_person_detector at full P5 width from a state_dict file, on
    the CPU at 64 px: boxes in the image's pixels, and a file that is not
    a YOLOv7 checkpoint gives way in the detectors' chain."""
    from chip_smoke import yolo_upstream_state
    from storygen_tpu_torch.data_process import detectors
    path = str(tmp_path / "yolov7.pt")
    state = yolo_upstream_state(P.YOLOV7_P5_SPEC, 80, 0)
    for j in range(3):  # every anchor confident of class 0
        b = state[f"model.105.m.{j}.bias"].view(3, 85)
        b[:, 4] = 8.0
        b[:, 5] = 8.0
    torch.save({"model": state}, path)
    detect = P.yolov7_person_detector(path, img_size=64, device="cpu")
    image = np.random.RandomState(5).randint(0, 256, (48, 80, 3)).astype(
        np.uint8)
    boxes = detect(image)
    assert boxes and all(0 <= x1 < x2 <= 80 and 0 <= y1 < y2 <= 48
                         for x1, y1, x2, y2 in boxes)
    torch.save({"model": {"not.a.yolo": torch.zeros(1)}}, str(
        tmp_path / "other.pt"))
    assert detectors.yolov7_person_detector(str(tmp_path / "other.pt"),
                                            device="cpu") is None
