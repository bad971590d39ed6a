"""YOLOv7-P5 in deploy form as a PyTorch module. Counterpart of
storygen_tpu/detection/yolov7.py.

- The graph is the public yolov7.yaml layer table (`YOLOV7_P5_SPEC`, a
  data table) run by a small interpreter, NHWC at the interface as the
  rest of the port: every Conv + BN + SiLU, RepConv branch trio and
  IDetect implicit pair is folded into one conv + bias when the weights
  are imported, so the module is convs, concats, max-pools and nearest
  upsamples. The convs are `F.conv2d` (cuDNN on the card), as the JAX
  package computes them with XLA's convolution and no Pallas kernel.
- `import_yolov7_params` folds an upstream train-form state_dict (the
  official yolov7.pt, read without the upstream package by
  `load_torch_state`'s lenient unpickler) into the module's state_dict;
  `flax_to_state_dict` carries the JAX package's parameter tree (numpy
  leaves, HWIO kernels) into the same module.
- `decode_boxes` is IDetect's inference decode; `nms` is class-aware
  greedy NMS with static outputs: conf = obj x cls, best class only,
  boxes offset by class so that NMS never suppresses across classes, and
  `max_det` rows with a valid mask.
- `yolov7_person_detector` is the masking stage's person detector on the
  card (device=None), or on the CPU when asked.
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# --------------------------------------------------------------------- spec
# Canonical YOLOv7-P5 layer table (public yolov7.yaml, deploy indices).
# Entries: ('conv', from, c2, k, s) | ('mp', from) | ('up', from)
#        | ('cat', (from...)) | ('sppcspc', from, c2)
#        | ('repconv', from, c2) | ('detect', (from...))
# 'from' is the absolute producing layer index; -1 means the model input.
YOLOV7_P5_SPEC: Tuple[Tuple, ...] = (
    ('conv', -1, 32, 3, 1),    # 0
    ('conv', 0, 64, 3, 2),     # 1  P1/2
    ('conv', 1, 64, 3, 1),     # 2
    ('conv', 2, 128, 3, 2),    # 3  P2/4
    ('conv', 3, 64, 1, 1),     # 4
    ('conv', 3, 64, 1, 1),     # 5
    ('conv', 5, 64, 3, 1),     # 6
    ('conv', 6, 64, 3, 1),     # 7
    ('conv', 7, 64, 3, 1),     # 8
    ('conv', 8, 64, 3, 1),     # 9
    ('cat', (9, 7, 5, 4)),     # 10  ELAN
    ('conv', 10, 256, 1, 1),   # 11
    ('mp', 11),                # 12
    ('conv', 12, 128, 1, 1),   # 13
    ('conv', 11, 128, 1, 1),   # 14
    ('conv', 14, 128, 3, 2),   # 15
    ('cat', (15, 13)),         # 16  P3/8
    ('conv', 16, 128, 1, 1),   # 17
    ('conv', 16, 128, 1, 1),   # 18
    ('conv', 18, 128, 3, 1),   # 19
    ('conv', 19, 128, 3, 1),   # 20
    ('conv', 20, 128, 3, 1),   # 21
    ('conv', 21, 128, 3, 1),   # 22
    ('cat', (22, 20, 18, 17)),  # 23
    ('conv', 23, 512, 1, 1),   # 24
    ('mp', 24),                # 25
    ('conv', 25, 256, 1, 1),   # 26
    ('conv', 24, 256, 1, 1),   # 27
    ('conv', 27, 256, 3, 2),   # 28
    ('cat', (28, 26)),         # 29  P4/16
    ('conv', 29, 256, 1, 1),   # 30
    ('conv', 29, 256, 1, 1),   # 31
    ('conv', 31, 256, 3, 1),   # 32
    ('conv', 32, 256, 3, 1),   # 33
    ('conv', 33, 256, 3, 1),   # 34
    ('conv', 34, 256, 3, 1),   # 35
    ('cat', (35, 33, 31, 30)),  # 36
    ('conv', 36, 1024, 1, 1),  # 37
    ('mp', 37),                # 38
    ('conv', 38, 512, 1, 1),   # 39
    ('conv', 37, 512, 1, 1),   # 40
    ('conv', 40, 512, 3, 2),   # 41
    ('cat', (41, 39)),         # 42  P5/32
    ('conv', 42, 256, 1, 1),   # 43
    ('conv', 42, 256, 1, 1),   # 44
    ('conv', 44, 256, 3, 1),   # 45
    ('conv', 45, 256, 3, 1),   # 46
    ('conv', 46, 256, 3, 1),   # 47
    ('conv', 47, 256, 3, 1),   # 48
    ('cat', (48, 46, 44, 43)),  # 49
    ('conv', 49, 1024, 1, 1),  # 50
    # head
    ('sppcspc', 50, 512),      # 51
    ('conv', 51, 256, 1, 1),   # 52
    ('up', 52),                # 53
    ('conv', 37, 256, 1, 1),   # 54
    ('cat', (54, 53)),         # 55
    ('conv', 55, 256, 1, 1),   # 56
    ('conv', 55, 256, 1, 1),   # 57
    ('conv', 57, 128, 3, 1),   # 58
    ('conv', 58, 128, 3, 1),   # 59
    ('conv', 59, 128, 3, 1),   # 60
    ('conv', 60, 128, 3, 1),   # 61
    ('cat', (61, 60, 59, 58, 57, 56)),  # 62  ELAN-W
    ('conv', 62, 256, 1, 1),   # 63
    ('conv', 63, 128, 1, 1),   # 64
    ('up', 64),                # 65
    ('conv', 24, 128, 1, 1),   # 66
    ('cat', (66, 65)),         # 67
    ('conv', 67, 128, 1, 1),   # 68
    ('conv', 67, 128, 1, 1),   # 69
    ('conv', 69, 64, 3, 1),    # 70
    ('conv', 70, 64, 3, 1),    # 71
    ('conv', 71, 64, 3, 1),    # 72
    ('conv', 72, 64, 3, 1),    # 73
    ('cat', (73, 72, 71, 70, 69, 68)),  # 74
    ('conv', 74, 128, 1, 1),   # 75  P3 head
    ('mp', 75),                # 76
    ('conv', 76, 128, 1, 1),   # 77
    ('conv', 75, 128, 1, 1),   # 78
    ('conv', 78, 128, 3, 2),   # 79
    ('cat', (79, 77, 63)),     # 80
    ('conv', 80, 256, 1, 1),   # 81
    ('conv', 80, 256, 1, 1),   # 82
    ('conv', 82, 128, 3, 1),   # 83
    ('conv', 83, 128, 3, 1),   # 84
    ('conv', 84, 128, 3, 1),   # 85
    ('conv', 85, 128, 3, 1),   # 86
    ('cat', (86, 85, 84, 83, 82, 81)),  # 87
    ('conv', 87, 256, 1, 1),   # 88  P4 head
    ('mp', 88),                # 89
    ('conv', 89, 256, 1, 1),   # 90
    ('conv', 88, 256, 1, 1),   # 91
    ('conv', 91, 256, 3, 2),   # 92
    ('cat', (92, 90, 51)),     # 93
    ('conv', 93, 512, 1, 1),   # 94
    ('conv', 93, 512, 1, 1),   # 95
    ('conv', 95, 256, 3, 1),   # 96
    ('conv', 96, 256, 3, 1),   # 97
    ('conv', 97, 256, 3, 1),   # 98
    ('conv', 98, 256, 3, 1),   # 99
    ('cat', (99, 98, 97, 96, 95, 94)),  # 100
    ('conv', 100, 512, 1, 1),  # 101  P5 head
    ('repconv', 75, 256),      # 102
    ('repconv', 88, 512),      # 103
    ('repconv', 101, 1024),    # 104
    ('detect', (102, 103, 104)),  # 105
)

ANCHORS_P5 = np.array(
    [[[12, 16], [19, 36], [40, 28]],
     [[36, 75], [76, 55], [72, 146]],
     [[142, 110], [192, 243], [459, 401]]], np.float32)
STRIDES_P5 = (8, 16, 32)
# YOLOv7's BatchNorm2d eps (its models/yolo.py initialization)
BN_EPS = 1e-3
# NMS's class offset: each class's boxes are shifted into their own
# coordinate island, so boxes of different classes never overlap
CLASS_OFFSET = 7680.0


def scaled_spec(width: float) -> Tuple[Tuple, ...]:
    """Channel-scaled copy of the P5 graph (test-size variants). Widths
    are rounded to multiples of 8 with a floor of 8."""
    def s(c):
        return max(8, int(round(c * width / 8)) * 8)
    out = []
    for e in YOLOV7_P5_SPEC:
        if e[0] in ('conv', 'repconv', 'sppcspc'):
            out.append((e[0], e[1], s(e[2])) + e[3:])
        else:
            out.append(e)
    return tuple(out)


def spec_channels(spec: Sequence[Tuple]) -> Dict[int, int]:
    """Output channels of every row of `spec` (-1: the RGB input)."""
    ch = {-1: 3}
    for i, e in enumerate(spec):
        if e[0] in ('conv', 'repconv', 'sppcspc'):
            ch[i] = e[2]
        elif e[0] in ('mp', 'up'):
            ch[i] = ch[e[1]]
        elif e[0] == 'cat':
            ch[i] = sum(ch[f] for f in e[1])
    return ch


# -------------------------------------------------------------------- model
class _FusedConv(nn.Module):
    """conv + bias (+SiLU): the deploy form of upstream Conv / RepConv.
    NCHW inside the module; `weight` is OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.act = stride, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv2d(x, self.weight, self.bias, self.stride, k // 2)
        return F.silu(y) if self.act else y


class _SPPCSPC(nn.Module):
    """CSP spatial pyramid pooling, deploy-fused."""

    def __init__(self, cin: int, features: int,
                 pool_sizes: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = features  # e=0.5: hidden = 2*c2*0.5
        self.pool_sizes = pool_sizes
        self.cv1 = _FusedConv(cin, c_, 1)
        self.cv2 = _FusedConv(cin, c_, 1)
        self.cv3 = _FusedConv(c_, c_, 3)
        self.cv4 = _FusedConv(c_, c_, 1)
        self.cv5 = _FusedConv(c_ * (1 + len(pool_sizes)), c_, 1)
        self.cv6 = _FusedConv(c_, c_, 3)
        self.cv7 = _FusedConv(2 * c_, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [x1] + [F.max_pool2d(x1, k, 1, k // 2)
                        for k in self.pool_sizes]
        y1 = self.cv6(self.cv5(torch.cat(pools, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class YOLOv7(nn.Module):
    """Graph-interpreted YOLOv7 (deploy form).

    forward(x (B, H, W, 3) in [0, 1]) -> per-scale raw head maps
    [(B, ny, nx, na*(5+nc))]; decode with :func:`decode_boxes`. Parameters
    ``m{i}`` per spec row and ``m{i}_{j}`` per detect scale, as the JAX
    package's tree names them. The parameters are created empty: load an
    import (`import_yolov7_params`, `flax_to_state_dict`)."""

    def __init__(self, spec: Tuple[Tuple, ...] = YOLOV7_P5_SPEC,
                 num_classes: int = 80, num_anchors: int = 3):
        super().__init__()
        self.spec, self.num_classes = spec, num_classes
        self.num_anchors = num_anchors
        ch = spec_channels(spec)
        no = num_anchors * (5 + num_classes)
        layers = {}
        for i, e in enumerate(spec):
            if e[0] == 'conv':
                layers[f"m{i}"] = _FusedConv(ch[e[1]], e[2], e[3], e[4])
            elif e[0] == 'repconv':
                layers[f"m{i}"] = _FusedConv(ch[e[1]], e[2], 3, 1)
            elif e[0] == 'sppcspc':
                layers[f"m{i}"] = _SPPCSPC(ch[e[1]], e[2])
            elif e[0] == 'detect':
                for j, f in enumerate(e[1]):
                    layers[f"m{i}_{j}"] = _FusedConv(ch[f], no, 1, act=False)
            elif e[0] not in ('mp', 'up', 'cat'):
                raise ValueError(f"unknown spec entry {e}")
        self.layers = nn.ModuleDict(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dtype = next(self.parameters()).dtype
        saved: Dict[int, torch.Tensor] = {-1: x.permute(0, 3, 1, 2).to(dtype)}
        outs: List[torch.Tensor] = []
        for i, e in enumerate(self.spec):
            kind = e[0]
            if kind in ('conv', 'repconv', 'sppcspc'):
                y = self.layers[f"m{i}"](saved[e[1]])
            elif kind == 'mp':
                y = F.max_pool2d(saved[e[1]], 2, 2)
            elif kind == 'up':
                y = F.interpolate(saved[e[1]], scale_factor=2,
                                  mode="nearest")
            elif kind == 'cat':
                y = torch.cat([saved[f] for f in e[1]], 1)
            else:  # detect
                outs += [self.layers[f"m{i}_{j}"](saved[f]).permute(
                    0, 2, 3, 1) for j, f in enumerate(e[1])]
                continue
            saved[i] = y
        return outs


def decode_boxes(outs: Sequence[torch.Tensor], num_classes: int = 80,
                 anchors: np.ndarray = ANCHORS_P5,
                 strides: Sequence[int] = STRIDES_P5) -> torch.Tensor:
    """IDetect's inference decode: sigmoid everything; xy = (2s - 0.5 +
    grid) * stride, wh = (2s)^2 * anchor. Returns (B, total_anchors,
    5+nc) fp32 with xywh in input-pixel space."""
    na = anchors.shape[1]
    zs = []
    for i, o in enumerate(outs):
        b, ny, nx, _ = o.shape
        y = torch.sigmoid(o.reshape(b, ny, nx, na, 5 + num_classes).float())
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=o.device),
            torch.arange(nx, dtype=torch.float32, device=o.device),
            indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :]     # (ny,nx,1,2)
        anc = torch.as_tensor(anchors[i], device=o.device)[None, None]
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(strides[i])
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        zs.append(torch.cat([xy, wh, y[..., 4:]], -1)
                  .reshape(b, ny * nx * na, 5 + num_classes))
    return torch.cat(zs, 1)


# ---------------------------------------------------------------------- nms
def nms(pred: torch.Tensor, conf_thres: float = 0.25,
        iou_thres: float = 0.45, max_det: int = 300,
        class_filter: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Class-aware greedy NMS over one image's decoded predictions, with
    static outputs: conf = obj * cls, best class only, each class's boxes
    offset by CLASS_OFFSET so that classes never suppress each other.

    pred: (N, 5+nc) xywh + obj + cls. Returns (boxes_xyxy (n, 4), scores
    (n,), classes (n,), valid mask (n,)) with n = min(max_det, N), in
    descending score order; rows past the boxes that pass conf_thres (and
    the class filter) are not valid."""
    obj = pred[:, 4]
    score, cls = (pred[:, 5:] * obj[:, None]).max(-1)
    keep = score >= conf_thres
    if class_filter is not None:
        keep &= cls == class_filter
    score = torch.where(keep, score, torch.zeros_like(score))

    xy, wh = pred[:, 0:2], pred[:, 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)  # xyxy

    n = min(max_det, pred.shape[0])
    top_score, top_idx = torch.topk(score, n)
    top_boxes, top_cls = boxes[top_idx], cls[top_idx]

    ob = top_boxes + top_cls.float()[:, None] * CLASS_OFFSET
    area = (ob[:, 2] - ob[:, 0]).clamp(min=0) * \
        (ob[:, 3] - ob[:, 1]).clamp(min=0)
    lt = torch.maximum(ob[:, None, :2], ob[None, :, :2])
    rb = torch.minimum(ob[:, None, 2:], ob[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-9)
    # suppresses[i, j]: box i, kept, removes the lower-scored box j
    suppresses = torch.triu(iou > iou_thres, diagonal=1)
    alive = top_score > 0
    # the scores descend, so only the first alive.sum() boxes can suppress
    for i in range(int(alive.sum())):
        alive &= ~(suppresses[i] & alive[i])
    return top_boxes, top_score, top_cls, alive


# ------------------------------------------------------------------ letterbox
def letterbox(image: np.ndarray, new_size: int = 640,
              stride: int = 32) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize + gray (114) pad to the smallest multiple
    of `stride`. Returns (padded float image in [0, 1], scale, (pad_x,
    pad_y)). Host code (cv2)."""
    import cv2
    h, w = image.shape[:2]
    r = min(new_size / h, new_size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    ph = (-nh) % stride
    pw = (-nw) % stride
    top, left = ph // 2, pw // 2
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((nh + ph, nw + pw, 3), 114, np.uint8)
    out[top:top + nh, left:left + nw] = resized
    return out.astype(np.float32) / 255.0, r, (left, top)


# ------------------------------------------------------------------ importer
class _Stub:
    """Placeholder instance for unresolvable pickled classes."""


class _LenientUnpickler(pickle.Unpickler):
    """Unpickles a torch checkpoint whose module classes are missing by
    substituting stub classes: tensors rebuild normally, module objects
    become attribute bags to walk."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


class _LenientPickleModule:
    Unpickler = _LenientUnpickler

    @staticmethod
    def load(f, **kw):
        return _LenientUnpickler(f).load()


def _walk_state(obj, prefix, out):
    """Collect {dotted_key: tensor} from a stubbed nn.Module tree (its
    __dict__ keeps _parameters/_buffers/_modules ordered dicts)."""
    if isinstance(obj, torch.Tensor):
        out[prefix.rstrip(".")] = obj
        return
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for field in ("_parameters", "_buffers"):
        for k, v in (d.get(field) or {}).items():
            if v is not None:
                out[prefix + k] = v
    for k, v in (d.get("_modules") or {}).items():
        _walk_state(v, f"{prefix}{k}.", out)


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A flat fp32 numpy state_dict from a YOLOv7 checkpoint: a plain
    state_dict file, {'model' (or 'ema'): state_dict}, or the official
    release .pt (a pickled Model whose class definitions are not
    installed: stubbed and walked). The file is unpickled in full, so load
    only checkpoints from a trusted source."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_LenientPickleModule)
    state: Dict[str, Any] = {}
    if isinstance(obj, dict):
        cand = obj.get("model", obj.get("ema", obj))
        if isinstance(cand, dict):
            state = dict(cand)
        else:  # stubbed or real nn.Module
            _walk_state(cand, "", state)
    else:
        _walk_state(obj, "", state)
    out = {k: v.detach().float().numpy() for k, v in state.items()
           if hasattr(v, "detach")}
    if not out:
        raise ValueError(f"no tensors found in {path}")
    return out


def _fuse_conv_bn(w, bn_g, bn_b, bn_m, bn_v, eps=BN_EPS):
    """Fold BatchNorm into the preceding conv (OIHW in, OIHW out)."""
    std = np.sqrt(bn_v + eps)
    scale = bn_g / std
    return w * scale[:, None, None, None], bn_b - bn_m * scale


def import_yolov7_params(state: Dict[str, np.ndarray],
                         spec: Tuple[Tuple, ...] = YOLOV7_P5_SPEC,
                         num_classes: int = 80,
                         num_anchors: int = 3,
                         prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """Fold an upstream train-form state_dict into YOLOv7's state_dict
    (fp32, OIHW), in the JAX package's numpy arithmetic.

    Per spec row i (upstream nn.Sequential index i):
      conv:    model.i.conv.weight + model.i.bn.* -> fused weight/bias
      sppcspc: model.i.cv{1..7}.{conv,bn} -> fused
      repconv: 3x3 + padded 1x1 + identity-BN branches summed
      detect:  model.i.m.j (1x1 conv) with ImplicitA folded into the bias
               and ImplicitM scaling both
    """
    def g(k):
        key = prefix + k
        if key not in state:
            raise KeyError(f"missing {key}")
        return state[key]

    def fused(base):
        return _fuse_conv_bn(g(f"{base}.conv.weight"), g(f"{base}.bn.weight"),
                             g(f"{base}.bn.bias"),
                             g(f"{base}.bn.running_mean"),
                             g(f"{base}.bn.running_var"))

    def bn_branch(w, base):
        return _fuse_conv_bn(w, g(f"{base}.weight"), g(f"{base}.bias"),
                             g(f"{base}.running_mean"),
                             g(f"{base}.running_var"))

    convs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for i, e in enumerate(spec):
        kind = e[0]
        if kind == 'conv':
            convs[f"m{i}"] = fused(str(i))
        elif kind == 'sppcspc':
            for j in range(1, 8):
                convs[f"m{i}.cv{j}"] = fused(f"{i}.cv{j}")
        elif kind == 'repconv':
            w3, b3 = bn_branch(g(f"{i}.rbr_dense.0.weight"),
                               f"{i}.rbr_dense.1")
            w1, b1 = bn_branch(g(f"{i}.rbr_1x1.0.weight"), f"{i}.rbr_1x1.1")
            w = w3 + np.pad(w1, ((0, 0), (0, 0), (1, 1), (1, 1)))
            b = b3 + b1
            if f"{prefix}{i}.rbr_identity.weight" in state:
                cin = w3.shape[1]
                wid = np.zeros_like(w3)
                wid[np.arange(w3.shape[0]), np.arange(cin) % cin, 1, 1] = 1
                wi, bi = bn_branch(wid, f"{i}.rbr_identity")
                w, b = w + wi, b + bi
            convs[f"m{i}"] = (w, b)
        elif kind == 'detect':
            for j in range(len(e[1])):
                w = g(f"{i}.m.{j}.weight")         # (no, c, 1, 1)
                b = g(f"{i}.m.{j}.bias")
                ia = g(f"{i}.ia.{j}.implicit").reshape(-1)   # (c,)
                im = g(f"{i}.im.{j}.implicit").reshape(-1)   # (no,)
                b = b + w[:, :, 0, 0] @ ia
                w = w * im[:, None, None, None]
                b = b * im
                convs[f"m{i}_{j}"] = (w, b)
    out = {}
    for name, (w, b) in convs.items():
        out[f"layers.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w, np.float32))
        out[f"layers.{name}.bias"] = torch.from_numpy(
            np.ascontiguousarray(b, np.float32))
    return out


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's YOLOv7 variables ({"params": {"m{i}": {"kernel"
    HWIO, "bias"}, "m{i}": {"cv{j}": ...}, ...}} with numpy leaves) as
    YOLOv7's state_dict."""
    out = {}

    def walk(tree, path):
        if "kernel" in tree:
            out[f"layers.{path}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(
                    np.asarray(tree["kernel"], np.float32), (3, 2, 0, 1))))
            out[f"layers.{path}.bias"] = torch.from_numpy(
                np.asarray(tree["bias"], np.float32).copy())
            return
        for k, v in tree.items():
            walk(v, f"{path}.{k}" if path else k)

    walk(variables["params"], "")
    return out


# ------------------------------------------------------------------ adapter
def yolov7_person_detector(weights, conf: float = 0.5,
                           iou: float = 0.45, img_size: int = 640,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> Callable:
    """The masking stage's person detector: image HWC uint8 RGB -> person
    boxes [(x1, y1, x2, y2), ...] in the image's pixels, by YOLOv7 on
    `device` (None: the card; without one this raises). `weights` is a
    YOLOv7 checkpoint file (`load_torch_state`) or its folded state_dict
    (`import_yolov7_params`)."""
    from storygen_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    state = weights if isinstance(weights, dict) else import_yolov7_params(
        load_torch_state(weights))
    model = YOLOv7()
    model.load_state_dict(state, strict=True)
    model = model.to(device=dev, dtype=dtype).eval()

    @torch.no_grad()
    def detect(image: np.ndarray) -> List[Tuple[float, float, float, float]]:
        padded, r, (px, py) = letterbox(np.asarray(image), img_size)
        pred = decode_boxes(model(torch.from_numpy(padded)[None].to(dev)))
        boxes, _score, _cls, valid = (
            t.cpu().numpy() for t in nms(pred[0], conf_thres=conf,
                                         iou_thres=iou, class_filter=0))
        h, w = image.shape[:2]
        out = []
        for bx, ok in zip(boxes, valid):
            if not ok:
                continue
            x1 = min(max((bx[0] - px) / r, 0), w)
            y1 = min(max((bx[1] - py) / r, 0), h)
            x2 = min(max((bx[2] - px) / r, 0), w)
            y2 = min(max((bx[3] - py) / r, 0), h)
            if x2 > x1 and y2 > y1:
                out.append((float(x1), float(y1), float(x2), float(y2)))
        return out

    return detect
