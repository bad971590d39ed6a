"""The work that a cell's inputs need, counted from the configuration's
shapes: operations, bytes and exponentials of every product, and the
least time the card could take for it.

Each model is walked in its execution order (the same structure as
reference/sd15_vlcm.py) into `Op`s of three classes: "attn", the UNet's
attention cores (attn1, attn2, attn3; the port's kernels F, M, L, DQ,
DKV), "conv", every 3x3 convolution of the UNet and the VAE (stride 1,
stride 2, the 2x upsampling's conv and their input gradients; the port's
C, P, D, U, UB and the library's), and "mm", every other product
(projections, 1x1 convolutions, the feed-forward, CLIP's and the VAE's
attention, which run on plain torch).

What is counted:
- a product of (M, K) by (K, N): 2 M K N operations; its bytes read each
  input once and write the output once, 2 bytes an element (bf16);
- a 3x3 convolution: 2 * 9 * Cin * Cout per output pixel; the 2x
  upsampling's conv in its phase form, 4 taps per output pixel (what the
  inputs need: each output phase is a 2x2 conv of the source);
- an attention core: 4 * Sq * Skv * d per head (q k^T and p v), Sq * Skv
  exponentials, over the kept references' spans only; its bytes q, k, v
  read and o written;
- training's backward: each product's input gradient where its input
  requires one (after the first attn3, whose parameters train), the
  weight gradient of attn3's projections, and the attention backward's
  products (dP and dQ where q needs a gradient, dV and dK where k and v
  do) with one exponential per logit; recomputation (block checkpointing,
  the attention backward's q k^T) is not counted.

`least_seconds` is max(operations / 989e12, bytes / 3.35e12, exps /
3.87e12) per op, summed: the H100 SXM's dense bf16 rate, its HBM3
bandwidth and its special-function units (132 SMs x 16 a clock x 1.83
GHz), the peaks of the repository's chip_smoke.py::bound_ms.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXPS = 132 * 16 * 1.83e9
ELEM = 2  # bytes of a bf16 element


class Op(NamedTuple):
    cls: str      # "attn" | "conv" | "mm"
    flops: float
    bytes: float
    exps: float = 0.0


def least_seconds(ops: Iterable[Op]) -> float:
    return sum(max(o.flops / PEAK_FLOPS, o.bytes / PEAK_BYTES,
                   o.exps / PEAK_EXPS) for o in ops)


def flops(ops: Iterable[Op]) -> float:
    return sum(o.flops for o in ops)


def mm(rows: float, k: int, n: int) -> Op:
    return Op("mm", 2.0 * rows * k * n, ELEM * (rows * k + k * n + rows * n))


def conv3x3(r: int, h: int, w: int, cin: int, cout: int,
            kind: str = "s1") -> Op:
    """r images of h x w x cin in; kind "s1" (SAME), "s2" (stride 2), "up"
    (nearest 2x, then SAME, in phase form)."""
    ho, wo, taps = {"s1": (h, w, 9), "s2": (h // 2, w // 2, 9),
                    "up": (2 * h, 2 * w, 4)}[kind]
    return Op("conv", 2.0 * r * ho * wo * cin * cout * taps,
              ELEM * (r * h * w * cin + 9 * cin * cout + r * ho * wo * cout))


def attn_core(r: int, heads: int, sq: int, skv: int, d: int,
              cls: str = "attn") -> Op:
    return Op(cls, 4.0 * r * heads * sq * skv * d,
              ELEM * r * heads * d * (2 * sq + 2 * skv),
              float(r) * heads * sq * skv)


def attn_backward(r: int, heads: int, sq: int, skv: int, d: int,
                  dq: bool, dkv: bool) -> Optional[Op]:
    if not (dq or dkv):
        return None
    products = 2 + 2 * dq + 4 * dkv  # dP, dQ, dV + dK
    nbytes = ELEM * r * heads * d * (
        sq * (3 + dq) + skv * (2 + 2 * dkv))  # q, o, dO (+dQ); k, v (+dK, dV)
    return Op("attn", 2.0 * r * heads * sq * skv * d * products, nbytes,
              float(r) * heads * sq * skv)


class Walk:
    """Collects forward ops and, for training, the backward ops that
    autograd needs. `grad` says whether the running activation requires a
    gradient."""

    def __init__(self, train: bool = False):
        self.train = train
        self.fwd: List[Op] = []
        self.bwd: List[Op] = []
        self.grad = False

    def op(self, o: Op, din: bool = False, dw: bool = False) -> None:
        self.fwd.append(o)
        if self.train and din:
            self.bwd.append(o)
        if self.train and dw:
            self.bwd.append(o)

    @property
    def ops(self) -> List[Op]:
        return self.fwd + self.bwd


def _resnet(wk: Walk, r, h, w, cin, cout, temb: Optional[int]):
    wk.op(conv3x3(r, h, w, cin, cout), din=wk.grad)
    if temb:
        wk.op(mm(r, temb, cout))
    wk.op(conv3x3(r, h, w, cout, cout), din=wk.grad)
    if cin != cout:
        wk.op(mm(r * h * w, cin, cout), din=wk.grad)


def _transformer(wk: Walk, r, h, w, c, heads, text_len, text_dim,
                 kept: Optional[Sequence[int]], n_refs: int):
    s, d = h * w, c // heads
    g = wk.grad
    wk.op(mm(r * s, c, c), din=g)                       # proj_in
    for _ in range(3):
        wk.op(mm(r * s, c, c), din=g)                   # attn1 q, k, v
    wk.op(attn_core(r, heads, s, s, d))
    if wk.train and g:
        wk.bwd.append(attn_backward(r, heads, s, s, d, True, True))
    wk.op(mm(r * s, c, c), din=g)                       # attn1 out
    wk.op(mm(r * s, c, c), din=g)                       # attn2 q
    for _ in range(2):
        wk.op(mm(r * text_len, text_dim, c))            # attn2 k, v
    wk.op(attn_core(r, heads, s, text_len, d))
    if wk.train and g:
        wk.bwd.append(attn_backward(r, heads, s, text_len, d, True, False))
    wk.op(mm(r * s, c, c), din=g)                       # attn2 out
    if kept is not None:
        wk.op(mm(r * s, c, c), din=g, dw=True)          # attn3 q
        for _ in range(2):
            wk.op(mm(r * n_refs * s, c, c), dw=True)    # attn3 k, v
        for k in kept:
            wk.op(attn_core(1, heads, s, k * s, d))
            if wk.train:
                wk.bwd.append(attn_backward(1, heads, s, k * s, d, True,
                                            True))
        wk.op(mm(r * s, c, c), din=True, dw=True)       # attn3 out
        wk.grad = wk.train
    g = wk.grad
    wk.op(mm(r * s, c, 8 * c), din=g)                   # ff proj
    wk.op(mm(r * s, 4 * c, c), din=g)                   # ff out
    wk.op(mm(r * s, c, c), din=g)                       # proj_out


def unet_ops(u: dict, rows: int, hw: int, text_len: int = 77,
             kept: Optional[Sequence[int]] = None, n_refs: int = 0,
             train: bool = False) -> List[Op]:
    """One UNet pass over `rows` latents of hw x hw. kept: None for the
    reference cycle (no attn3), else each row's number of kept
    references out of `n_refs` (attn3's kv is n_refs spans). train: add
    the backward that attn3's gradients need."""
    wk = Walk(train)
    ch = u["block_out_channels"]
    heads, temb = u["attention_head_dim"], 4 * ch[0]
    tdim = u["cross_attention_dim"]
    n_lay = u["layers_per_block"]
    r = rows
    wk.op(mm(r, ch[0], temb))
    wk.op(mm(r, temb, temb))
    wk.op(conv3x3(r, hw, hw, u["in_channels"], ch[0]))
    skips = [ch[0]]
    h, c = hw, ch[0]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(n_lay):
            _resnet(wk, r, h, h, c, ch[i], temb)
            c = ch[i]
            if kind == "CrossAttnDownBlock2D":
                _transformer(wk, r, h, h, c, heads, text_len, tdim, kept,
                             n_refs)
            skips.append(c)
        if i < len(ch) - 1:
            wk.op(conv3x3(r, h, h, c, c, "s2"), din=wk.grad)
            h //= 2
            skips.append(c)
    _resnet(wk, r, h, h, c, c, temb)
    _transformer(wk, r, h, h, c, heads, text_len, tdim, kept, n_refs)
    _resnet(wk, r, h, h, c, c, temb)
    rev = list(reversed(ch))
    for i, kind in enumerate(u["up_block_types"]):
        for j in range(n_lay + 1):
            cin = c + skips.pop()
            _resnet(wk, r, h, h, cin, rev[i], temb)
            c = rev[i]
            if kind == "CrossAttnUpBlock2D":
                _transformer(wk, r, h, h, c, heads, text_len, tdim, kept,
                             n_refs)
        if i < len(ch) - 1:
            wk.op(conv3x3(r, h, h, c, c, "up"), din=wk.grad)
            h *= 2
    wk.op(conv3x3(r, h, h, c, u["out_channels"]), din=wk.grad)
    return [o for o in wk.ops if o is not None]


def _vae_resnets(ops, r, h, cin, cout):
    ops.append(conv3x3(r, h, h, cin, cout))
    ops.append(conv3x3(r, h, h, cout, cout))
    if cin != cout:
        ops.append(mm(r * h * h, cin, cout))


def _vae_attention(ops, r, h, c):
    s = h * h
    ops.extend(mm(r * s, c, c) for _ in range(4))
    ops.append(attn_core(r, 1, s, s, c, cls="mm"))


def vae_encode_ops(v: dict, images: int, px: int) -> List[Op]:
    ch, n = v["block_out_channels"], v["layers_per_block"]
    ops = [conv3x3(images, px, px, v["in_channels"], ch[0])]
    h, c = px, ch[0]
    for i, co in enumerate(ch):
        for _ in range(n):
            _vae_resnets(ops, images, h, c, co)
            c = co
        if i < len(ch) - 1:
            ops.append(conv3x3(images, h, h, c, c, "s2"))
            h //= 2
    _vae_resnets(ops, images, h, c, c)
    _vae_attention(ops, images, h, c)
    _vae_resnets(ops, images, h, c, c)
    lat2 = 2 * v["latent_channels"]
    ops.append(conv3x3(images, h, h, c, lat2))
    ops.append(mm(images * h * h, lat2, lat2))
    return ops


def vae_decode_ops(v: dict, images: int, px: int) -> List[Op]:
    ch, n = list(reversed(v["block_out_channels"])), v["layers_per_block"]
    lat = v["latent_channels"]
    h = px // 2 ** (len(ch) - 1)
    ops = [mm(images * h * h, lat, lat), conv3x3(images, h, h, lat, ch[0])]
    c = ch[0]
    _vae_resnets(ops, images, h, c, c)
    _vae_attention(ops, images, h, c)
    _vae_resnets(ops, images, h, c, c)
    for i, co in enumerate(ch):
        for _ in range(n + 1):
            _vae_resnets(ops, images, h, c, co)
            c = co
        if i < len(ch) - 1:
            ops.append(conv3x3(images, h, h, c, c, "up"))
            h *= 2
    ops.append(conv3x3(images, h, h, c, v["out_channels"]))
    return ops


def clip_ops(c: dict, seqs: int, length: int = 77) -> List[Op]:
    d, f = c["hidden_size"], c["intermediate_size"]
    heads = c["num_attention_heads"]
    rows = seqs * length
    ops = []
    for _ in range(c["num_hidden_layers"]):
        ops.extend(mm(rows, d, d) for _ in range(4))
        ops.append(attn_core(seqs, heads, length, length, d // heads,
                             cls="mm"))
        ops.append(mm(rows, d, f))
        ops.append(mm(rows, f, d))
    return ops


def frame_call_ops(cfg: dict, batch: int, refs: int) -> List[Op]:
    """One story frame call of `batch` stories on `refs` references: the
    CLIP passes (empty, caption, the references' captions), the
    references' VAE encode, num_inference_steps of the reference pass and
    the main pass (3-way CFG; 2-way without references) and the decode."""
    smp = cfg["sampling"]
    px = smp["height"]
    hw = px // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    ops = clip_ops(cfg["text_encoder"], (2 + refs) * batch)
    per_step: List[Op] = []
    if refs:
        ops += vae_encode_ops(cfg["vae"], refs * batch, px)
        per_step += unet_ops(cfg["unet"], 2 * refs * batch, hw)
        per_step += unet_ops(cfg["unet"], 3 * batch, hw,
                             kept=[refs] * 3 * batch, n_refs=refs)
    else:
        per_step += unet_ops(cfg["unet"], 2 * batch, hw)
    ops += per_step * smp["num_inference_steps"]
    ops += vae_decode_ops(cfg["vae"], batch, px)
    return ops


def train_step_ops(cfg: dict, batch: int, refs: int,
                   kept: Sequence[int], px: int) -> List[Op]:
    """One stage-2 micro-step: VAE encodes of the targets and the
    references, their CLIP passes, the frozen reference pass, and the main
    pass with the backward into attn3 (`kept`: each sample's kept
    references)."""
    hw = px // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    ops = vae_encode_ops(cfg["vae"], batch * (1 + refs), px)
    ops += clip_ops(cfg["text_encoder"], batch * (1 + refs))
    ops += unet_ops(cfg["unet"], refs * batch, hw)
    ops += unet_ops(cfg["unet"], batch, hw, kept=list(kept), n_refs=refs,
                    train=True)
    return ops
