"""The work counts (counts.py) against hand counts at small shapes and
against torch's FLOP counter over the reference at tiny widths."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import sd15_vlcm as R
from benchmark.reference.numerics import Numerics
from benchmark.tests.tiny import tiny
from benchmark.core import Bench


def test_matmul_by_hand():
    o = counts.mm(10, 3, 4)
    assert o.flops == 2 * 10 * 3 * 4
    assert o.bytes == 2 * (10 * 3 + 3 * 4 + 10 * 4)


@pytest.mark.parametrize("kind,out_hw,taps", [("s1", 8, 9), ("s2", 4, 9),
                                              ("up", 16, 4)])
def test_conv_by_hand(kind, out_hw, taps):
    o = counts.conv3x3(2, 8, 8, 5, 7, kind)
    assert o.cls == "conv"
    assert o.flops == 2 * 2 * out_hw * out_hw * 5 * 7 * taps
    assert o.bytes == 2 * (2 * 8 * 8 * 5 + 9 * 5 * 7 + 2 * out_hw ** 2 * 7)


def test_attention_by_hand():
    o = counts.attn_core(3, 2, 16, 48, 8)
    assert o.flops == 4 * 3 * 2 * 16 * 48 * 8
    assert o.exps == 3 * 2 * 16 * 48
    assert o.bytes == 2 * 3 * 2 * 8 * (2 * 16 + 2 * 48)
    b = counts.attn_backward(3, 2, 16, 48, 8, dq=True, dkv=False)
    assert b.flops == 2 * 3 * 2 * 16 * 48 * 8 * 4  # dP, dQ
    b = counts.attn_backward(3, 2, 16, 48, 8, dq=True, dkv=True)
    assert b.flops == 2 * 3 * 2 * 16 * 48 * 8 * 8  # dP, dQ, dV, dK
    assert counts.attn_backward(3, 2, 16, 48, 8, False, False) is None


def test_least_seconds_takes_the_binding_term():
    ops = [counts.Op("attn", 989e12, 0.0, 0.0),        # 1 s of operations
           counts.Op("attn", 0.0, 3.35e12 * 2, 0.0),   # 2 s of bytes
           counts.Op("attn", 1.0, 1.0, counts.PEAK_EXPS * 3)]  # 3 s of exps
    assert math.isclose(counts.least_seconds(ops), 6.0)


def tiny_cfg():
    bench = Bench()
    return tiny(bench.config("sd15-vlcm-story-infer"), px=32)


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def upsample_extra(u, rows, hw):
    """The 2x upsampling's conv as the reference computes it (9 taps on
    the 2x grid) less the phase form's 4 taps that counts.py counts."""
    ch = list(reversed(u["block_out_channels"]))
    h, extra = hw // 2 ** (len(ch) - 1), 0
    for c in ch[:-1]:
        extra += 2 * rows * (2 * h) ** 2 * c * c * 5
        h *= 2
    return extra


@pytest.mark.parametrize("consume", [False, True])
def test_unet_counts_match_the_flop_counter(consume):
    cfg = tiny_cfg()
    u = cfg["unet"]
    sd = {k: v.float() for k, v in _weights(cfg).items()}
    rows, hw, refs = 2, 8, 3
    x = torch.randn(rows, hw, hw, 4)
    text = torch.randn(rows, 77, u["cross_attention_dim"])
    t = torch.tensor([5, 700])
    ctx = None
    if consume:
        _, taps = R.unet(Numerics(), sd, u, x.repeat(refs, 1, 1, 1),
                         t.repeat(refs), text.repeat(refs, 1, 1))
        ctx = {k: v.reshape(refs, rows, *v.shape[1:]).transpose(0, 1)
               .reshape(rows, -1, v.shape[-1]) for k, v in taps.items()}
    with torch.no_grad():
        got = counted(lambda: R.unet(Numerics(), sd, u, x, t, text, ctx))
    ops = counts.unet_ops(u, rows, hw, kept=[refs] * rows if consume
                          else None, n_refs=refs)
    want = counts.flops(ops) + upsample_extra(u, rows, hw)
    assert got == pytest.approx(want, rel=1e-9)


def test_vae_and_clip_counts_match_the_flop_counter():
    cfg = tiny_cfg()
    sd = {k: v.float() for k, v in _weights(cfg).items()}
    v, c = cfg["vae"], cfg["text_encoder"]
    img = torch.rand(2, 32, 32, 3)
    with torch.no_grad():
        got = counted(lambda: R.vae_encode(Numerics(), sd, v, img))
        assert got == pytest.approx(
            counts.flops(counts.vae_encode_ops(v, 2, 32)))
        z = torch.randn(2, 4, 4, 4)
        got = counted(lambda: R.vae_decode(Numerics(), sd, v, z))
        want = counts.flops(counts.vae_decode_ops(v, 2, 32))
        ch = list(reversed(v["block_out_channels"]))
        extra = sum(2 * 2 * (2 * 4 * 2 ** i) ** 2 * co * co * 5
                    for i, co in enumerate(ch[1:]))
        assert got == pytest.approx(want + extra)
        ids = torch.randint(0, 1000, (3, 77))
        got = counted(lambda: R.clip_text(Numerics(), sd, c, ids))
        assert got == pytest.approx(counts.flops(counts.clip_ops(c, 3)))


def test_the_training_backward_adds_attn3_weight_gradients():
    u = tiny_cfg()["unet"]
    fwd = counts.flops(counts.unet_ops(u, 2, 8, kept=[3, 1], n_refs=3))
    both = counts.flops(counts.unet_ops(u, 2, 8, kept=[3, 1], n_refs=3,
                                        train=True))
    assert both > 1.5 * fwd


def test_a_full_frame_call_at_the_cells_sizes():
    """A 3-reference step at B = 4, 6B reference rows at ~0.78 TFLOP and
    3B main rows at ~1.24, is some 34 TFLOP."""
    cfg = Bench().config("sd15-vlcm-story-infer")
    u = cfg["unet"]
    step = counts.flops(counts.unet_ops(u, 24, 64) + counts.unet_ops(
        u, 12, 64, kept=[3] * 12, n_refs=3))
    assert 25e12 < step < 40e12


def _weights(cfg):
    from benchmark import program
    models = program.build(cfg, 5, "cpu", torch.float32)
    return {k: v for m in models.values() for k, v in m.state_dict().items()}
