"""Port parity: layers and the VLCM transformer block, JAX vs
storygen_tpu_torch in fp32 on the same seeded inputs and carried-over
weights (atol/rtol 1e-4)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from storygen_tpu.models import attention as JA
from storygen_tpu.models import layers as JL
from storygen_tpu_torch.models import attention as TA
from storygen_tpu_torch.models import layers as TL
from tests.torch_port_util import assert_close, load, rand, t

RNG = jax.random.PRNGKey(0)


def test_timestep_embedding():
    ts = jnp.asarray([0, 1, 45, 500, 981])
    for dim in (32, 320, 33):
        assert_close(JL.get_timestep_embedding(ts, dim),
                     TL.get_timestep_embedding(torch.tensor([0, 1, 45, 500,
                                                             981]), dim))


def test_timestep_mlp():
    x = rand(0, (3, 16))
    jm = JL.TimestepEmbedding(64)
    p = jm.init(RNG, jnp.asarray(x))
    tm = load(TL.TimestepEmbedding(16, 64), p)
    assert_close(jm.apply(p, jnp.asarray(x)), tm(t(x)))


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm(act):
    x = rand(1, (2, 8, 8, 16), 3.0) + 0.5
    jm = JL.GroupNorm(4, 1e-5, act=act)
    p = jm.init(RNG, jnp.asarray(x))
    tm = load(TL.GroupNorm(4, 16, 1e-5, act=act), p)
    assert_close(jm.apply(p, jnp.asarray(x)), tm(t(x)))


@pytest.mark.parametrize("cin,cout,temb", [(16, 16, True), (16, 32, True),
                                           (8, 8, False)])
def test_resnet_block(cin, cout, temb):
    x = rand(2, (2, 8, 8, cin))
    tv = rand(3, (2, 64)) if temb else None
    jm = JL.ResnetBlock2D(cout, groups=4)
    jt = None if tv is None else jnp.asarray(tv)
    p = jm.init(RNG, jnp.asarray(x), jt)
    tm = load(TL.ResnetBlock2D(cin, cout, 4, 1e-5, 64 if temb else None), p)
    assert_close(jm.apply(p, jnp.asarray(x), jt),
                 tm(t(x), None if tv is None else t(tv)))


def test_downsample_and_upsample():
    x = rand(4, (2, 8, 8, 16))
    jd = JL.Downsample2D(16)
    pd = jd.init(RNG, jnp.asarray(x))
    assert_close(jd.apply(pd, jnp.asarray(x)),
                 load(TL.Downsample2D(16), pd)(t(x)))
    ju = JL.Upsample2D(16)
    pu = ju.init(RNG, jnp.asarray(x))
    assert_close(ju.apply(pu, jnp.asarray(x)),
                 load(TL.Upsample2D(16), pu)(t(x)))


def test_layer_norm_and_feed_forward():
    x = rand(5, (2, 10, 16), 2.0)
    jn = JA.LayerNorm()
    pn = jn.init(RNG, jnp.asarray(x))
    assert_close(jn.apply(pn, jnp.asarray(x)),
                 load(TA.LayerNorm(16), pn)(t(x)))
    jf = JA.FeedForward(16)
    pf = jf.init(RNG, jnp.asarray(x))
    assert_close(jf.apply(pf, jnp.asarray(x)),
                 load(TA.FeedForward(16), pf)(t(x)))


@pytest.mark.parametrize("cross", [None, 24])
def test_cross_attention(cross):
    x = rand(6, (2, 20, 16))
    ctx = None if cross is None else rand(7, (2, 7, cross))
    jm = JA.CrossAttention(16, 4, 4, cross_attention_dim=cross)
    jc = None if ctx is None else jnp.asarray(ctx)
    p = jm.init(RNG, jnp.asarray(x), jc)
    tm = load(TA.CrossAttention(16, 4, 4, cross), p)
    assert_close(jm.apply(p, jnp.asarray(x), jc),
                 tm(t(x), None if ctx is None else t(ctx)))


@pytest.mark.parametrize("with_image", [False, True])
def test_transformer_2d(with_image):
    """Both cycles: the tap after attn1 and the attn2 || attn3 sum."""
    x = rand(8, (2, 4, 4, 16))
    text = rand(9, (2, 7, 24))
    img = rand(10, (2, 32, 16)) if with_image else None  # 2 refs x 16
    jm = JA.Transformer2DModel(4, 4, in_channels=16, cross_attention_dim=24,
                               norm_num_groups=4)
    p = jm.init(RNG, jnp.asarray(x), jnp.asarray(text))
    tm = load(TA.Transformer2DModel(4, 4, 16, 24, 4), p)
    ji = None if img is None else jnp.asarray(img)
    out_j, tap_j = jm.apply(p, jnp.asarray(x), jnp.asarray(text), ji)
    out_t, tap_t = tm(t(x), t(text), None if img is None else t(img))
    assert_close(out_j, out_t, msg="hidden")
    assert_close(tap_j, tap_t, msg="tap")
