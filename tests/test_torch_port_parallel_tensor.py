"""Port parity of tensor parallelism (storygen_tpu_torch/parallel/tensor.py)
against the JAX package, at the tiny widths of tests/test_tensor_parallel.py.

- The port's specs equal the JAX package's unet_param_spec / vae_param_spec
  for every parameter, JAX's Dense (in, out) and HWIO dims mapped to torch's
  (out, in) and OIHW; the one stated difference is the GEGLU projection,
  whose halves the port splits alike (Shard(0, halves=2)).
- The UNet sharded over 2 and 4 ranks (a reference pass, then the image
  cycle with 3 refs under a ref_mask; default and fused conv
  configurations) and the VAE's encode and decode, against the JAX
  package's apply on the same weights, within 1e-4 of the largest
  magnitude; each pass makes one all-reduce per row-parallel site.
- The stage-2 step on a (data 2, tensor 2) mesh with AdamW against the
  port's one-process step, a TP checkpoint that resumes bit for bit, and
  AdamW8bit's blocks under TP, whose difference from the unsharded run is
  pinned.
- A shard that would cut a GroupNorm group or an attention head raises.

The ranks run as gloo subprocesses (tests/torch_port_ranks.py)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.checkpoint import hf_import
from storygen_tpu.configs import UNetConfig as JUNetConfig
from storygen_tpu.configs import VAEConfig as JVAEConfig
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu.parallel import tensor as JT
from storygen_tpu_torch.checkpoint import convert
from storygen_tpu_torch.parallel import tensor as T
from tests import torch_port_ranks as R
from tests.torch_port_util import jax_params

# tests/test_tensor_parallel.py's widths: 4 heads, 4 groups (8 channels
# each at 32), so tensor 4 keeps one head and one group per shard
UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16)
VAE = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
           norm_num_groups=8)
REL = 1e-4
N, B, HW, TXT = 3, 2, 16, 7


def rand(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(*shape) * scale).astype(
            np.float32))


def close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, msg)


def _port_name(path, rewrites):
    name = ".".join(convert._diffusers_segments(path)
                    + (convert._LEAF_RENAME[path[-1]],))
    for pat, rep in rewrites.items():
        name = re.sub(pat, rep, name)
    return name


def _jax_dim(path, spec, ndim):
    """The sharded dim of a JAX PartitionSpec in the port's layout."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    if not dims:
        return None
    (d,) = dims
    if path[-1] != "kernel":
        return d
    return {4: {3: 0, 2: 1}, 2: {1: 0, 0: 1}}[ndim][d]


@pytest.mark.parametrize("model", ["unet", "vae"])
def test_specs_equal_jax_with_the_geglu_halves(model):
    from flax.traverse_util import flatten_dict
    if model == "unet":
        module = JUNet(config=JUNetConfig(**UNET))
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                                jnp.zeros((1, 7, 16)))
        jspec, spec, rewrites = JT.unet_param_spec, T.unet_param_spec, {}
    else:
        module = JVAE(config=JVAEConfig(**VAE))
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)),
                                jax.random.PRNGKey(0))
        jspec, spec = JT.vae_param_spec, T.vae_param_spec
        rewrites = convert.VAE_REWRITES
    port = {n: tuple(p.shape) for n, p in (
        R.tiny_unet(UNET, 0) if model == "unet" else R.tiny_vae(VAE, 0)
    ).named_parameters()}
    flat = flatten_dict(shapes["params"])
    assert len(flat) == len(port)
    halves, sharded = [], 0
    for path, leaf in flat.items():
        name = _port_name(path, rewrites)
        mine = spec(name, port[name])
        want = _jax_dim(path, jspec(path, leaf.shape), leaf.ndim)
        assert (None if mine is None else mine.dim) == want, name
        if mine is not None:
            sharded += 1
            if mine.halves != 1:
                halves.append(name)
    # the one difference: GEGLU's packed [value | gate] splits per half
    assert sorted(halves) == sorted(
        n for n in port if n.endswith(("ff.net.0.proj.weight",
                                       "ff.net.0.proj.bias")))
    assert sharded > 0 and (model == "vae") == (not halves)


@pytest.fixture(scope="module")
def unet_case():
    """Inputs, and the JAX package's reference pass and image cycle on
    the port's seeded weights."""
    unet = R.tiny_unet(UNET, 1)
    junet = JUNet(config=JUNetConfig(**UNET))
    up = jax_params(junet, unet.state_dict(), hf_import.torch_to_flax_unet,
                    jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                    jnp.zeros((1, 7, 16)))
    kw = dict(cfg=UNET, seed=1, x=rand(0, B, HW, HW, 4),
              t=torch.tensor([5, 500]), text=rand(1, B, TXT, 16),
              refs=rand(2, N, B, HW, HW, 4, scale=0.5),
              ref_t=torch.tensor([30, 20, 20, 14, 10, 7]),
              ref_text=rand(3, N, B, TXT, 16),
              ref_mask=torch.tensor([[0, 1, 1], [1, 1, 1]], dtype=torch.bool))
    j = {k: jnp.asarray(v.numpy()) for k, v in kw.items()
         if torch.is_tensor(v)}
    _, raw = jax.jit(junet.apply)(
        up, j["refs"].reshape((N * B, HW, HW, 4)), j["ref_t"],
        j["ref_text"].reshape((N * B, TXT, 16)))
    ctx = {k: v.reshape((N, B) + v.shape[1:]).transpose(1, 0, 2, 3)
           .reshape(B, N * v.shape[1], v.shape[2]) for k, v in raw.items()}
    eps, _ = jax.jit(junet.apply)(up, j["x"], j["t"], j["text"], ctx,
                                  j["ref_mask"])
    return kw, np.asarray(eps), {k: np.asarray(v) for k, v in ctx.items()}


@pytest.mark.parametrize("tensor,fused", [(2, False), (4, False),
                                          (2, True)])
def test_tp_unet_matches_jax(unet_case, tensor, fused, tmp_path):
    kw, eps, ctx = unet_case
    outs = R.run_ranks("unet_forward", tensor, tmp_path, fused=fused, **kw)
    for rank, out in enumerate(outs):
        close(out["eps"], eps, msg=f"rank {rank} eps")
        for k in ctx:
            close(out["ctx"][k], ctx[k], msg=f"rank {rank} {k}")
        # 16 transformer blocks x 3 row-parallel sites (attn1, attn2, ff)
        # + 22 resnet conv2; the image cycle adds attn3's
        assert (out["ref_reduces"], out["main_reduces"]) == (
            16 * 3 + 22, 16 * 4 + 22)


@pytest.fixture(scope="module")
def vae_case():
    vae = R.tiny_vae(VAE, 2)
    jvae = JVAE(config=JVAEConfig(**VAE))
    vp = jax_params(jvae, vae.state_dict(), hf_import.torch_to_flax_vae,
                    jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(0))
    kw = dict(cfg=VAE, seed=2, image=rand(4, 2, 64, 64, 3, scale=0.3),
              z=rand(5, 2, 8, 8, 4))
    dist = jax.jit(lambda p, x: jvae.apply(p, x, method=jvae.encode))(
        vp, jnp.asarray(kw["image"].numpy()))
    dec = jax.jit(lambda p, z: jvae.apply(p, z, method=jvae.decode))(
        vp, jnp.asarray(kw["z"].numpy()))
    return kw, {"mean": np.asarray(dist.mean),
                "logvar": np.asarray(dist.logvar), "decode": np.asarray(dec)}


@pytest.mark.parametrize("tensor", [2, 4])
def test_tp_vae_matches_jax(vae_case, tensor, tmp_path):
    kw, want = vae_case
    for rank, out in enumerate(R.run_ranks("vae_forward", tensor, tmp_path,
                                           **kw)):
        for k, v in want.items():
            close(out[k], v, msg=f"rank {rank} {k}")


def test_tp_step_matches_one_process_and_resumes(tmp_path):
    """(data 2, tensor 2), AdamW, 2 steps: loss, grad_norm and every
    updated attn3 parameter (gathered whole) against the port's one-process
    step on the same global batch and draws; a checkpoint of full tensors
    after step 1 resumes a fresh sharded run to step 2 bit for bit; and
    save_pretrained of the sharded UNet writes it whole."""
    batch, draws = R.step_inputs()
    want, _, opt = R.train_steps(batch, draws, R.STEP_TRAIN, steps=2)
    outs = R.run_ranks("tp_step", 4, tmp_path, batch=batch, draws=draws,
                       train_kw=R.STEP_TRAIN, data=2, steps=2,
                       ckpt_dir=str(tmp_path / "ckpt"))
    plan = outs[0]["plan"]
    assert any(n.endswith("attn3.to_q.weight") for n in plan)
    for rank, out in enumerate(outs):
        for m, w in zip(out["metrics"], want):
            close(m["loss"], w["loss"].detach(), rel=1e-5)
            close(m["grad_norm"], w["grad_norm"], rel=1e-5)
        for k, p in opt.params.items():
            np.testing.assert_allclose(out["params"][k].detach().numpy(),
                                       p.detach().numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"rank {rank} {k}")
            assert torch.equal(out["resumed"][k], out["params"][k]), k
    exported = torch.load(tmp_path / "ckpt" / "export" / "unet" /
                          "diffusion_pytorch_model.bin")
    whole = dict(R.step_bundle()["unet"].named_parameters())
    assert {k: v.shape for k, v in exported.items()} == {
        k: v.shape for k, v in whole.items()}
    for k in opt.params:
        assert torch.equal(exported[k], outs[0]["params"][k].detach()), k


@pytest.fixture(scope="module")
def adamw8bit_runs(tmp_path_factory):
    """Two AdamW8bit steps unsharded and on (data 1, tensor 2): the
    unsharded optimizer, the parameters before the steps and rank 0's
    result."""
    batch, draws = R.step_inputs()
    kw = dict(R.STEP_TRAIN, use_8bit_adam=True)
    _, _, opt = R.train_steps(batch, draws, kw, steps=2)
    start = dict(R.step_bundle()["unet"].named_parameters())
    out = R.run_ranks("tp_step", 2, tmp_path_factory.mktemp("adamw8bit"),
                      batch=batch, draws=draws, train_kw=kw, data=1,
                      steps=2)[0]
    return opt, start, out


def test_adamw8bit_blocks_under_tp(adamw8bit_runs):
    """AdamW8bit's 256-element blocks form on the full tensor under tensor
    parallelism, as GSPMD forms them for the JAX package, so a TP = 2 run
    moves every attn3 tensor as the unsharded run does: the row-split
    shards (to_q / to_k / to_v), the column-split ones (to_out's weight,
    whose blocks mix both ranks' elements) and the replicated biases, each
    within 1e-2 of its largest update (max |difference| / max |update|:
    the gradients differ by roundoff, which may flip a quantization
    level). At these inputs: column-split 3.9e-5 (7.45e-2 to 0.4275 when
    the blocks formed on each shard), row-split 8.4e-3, replicated
    3.9e-3."""
    opt, start, out = adamw8bit_runs
    by_split = {0: [], 1: [], None: []}
    for k, p in opt.params.items():
        upd = (p.detach() - start[k].detach()).abs().max()
        diff = (out["params"][k].detach() - p.detach()).abs().max() / upd
        shard = out["plan"].get(k)
        by_split[None if shard is None else shard.dim].append(float(diff))
    assert len(by_split[1]) == 7 and len(by_split[0]) == 21
    assert max(by_split[0] + by_split[1] + by_split[None]) <= 1e-2, by_split


def test_adamw8bit_sharded_scales_are_the_full_tensors(adamw8bit_runs):
    """After two steps, each moment of a sharded tensor carries the scales
    that the unsharded optimizer gives the full tensor: one per 256
    elements of the full tensor's flat order, each within 1e-4 of it
    (the moments differ by the gradients' fp32 roundoff under TP: 1.3e-5
    at most at these inputs)."""
    opt, _, out = adamw8bit_runs
    assert sum(k in out["plan"] for k in opt.params) == 28
    for k in opt.params:
        for got, want in zip(out["scales"][k],
                             (opt.mu[k].scale, opt.nu[k].scale)):
            assert got.shape == want.shape, k
            torch.testing.assert_close(got, want, rtol=1e-4, atol=0,
                                       msg=k)


def test_a_shard_that_cuts_a_group_or_a_head_raises():
    unet = R.tiny_unet(UNET, 0)
    # 4 groups over 8 ranks: 4 channels of the 8 of each group
    with pytest.raises(ValueError, match=r"down_blocks\.0\.resnets\.0\."
                                         r"norm2\.weight.*cuts its groups"):
        T.shard_plan(unet, T.unet_param_spec, 8)
    vae = R.tiny_vae(VAE, 0)
    assert T.shard_plan(vae, T.vae_param_spec, 8)  # 8 groups of 4: whole
    with pytest.raises(ValueError, match="cuts its groups"):
        T.shard_plan(vae, T.vae_param_spec, 16)
    # 4 heads over 8 ranks, where the groups allow it
    cfg = dict(UNET, norm_num_groups=8)
    with pytest.raises(ValueError, match=r"attn1\.to_q\.weight: 4 heads"):
        T.shard_plan(R.tiny_unet(cfg, 0), T.unet_param_spec, 8)
    # a tensor size that divides no width leaves the model replicated
    assert T.shard_plan(unet, T.unet_param_spec, 3) == {}


@pytest.mark.parametrize("tensor", [1, 2, 4, 8])
def test_g_takes_the_feed_forward_shards_up_to_tensor_4(tensor):
    """Kernel G's instantiation for each SD-1.5 feed-forward shard (inner
    1280 / 2560 / 5120 over `tensor` ranks, E unchanged), up to tensor 8:
    there the first level's N = 160 is not a multiple of 64 and takes G's
    K step of 32. The tile follows the rows per image of the level."""
    from storygen_tpu_torch.ops.geglu import geglu_tile
    for e in (320, 640, 1280):
        n = 4 * e // tensor
        tile = geglu_tile(4096 // (e // 320) ** 2, n, e)
        assert n % tile[3] == 0
        assert tile[3] == (32 if (tensor, e) == (8, 320) else 64)
