"""Port parity for the training timer, storygen_tpu_torch/scripts/
bench_train.py: its step (`make_step`, the stage-2 step over a stage's
subset) over "full", every UNet parameter, against the JAX package's
jitted `make_stage2_step` over STAGE_PREDICATES["full"], on the same
weights, batch (`make_batch`, the JAX script's RandomState(0) batch) and
draws (recomputed from the JAX step's keys): one step from images with
AdamW8bit (whose first update reads the fp32 moments, before they are
quantised) and one from precomputed moments, no row dropped, with AdamW.
Loss, grad norm and every updated parameter at tests/test_torch_port_
train_step.py's tolerance, on a two-level tiny UNet (its JAX step
compiles in about 20 s, the 8-bit one in about 40). Then the timers'
mixed precision, as both scripts run it: weights in bf16, the trained
subset ("full": the whole UNet) in fp32, the UNet computing in bf16; its
loss and gradients against the JAX step on bf16 modules, at bf16's
tolerance. Then `run` end to end on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from storygen_tpu.checkpoint import hf_import
from storygen_tpu.configs import CLIPTextConfig as JCLIPConfig
from storygen_tpu.configs import SchedulerConfig as JSchedConfig
from storygen_tpu.configs import TrainConfig as JTrainConfig
from storygen_tpu.configs import UNetConfig as JUNetConfig
from storygen_tpu.configs import VAEConfig as JVAEConfig
from storygen_tpu.diffusion import schedule as JS
from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu.training import optim as j_optim
from storygen_tpu.training import steps as j_steps
from storygen_tpu_torch.checkpoint.convert import jax_to_state_dict
from storygen_tpu_torch.configs import (CLIPTextConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.models.layers import Conv3x3, ResnetBlock2D
from storygen_tpu_torch.scripts import bench_train
from storygen_tpu_torch.training import trainer
from tests.torch_port_util import assert_close, jax_params, np_tree

# tests/test_torch_port_train_step.py's VAE and CLIP; its UNet cut to two
# levels of one resnet each (attn1-3 at the first level and the mid block)
UNET = dict(block_out_channels=(16, 32), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16, layers_per_block=1,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=2, latent_channels=4)
CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8)
IMG, B, N = 64, 2, 3
LAT = (B, IMG // 8, IMG // 8, 4)
# test_torch_port_train_step.py's learning rate and epsilon, which bound
# the first Adam update's sensitivity to the gradient's roundoff
TRAIN = dict(learning_rate=1e-3, adam_epsilon=1e-4)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_models(seed=0):
    return trainer.build_models(TrainConfig(mixed_precision="fp32",
                                            seed=seed), "cpu",
                                UNetConfig(**UNET), VAEConfig(**VAE),
                                CLIPTextConfig(**CLIP))


# two jitted JAX steps in fp32: AdamW8bit from images, AdamW from moments
@pytest.mark.parametrize("opt,precomputed", [("8bit", False),
                                             ("fp32", True)])
def test_bench_full_step_matches_jax(opt, precomputed):
    bundle = _port_models()
    unet, vae, clip = bundle["unet"], bundle["vae"], bundle["text_encoder"]
    junet = JUNet(config=JUNetConfig(**UNET))
    jvae = JVAE(config=JVAEConfig(**VAE))
    jclip = JCLIP(config=JCLIPConfig(**CLIP))
    up = jax_params(junet, unet.state_dict(), hf_import.torch_to_flax_unet,
                    jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                    jnp.zeros((1, 8, 16)))
    vp = jax_params(jvae, vae.state_dict(), hf_import.torch_to_flax_vae,
                    jnp.zeros((1, IMG, IMG, 3)), jax.random.PRNGKey(0))
    cp = jax_params(jclip, clip.state_dict(), hf_import.torch_to_flax_clip,
                    jnp.zeros((1, 8), jnp.int32))
    batch = bench_train.make_batch(B, IMG, precomputed, torch.float32, 64, 8,
                                   "cpu")

    # the JAX script's step: stage 2's over the "full" subset
    tx = j_optim.make_optimizer(JTrainConfig(
        gradient_accumulation_steps=1, use_8bit_adam=opt == "8bit", **TRAIN))
    j_train, j_frozen = j_optim.partition_params(
        up, j_optim.STAGE_PREDICATES["full"])
    step = j_steps.make_stage2_step(junet, jvae, jclip,
                                    JS.make_schedule(JSchedConfig()), tx)
    key = jax.random.PRNGKey(11)
    new_state, metrics = jax.jit(step)(
        j_steps.init_train_state(j_train, tx),
        j_steps.FrozenBundle(j_frozen, vp, cp),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key)

    # its draws: the refs' posterior noise from one key per ref in the
    # precomputed mode (the JAX step's vmap), from ks[3] otherwise
    ks = jax.random.split(key, 6)
    ref_noise = (jnp.concatenate([jax.random.normal(k, LAT) for k in
                                  jax.random.split(ks[3], N)])
                 if precomputed else
                 jax.random.normal(ks[3], (N * B,) + LAT[1:]))
    draws = {"posterior_noise": jax.random.normal(ks[0], LAT),
             "noise": jax.random.normal(ks[1], LAT),
             "t": jax.random.randint(ks[2], (B,), 0, 1000),
             "ref_posterior_noise": ref_noise,
             "ref_noise": jax.random.normal(ks[4], LAT),
             "ref_mask": j_steps._sample_ref_mask(ks[5], B, N),
             "prompt_dropout": jnp.zeros((B,), bool),
             "ref_dropout": jnp.zeros((B,), bool)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    updated = jax_to_state_dict(np_tree(
        j_optim.merge_params(new_state.trainable, j_frozen)))

    port_step, optimizer = bench_train.make_step(bundle, "full", opt, "cpu",
                                                 **TRAIN)
    assert type(optimizer).__name__ == ("AdamW8bit" if opt == "8bit"
                                        else "AdamW")
    out = port_step(batch, torch.Generator().manual_seed(0), draws)
    assert_close(metrics["loss"], out["loss"], msg="loss")
    assert_close(metrics["grad_norm"], out["grad_norm"], msg="grad_norm")
    params = dict(unet.named_parameters())
    assert set(optimizer.params) == set(params)
    for k, p in params.items():
        assert p.dtype == torch.float32
        assert_close(updated[k], p, atol=1e-6, rtol=1e-5, msg=k)


# bf16 parity: the loss and the grad norm within 2e-2 of the JAX step's
# (about five bf16 roundings, 2^-8 each); the gradient's distance from the
# fp32 step's, in relative L2 (as a whole, and the worst tensor), at most
# 1.5 times the JAX bf16 step's own
BF16_LOSS, BF16_VS_JAX = 2e-2, 1.5


def test_bench_full_step_in_mixed_precision_matches_jax():
    """The timers' full step as both scripts run it: every weight rounded
    to bf16 (the port's models are bf16, the JAX script casts the VAE and
    the frozen UNet), the trained subset, "full", fp32 on both sides, the
    modules computing in bf16 (the JAX modules' dtype, the port's
    `compute_dtype`). The JAX step runs on optax.sgd(1.0), so that its
    update is minus the gradient; the port's optimizer keeps its
    gradients. Draws in the dtypes the JAX step draws them in. Both bf16
    steps' gradients are held against the port's fp32 step on the same
    rounded weights (the first test holds that step to the JAX one), and
    the port's may be off it by at most 1.5 times the JAX step's."""
    bundle, exact = _port_models(seed=2), _port_models(seed=2)
    unet, vae, clip = bundle["unet"], bundle["vae"], bundle["text_encoder"]
    for key in ("unet", "vae", "text_encoder"):
        bundle[key].to(torch.bfloat16)
        exact[key].to(torch.bfloat16).float()
    bf16 = jnp.bfloat16
    junet = JUNet(config=JUNetConfig(**UNET), dtype=bf16)
    jvae = JVAE(config=JVAEConfig(**VAE), dtype=bf16)
    jclip = JCLIP(config=JCLIPConfig(**CLIP), dtype=bf16)

    def fp32(module):
        return {k: v.float() for k, v in module.state_dict().items()}

    up = jax_params(junet, fp32(unet), hf_import.torch_to_flax_unet,
                    jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                    jnp.zeros((1, 8, 16)))
    vp = jax.tree.map(lambda x: x.astype(bf16), jax_params(
        jvae, fp32(vae), hf_import.torch_to_flax_vae,
        jnp.zeros((1, IMG, IMG, 3)), jax.random.PRNGKey(0)))
    cp = jax_params(jclip, fp32(clip), hf_import.torch_to_flax_clip,
                    jnp.zeros((1, 8), jnp.int32))
    batch = bench_train.make_batch(B, IMG, False, torch.bfloat16, 64, 8,
                                   "cpu")

    j_train, j_frozen = j_optim.partition_params(
        up, j_optim.STAGE_PREDICATES["full"])
    step = j_steps.make_stage2_step(junet, jvae, jclip,
                                    JS.make_schedule(JSchedConfig()),
                                    optax.sgd(1.0))
    key = jax.random.PRNGKey(13)
    new_state, metrics = jax.jit(step)(
        j_steps.init_train_state(j_train, optax.sgd(1.0)),
        j_steps.FrozenBundle(j_frozen, vp, cp),
        {k: jnp.asarray(v.float().numpy()).astype(bf16)
         if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
         for k, v in batch.items()}, key)
    j_grads = jax_to_state_dict(np_tree(jax.tree.map(
        lambda a, b: a - b, j_train, new_state.trainable)))

    # the posterior and noise draws in the VAE's bf16, as the JAX step
    ks = jax.random.split(key, 6)
    draws = {"posterior_noise": jax.random.normal(ks[0], LAT, bf16),
             "noise": jax.random.normal(ks[1], LAT, bf16),
             "t": jax.random.randint(ks[2], (B,), 0, 1000),
             "ref_posterior_noise": jax.random.normal(
                 ks[3], (N * B,) + LAT[1:], bf16),
             "ref_noise": jax.random.normal(ks[4], LAT, bf16),
             "ref_mask": j_steps._sample_ref_mask(ks[5], B, N),
             "prompt_dropout": jnp.zeros((B,), bool),
             "ref_dropout": jnp.zeros((B,), bool)}
    draws = {k: torch.from_numpy(np.array(
        v.astype(jnp.float32) if v.dtype == bf16 else v))
        for k, v in draws.items()}

    def grads_of(models, data):
        step, optimizer = bench_train.make_step(models, "full", "fp32",
                                                "cpu", **TRAIN)
        kept = []
        optimizer.update = kept.append
        out = step(data, torch.Generator().manual_seed(0), draws)
        return out, {k: g.float().numpy() for k, g in kept[0].items()}

    _, want = grads_of(exact, {k: v.float() if v.is_floating_point() else v
                               for k, v in batch.items()})
    port_step, optimizer = bench_train.make_step(bundle, "full", "fp32",
                                                 "cpu", **TRAIN)
    assert unet.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    assert all(p.dtype == torch.bfloat16 for m in (vae, clip)
               for p in m.parameters())
    kept, dtypes = [], set()
    optimizer.update = kept.append
    hooks = [m.register_forward_hook(
        lambda mod, args, out: dtypes.add(out.dtype))
        for m in unet.modules() if isinstance(m, (Conv3x3, ResnetBlock2D))]
    out = port_step(batch, torch.Generator().manual_seed(0), draws)
    for h in hooks:
        h.remove()
    assert dtypes == {torch.bfloat16}
    (grads,) = kept
    assert set(grads) == set(j_grads) == set(dict(unet.named_parameters()))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    loss_j, norm_j = float(metrics["loss"]), float(metrics["grad_norm"])
    assert abs(float(out["loss"]) - loss_j) <= BF16_LOSS * abs(loss_j)
    assert abs(float(out["grad_norm"]) - norm_j) <= BF16_LOSS * norm_j
    got = {k: g.float().numpy() for k, g in grads.items()}
    ref = {k: np.asarray(j_grads[k], np.float32) for k in got}
    names = [k for k in got if np.any(want[k])]

    def off(grads):
        """(relative L2 distance from the fp32 step's gradient as a whole,
        the worst tensor's)"""
        whole = rel(np.concatenate([grads[k].ravel() for k in names]),
                    np.concatenate([want[k].ravel() for k in names]))
        return whole, max(rel(grads[k], want[k]) for k in names)

    port_off, jax_off = off(got), off(ref)
    print(f"loss {float(out['loss']):.6f} / JAX {loss_j:.6f}, grad norm "
          f"{float(out['grad_norm']):.6f} / {norm_j:.6f}; off the fp32 "
          f"gradient (whole, worst tensor): port {port_off}, JAX {jax_off}")
    assert port_off[0] <= BF16_VS_JAX * jax_off[0]
    assert port_off[1] <= BF16_VS_JAX * jax_off[1]


def test_bench_train_run_on_the_cpu():
    """`run` on the CPU: the untimed step and two timed ones, 8-bit over
    "full", from precomputed moments, each timed step's host time kept;
    every UNet parameter moves and stays fp32, nothing else moves."""
    bundle = _port_models(seed=1)
    before = {f"{m}.{n}": p.detach().clone()
              for m in ("unet", "vae", "text_encoder")
              for n, p in bundle[m].named_parameters()}
    out = bench_train.run(bundle, stage="full", opt="8bit", precomputed=True,
                          batch=1, iters=2, img=IMG, device="cpu")
    assert out["device"] == "cpu" and out["ms_per_step"] > 0
    assert out["samples_per_sec"] == pytest.approx(1e3 / out["ms_per_step"])
    assert out["step_device_ms"] is None and len(out["step_host_ms"]) == 2
    assert sum(out["step_host_ms"]) == pytest.approx(
        2 * out["ms_per_step"], rel=0.05)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert bundle["unet"].gradient_checkpointing
    for m in ("unet", "vae", "text_encoder"):
        for n, p in bundle[m].named_parameters():
            moved = not torch.equal(p.detach().float(),
                                    before[f"{m}.{n}"].float())
            assert moved == (m == "unet"), (m, n)
            assert p.dtype == torch.float32
