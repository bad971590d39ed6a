"""Port parity for the slice as a whole: one stage-2 training step of the
JAX package (`make_stage2_step`, jitted) against the port's step, fed the
same draws (recomputed here from the JAX step's
`jax.random.split(rng, 6)` keys, the ref mask through
`steps._sample_ref_mask`), with the same weights (the port's seeded random
init carried into the JAX trees by storygen_tpu/checkpoint/hf_import.py).
Loss, grad_norm and every updated attn3 parameter agree at fp32 tolerance,
for the port in both conv configurations (configs.ConvKernels: the default
and the fused one, each from the same seeded weights, against the one JAX
step). Then the port's trainer end to end on the CPU for each stage."""
import jax
import jax.numpy as jnp
import numpy as np
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
from storygen_tpu_torch.configs import (CLIPTextConfig, ConvKernels,
                                        SchedulerConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.data.loader import SyntheticStoryDataset
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.training import optim, steps, trainer
from tests.torch_port_util import assert_close, jax_params, np_tree

# the tiny widths of tests/test_training.py
UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=2, latent_channels=4)
CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8)
IMG, B, N = 64, 2, 3
# Adam's first update is g / (|g| + eps) per element, which turns a 1e-6
# relative difference of a gradient near eps into a visible one; an eps of
# 1e-4 keeps the update's sensitivity bounded, so the updated parameters
# can be held to 1e-6. The default eps is held against optax in
# test_torch_port_train_optim.py.
TRAIN = dict(gradient_accumulation_steps=1, learning_rate=1e-3,
             adam_epsilon=1e-4)


def _port_models(seed=0, conv=ConvKernels()):
    cfg = TrainConfig(mixed_precision="fp32", seed=seed)
    return trainer.build_models(cfg, "cpu", UNetConfig(**UNET),
                                VAEConfig(**VAE), CLIPTextConfig(**CLIP),
                                conv)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "image": (rs.randn(B, IMG, IMG, 3) * 0.2).astype(np.float32),
        "mask": (rs.rand(B, IMG, IMG, 1) > 0.8).astype(np.float32),
        "input_ids": rs.randint(0, 64, (B, 8)),
        "ref_images": (rs.randn(N, B, IMG, IMG, 3) * 0.2).astype(np.float32),
        "ref_input_ids": rs.randint(0, 64, (N, B, 8)),
    }


def test_stage2_step_matches_jax():
    bundle = _port_models()
    unet, vae, clip = bundle["unet"], bundle["vae"], bundle["text_encoder"]
    junet = JUNet(config=JUNetConfig(**UNET))
    jvae = JVAE(config=JVAEConfig(**VAE))
    jclip = JCLIP(config=JCLIPConfig(**CLIP))
    rng = jax.random.PRNGKey(0)
    up = jax_params(junet, unet.state_dict(), hf_import.torch_to_flax_unet,
                     jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                     jnp.zeros((1, 8, 16)))
    vp = jax_params(jvae, vae.state_dict(), hf_import.torch_to_flax_vae,
                     jnp.zeros((1, IMG, IMG, 3)), rng)
    cp = jax_params(jclip, clip.state_dict(), hf_import.torch_to_flax_clip,
                     jnp.zeros((1, 8), jnp.int32))

    # the JAX step
    tx = j_optim.make_optimizer(JTrainConfig(**TRAIN))
    j_train, j_frozen = j_optim.partition_params(
        up, j_optim.STAGE_PREDICATES["stage2"])
    step = j_steps.make_stage2_step(junet, jvae, jclip,
                                    JS.make_schedule(JSchedConfig()), tx)
    batch = _batch()
    key = jax.random.PRNGKey(7)
    new_state, metrics = jax.jit(step)(
        j_steps.init_train_state(j_train, tx),
        j_steps.FrozenBundle(j_frozen, vp, cp),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)

    # its draws, in the order the JAX step makes them
    ks = jax.random.split(key, 6)
    lat = (B, IMG // 8, IMG // 8, 4)
    draws = {
        "posterior_noise": jax.random.normal(ks[0], lat),
        "noise": jax.random.normal(ks[1], lat),
        "t": jax.random.randint(ks[2], (B,), 0, 1000),
        "ref_posterior_noise": jax.random.normal(ks[3], (N * B,) + lat[1:]),
        "ref_noise": jax.random.normal(ks[4], lat),
        "ref_mask": j_steps._sample_ref_mask(ks[5], B, N),
    }
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    merged = j_optim.merge_params(new_state.trainable, j_frozen)
    updated = jax_to_state_dict(np_tree(merged))

    # the port's step, in both conv configurations from the same weights
    fused = _port_models(conv=ConvKernels(True, True))
    for name, b in (("default", bundle), ("fused", fused)):
        trainable = optim.partition_params(b["unet"],
                                           optim.STAGE_PREDICATES["stage2"])
        opt = optim.AdamW(trainable, TrainConfig(**TRAIN))
        port_step = steps.make_train_step(
            b["unet"], b["vae"], b["text_encoder"],
            S.make_schedule(SchedulerConfig()), opt, stage="stage2")
        out = port_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.Generator().manual_seed(0), draws)

        assert_close(metrics["loss"], out["loss"], msg=f"{name} loss")
        assert_close(metrics["grad_norm"], out["grad_norm"],
                     msg=f"{name} grad_norm")
        assert len(trainable) == 16 * 5
        for k, p in trainable.items():
            assert_close(updated[k], p, atol=1e-6, rtol=1e-5,
                         msg=f"{name} {k}")


@pytest.mark.parametrize("stage", ["stage1", "stage2", "coco"])
def test_trainer_updates_only_the_stage_subset(stage, tmp_path):
    bundle = _port_models(seed=3)
    before = {f"{m}.{n}": p.detach().clone()
              for m in ("unet", "vae", "text_encoder")
              for n, p in bundle[m].named_parameters()}
    cfg = TrainConfig(logdir=str(tmp_path), train_steps=2,
                      train_batch_size=2, gradient_accumulation_steps=2,
                      learning_rate=1e-3, mixed_precision="fp32", seed=3)
    ds = SyntheticStoryDataset(3, size=IMG, seed=4, vocab_size=64,
                               max_length=8)
    state = trainer.train(stage, cfg, ds, device="cpu", models_bundle=bundle)
    assert state.step == 2 and state.optimizer.count == 2
    assert len(state.losses) == 4 and np.isfinite(state.losses).all()
    part = {"stage1": "attn1", "stage2": "attn3", "coco": "attn3"}[stage]
    for m in ("unet", "vae", "text_encoder"):
        for n, p in bundle[m].named_parameters():
            moved = not torch.equal(p.detach(), before[f"{m}.{n}"])
            assert moved == (m == "unet" and part in n), (m, n)
    assert (tmp_path / "config.json").exists()
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 1
