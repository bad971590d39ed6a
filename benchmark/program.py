"""The system under test: the port's models, built from a configuration
file's sizes on the meta device and given the benchmark's seeded weights
on the run's device. The only module of the harness, with the kinds, that
imports `storygen_tpu_torch`."""
from __future__ import annotations

import torch

from benchmark import weights

# the seeds' paths of the three models' weights
UNET, VAE, TEXT = 1, 2, 3


def unet_config(cfg: dict):
    from storygen_tpu_torch.configs import UNetConfig
    u = cfg["unet"]
    keys = ("sample_size", "in_channels", "out_channels", "down_block_types",
            "up_block_types", "block_out_channels", "layers_per_block",
            "cross_attention_dim", "attention_head_dim", "norm_num_groups",
            "norm_eps", "flip_sin_to_cos", "freq_shift",
            "downsample_padding", "mid_block_type", "act_fn")
    return UNetConfig(**{k: tuple(u[k]) if isinstance(u[k], list) else u[k]
                         for k in keys})


def vae_config(cfg: dict):
    from storygen_tpu_torch.configs import VAEConfig
    v = cfg["vae"]
    keys = ("in_channels", "out_channels", "block_out_channels",
            "layers_per_block", "latent_channels", "norm_num_groups",
            "sample_size", "act_fn", "scaling_factor")
    return VAEConfig(**{k: tuple(v[k]) if isinstance(v[k], list) else v[k]
                        for k in keys})


def text_config(cfg: dict):
    from storygen_tpu_torch.configs import CLIPTextConfig
    c, tok = cfg["text_encoder"], cfg["tokenizer"]
    keys = ("vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "max_position_embeddings", "layer_norm_eps", "hidden_act")
    return CLIPTextConfig(**{k: c[k] for k in keys},
                          bos_token_id=tok["bos_id"],
                          eos_token_id=tok["eos_id"],
                          pad_token_id=tok["pad_id"])


def build(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{"unet", "vae", "text_encoder"}: the port's modules with the
    program's default ConvKernels, weights from `seed`, on `device`."""
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_config(cfg))
        vae = AutoencoderKL(vae_config(cfg))
        text = CLIPTextModel(text_config(cfg))
    models = {"unet": (unet, UNET), "vae": (vae, VAE),
              "text_encoder": (text, TEXT)}
    return {k: weights.fill(m, weights.sub_seed(seed, path), device, dtype)
            for k, (m, path) in models.items()}


def reference_weights(module_specs: dict, seed: int, device,
                      dtype=torch.bfloat16) -> dict:
    """The same weights as `build` gives the program, in float32, as one
    state dict per model: {"unet": {...}, "vae": {...}, "text_encoder":
    {...}}. `module_specs` maps each model to its [(name, shape)];
    `dtype` is the one `build` drew in."""
    paths = {"unet": UNET, "vae": VAE, "text_encoder": TEXT}
    out = {}
    for k, spec in module_specs.items():
        w = weights.make(spec, weights.sub_seed(seed, paths[k]),
                         dtype, device)
        out[k] = {n: t.float() for n, t in w.items()}
        del w
    return out
