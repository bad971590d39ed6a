"""Export the port's modules as a diffusers-layout folder.

Counterpart of storygen_tpu/checkpoint/hf_export.py and the inverse of
hf_import.py: unet/, vae/ and text_encoder/ each with its config.json and a
`torch.save` weight file (contiguous CPU tensors in the model's dtype,
diffusers names, which the port's modules carry already),
scheduler/scheduler_config.json and model_index.json, in the schemas of
the JAX package's exporter, so either package loads what the other wrote.

A module sharded by parallel/tensor.py is written whole: every rank of
its tensor group calls `save_pretrained`, the shards are gathered into
full tensors (a collective), and rank 0 alone writes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from storygen_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                        UNetConfig, VAEConfig)

# the diffusers version of the reference's pin
_DIFFUSERS_VERSION = "0.13.1"


def diffusers_unet_config(cfg: UNetConfig) -> Dict[str, Any]:
    """unet/config.json; sample_size is written in pixels."""
    return {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "act_fn": cfg.act_fn,
        "attention_head_dim": cfg.attention_head_dim,
        "block_out_channels": list(cfg.block_out_channels),
        "center_input_sample": False,
        "cross_attention_dim": cfg.cross_attention_dim,
        "down_block_types": list(cfg.down_block_types),
        "downsample_padding": cfg.downsample_padding,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": cfg.freq_shift,
        "in_channels": cfg.in_channels,
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": cfg.mid_block_scale_factor,
        "norm_eps": cfg.norm_eps,
        "norm_num_groups": cfg.norm_num_groups,
        "out_channels": cfg.out_channels,
        "sample_size": cfg.sample_size * 8,
        "up_block_types": list(cfg.up_block_types),
    }


def diffusers_vae_config(cfg: VAEConfig) -> Dict[str, Any]:
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "act_fn": cfg.act_fn,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "in_channels": cfg.in_channels,
        "latent_channels": cfg.latent_channels,
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": cfg.norm_num_groups,
        "out_channels": cfg.out_channels,
        "sample_size": cfg.sample_size,
        "scaling_factor": cfg.scaling_factor,
        "up_block_types": ["UpDecoderBlock2D"] * n,
    }


def diffusers_scheduler_config(cfg: SchedulerConfig) -> Dict[str, Any]:
    """The DDIMScheduler config the reference stack opens."""
    return {
        "_class_name": "DDIMScheduler",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "beta_end": cfg.beta_end,
        "beta_schedule": cfg.beta_schedule,
        "beta_start": cfg.beta_start,
        "clip_sample": cfg.clip_sample,
        "num_train_timesteps": cfg.num_train_timesteps,
        "prediction_type": cfg.prediction_type,
        "set_alpha_to_one": cfg.set_alpha_to_one,
        "skip_prk_steps": True,
        "steps_offset": cfg.steps_offset,
        "trained_betas": None,
    }


def transformers_clip_config(cfg: CLIPTextConfig) -> Dict[str, Any]:
    """text_encoder/config.json of a transformers CLIPTextModel."""
    return {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "attention_dropout": 0.0,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
        "hidden_act": cfg.hidden_act,
        "hidden_size": cfg.hidden_size,
        "initializer_factor": 1.0,
        "initializer_range": 0.02,
        "intermediate_size": cfg.intermediate_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "num_attention_heads": cfg.num_attention_heads,
        "num_hidden_layers": cfg.num_hidden_layers,
        "projection_dim": 768,
        "torch_dtype": "float32",
        "vocab_size": cfg.vocab_size,
    }


MODEL_INDEX = {
    "_class_name": "StableDiffusionPipeline",
    "_diffusers_version": _DIFFUSERS_VERSION,
    "scheduler": ["diffusers", "DDIMScheduler"],
    "text_encoder": ["transformers", "CLIPTextModel"],
    "tokenizer": ["transformers", "CLIPTokenizer"],
    "unet": ["diffusers", "UNet2DConditionModel"],
    "vae": ["diffusers", "AutoencoderKL"],
}


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict, a sharded module's gathered whole (a
    collective over its tensor group)."""
    state = module.state_dict()
    if getattr(module, "tp", None) is not None:
        from storygen_tpu_torch.parallel.tensor import full_tensors
        state = full_tensors(state, module.tp_plan, module.tp)
    return state


def save_weights(state: Dict[str, torch.Tensor], path: str) -> None:
    """`torch.save` of a state dict as contiguous CPU tensors in their own
    dtypes."""
    torch.save({k: v.detach().to("cpu").contiguous()
                for k, v in state.items()}, path)


def _dump(root: str, sub: str, name: str, payload: dict) -> None:
    folder = os.path.join(root, sub)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, name), "w") as f:
        json.dump(payload, f, indent=2)


def save_pretrained(root: str, unet: Optional[nn.Module] = None,
                    vae: Optional[nn.Module] = None,
                    text_encoder: Optional[nn.Module] = None,
                    scheduler_config: Optional[SchedulerConfig] = None,
                    tokenizer=None) -> None:
    """Write the folder for the modules given, each under the schema of
    its own `.config`, and tokenizer/ when the tokenizer has a
    save_pretrained of its own. Sharded modules are gathered whole first;
    then only rank 0 of a process group writes."""
    from storygen_tpu_torch.parallel.multihost import is_coordinator
    parts = [(sub, fname, module, schema, full_state_dict(module))
             for sub, fname, module, schema in (
                 ("unet", "diffusion_pytorch_model.bin", unet,
                  diffusers_unet_config),
                 ("vae", "diffusion_pytorch_model.bin", vae,
                  diffusers_vae_config),
                 ("text_encoder", "pytorch_model.bin", text_encoder,
                  transformers_clip_config)) if module is not None]
    if not is_coordinator():
        return
    for sub, fname, module, schema, state in parts:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        save_weights(state, os.path.join(root, sub, fname))
        _dump(root, sub, "config.json", schema(module.config))
    _dump(root, "scheduler", "scheduler_config.json",
          diffusers_scheduler_config(scheduler_config or SchedulerConfig()))
    _dump(root, "", "model_index.json", MODEL_INDEX)
    tok = getattr(tokenizer, "tok", tokenizer)
    if hasattr(tok, "save_pretrained"):
        tok.save_pretrained(os.path.join(root, "tokenizer"))
