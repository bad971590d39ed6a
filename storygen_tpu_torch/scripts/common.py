"""What the entry points share: the device flag, the tokenizer folder, a
pipeline loaded from a diffusers folder, and the timers' conv flag and
seeded full-width models."""
from __future__ import annotations

import argparse
import os

import torch

from storygen_tpu_torch.checkpoint.hf_import import load_diffusers_pretrained
from storygen_tpu_torch.configs import ConvKernels, TrainConfig
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.pipeline import StoryGenPipeline
from storygen_tpu_torch.utils.device import resolve_device


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu only "
                         "when asked)")


def add_process_flags(ap: argparse.ArgumentParser) -> None:
    """The JAX scripts' multi-process flags (parallel/multihost.py), and
    the backend."""
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (or an init method URL)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--backend", default="nccl",
                    help="torch.distributed backend: nccl (default) or gloo")


# the two conv configurations, by the name the timers' --conv takes: the
# default one, and the fused one (the JAX package's STORYGEN_HALO_FUSED=1
# STORYGEN_HALO_DOWN=1)
CONV = {"default": ConvKernels(),
        "fused": ConvKernels(fused_prologue=True, strided=True)}


def add_conv_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--conv", default="default", choices=tuple(CONV),
                    help="the convs' kernels: default (GroupNorm + SiLU, "
                         "then C; stride 2 in F.conv2d) or fused (P with "
                         "the GroupNorm + SiLU as prologue; stride 2 on D)")


def full_width_models(device, conv: str = "default") -> dict:
    """trainer.build_models's bundle: the SD-1.5 + VLCM UNet, VAE and CLIP
    text encoder at their published widths from random weights seeded 1,
    2 and 3, bf16, on `device`, their convs on CONV[conv]'s kernels (the
    weights do not depend on it), no block checkpointed."""
    from storygen_tpu_torch.training import trainer
    return trainer.build_models(
        TrainConfig(mixed_precision="bf16", seed=1, remat=False), device,
        conv=CONV[conv])


def tokenizer_folder(root: str) -> str:
    """<root>/tokenizer when there is one, else root itself."""
    sub = os.path.join(root, "tokenizer")
    return sub if os.path.isdir(sub) else root


def load_pipeline(ckpt: str, device, dtype: torch.dtype = torch.bfloat16):
    """StoryGenPipeline over a diffusers folder's models on `device` in
    `dtype`, with the folder's tokenizer."""
    dev = resolve_device(device)
    b = load_diffusers_pretrained(ckpt, dev, dtype)
    return StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"],
                            Tokenizer(tokenizer_folder(ckpt)),
                            b["scheduler_config"], device=dev)
