"""What the entry points share: the device flag, the tokenizer folder and
a pipeline loaded from a diffusers folder."""
from __future__ import annotations

import argparse
import os

import torch

from storygen_tpu_torch.checkpoint.hf_import import load_diffusers_pretrained
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
