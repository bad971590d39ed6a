"""Tiny versions of the configurations for the CPU tests: the same
structure (four UNet levels, attention in three, the VAE's four levels,
CLIP's causal layers) at widths a CPU runs in seconds."""
from __future__ import annotations

import copy

from benchmark.core import Bench

UNET = {"block_out_channels": [16, 32, 32, 32], "attention_head_dim": 4,
        "norm_num_groups": 4, "cross_attention_dim": 16}
VAE = {"block_out_channels": [8, 8, 8, 8], "layers_per_block": 1,
       "norm_num_groups": 2}
TEXT = {"hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2}


def tiny(cfg: dict, px: int = 64, steps: int = 3) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["unet"].update(UNET)
    cfg["unet"]["sample_size"] = px // 8
    cfg["vae"].update(VAE)
    cfg["vae"]["sample_size"] = px
    cfg["text_encoder"].update(TEXT)
    if "sampling" in cfg:
        cfg["sampling"].update(height=px, width=px,
                               num_inference_steps=steps)
    if "training" in cfg:
        cfg["training"]["image_size"] = px
        cfg["training"]["gradient_accumulation_steps"] = 4
    return cfg


def tiny_cell(cell: str, batch: int = None):
    """(cfg, traffic) of a cell of BENCHMARK.json at tiny widths."""
    bench = Bench()
    w = bench.cell(cell)
    traffic = dict(bench.traffic(w["traffic"]))
    if batch:
        traffic["batch"] = batch
    return tiny(bench.config(w["config"])), traffic
