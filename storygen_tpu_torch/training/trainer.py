"""Training driver: `train(stage, config, dataset)` for the three stages.

Counterpart of storygen_tpu/training/trainer.py: config dump to the
logdir, trainable-subset finetuning, gradient accumulation, loss and lr
logging. The models are built at the SD-1.5 + VLCM widths with seeded
random weights (no checkpoint files ship with the repository). Trainable
parameters are kept in fp32, as the JAX package keeps its parameters, while
the models compute in bf16 under `mixed_precision="bf16"`.

Not ported yet: loading pretrained weights, checkpoint save and resume, the
validation SampleLogger, data-parallel and multi-host runs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from storygen_tpu_torch.configs import (CLIPTextConfig, ConvKernels,
                                        SchedulerConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.data.loader import batches
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.training import optim, steps
from storygen_tpu_torch.utils.device import require_on, resolve_device
from storygen_tpu_torch.utils.logging import MetricLogger


class TrainState(NamedTuple):
    step: int                           # optimizer steps taken
    trainable: Dict[str, torch.Tensor]  # the optimized parameters, by name
    optimizer: optim.AdamW
    losses: List[float]                 # per micro-step
    micro_seconds: List[float]          # wall time of each micro-step


def build_models(cfg: TrainConfig, device="cuda",
                 unet_config: UNetConfig = UNetConfig(),
                 vae_config: VAEConfig = VAEConfig(),
                 clip_config: CLIPTextConfig = CLIPTextConfig(),
                 conv: ConvKernels = ConvKernels()) -> dict:
    """UNet, VAE and CLIP text encoder with seeded random weights in the
    config's dtype, allocated on `device`, the UNet's and the VAE's convs
    on the kernels `conv` picks; the UNet checkpoints each block under
    `cfg.remat`."""
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    dev = resolve_device(device)
    # "fp16" (the reference YAMLs' AMP flag) runs in bf16
    dtype = (torch.bfloat16 if cfg.mixed_precision in ("bf16", "fp16")
             else torch.float32)

    def make(cls, seed, *args):
        with torch.device(dev):
            module = cls(*args)
        return init_random_(module.to(dtype), seed)

    unet = make(UNet2DConditionModel, cfg.seed, unet_config, conv)
    unet.gradient_checkpointing = cfg.remat
    return dict(unet=unet,
                vae=make(AutoencoderKL, cfg.seed + 1, vae_config, conv),
                text_encoder=make(CLIPTextModel, cfg.seed + 2, clip_config),
                scheduler_config=SchedulerConfig())


def to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def make_stage_step(stage: str, cfg: TrainConfig, bundle: dict,
                    dev: torch.device):
    """Freeze all but the stage's subset (kept in fp32) and build its
    optimizer and train step; returns (step_fn, optimizer)."""
    if stage not in optim.STAGE_PREDICATES:
        raise ValueError(f"unknown stage {stage!r}")
    unet, vae, clip = (bundle["unet"], bundle["vae"],
                       bundle["text_encoder"])
    for m in (vae, clip):
        m.requires_grad_(False)
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES[stage])
    for p in trainable.values():
        p.data = p.data.float()  # fp32 trained parameters
    opt = optim.AdamW(trainable, cfg)
    sched = S.make_schedule(bundle["scheduler_config"], device=dev)
    step_fn = steps.make_train_step(
        unet, vae, clip, sched, opt, stage=stage,
        num_refs=cfg.num_ref_frames, ref_noise_decay=stage != "coco",
        use_mask=stage != "coco",
        num_train_timesteps=bundle["scheduler_config"].num_train_timesteps)
    return step_fn, opt


def train(stage: str = "stage2", config: Optional[TrainConfig] = None,
          dataset=None, device=None, models_bundle: Optional[dict] = None,
          **overrides) -> TrainState:
    """Run a training stage for `train_steps` optimizer steps of
    `gradient_accumulation_steps` micro-batches each; returns the final
    TrainState.

    stage: 'stage1' | 'stage2' | 'coco'.
    dataset: len/getitem over dicts with image, mask, input_ids and, for
      the stages with refs, ref_images and ref_input_ids (numpy arrays;
      see data/loader.py).
    device: None (the card) or a torch device; the models of
      `models_bundle` must already live there.
    """
    cfg = config or TrainConfig(**overrides)
    if overrides and config is not None:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = resolve_device(device)
    os.makedirs(cfg.logdir, exist_ok=True)
    with open(os.path.join(cfg.logdir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    bundle = models_bundle or build_models(cfg, dev)
    require_on(dev, **{k: bundle[k] for k in ("unet", "vae", "text_encoder")})
    step_fn, opt = make_stage_step(stage, cfg, bundle, dev)

    logger = MetricLogger(cfg.logdir)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    it = batches(dataset, cfg.train_batch_size, seed=cfg.seed)
    ga = cfg.gradient_accumulation_steps
    losses: List[float] = []
    seconds: List[float] = []
    window, last_t, last_opt = [], time.time(), 0
    for micro in range(cfg.train_steps * ga):
        t0 = time.perf_counter()
        metrics = step_fn(to_device(next(it), dev), gen)
        losses.append(metrics["loss"].item())  # waits for the step
        seconds.append(time.perf_counter() - t0)
        window.append(losses[-1])
        if (micro + 1) % ga:
            continue
        opt_step = (micro + 1) // ga
        if opt_step % 50 == 0 or opt_step == 1:
            now = time.time()
            logger.log(opt_step, {
                "loss": sum(window) / len(window),  # mean over the window
                "lr": optim.lr_at(cfg, opt_step),
                "steps_per_sec": (opt_step - last_opt)
                / max(now - last_t, 1e-9)})
            window, last_t, last_opt = [], now, opt_step
    return TrainState(cfg.train_steps, opt.params, opt, losses, seconds)
