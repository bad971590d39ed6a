"""Training driver: `train(stage, config, dataset)` for the three stages.

Counterpart of storygen_tpu/training/trainer.py: config dump to the
logdir, trainable-subset finetuning, gradient accumulation, loss and lr
logging, validation renders (`SampleLogger`), checkpoints with resume, and
diffusers-folder exports. The models come from `pretrained_model_path`
when it was named and holds a diffusers folder (checkpoint/hf_import.py),
else from a seeded random init at the SD-1.5 + VLCM widths. Trainable
parameters are kept in fp32, as the JAX package keeps its parameters,
while the models compute in bf16 under `mixed_precision="bf16"`.

Every `checkpointing_steps` optimizer steps the trainer saves
`<logdir>/checkpoints/<step>` (checkpoint/torch_io.py): the micro-step
count (which is also the loader's position), the trainable tensors, the
optimizer's whole state and the generator's state; a run started on a
logdir with a checkpoint resumes from the latest one and continues the
uninterrupted run's draws and batches. Every `export_steps` (default:
the checkpointing cadence) it also writes the full pipeline folder to
`<logdir>/checkpoint_<step>`.

With `latents_path` the trainer reads precomputed VAE posterior moments
(data/datasets.py) and the step samples them, applying CFG dropout; that
mode needs the tokenizer for the empty prompt's ids. Samples with prompts
(the StorySalon and COCO datasets) are tokenized by the loader.

Data parallelism: inside a process group (parallel/multihost.py) every
rank trains a replica on its own device, on its shard of the loader at
`train_batch_size // world` samples, and the step averages the gradients
over the world (training/steps.py); the replicas start from rank 0's
weights. Logs, checkpoints, exports and validation renders are written by
rank 0 alone, and the other ranks wait for it; every rank resumes from the
same checkpoint. A `mesh_shape` that asks for more devices than the world
has is told that the run trains on what it has, as the JAX package caps
its mesh at its devices.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from storygen_tpu_torch.checkpoint import hf_export, hf_import, torch_io
from storygen_tpu_torch.configs import (DEFAULT_MODEL_PATH, CLIPTextConfig,
                                        ConvKernels, SchedulerConfig,
                                        TrainConfig, UNetConfig, VAEConfig)
from storygen_tpu_torch.data.datasets import PrecomputedLatentDataset
from storygen_tpu_torch.data.loader import DataLoader, collate
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.parallel import mesh as M
from storygen_tpu_torch.parallel import multihost
from storygen_tpu_torch.training import optim, steps
from storygen_tpu_torch.utils.device import require_on, resolve_device
from storygen_tpu_torch.utils.image import write_png
from storygen_tpu_torch.utils.logging import MetricLogger


class TrainState(NamedTuple):
    step: int                           # optimizer steps taken
    trainable: Dict[str, torch.Tensor]  # the optimized parameters, by name
    optimizer: optim.AdamW
    losses: List[float]                 # per micro-step of this run
    micro_seconds: List[float]          # wall time of each micro-step


class SampleLogger:
    """Render validation images every `validation_steps` into
    <logdir>/<subdir>/step<step>_<i>.png. The pipeline holds the live
    modules, so it renders what training has made so far."""

    def __init__(self, pipeline, logdir: str, stage: str = "auto-regressive",
                 subdir: str = "samples", num_samples_per_prompt: int = 1,
                 num_inference_steps: int = 40, guidance_scale: float = 7.0,
                 image_guidance_scale: float = 3.5,
                 height: int = 512, width: int = 512):
        self.pipeline = pipeline
        self.logdir = os.path.join(logdir, subdir)
        os.makedirs(self.logdir, exist_ok=True)
        self.stage = stage
        self.kw = dict(num_inference_steps=num_inference_steps,
                       guidance_scale=guidance_scale,
                       image_guidance_scale=image_guidance_scale,
                       height=height, width=width,
                       num_images_per_prompt=num_samples_per_prompt)

    def log_sample_images(self, batch: Dict, step: int) -> List[str]:
        """Render the collated validation batch (prompt, and ref_images
        with ref_prompts unless the stage is "no") with a generator seeded
        by the step; returns the PNG paths."""
        prompts = batch.get("prompt", ["a story illustration"])
        gen = torch.Generator(device=self.pipeline.device).manual_seed(step)
        if self.stage == "no":
            imgs = self.pipeline(stage="no", prompt=prompts, generator=gen,
                                 **self.kw)
        else:
            prev = batch.get("ref_prompts")
            if prev and isinstance(prev[0], list):  # per sample -> per ref
                prev = [[p[i] for p in prev] for i in range(len(prev[0]))]
            imgs = self.pipeline(stage=self.stage, prompt=prompts,
                                 image_prompt=np.asarray(batch["ref_images"]),
                                 prev_prompt=prev, generator=gen, **self.kw)
        paths = []
        for i, img in enumerate(imgs):
            paths.append(os.path.join(self.logdir, f"step{step}_{i}.png"))
            write_png(paths[-1], (np.asarray(img) * 255).astype(np.uint8))
        return paths


def build_models(cfg: TrainConfig, device="cuda",
                 unet_config: Optional[UNetConfig] = None,
                 vae_config: Optional[VAEConfig] = None,
                 clip_config: Optional[CLIPTextConfig] = None,
                 conv: ConvKernels = ConvKernels()) -> dict:
    """UNet, VAE and CLIP text encoder in the config's dtype on `device`,
    the UNet's and the VAE's convs on the kernels `conv` picks; the UNet
    checkpoints each block under `cfg.remat`.

    They are loaded from `cfg.pretrained_model_path` when it was named
    (not left at DEFAULT_MODEL_PATH, so a ./ckpt folder where the run
    starts changes nothing) and holds unet/; a config given here must then
    equal the folder's. Otherwise they are seeded at random with the
    configs given, the SD-1.5 + VLCM ones where none is."""
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    dev = resolve_device(device)
    # "fp16" (the reference YAMLs' AMP flag) runs in bf16
    dtype = (torch.bfloat16 if cfg.mixed_precision in ("bf16", "fp16")
             else torch.float32)
    root = cfg.pretrained_model_path
    given = dict(unet_config=unet_config, vae_config=vae_config,
                 clip_config=clip_config)
    if root and root != DEFAULT_MODEL_PATH \
            and os.path.isdir(os.path.join(root, "unet")):
        bundle = hf_import.load_diffusers_pretrained(root, dev, dtype, conv)
        for key, config in given.items():
            if config is not None and config != bundle[key]:
                raise ValueError(f"{key} {config} differs from the one in "
                                 f"{root}: {bundle[key]}")
    else:
        def make(cls, seed, *args):
            with torch.device(dev):
                module = cls(*args)
            return init_random_(module.to(dtype), seed)

        unet_config = unet_config or UNetConfig()
        vae_config = vae_config or VAEConfig()
        clip_config = clip_config or CLIPTextConfig()
        bundle = dict(
            unet=make(UNet2DConditionModel, cfg.seed, unet_config, conv),
            unet_config=unet_config,
            vae=make(AutoencoderKL, cfg.seed + 1, vae_config, conv),
            vae_config=vae_config,
            text_encoder=make(CLIPTextModel, cfg.seed + 2, clip_config),
            clip_config=clip_config, scheduler_config=SchedulerConfig())
    bundle["unet"].gradient_checkpointing = cfg.remat
    return bundle


# the stages that `train` runs, those of the JAX package's train();
# optim.STAGE_PREDICATES also names "full", every UNet parameter, which
# the JAX package's scripts/bench_train.py trains with the stage-2 step,
# as does the port's scripts/bench_train.py
STAGES = ("stage1", "stage2", "coco")

# a loaded batch (this process's rows) -> tensors on the device
to_device = multihost.host_local_batch


def make_stage_step(stage: str, cfg: TrainConfig, bundle: dict,
                    dev: torch.device,
                    empty_ids: Optional[torch.Tensor] = None,
                    mesh: Optional[M.Mesh] = None):
    """Freeze all but the stage's subset (kept in fp32) and build its
    optimizer (optim.make_optimizer) and train step; `empty_ids` are the
    empty prompt's ids for the precomputed mode's CFG dropout; `mesh` the
    data-parallel mesh. Returns (step_fn, optimizer)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    unet, vae, clip = (bundle["unet"], bundle["vae"],
                       bundle["text_encoder"])
    for m in (vae, clip):
        m.requires_grad_(False)
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES[stage])
    for p in trainable.values():
        p.data = p.data.float()  # fp32 trained parameters
    opt = optim.make_optimizer(cfg, trainable)
    sched = S.make_schedule(bundle["scheduler_config"], device=dev)
    step_fn = steps.make_train_step(
        unet, vae, clip, sched, opt, stage=stage,
        num_refs=cfg.num_ref_frames, ref_noise_decay=stage != "coco",
        use_mask=stage != "coco",
        num_train_timesteps=bundle["scheduler_config"].num_train_timesteps,
        empty_ids=empty_ids, mesh=mesh)
    return step_fn, opt


def checkpoint_dir(cfg: TrainConfig) -> str:
    return os.path.join(cfg.logdir, "checkpoints")


def train(stage: str = "stage2", config: Optional[TrainConfig] = None,
          dataset=None, device=None, models_bundle: Optional[dict] = None,
          tokenizer=None, val_dataset=None,
          sample_logger: Optional[SampleLogger] = None,
          **overrides) -> TrainState:
    """Run a training stage for `train_steps` optimizer steps of
    `gradient_accumulation_steps` micro-batches each, resuming from the
    latest checkpoint under the logdir if there is one; returns the final
    TrainState.

    stage: 'stage1' | 'stage2' | 'coco'.
    dataset: len/getitem over dicts with image, mask, input_ids (or a
      prompt) and, for the stages with refs, ref_images and ref_input_ids
      (or ref_prompts) (numpy arrays; see data/loader.py and
      data/datasets.py); None with `latents_path` set, whose .npz files
      then make the dataset.
    device: None (the card) or a torch device; the models of
      `models_bundle` must already live there.
    tokenizer: list of str -> (B, 77) ids: tokenizes the samples' prompts,
      gives the precomputed mode its empty prompt, the validation pipeline
      its tokenizer and the exports their tokenizer/ (when it has a
      save_pretrained).
    val_dataset, sample_logger: validation renders every
      `validation_steps` (a SampleLogger is made from
      `validation_sample_logger` when a tokenizer is given).
    """
    cfg = config or TrainConfig(**overrides)
    if overrides and config is not None:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = resolve_device(device)
    rank, world = M.world()
    mesh = multihost.global_mesh() if dist.is_initialized() else None
    if cfg.mesh_devices > world:
        print(f"mesh_shape {tuple(cfg.mesh_shape)} asks for "
              f"{cfg.mesh_devices} devices: this run trains on the {world} "
              f"it has", flush=True)
    if cfg.train_batch_size % world:
        raise ValueError(f"train_batch_size {cfg.train_batch_size} does not "
                         f"split over {world} ranks")
    coordinator = multihost.is_coordinator()
    if cfg.latents_path:
        if dataset is not None:
            raise ValueError("give a dataset or latents_path, not both")
        dataset = PrecomputedLatentDataset(cfg.latents_path)
    if coordinator:
        os.makedirs(cfg.logdir, exist_ok=True)
        with open(os.path.join(cfg.logdir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    bundle = models_bundle or build_models(cfg, dev)
    require_on(dev, **{k: bundle[k] for k in ("unet", "vae", "text_encoder")})
    if mesh is not None:  # every replica starts from rank 0's weights
        M.replicate([bundle[k] for k in ("unet", "vae", "text_encoder")],
                    mesh)
    empty_ids = None
    if tokenizer is not None:
        empty_ids = torch.as_tensor(np.asarray(tokenizer([""]))[0],
                                    dtype=torch.long)
    step_fn, opt = make_stage_step(stage, cfg, bundle, dev, empty_ids, mesh)

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    ckpt_dir = checkpoint_dir(cfg)
    start = 0
    latest = torch_io.latest_step(ckpt_dir)
    if latest is not None:
        saved = torch_io.restore_checkpoint(ckpt_dir, latest)
        with torch.no_grad():
            for name, p in opt.params.items():
                p.copy_(saved["trainable"][name])
        opt.load_state_dict(saved["optimizer"])
        gen.set_state(saved["generator"])
        start = int(saved["micro_step"])
        print(f"resumed from step {latest} (micro-step {start})", flush=True)

    if sample_logger is None and cfg.validation_sample_logger is not None \
            and tokenizer is not None and coordinator:
        from storygen_tpu_torch.pipeline import StoryGenPipeline
        pipe = StoryGenPipeline(bundle["unet"], bundle["vae"],
                                bundle["text_encoder"], tokenizer,
                                bundle["scheduler_config"], device=dev)
        sample_logger = SampleLogger(pipe, cfg.logdir,
                                     **cfg.validation_sample_logger)

    loader = DataLoader(dataset, cfg.train_batch_size // world, tokenizer,
                        seed=cfg.seed, num_threads=cfg.loader_threads,
                        num_shards=world, shard_id=rank, start=start)
    logger = MetricLogger(cfg.logdir) if coordinator else None
    ga = cfg.gradient_accumulation_steps
    losses: List[float] = []
    seconds: List[float] = []
    window, last_t, last_opt = [], time.time(), start // ga
    it = iter(loader)
    try:
        for micro in range(start, cfg.train_steps * ga):
            t0 = time.perf_counter()
            metrics = step_fn(to_device(next(it), dev), gen)
            losses.append(metrics["loss"].item())  # waits for the step
            seconds.append(time.perf_counter() - t0)
            window.append(losses[-1])
            if (micro + 1) % ga:
                continue
            opt_step = (micro + 1) // ga
            if (opt_step % 50 == 0 or opt_step == 1) and coordinator:
                now = time.time()
                logger.log(opt_step, {
                    "loss": sum(window) / len(window),  # the window's mean
                    "lr": optim.lr_at(cfg, opt_step),
                    "steps_per_sec": (opt_step - last_opt)
                    / max(now - last_t, 1e-9)})
                window, last_t, last_opt = [], now, opt_step
            render = (val_dataset is not None
                      and opt_step % cfg.validation_steps == 0)
            save = opt_step % cfg.checkpointing_steps == 0
            if render and sample_logger is not None and coordinator:
                vb = collate([val_dataset[opt_step % len(val_dataset)]])
                sample_logger.log_sample_images(vb, opt_step)
            if save and coordinator:
                torch_io.save_checkpoint(ckpt_dir, opt_step, {
                    "micro_step": micro + 1,
                    "trainable": opt.params,
                    "optimizer": opt.state_dict(),
                    "generator": gen.get_state()})
                if opt_step % (cfg.export_steps
                               or cfg.checkpointing_steps) == 0:
                    # the trained subset in its fp32, the rest in the
                    # compute dtype
                    hf_export.save_pretrained(
                        os.path.join(cfg.logdir, f"checkpoint_{opt_step}"),
                        unet=bundle["unet"], vae=bundle["vae"],
                        text_encoder=bundle["text_encoder"],
                        scheduler_config=bundle["scheduler_config"],
                        tokenizer=tokenizer)
            if render or save:
                multihost.barrier()  # the other ranks wait for rank 0
    finally:
        it.close()
    return TrainState(cfg.train_steps, opt.params, opt, losses, seconds)
