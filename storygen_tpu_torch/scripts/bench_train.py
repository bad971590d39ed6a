"""Training-step throughput: the stage-2 step at 512 px, 3 refs.

  python -m storygen_tpu_torch.scripts.bench_train [--batch 4]
      [--no-remat] [--precomputed] [--stage {stage1,stage2,coco,full}]
      [--opt {fp32,8bit}] [--iters 5] [--conv fused]

The JAX package's scripts/bench_train.py: the full-width SD-1.5 + VLCM
UNet, VAE and CLIP text encoder from seeded random weights, the stage-2
step (masked MSE over 3 references, a random 1-3 of them kept) for every
--stage, which picks only the trained subset (`optim.STAGE_PREDICATES`;
"full" trains every UNet parameter). The trained subset is kept in fp32,
the frozen weights in bf16, and the UNet computes in bf16. Every step
updates the parameters (gradient_accumulation_steps 1); --opt 8bit keeps
AdamW's moments in 8 bits (training/optim8bit.py). One fixed batch from
np.random.RandomState(0): images in [-1, 1]-ish, or with --precomputed
the VAE posterior moments the step samples (the port's step applies its
CFG dropout there, which the JAX step leaves out). One untimed step, the
memory line, then --iters timed steps on generators seeded 2 + i,
synchronised after the last.

Not ported: --attn and --variant, which pick the JAX package's attention
path and forward variant: the port's product path is kernel F, and the
other variants are the attention studies (storygen_tpu_torch/studies/);
--ref-encode, which picks among XLA formulations of one batched reference
encode (STORYGEN_REF_ENCODE), of which the port has the one.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig, TrainConfig
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.scripts.bench import Marks, synchronize
from storygen_tpu_torch.scripts.common import (add_conv_flag, add_device_flag,
                                               full_width_models)
from storygen_tpu_torch.training import optim, steps
from storygen_tpu_torch.utils.device import (card_facts, facts_tag,
                                             resolve_device)

N_REFS = 3
IMG = 512


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    doc = __doc__.split("\n\n")
    ap = argparse.ArgumentParser(description=doc[0], epilog=doc[-1])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--remat", dest="remat", action="store_true",
                    default=True)
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--precomputed", action="store_true",
                    help="train from precomputed VAE latent moments")
    ap.add_argument("--stage", default="stage2",
                    choices=["stage1", "stage2", "coco", "full"],
                    help="trainable-subset predicate; 'full' trains every "
                         "UNet param")
    ap.add_argument("--opt", default="fp32", choices=["fp32", "8bit"],
                    help="Adam moment storage (8bit = optim8bit.AdamW8bit)")
    ap.add_argument("--iters", type=int, default=5)
    add_conv_flag(ap)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_batch(b: int, img: int, precomputed: bool, dtype: torch.dtype,
               vocab: int, length: int, dev) -> dict:
    """The JAX script's one batch (bench_train.py:94-120), from
    np.random.RandomState(0) in its order, its images or moments in the
    models' `dtype`."""
    r = np.random.RandomState(0)

    def floats(shape, scale):
        return torch.from_numpy(r.randn(*shape)).to(dev, dtype) * scale

    def ids(shape):
        return torch.from_numpy(r.randint(0, vocab, shape)).to(dev)

    def mask():
        return torch.from_numpy(r.rand(b, img, img, 1) > 0.8).to(
            dev, torch.float32)

    if precomputed:
        h = img // 8
        return {"latent_moments": floats((b, h, h, 8), 0.3),
                "ref_latent_moments": floats((N_REFS, b, h, h, 8), 0.3),
                "mask": mask(), "input_ids": ids((b, length)),
                "ref_input_ids": ids((N_REFS, b, length))}
    return {"image": floats((b, img, img, 3), 0.2), "mask": mask(),
            "input_ids": ids((b, length)),
            "ref_images": floats((N_REFS, b, img, img, 3), 0.2),
            "ref_input_ids": ids((N_REFS, b, length))}


def make_step(models: dict, stage: str, opt: str, dev, **config):
    """The stage-2 step over `stage`'s trainable subset of the UNet, that
    subset cast to fp32, and its optimizer (AdamW or AdamW8bit) at
    gradient_accumulation_steps 1 and TrainConfig's other defaults, or
    the fields given in `config`; the UNet keeps computing in the dtype
    its weights had. Returns (step, optimizer)."""
    unet, vae, clip = (models["unet"], models["vae"],
                       models["text_encoder"])
    for m in (vae, clip):
        m.requires_grad_(False)
    unet.compute_dtype = unet.compute_dtype or unet.conv_in.weight.dtype
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES[stage])
    for p in trainable.values():
        p.data = p.data.float()
    cfg = TrainConfig(gradient_accumulation_steps=1,
                      use_8bit_adam=opt == "8bit", **config)
    optimizer = optim.make_optimizer(cfg, trainable)
    clip_cfg = clip.config
    # the empty prompt's ids (BOS, then EOS padding), which the
    # precomputed mode's CFG dropout puts in the dropped rows
    empty = torch.full((clip_cfg.max_position_embeddings,),
                       clip_cfg.pad_token_id, dtype=torch.long)
    empty[0], empty[1] = clip_cfg.bos_token_id, clip_cfg.eos_token_id
    step = steps.make_train_step(
        unet, vae, clip, S.make_schedule(SchedulerConfig(), device=dev),
        optimizer, stage="stage2", num_refs=N_REFS, empty_ids=empty)
    return step, optimizer


def gib(n: int) -> float:
    return n / 2 ** 30


def run(models: dict, *, stage: str = "stage2", opt: str = "fp32",
        precomputed: bool = False, batch: int = 4, iters: int = 5,
        img: int = IMG, remat: bool = True, conv: str = "default",
        device=None) -> dict:
    """One untimed step, the memory line, then `iters` timed steps of the
    stage-2 step over `stage`'s subset on `models` (trainer.build_models's
    bundle on `device`; its UNet is trained in place). Prints the memory
    and summary lines; returns the summary's numbers, the losses of every
    step, each timed step's times (`Marks`) and the peak memory. `remat`
    checkpoints each UNet block."""
    dev = resolve_device(device)
    models["unet"].gradient_checkpointing = remat
    step, _ = make_step(models, stage, opt, dev)
    clip_cfg = models["text_encoder"].config
    data = make_batch(batch, img, precomputed, models["vae"].dtype,
                      clip_cfg.vocab_size, clip_cfg.max_position_embeddings,
                      dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(data, torch.Generator(device=dev).manual_seed(1))["loss"]]
    synchronize(dev)
    memory = {}
    if dev.type == "cuda":
        memory = {"allocated_gib": gib(torch.cuda.memory_allocated(dev)),
                  "peak_gib": gib(torch.cuda.max_memory_allocated(dev))}
        print(f"memory in use: {memory['allocated_gib']:.2f} GiB (peak "
              f"{memory['peak_gib']:.2f} GiB) {facts_tag(card_facts(dev))}",
              flush=True)
    t0 = time.perf_counter()
    marks = Marks(dev)
    for i in range(iters):
        g = torch.Generator(device=dev).manual_seed(2 + i)
        losses.append(step(data, g)["loss"])
        marks.mark()
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    losses = [float(x) for x in losses]
    facts = card_facts(dev)
    print(f"{stage} train step: batch {batch} remat={remat} opt={opt} "
          f"precomputed={precomputed} conv={conv}: {dt * 1e3:.1f} ms/step, "
          f"{batch / dt:.3f} samples/s/chip, loss={losses[-1]:.4f} "
          f"{facts_tag(facts)}", flush=True)
    return {"stage": stage, "opt": opt, "precomputed": precomputed,
            "batch": batch, "remat": remat, "conv": conv,
            "ms_per_step": dt * 1e3, "samples_per_sec": batch / dt,
            "losses": losses, **marks.times("step"), **memory, **facts}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    models = full_width_models(dev, args.conv)
    return run(models, stage=args.stage, opt=args.opt,
               precomputed=args.precomputed, batch=args.batch,
               iters=args.iters, remat=args.remat, conv=args.conv,
               device=dev)


if __name__ == "__main__":
    main()
