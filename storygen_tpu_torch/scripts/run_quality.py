"""The quality loop: train a stage-2 checkpoint, generate every held-out
StorySalon window with the auto-regressive stage, score them, and write
<root>/quality.json (or --out).

  python -m storygen_tpu_torch.scripts.run_quality --root ./quality_run \\
      --data ./synth_storysalon --config <stage-2 YAML>
  python -m storygen_tpu_torch.scripts.run_quality --skip_train \\
      --ckpt_step 50                       # reuse train/checkpoint_50
  python -m storygen_tpu_torch.scripts.run_quality --skip_train \\
      --state_step 250 --base_ckpt <folder the run started from>

1. Train (unless --skip_train finds the checkpoint): the port's
   scripts/train.py main on --config with its logdir at <root>/train and
   its dataset at --data (a synthetic corpus from make_synth_storysalon
   when the folder lacks --stories stories). The config must name a
   tokenizer that exists (`tokenizer_path`, or a `pretrained_model_path`
   with tokenizer/).
2. Generate each held-out window from its 3 ground-truth refs (DDIM-40 by
   default, guidance 7.0, image guidance 3.5), window i with the draws of
   `seeded_draws(device, i)`, from <root>/train/checkpoint_<ckpt_step>, or
   from --base_ckpt with the trainer's state <root>/train/checkpoints/
   <state_step> swapped into its UNet by name.
3. Score with a seeded random-init CLIP scorer at ViT-B/32's widths that
   the port writes (<root>/clip_scorer): CLIP-I against the ground truth,
   CLIP-T against the captions, CLIP-FID (the Frechet distance of the CLIP
   image features) and PickScore with the same folder, each as a mean, a
   distribution and per window. No real CLIP weights ship, so these are
   self-consistency numbers under the reference protocol, not absolutes.

Runs on the card unless given --device cpu. The generation tokenizer is
<ckpt>/tokenizer (or --base_ckpt's); a missing one raises. Needs PIL.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.configs import CLIPConfig
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.scripts.common import add_device_flag

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the seeded scorer's widths: CLIP ViT-B/32's, transformers' defaults
SCORER_CONFIG = CLIPConfig()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    tmp = tempfile.gettempdir()  # honours TMPDIR
    ap.add_argument("--root", default=os.path.join(tmp, "quality_run"))
    ap.add_argument("--data", default=os.path.join(tmp, "synth_storysalon"))
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "stage2_tpu_smoke.yml"))
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--num_inference_steps", type=int, default=40)
    ap.add_argument("--sampler", default="ddim",
                    choices=["ddim", "dpm++", "pndm", "lms", "euler"])
    ap.add_argument("--ref_feature_interval", type=int, default=1)
    ap.add_argument("--out", default="quality.json",
                    help="output json filename under --root")
    ap.add_argument("--stories", type=int, default=18)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--test-stories", type=int, default=4)
    ap.add_argument("--ckpt_step", type=int, default=50,
                    help="score <root>/train/checkpoint_<ckpt_step>")
    ap.add_argument("--state_step", type=int, default=None,
                    help="score the trainer's state <root>/train/"
                         "checkpoints/<state_step> on --base_ckpt")
    ap.add_argument("--base_ckpt", default=None,
                    help="the folder the run was initialised from")
    ap.add_argument("--stage", default="stage2")
    add_device_flag(ap)
    return ap.parse_args(argv)


def ensure_synth(root: str, stories: int, frames: int,
                 test_stories: int) -> None:
    """A synthetic corpus at `root` unless it holds `stories` stories."""
    from storygen_tpu_torch.scripts import make_synth_storysalon
    img_root = os.path.join(root, "image_inpainted_finally_checked")
    if os.path.isdir(img_root) and len(os.listdir(img_root)) >= stories:
        return
    make_synth_storysalon.write(root, stories, frames, 512, test_stories)


def ensure_clip(path: str, tokenizer_dir: str,
                config: CLIPConfig = SCORER_CONFIG, seed: int = 0) -> None:
    """Write a seeded random-init CLIP scorer folder at `path` unless it
    has a config.json: config.json in transformers' CLIPConfig layout, the
    weights (pytorch_model.bin), a preprocessor_config.json (shortest edge
    and crop at the tower's image size) and the tokenizer files of
    `tokenizer_dir`; the text vocabulary covers the tokenizer's ids. The
    weights are made on the CPU, so the folder does not depend on the
    device."""
    from storygen_tpu_torch.checkpoint.hf_export import save_weights
    from storygen_tpu_torch.models.clip_vision import CLIPModel
    from storygen_tpu_torch.models.init import init_random_
    if os.path.exists(os.path.join(path, "config.json")):
        return
    tok = Tokenizer(tokenizer_dir)
    vocab = max(config.text_config.vocab_size, max(tok.encoder.values()) + 1)
    config = dataclasses.replace(config, text_config=dataclasses.replace(
        config.text_config, vocab_size=vocab))
    model = CLIPModel(config)
    for part in (model.text_model, model.vision_model,
                 model.visual_projection, model.text_projection):
        init_random_(part, seed)
    with torch.no_grad():  # as transformers initialises the class token
        cls = model.vision_model.embeddings.class_embedding
        cls.copy_(torch.randn(cls.shape, generator=torch.Generator()
                              .manual_seed(seed)) * cls.numel() ** -0.5)
    os.makedirs(path, exist_ok=True)
    save_weights(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config.to_dict(), f, indent=2)
    side = config.vision_config.image_size
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"image_processor_type": "CLIPImageProcessor",
                   "processor_class": "CLIPProcessor",
                   "size": {"shortest_edge": side},
                   "crop_size": {"height": side, "width": side},
                   "do_resize": True, "do_center_crop": True,
                   "do_rescale": True, "rescale_factor": 1 / 255,
                   "do_normalize": True, "do_convert_rgb": True,
                   "resample": 3}, f, indent=2)
    tok.save_pretrained(path)


def dist(a) -> dict:
    a = np.asarray(a, np.float64)
    return {"mean": float(a.mean()), "std": float(a.std()),
            "p10": float(np.percentile(a, 10)),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "n": int(a.size)}


def tokenizer_dir(ckpt: str) -> str:
    """<ckpt>/tokenizer; raises if there is none."""
    path = os.path.join(ckpt, "tokenizer")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no tokenizer/ in {ckpt}")
    return path


def swap_in_state(unet: torch.nn.Module, ckpt_dir: str, step: int,
                  stage: str = "stage2") -> List[str]:
    """Copy the trainer's saved trainable tensors of checkpoint `step`
    (checkpoint/torch_io.py) into `unet` by name, each cast to the
    parameter's dtype; returns the names. A name that the UNet lacks, or
    that `stage` does not train, raises."""
    from storygen_tpu_torch.checkpoint import torch_io
    from storygen_tpu_torch.training.optim import STAGE_PREDICATES
    saved = torch_io.restore_checkpoint(ckpt_dir, step)["trainable"]
    params = dict(unet.named_parameters())
    bad = sorted(n for n in saved if n not in params
                 or not STAGE_PREDICATES[stage](n))
    if bad:
        raise KeyError(f"{len(bad)} saved tensors are not {stage}'s UNet "
                       f"parameters, e.g. {bad[:3]}")
    with torch.no_grad():
        for name, value in saved.items():
            params[name].copy_(value)
    return sorted(saved)


def generate_windows(pipe, test_ds, gen_dir: str, num_inference_steps: int,
                     sampler: str, interval: int, skip_existing: bool = False
                     ) -> None:
    """Window i of the test split from its 3 GT refs, with the draws of
    seeded_draws(device, i), into <gen_dir>/<i:04d>.png."""
    from PIL import Image
    from storygen_tpu_torch.pipeline import seeded_draws
    os.makedirs(gen_dir, exist_ok=True)
    for i in range(len(test_ds)):
        path = os.path.join(gen_dir, f"{i:04d}.png")
        if skip_existing and os.path.exists(path):
            continue
        s = test_ds[i]
        out = pipe(stage="auto-regressive", prompt=[s["prompt"]],
                   image_prompt=np.asarray(s["ref_images"])[:, None],
                   prev_prompt=[[p] for p in s["ref_prompts"]],
                   num_inference_steps=num_inference_steps,
                   guidance_scale=7.0, image_guidance_scale=3.5,
                   sampler=sampler, ref_feature_interval=interval,
                   draw=functools.partial(seeded_draws(pipe.device, i), 0))
        Image.fromarray((out[0] * 255).astype(np.uint8)).save(path)
        print(f"generated window {i + 1}/{len(test_ds)}", flush=True)


def write_ground_truth(test_ds, gt_dir: str) -> List[str]:
    """The test windows' target frames as PNGs (kept when present); returns
    their captions."""
    from PIL import Image
    os.makedirs(gt_dir, exist_ok=True)
    captions = []
    for i in range(len(test_ds)):
        s = test_ds[i]
        captions.append(s["prompt"])
        path = os.path.join(gt_dir, f"{i:04d}.png")
        if not os.path.exists(path):
            gt = ((np.asarray(s["image"]) + 1.0) / 2.0 * 255).astype(np.uint8)
            Image.fromarray(gt).save(path)
    return captions


def read_images(folder: str, n: int) -> list:
    from PIL import Image
    return [Image.open(os.path.join(folder, f"{i:04d}.png")).convert("RGB")
            for i in range(n)]


def score(scorer, picker, gen_imgs, captions, feats_gt: np.ndarray,
          text_feats: np.ndarray) -> Dict:
    """The metrics of one pass: means, distributions and per-window
    scores (the embeddings are L2-normalised, so a window's CLIP-I and
    CLIP-T are row dot products). CLIP-FID is NaN for a single window,
    whose features have no covariance."""
    from storygen_tpu_torch.evaluation.fid import fid_from_features
    feats_gen = scorer.image_embed(gen_imgs)
    per_clip_i = np.sum(feats_gen * feats_gt, axis=-1)
    per_clip_t = np.sum(feats_gen * text_feats, axis=-1)
    picks = np.asarray([picker.score(c, [im])[0]
                        for c, im in zip(captions, gen_imgs)])
    return {"clip_i": float(per_clip_i.mean()),
            "clip_t": float(per_clip_t.mean()),
            "clip_fid": (fid_from_features(feats_gt, feats_gen)
                         if len(gen_imgs) > 1 else float("nan")),
            "pickscore": float(picks.mean()),
            "clip_i_dist": dist(per_clip_i),
            "clip_t_dist": dist(per_clip_t),
            "pickscore_dist": dist(picks),
            "per_window": {"clip_i": [float(v) for v in per_clip_i],
                           "clip_t": [float(v) for v in per_clip_t],
                           "pickscore": [float(v) for v in picks]}}


def train_stage(stage: str, base_yaml: str, out_yaml: str, device: str,
                **overrides):
    """scripts/train.py's main on a copy of `base_yaml` with `overrides`."""
    import yaml

    from storygen_tpu_torch.scripts import train
    with open(base_yaml) as f:
        cfg = yaml.safe_load(f)
    cfg.update(overrides)
    with open(out_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    return train.main(["--stage", stage, "--config", out_yaml,
                       "--device", device])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from storygen_tpu_torch.checkpoint.hf_import import \
        load_diffusers_pretrained
    from storygen_tpu_torch.data.datasets import StorySalonDataset
    from storygen_tpu_torch.evaluation.clip_scores import (CLIPScorer,
                                                           PickScorer)
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    from storygen_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    os.makedirs(args.root, exist_ok=True)
    ensure_synth(args.data, args.stories, args.frames, args.test_stories)
    train_dir = os.path.join(args.root, "train")
    ckpt = os.path.join(train_dir, f"checkpoint_{args.ckpt_step}")
    if args.state_step is not None:
        if not args.base_ckpt:
            raise ValueError("--state_step needs --base_ckpt")
        ckpt = args.base_ckpt

    # 1. train the stage-2 checkpoint
    if not args.skip_train or not os.path.isdir(ckpt):
        train_stage("stage2", args.config,
                    os.path.join(args.root, "train_config.yml"), args.device,
                    logdir=train_dir, dataset_path=args.data)
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(f"no checkpoint at {ckpt}")

    # 2. generate every held-out window
    b = load_diffusers_pretrained(ckpt, dev, torch.bfloat16)
    tok_dir = tokenizer_dir(args.base_ckpt or ckpt)
    if args.state_step is not None:
        swap_in_state(b["unet"], os.path.join(train_dir, "checkpoints"),
                      args.state_step, args.stage)
        ckpt = (f"{train_dir}/checkpoints@{args.state_step} "
                f"(base {args.base_ckpt})")
    pipe = StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"],
                            Tokenizer(tok_dir), b["scheduler_config"],
                            device=dev)
    test_ds = StorySalonDataset(args.data, "test")
    tag = os.path.splitext(os.path.basename(args.out))[0]
    gen_dir = os.path.join(args.root,
                           "gen" if tag == "quality" else f"gen_{tag}")
    gt_dir = os.path.join(args.root, "gt")
    cap_dir = os.path.join(args.root, "captions")
    os.makedirs(cap_dir, exist_ok=True)
    generate_windows(pipe, test_ds, gen_dir, args.num_inference_steps,
                     args.sampler, args.ref_feature_interval)
    captions = write_ground_truth(test_ds, gt_dir)
    for i, c in enumerate(captions):
        with open(os.path.join(cap_dir, f"{i:04d}.txt"), "w") as f:
            f.write(c)
    del pipe, b

    # 3. score with the seeded scorer
    clip_path = os.path.join(args.root, "clip_scorer")
    ensure_clip(clip_path, tok_dir)
    scorer = CLIPScorer(clip_path, dev)
    picker = PickScorer(clip_path, clip_path, dev)
    n = len(test_ds)
    metrics = score(scorer, picker, read_images(gen_dir, n), captions,
                    scorer.image_embed(read_images(gt_dir, n)),
                    scorer.text_embed(captions))
    metrics.update({"num_windows": n,
                    "num_inference_steps": args.num_inference_steps,
                    "sampler": args.sampler,
                    "ref_feature_interval": args.ref_feature_interval,
                    "checkpoint": ckpt})
    with open(os.path.join(args.root, args.out), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
