"""Several quality passes in one process: the base folder is loaded once
and the scorers are set up once, and each checkpoint's trained tensors are
swapped into the UNet by name from the trainer's states
(<root>/train/checkpoints/<step>, checkpoint/torch_io.py).

  python -m storygen_tpu_torch.scripts.run_quality_suite --root ./chain \\
      --data ./synth_storysalon --base ./chain/stage1/checkpoint_50 \\
      --first_step 50 --final_step 500 --curve_steps 250

Phase A (at once): exact DDIM-40 and dpm++-25 with ref_feature_interval 2
at --first_step. Phase B (once the state of --final_step exists, polled
every --poll_s seconds): exact DDIM-40, dpm++-25 with interval 2 and plain
dpm++-25 at --final_step, then exact DDIM-40 at each --curve_steps state
that exists. Each pass writes <root>/quality_<config>_s<step>.json in
run_quality's schema as it ends (an existing one is kept), so partial
progress survives a kill. Runs on the card unless given --device cpu; the
base folder needs its tokenizer/. Needs PIL.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from storygen_tpu_torch.checkpoint import torch_io
from storygen_tpu_torch.scripts import run_quality as Q
from storygen_tpu_torch.scripts.common import add_device_flag

# (name, sampler, steps, ref_feature_interval)
CONFIGS = [("exact", "ddim", 40, 1),
           ("dpm25_ri2", "dpm++", 25, 2),
           ("dpm25", "dpm++", 25, 1)]
# phase A runs the first two at the first step
FIRST_CONFIGS = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    tmp = tempfile.gettempdir()  # honours TMPDIR
    ap.add_argument("--root", default=os.path.join(tmp, "chain"))
    ap.add_argument("--data", default=os.path.join(tmp, "synth_storysalon"))
    ap.add_argument("--base", required=True,
                    help="diffusers folder the run was initialised from")
    ap.add_argument("--first_step", type=int, default=50)
    ap.add_argument("--final_step", type=int, default=500)
    ap.add_argument("--curve_steps", type=int, nargs="*", default=[250])
    ap.add_argument("--stage", default="stage2")
    ap.add_argument("--poll_s", type=float, default=60.0)
    add_device_flag(ap)
    return ap.parse_args(argv)


def state_exists(ckpt_dir: str, step: int) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, str(step),
                                       torch_io.STATE_FILE))


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the passes; returns the tags written."""
    args = parse_args(argv)
    from storygen_tpu_torch.checkpoint.hf_import import \
        load_diffusers_pretrained
    from storygen_tpu_torch.data.datasets import StorySalonDataset
    from storygen_tpu_torch.data.tokenizer import Tokenizer
    from storygen_tpu_torch.evaluation.clip_scores import (CLIPScorer,
                                                           PickScorer)
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    from storygen_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    ckpt_dir = os.path.join(args.root, "train", "checkpoints")
    print("loading the base folder (once)", flush=True)
    b = load_diffusers_pretrained(args.base, dev, torch.bfloat16)
    tok_dir = Q.tokenizer_dir(args.base)
    pipe = StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"],
                            Tokenizer(tok_dir), b["scheduler_config"],
                            device=dev)

    def load_step(step):
        Q.swap_in_state(b["unet"], ckpt_dir, step, args.stage)
        print(f"swapped in state {step}", flush=True)

    test_ds = StorySalonDataset(args.data, "test")
    n = len(test_ds)
    gt_dir = os.path.join(args.root, "gt")
    captions = Q.write_ground_truth(test_ds, gt_dir)

    clip_path = os.path.join(args.root, "clip_scorer")
    Q.ensure_clip(clip_path, tok_dir)
    scorer = CLIPScorer(clip_path, dev)
    picker = PickScorer(clip_path, clip_path, dev)
    feats_gt = scorer.image_embed(Q.read_images(gt_dir, n))
    text_feats = scorer.text_embed(captions)
    written = []

    def run_config(tag, step, sampler, nsteps, interval):
        out_p = os.path.join(args.root, f"quality_{tag}.json")
        written.append(tag)
        if os.path.exists(out_p):
            print(f"skip {tag} (exists)", flush=True)
            return
        gen_dir = os.path.join(args.root, f"gen_{tag}")
        t0 = time.time()
        Q.generate_windows(pipe, test_ds, gen_dir, nsteps, sampler, interval,
                           skip_existing=True)
        metrics = Q.score(scorer, picker, Q.read_images(gen_dir, n),
                          captions, feats_gt, text_feats)
        metrics.update({
            "num_windows": n, "num_inference_steps": nsteps,
            "sampler": sampler, "ref_feature_interval": interval,
            "checkpoint": f"{ckpt_dir}@{step} (base {args.base})"})
        with open(out_p, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"{tag}: done in {time.time() - t0:.0f}s "
              + json.dumps({k: metrics[k] for k in
                            ("clip_i", "clip_fid", "pickscore")}),
              flush=True)

    # phase A: the first checkpoint
    s = args.first_step
    load_step(s)
    for name, sampler, nsteps, interval in CONFIGS[:FIRST_CONFIGS]:
        run_config(f"{name}_s{s}", s, sampler, nsteps, interval)

    # phase B: the final checkpoint once it exists, then the curve
    s = args.final_step
    while not state_exists(ckpt_dir, s):
        print(f"waiting for state {s}", flush=True)
        time.sleep(args.poll_s)
    load_step(s)
    for name, sampler, nsteps, interval in CONFIGS:
        run_config(f"{name}_s{s}", s, sampler, nsteps, interval)
    name, sampler, nsteps, interval = CONFIGS[0]
    for s in args.curve_steps:
        if state_exists(ckpt_dir, s):
            load_step(s)
            run_config(f"{name}_s{s}", s, sampler, nsteps, interval)
    print("suite complete", flush=True)
    return written


if __name__ == "__main__":
    main()
