"""The chained training workflow in one call: stage 1, then stage 2
initialised from stage 1's export, then the quality suite.

  python -m storygen_tpu_torch.scripts.run_chain --root ./chain \\
      --data ./synth_storysalon --stage1_config <stage-1 YAML> \\
      --stage2_config <stage-2 YAML> --steps 500 --score_steps 100 250 500

0. A synthetic StorySalon corpus at --data (18 stories x 16 frames, 4
   held out: 52 test windows) when the folder has no images yet; an
   existing corpus is used as it is.
1. Stage 1 (attn1) from --stage1_config for --stage1_steps optimizer
   steps; the trainer exports <root>/stage1/checkpoint_<stage1_steps>.
2. VAE posterior moments of the corpus from that export (unless
   --no_latents), then stage 2 (attn3) from the export for --steps steps,
   a trainer state every --ckpt_every steps and the export
   <root>/train/checkpoint_<steps> at the end (the trainer writes it; no
   separate export step). --steps must be a multiple of --ckpt_every,
   or the final state would never be written: that raises before any
   training.
3. The quality suite (run_quality_suite) on the states: exact DDIM-40 at
   the first state, each --score_steps state and the final one; dpm++-25
   with ref_feature_interval 2 at the first and final states; plain
   dpm++-25 at the final one.
4. <root>/chain.json: the stage-2 loss curve (the trainer's
   metrics.jsonl), the exact passes by step and the fast passes the suite
   ran.

The configs default to the repository's configs/stage{1,2}_tpu_smoke.yml;
each must name a tokenizer that exists (`tokenizer_path`, or a
`pretrained_model_path` with tokenizer/). Runs on the card unless given
--device cpu. Needs PyYAML and PIL.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

from storygen_tpu_torch.scripts import run_quality as Q
from storygen_tpu_torch.scripts.common import add_device_flag

CONFIGS = os.path.join(Q.REPO, "configs")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    tmp = tempfile.gettempdir()  # honours TMPDIR
    ap.add_argument("--root", default=os.path.join(tmp, "chain"))
    ap.add_argument("--data", default=os.path.join(tmp, "synth_storysalon"))
    ap.add_argument("--steps", type=int, default=500,
                    help="stage-2 optimizer steps")
    ap.add_argument("--stage1_steps", type=int, default=50)
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--score_steps", type=int, nargs="+",
                    default=[100, 250, 500],
                    help="stage-2 states that get the exact quality pass")
    ap.add_argument("--no_latents", action="store_true",
                    help="stage 2 encodes its images in the step instead "
                         "of reading precomputed moments")
    ap.add_argument("--skip_stage1", action="store_true")
    ap.add_argument("--skip_stage2", action="store_true")
    ap.add_argument("--skip_fast_points", action="store_true")
    ap.add_argument("--stage1_config",
                    default=os.path.join(CONFIGS, "stage1_tpu_smoke.yml"))
    ap.add_argument("--stage2_config",
                    default=os.path.join(CONFIGS, "stage2_tpu_smoke.yml"))
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the chain; returns the summary written to chain.json."""
    args = parse_args(argv)
    if args.steps % args.ckpt_every:
        raise ValueError(f"--steps {args.steps} is not a multiple of "
                         f"--ckpt_every {args.ckpt_every}: the final state "
                         "would never be written")
    from storygen_tpu_torch.scripts import (make_synth_storysalon,
                                            precompute_latents,
                                            run_quality_suite)
    from storygen_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    os.makedirs(args.root, exist_ok=True)

    # 0. the corpus
    if not os.path.isdir(os.path.join(args.data,
                                      "image_inpainted_finally_checked")):
        make_synth_storysalon.write(args.data, 18, 16, 512, 4)

    # 1. stage 1, exported at its last step
    stage1_dir = os.path.join(args.root, "stage1")
    stage1_ckpt = os.path.join(stage1_dir, f"checkpoint_{args.stage1_steps}")
    if not args.skip_stage1 and not os.path.isdir(stage1_ckpt):
        Q.train_stage("stage1", args.stage1_config,
                      os.path.join(args.root, "stage1_config.yml"),
                      args.device, logdir=stage1_dir, dataset_path=args.data,
                      train_steps=args.stage1_steps,
                      checkpointing_steps=args.stage1_steps,
                      validation_steps=10 ** 6)
    if not os.path.isdir(stage1_ckpt):
        raise FileNotFoundError(f"no stage-1 export at {stage1_ckpt}")

    # 2. precomputed moments (the VAE is frozen in both stages), stage 2
    latents_dir = None
    if not args.no_latents:
        latents_dir = os.path.join(args.root, "latents")
        done_flag = os.path.join(latents_dir, ".complete")
        if not os.path.exists(done_flag):
            precompute_latents.main(["--ckpt", stage1_ckpt, "--dataset",
                                     args.data, "--out", latents_dir,
                                     "--device", args.device])
            open(done_flag, "w").close()
    train_dir = os.path.join(args.root, "train")
    final_ckpt = os.path.join(train_dir, f"checkpoint_{args.steps}")
    if not args.skip_stage2 and not os.path.isdir(final_ckpt):
        Q.train_stage("stage2", args.stage2_config,
                      os.path.join(args.root, "stage2_config.yml"),
                      args.device, logdir=train_dir, dataset_path=args.data,
                      pretrained_model_path=stage1_ckpt,
                      latents_path=latents_dir, train_steps=args.steps,
                      checkpointing_steps=args.ckpt_every,
                      export_steps=args.steps, validation_steps=10 ** 6,
                      validation_sample_logger=None)

    # 3. the quality passes
    mids = [s for s in args.score_steps if s != args.steps]
    run_quality_suite.main(
        ["--root", args.root, "--data", args.data, "--base", stage1_ckpt,
         "--first_step", str(args.ckpt_every), "--final_step",
         str(args.steps), "--device", args.device, "--curve_steps",
         *map(str, mids)])

    def quality(tag):
        path = os.path.join(args.root, f"quality_{tag}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # 4. the summary: only the passes the suite runs
    curve = {s: quality(f"exact_s{s}")
             for s in [args.ckpt_every] + mids + [args.steps]}
    fast = {}
    if not args.skip_fast_points:
        first, final = args.ckpt_every, args.steps
        for tag in (f"dpm25_ri2_s{first}", f"dpm25_ri2_s{final}",
                    f"dpm25_s{final}"):
            fast[tag] = quality(tag)
    loss_points = []
    metrics_jsonl = os.path.join(train_dir, "metrics.jsonl")
    if os.path.exists(metrics_jsonl):
        with open(metrics_jsonl) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        loss_points = [{"step": r["step"], "loss": r["loss"]}
                       for r in rows if "loss" in r]
    summary = {"stage1_ckpt": stage1_ckpt, "stage2_steps": args.steps,
               "loss_curve": loss_points,
               "quality_curve": {str(k): v for k, v in curve.items()},
               "fast_points": fast}
    with open(os.path.join(args.root, "chain.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary)[:2000])
    return summary


if __name__ == "__main__":
    main()
