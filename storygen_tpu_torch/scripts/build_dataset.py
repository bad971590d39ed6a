"""Dataset construction: the StorySalon preprocessing stages over a
directory of story videos, extract -> dedup -> mask -> inpaint -> align ->
caption. Counterpart of scripts/build_dataset.py, with its flags and
`--device` (default cuda) in place of a platform.

Models plug in by flag: the inpaint stage needs `--ckpt` (a diffusers
folder with its tokenizer), the caption stage `--caption_ckpt` (a local
HuggingFace image-to-text folder; needs `transformers`), the person
detector `--yolo_weights` or `--face_onnx`; a stage whose model is not
given is skipped, so partial pipelines run (e.g. extraction and dedup
only). Frames that the mask stage rejects are deleted and leave the story.

  python -m storygen_tpu_torch.scripts.build_dataset --videos ./videos \\
      --out ./StorySalon --stages extract,dedup,mask --device cuda
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from storygen_tpu_torch.scripts.common import add_device_flag, tokenizer_folder
from storygen_tpu_torch.utils.device import resolve_device

VIDEO_SUFFIXES = (".mp4", ".mkv", ".webm", ".avi", ".mov")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--videos", required=True,
                    help="directory of <story_id>.mp4 (+ optional .vtt)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--stages", default="extract,dedup,mask,align",
                    help="comma list: extract,dedup,mask,inpaint,align,caption")
    ap.add_argument("--dedup_threshold", type=float, default=0.75)
    ap.add_argument("--ckpt", default=None,
                    help="SD checkpoint folder for inpainting")
    ap.add_argument("--yolo_weights", default=None,
                    help="optional YOLO person-detector weights")
    ap.add_argument("--face_onnx", default=None,
                    help="optional cv2.FaceDetectorYN ONNX file")
    ap.add_argument("--caption_ckpt", default=None,
                    help="local HF image-to-text checkpoint folder for "
                         "the caption stage")
    add_device_flag(ap)
    return ap.parse_args(argv)


def inpaint_frames(inpainter, text_encoder, tok, frames, mask_dir) -> int:
    """Inpaint each frame that has a non-empty mask, at 512x512, over the
    frame's file; returns how many were inpainted."""
    import numpy as np
    from PIL import Image
    done = 0
    for f in frames:
        mask_p = os.path.join(mask_dir, os.path.basename(f))
        if not os.path.exists(mask_p):
            continue
        img = np.asarray(Image.open(f).convert("RGB")
                         .resize((512, 512)), np.float32) / 255.0
        m = np.asarray(Image.open(mask_p).convert("L")
                       .resize((512, 512)), np.float32) / 255.0
        if m.max() == 0:
            continue
        out = inpainter.inpaint_image(text_encoder, tok, img, m)
        Image.fromarray((out * 255).astype(np.uint8)).save(f)
        done += 1
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    stages = set(args.stages.split(","))
    dev = resolve_device(args.device)

    from storygen_tpu_torch.data_process import (dedup, detectors, extract,
                                                 masking)

    videos = sorted(f for f in os.listdir(args.videos)
                    if f.endswith(VIDEO_SUFFIXES))
    print(f"{len(videos)} videos, stages: {sorted(stages)}")

    embed_fn = None
    if "dedup" in stages:
        embed_fn = dedup.default_embedder(device=dev)

    caption_model = None
    if "caption" in stages and args.caption_ckpt:
        from storygen_tpu_torch.data_process import caption as caption_mod
        caption_model = caption_mod.hf_captioner(args.caption_ckpt,
                                                 device=dev)

    inpainter = None
    if "inpaint" in stages and args.ckpt:
        import torch
        from storygen_tpu_torch.checkpoint.hf_import import (
            load_diffusers_pretrained)
        from storygen_tpu_torch.data.tokenizer import Tokenizer
        from storygen_tpu_torch.data_process.inpaint import Inpainter
        bundle = load_diffusers_pretrained(args.ckpt, dev, torch.bfloat16)
        inpainter = (Inpainter(bundle["unet"], bundle["vae"], device=dev),
                     bundle["text_encoder"],
                     Tokenizer(tokenizer_folder(args.ckpt)))

    for vid in videos:
        story = os.path.splitext(vid)[0]
        img_dir = os.path.join(args.out,
                               "image_inpainted_finally_checked", story)
        mask_dir = os.path.join(args.out, "mask", story)

        if "extract" in stages:
            frames = extract.extract_keyframes(
                os.path.join(args.videos, vid), img_dir)
            print(f"[{story}] extracted {len(frames)} keyframes")

        frames = sorted(os.path.join(img_dir, f)
                        for f in os.listdir(img_dir)) \
            if os.path.isdir(img_dir) else []

        if "dedup" in stages and frames:
            kept = dedup.dedup_frames(frames, embed_fn,
                                      threshold=args.dedup_threshold,
                                      delete=True)
            print(f"[{story}] dedup: kept {len(kept)}/{len(frames)}")
            frames = kept

        if "mask" in stages and frames:
            text_det = detectors.default_text_detector()
            person_det = detectors.default_person_detector(
                yolo_weights=args.yolo_weights, face_onnx=args.face_onnx,
                device=dev)
            kept = masking.process_directory(
                img_dir, mask_dir, person_detector=person_det,
                text_detector=text_det, delete_rejected=True)
            note = "" if person_det else \
                " (no person detector: text-only masks, no person filter)"
            print(f"[{story}] masks written for {len(kept)} frames{note}")
            # the rejected frames are deleted: later stages skip them
            frames = kept

        if "inpaint" in stages and inpainter and frames:
            n = inpaint_frames(*inpainter, frames, mask_dir)
            print(f"[{story}] inpainted masked regions of {n} frames")

        if "caption" in stages and caption_model and frames:
            from storygen_tpu_torch.data_process import caption as caption_mod
            cap_dir = os.path.join(args.out, "Text", "Caption", story)
            caps = caption_mod.caption_story(frames, caption_model,
                                             out_dir=cap_dir)
            print(f"[{story}] captioned {len(caps)} frames -> {cap_dir}")

        if "align" in stages:
            vtt = os.path.join(args.videos, story + ".vtt")
            if os.path.exists(vtt):
                print(f"[{story}] transcript ready for align_story() — "
                      "plug CLIP embedders (see data_process/align.py)")

    print("done")


if __name__ == "__main__":
    main()
