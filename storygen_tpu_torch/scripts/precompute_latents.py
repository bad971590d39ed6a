"""VAE posterior moments of a StorySalon split, for training without the
encoder (TrainConfig.latents_path).

  python -m storygen_tpu_torch.scripts.precompute_latents \\
      --ckpt <sd_folder> --dataset ./StorySalon --out ./StorySalon_latents

Writes <out>/<index:08d>.npz per sample: latent_moments (h, w, 8) and
ref_latent_moments (N, h, w, 8) (mean and logvar, fp16), mask (fp16),
input_ids (77,) and ref_input_ids (N, 77), the layout
data/datasets.py::PrecomputedLatentDataset reads. The dataset's CFG
dropout is off: the train step applies it. A sample whose file exists is
skipped. Each sample's frame and refs are encoded by their own calls, as
the JAX script encodes them (its `--batch` flag, which it never reads, is
not taken).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.checkpoint.hf_import import load_diffusers_pretrained
from storygen_tpu_torch.data.datasets import StorySalonDataset
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.scripts.common import add_device_flag, tokenizer_folder
from storygen_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="train")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    vae = load_diffusers_pretrained(args.ckpt, dev, torch.bfloat16)["vae"]
    tokenizer = Tokenizer(tokenizer_folder(args.ckpt))
    ds = StorySalonDataset(args.dataset, args.split, cfg_dropout=False)
    os.makedirs(args.out, exist_ok=True)

    @torch.no_grad()
    def encode(imgs: np.ndarray) -> np.ndarray:
        dist = vae.encode(torch.from_numpy(imgs).to(dev))
        return torch.cat([dist.mean, dist.logvar], -1).float().cpu().numpy()

    for i in range(len(ds)):
        out_p = os.path.join(args.out, f"{i:08d}.npz")
        if os.path.exists(out_p):
            continue
        s = ds[i]
        np.savez_compressed(
            out_p,
            latent_moments=encode(s["image"][None])[0].astype(np.float16),
            ref_latent_moments=encode(s["ref_images"]).astype(np.float16),
            mask=s["mask"].astype(np.float16),
            input_ids=tokenizer([s["prompt"]])[0],
            ref_input_ids=tokenizer(s["ref_prompts"]))
        if i % 100 == 0:
            print(f"{i}/{len(ds)}")
    print("done")


if __name__ == "__main__":
    main()
