"""Offline diffusers-folder export of a training checkpoint.

Counterpart of the JAX package's scripts/export_checkpoint.py. With
TrainConfig.export_steps set above the checkpoint cadence, the trainer
keeps only its `<logdir>/checkpoints/<step>` saves (the trained subset,
the optimizer's state and the generator's); this script rebuilds the
openable pipeline folder from one of them, off the training loop. The
frozen tensors come from the base folder that the run started from (its
UNet through the VLCM surgery where it lacks attn3, as the loader applies
it), the trained ones from the checkpoint's `trainable`, and the VAE, the
text encoder, the scheduler and tokenizer/ from the base folder. It is
file work: tensors are read, merged by name and written through
checkpoint/hf_export.py's writer, with no arithmetic and no device.

  python -m storygen_tpu_torch.scripts.export_checkpoint \\
      --base <folder the run started from> --ckpt <logdir>/checkpoints \\
      [--step N] --stage stage2 --out <logdir>/checkpoint_N

Every tensor keeps its dtype: the base folder's as stored, the trained
ones the checkpoint's fp32. A run that computed in the base folder's dtype
(the smoke's and the tests') gets the in-loop export's folder tensor for
tensor. `--step` defaults to the latest checkpoint; `--stage` (stage1,
stage2, coco or full: every UNet parameter) names the subset that the
checkpoint trained, and a checkpoint tensor outside it, or a tensor of the
subset missing from the checkpoint, raises.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional, Sequence

import torch

from storygen_tpu_torch.checkpoint import hf_export, hf_import, torch_io
from storygen_tpu_torch.configs import load_pretrained_configs
from storygen_tpu_torch.training.optim import STAGE_PREDICATES


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="diffusers folder the run was initialized from")
    ap.add_argument("--ckpt", required=True,
                    help="<logdir>/checkpoints of the run")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: the latest)")
    ap.add_argument("--stage", default="stage2",
                    choices=["stage1", "stage2", "coco", "full"])
    ap.add_argument("--out", required=True)
    return ap.parse_args(argv)


def module_keys(cls, *args) -> List[str]:
    """The state-dict names of a module built on the meta device (no
    memory, no arithmetic)."""
    with torch.device("meta"):
        return list(cls(*args).state_dict())


def select(sd: Dict[str, torch.Tensor], keys: List[str],
           what: str) -> Dict[str, torch.Tensor]:
    """`keys` of a weight file's tensors; KeyError for a missing one (the
    file's other tensors are left out, as the loader ignores them)."""
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} tensors of {what} not in the base "
                       f"folder, e.g. {missing[:3]}")
    return {k: sd[k] for k in keys}


def merge_unet(base: Dict[str, torch.Tensor],
               trained: Dict[str, torch.Tensor],
               stage: str) -> Dict[str, torch.Tensor]:
    """The base UNet's tensors with the stage's subset taken from
    `trained`. KeyError for a trained name that the UNet lacks or that the
    stage does not train, and for a name of the subset that `trained`
    lacks."""
    train = STAGE_PREDICATES[stage]
    bad = sorted(n for n in trained if n not in base or not train(n))
    if bad:
        raise KeyError(f"{len(bad)} checkpoint tensors are not {stage}'s "
                       f"UNet parameters, e.g. {bad[:3]}")
    missing = sorted(n for n in base if train(n) and n not in trained)
    if missing:
        raise KeyError(f"{len(missing)} of {stage}'s UNet parameters are "
                       f"not in the checkpoint, e.g. {missing[:3]}")
    return {n: trained[n] if train(n) else t for n, t in base.items()}


def export(base: str, ckpt: str, out: str, stage: str = "stage2",
           step: Optional[int] = None) -> int:
    """Write the pipeline folder of checkpoint `step` (the latest if None)
    to `out`; returns the step."""
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    if step is None:
        step = torch_io.latest_step(ckpt)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt}")
    trained = torch_io.restore_checkpoint(ckpt, step)["trainable"]
    unet_cfg, vae_cfg, clip_cfg, sched_cfg = load_pretrained_configs(base)

    def read(sub: str) -> Dict[str, torch.Tensor]:
        return hf_import.load_state_dict_file(
            hf_import.find_weight_file(os.path.join(base, sub)))

    unet = select(hf_import.apply_attn3_surgery(read("unet")),
                  module_keys(UNet2DConditionModel, unet_cfg), "the UNet")
    te = ("text_encoder" if os.path.isdir(os.path.join(base, "text_encoder"))
          else "CLIP")
    hf_export.write_folder(out, {
        "unet": (merge_unet(unet, trained, stage), unet_cfg),
        "vae": (select(read("vae"), module_keys(AutoencoderKL, vae_cfg),
                       "the VAE"), vae_cfg),
        "text_encoder": (select(read(te), module_keys(CLIPTextModel,
                                                      clip_cfg),
                                "the text encoder"), clip_cfg)}, sched_cfg)
    tok = os.path.join(base, "tokenizer")
    if os.path.isdir(tok):
        shutil.copytree(tok, os.path.join(out, "tokenizer"),
                        dirs_exist_ok=True)
    return step


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    step = export(args.base, args.ckpt, args.out, args.stage, args.step)
    print(f"exported step {step} -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
