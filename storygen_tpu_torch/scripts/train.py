"""Training of stage 1, stage 2 or COCO from a YAML config.

  python -m storygen_tpu_torch.scripts.train --stage stage2 \\
      --config configs/stage2_config.yml

`main(argv)` reads the config with PyYAML (TrainConfig.from_yaml);
`run(stage, cfg, device)` takes a TrainConfig, so a host without PyYAML
calls it directly. The dataset: the precomputed latents when
`latents_path` is set, else COCO train2017 (stage coco) or the StorySalon
train split at `dataset_path`, with the StorySalon test split for the
validation renders (none for COCO). The tokenizer folder is
`tokenizer_path`, else `pretrained_model_path`, or the tokenizer/ inside
it when there is one (a `tokenizer_path` that is not a folder raises,
where the JAX script would read `pretrained_model_path` instead). One
process trains on one device: the JAX script's multi-process flags have
no counterpart yet.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from storygen_tpu_torch.configs import TrainConfig
from storygen_tpu_torch.data.datasets import (COCOMultiSegDataset,
                                              StorySalonDataset)
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.parallel import multihost
from storygen_tpu_torch.scripts.common import (add_device_flag,
                                               add_process_flags,
                                               tokenizer_folder)
from storygen_tpu_torch.training import trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", default="stage2",
                    choices=["stage1", "stage2", "coco"])
    ap.add_argument("--config", required=True)
    add_device_flag(ap)
    add_process_flags(ap)
    return ap.parse_args(argv)


def run(stage: str, cfg: TrainConfig, device="cuda") -> trainer.TrainState:
    """Train `stage` as the config says, on `device`."""
    dev = trainer.resolve_device(device)
    dataset = val_dataset = None
    if cfg.latents_path:  # the trainer reads the .npz files itself
        if stage != "coco":
            val_dataset = StorySalonDataset(cfg.dataset_path, "test")
    elif stage == "coco":
        dataset = COCOMultiSegDataset(cfg.dataset_path, seed=cfg.seed)
    else:
        dataset = StorySalonDataset(cfg.dataset_path, "train", seed=cfg.seed)
        val_dataset = StorySalonDataset(cfg.dataset_path, "test")
    tokenizer = Tokenizer(tokenizer_folder(cfg.tokenizer_path
                                           or cfg.pretrained_model_path))
    return trainer.train(stage, cfg, dataset, device=dev,
                         val_dataset=val_dataset, tokenizer=tokenizer)


def main(argv: Optional[Sequence[str]] = None) -> trainer.TrainState:
    """Train as the flags say; joins (and at the end leaves) the process
    group when the flags or the environment ask for one."""
    args = parse_args(argv)
    cfg = TrainConfig.from_yaml(args.config)
    if not multihost.initialize(args.coordinator, args.num_processes,
                                args.process_id, args.backend, args.device):
        return run(args.stage, cfg, args.device)
    try:
        return run(args.stage, cfg, multihost.rank_device(args.device))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
