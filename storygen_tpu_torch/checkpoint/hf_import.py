"""Load diffusers-layout checkpoint folders into the port's modules.

Counterpart of storygen_tpu/checkpoint/hf_import.py. The port's modules
carry the diffusers parameter names and layouts (checkpoint/convert.py), so
a weight file loads with `load_state_dict` and no conversion:

- `.bin` files through `torch.load(weights_only=True, mmap=True)`, and
  `.safetensors` files through the port's own reader (`read_safetensors`:
  an 8-byte little-endian header length, a JSON header, raw buffers),
  memory-mapped as well;
- the VLCM surgery (`apply_attn3_surgery`): a UNet file without the image
  cross-attention gets attn3 as a copy of attn1 and norm4 of norm1;
- the modules are built on the `meta` device and take the file's tensors
  with `assign=True`, cast to the asked dtype and moved to the device once,
  so a full-width load allocates no random weights and holds one copy.

A key that the model needs and the file lacks, or a shape that differs,
raises; keys that the model lacks (such as the `position_ids` buffer of
older transformers checkpoints) are ignored, as in the JAX package.
"""
from __future__ import annotations

import json
import logging
import mmap
import os
from typing import Dict, Mapping

import torch
import torch.nn as nn

from storygen_tpu_torch.configs import ConvKernels, load_pretrained_configs
from storygen_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.bin",
                "model.safetensors", "pytorch_model.bin")

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU tensors over a
    copy-on-write memory map of the file (nothing is read until used)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        out[name] = (torch.frombuffer(buf, dtype=dtype, count=count,
                                      offset=base + begin).reshape(shape)
                     if count else torch.empty(shape, dtype=dtype))
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors or .bin (torch zip) weight file as CPU tensors in the
    file's own dtypes."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def find_weight_file(folder: str) -> str:
    for name in WEIGHT_FILES:
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weight file in {folder}")


def apply_attn3_surgery(sd: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Fill missing attn3 weights from attn1 and missing norm4 weights
    from norm1 (the reference's load_SDM_state_dict): a vanilla SD-1.5 UNet
    file gets the VLCM image cross-attention as a copy of the
    self-attention. The copies are new tensors, so training attn3 leaves
    attn1 as it was."""
    out = dict(sd)
    for k, v in sd.items():
        if ".attn1." in k:
            k3 = k.replace(".attn1.", ".attn3.")
            if k3 not in out:
                out[k3] = v.clone()
        if ".norm1." in k and "transformer_blocks" in k:
            k4 = k.replace(".norm1.", ".norm4.")
            if k4 not in out:
                out[k4] = v.clone()
    return out


def load_into(module: nn.Module, sd: Mapping[str, torch.Tensor],
              device: torch.device, dtype: torch.dtype) -> nn.Module:
    """Assign the file's tensors to `module`'s parameters (built on the
    meta device), each cast to `dtype` on `device`. Raises KeyError for a
    missing key and ValueError for a shape that differs; extra keys are
    ignored."""
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{len(missing)} keys of {type(module).__name__} not "
                       f"in the state dict, e.g. {missing[:5]}")
    extra = sorted(set(sd) - set(want))
    if extra:
        log.debug("ignoring %d keys the model lacks: %s", len(extra), extra)
    tensors = {}
    for k, ref in want.items():
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {k}: file "
                             f"{tuple(sd[k].shape)}, model {tuple(ref.shape)}")
        tensors[k] = sd[k].to(device=device, dtype=dtype)
    module.load_state_dict(tensors, strict=True, assign=True)
    return module


def load_diffusers_pretrained(root: str, device=None,
                              dtype: torch.dtype = torch.float32,
                              conv: ConvKernels = ConvKernels()) -> dict:
    """Load a diffusers-layout folder (unet/, vae/, text_encoder/ or CLIP/,
    scheduler/) into the port's modules on `device` (None: the card) in
    `dtype`, the UNet's and the VAE's convs on the kernels `conv` picks.
    Returns unet, vae, text_encoder (in eval mode), unet_config,
    vae_config, clip_config and scheduler_config, as the JAX package's
    loader does."""
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    dev = resolve_device(device)
    unet_cfg, vae_cfg, clip_cfg, sched_cfg = load_pretrained_configs(root)
    te_dir = os.path.join(root, "text_encoder")
    if not os.path.isdir(te_dir):
        te_dir = os.path.join(root, "CLIP")

    def load(cls, args, folder, surgery=False):
        with torch.device("meta"):
            module = cls(*args)
        sd = load_state_dict_file(find_weight_file(folder))
        if surgery:
            sd = apply_attn3_surgery(sd)
        return load_into(module, sd, dev, dtype).eval()

    return dict(
        unet=load(UNet2DConditionModel, (unet_cfg, conv),
                  os.path.join(root, "unet"), surgery=True),
        unet_config=unet_cfg,
        vae=load(AutoencoderKL, (vae_cfg, conv), os.path.join(root, "vae")),
        vae_config=vae_cfg,
        text_encoder=load(CLIPTextModel, (clip_cfg,), te_dir),
        clip_config=clip_cfg, scheduler_config=sched_cfg)



def load_clip_model(folder: str, device=None,
                    dtype: torch.dtype = torch.float32):
    """A transformers CLIP folder (config.json with text_config,
    vision_config, projection_dim and logit_scale_init_value;
    model.safetensors or pytorch_model.bin) as the port's CLIPModel on
    `device` (None: the card) in `dtype`, in eval mode. Fields that
    config.json leaves out take transformers 4.57's defaults
    (configs.CLIPConfig); `*.position_ids` buffers of older saves are
    dropped."""
    from storygen_tpu_torch.configs import CLIPConfig
    from storygen_tpu_torch.models.clip_vision import CLIPModel
    dev = resolve_device(device)
    cfg = CLIPConfig.from_json(os.path.join(folder, "config.json"))
    names = ("model.safetensors", "pytorch_model.bin")
    path = next((os.path.join(folder, n) for n in names
                 if os.path.exists(os.path.join(folder, n))), None)
    if path is None:
        raise FileNotFoundError(f"no {' or '.join(names)} in {folder}")
    sd = {k: v for k, v in load_state_dict_file(path).items()
          if not k.endswith("position_ids")}
    with torch.device("meta"):
        model = CLIPModel(cfg)
    return load_into(model, sd, dev, dtype).eval()
