"""JAX/Flax parameter tree -> the port's (diffusers-named) state dict.

Re-implements, without flax, the renaming of
storygen_tpu/checkpoint/hf_export.py::flax_to_torch_state_dict and the path
mapping of hf_import.py::_flax_path_to_diffusers:

- flax list modules `name_{i}` become `name.{i}` for the diffusers lists;
- leaves `kernel`/`scale`/`embedding` become `weight`;
- conv kernels HWIO become OIHW, Dense kernels are transposed, and the
  Dense `proj_in`/`proj_out` become 1x1 convs (O, I, 1, 1);
- regex `key_rewrites` (VAE_REWRITES, CLIP_REWRITES) apply last.

The input is the parameter tree pulled to nested dicts of numpy arrays
(with or without the top-level "params" collection).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LIST_MODULES = ("down_blocks", "up_blocks", "resnets", "attentions",
                 "transformer_blocks", "downsamplers", "upsamplers",
                 "layers", "to_out", "net")
_LEAF_RENAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "embedding": "weight"}
_CONV1X1_NAMES = frozenset({"proj_in", "proj_out"})

VAE_REWRITES = {
    r"\bdownsamplers\.0\.(weight|bias)$": r"downsamplers.0.conv.\1",
    r"\bupsamplers\.0\.(weight|bias)$": r"upsamplers.0.conv.\1",
}
CLIP_REWRITES = {
    r"^text_model\.layers\.": "text_model.encoder.layers.",
    r"^text_model\.(token|position)_embedding\.":
        r"text_model.embeddings.\1_embedding.",
    r"\.fc([12])\.": r".mlp.fc\1.",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _diffusers_segments(path: Tuple[str, ...]) -> Tuple[str, ...]:
    segs = []
    for s in path[:-1]:
        m = re.fullmatch(r"(.+?)_(\d+)", s)
        if m and m.group(1) in _LIST_MODULES:
            segs += [m.group(1), m.group(2)]
        else:
            segs.append(s)
    return tuple(segs)


def _convert_leaf(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return w
    if w.ndim == 4:                      # HWIO -> OIHW
        return w.transpose(3, 2, 0, 1)
    if w.ndim == 2:
        if len(path) >= 2 and path[-2] in _CONV1X1_NAMES:
            return w.T[:, :, None, None]
        return w.T
    return w


def jax_to_state_dict(params: Mapping, prefix: str = "",
                      key_rewrites: Mapping[str, str] = {}
                      ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays -> {diffusers key: fp32 tensor}."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, w in _flatten(tree):
        key = prefix + ".".join(_diffusers_segments(path)
                                + (_LEAF_RENAME[path[-1]],))
        for pat, rep in key_rewrites.items():
            key = re.sub(pat, rep, key)
        leaf = _convert_leaf(path, np.asarray(w, dtype=np.float32))
        out[key] = torch.tensor(leaf)  # a writable copy
    return out


def unet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    return jax_to_state_dict(params)


def vae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    return jax_to_state_dict(params, key_rewrites=VAE_REWRITES)


def clip_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    return jax_to_state_dict(params, prefix="text_model.",
                             key_rewrites=CLIP_REWRITES)
