"""Typed configuration of the port: the model, scheduler and training
settings it reads.

The port's own copy of the dataclasses of storygen_tpu/configs.py, with
the same field names and defaults, so a configuration written for the JAX
package reads here unchanged. `TrainConfig` keeps the fields that
`training/` and the scripts read (the mesh's shape only to say how many
ranks train); the mesh's axes and the Pallas variant knobs have no
counterpart. `TrainConfig.from_yaml` reads the
repository's configs/*.yml (with PyYAML, imported there). Defaults are
the SD-1.5 + VLCM operating point. The model configs read a diffusers
folder's config.json files (`from_json`, `load_pretrained_configs`) as
the JAX package reads them: unknown keys are dropped, and a UNet
`sample_size` above 128 is taken as pixels.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _tuples(d: dict, *keys: str) -> dict:
    return {**d, **{k: tuple(d[k]) for k in keys if k in d}}


@dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 UNet + the VLCM image cross-attention (attn3)."""
    sample_size: int = 64  # latent H=W (512 px / 8)
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # diffusers' name; SD-1.5 uses it as the number of heads
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    act_fn: str = "silu"
    use_linear_projection: bool = False
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3

    @property
    def num_heads(self) -> int:
        return self.attention_head_dim

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_json(cls, path: str) -> "UNetConfig":
        d = _tuples(_read_json(path), "down_block_types", "up_block_types",
                    "block_out_channels")
        if d.get("sample_size", 64) > 128:
            # pixels (the exported schema writes sample_size * 8); the
            # config keeps latents
            d["sample_size"] = d["sample_size"] // 8
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (SD-1.5 vae/config.json)."""
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_size: int = 512
    act_fn: str = "silu"
    scaling_factor: float = 0.18215

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def from_json(cls, path: str) -> "VAEConfig":
        d = _tuples(_read_json(path), "block_out_channels")
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (text_config of CLIP/config.json)."""
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    pad_token_id: int = 49407

    @classmethod
    def from_json(cls, path: str) -> "CLIPTextConfig":
        """A text encoder's config.json, or a full CLIP config's
        `text_config`."""
        d = _read_json(path)
        return cls(**_filter_kwargs(cls, d.get("text_config", d)))


# transformers 4.57's CLIPTextConfig defaults (a ViT-B text tower), which a
# CLIP folder's config.json leaves out where its values equal them; they
# differ from SD-1.5's text encoder, CLIPTextConfig's defaults above
HF_CLIP_TEXT_DEFAULTS = dict(
    vocab_size=49408, hidden_size=512, intermediate_size=2048,
    num_hidden_layers=12, num_attention_heads=8, max_position_embeddings=77,
    layer_norm_eps=1e-5, hidden_act="quick_gelu", bos_token_id=49406,
    eos_token_id=49407, pad_token_id=1)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP's vision tower (`vision_config` of a CLIP config.json), with
    transformers 4.57's CLIPVisionConfig defaults: ViT-B/32 at 224 px."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class CLIPConfig:
    """A two-tower CLIP (transformers' CLIPConfig): every field that the
    file leaves out takes transformers 4.57's default."""
    text_config: CLIPTextConfig = CLIPTextConfig(**HF_CLIP_TEXT_DEFAULTS)
    vision_config: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPConfig":
        text = {**HF_CLIP_TEXT_DEFAULTS,
                **_filter_kwargs(CLIPTextConfig, d.get("text_config") or {})}
        vision = _filter_kwargs(CLIPVisionConfig,
                                d.get("vision_config") or {})
        top = {k: d[k] for k in ("projection_dim", "logit_scale_init_value")
               if k in d}
        return cls(CLIPTextConfig(**text), CLIPVisionConfig(**vision), **top)

    @classmethod
    def from_json(cls, path: str) -> "CLIPConfig":
        return cls.from_dict(_read_json(path))

    def to_dict(self) -> dict:
        """config.json in transformers' CLIPConfig layout, every field
        written."""
        return {
            "architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": self.projection_dim,
            "logit_scale_init_value": self.logit_scale_init_value,
            "text_config": dict(dataclasses.asdict(self.text_config),
                                model_type="clip_text_model",
                                projection_dim=self.projection_dim),
            "vision_config": dict(dataclasses.asdict(self.vision_config),
                                  model_type="clip_vision_model",
                                  projection_dim=self.projection_dim),
            "torch_dtype": "float32"}


@dataclass(frozen=True)
class ConvKernels:
    """Which kernels the UNet's and the VAE's convolutions take; the
    counterpart of the JAX package's STORYGEN_HALO_FUSED and
    STORYGEN_HALO_DOWN switches (storygen_tpu/ops/shift_conv.py), off by
    default as there.

    fused_prologue: every resnet conv takes its GroupNorm + SiLU as the
      prologue of kernel P instead of a separate GroupNorm pass before
      kernel C.
    strided: every 3x3 stride-2 conv (the UNet's and the VAE encoder's
      downsamplers) runs kernel D instead of F.conv2d.
    Parameter names and shapes do not depend on it."""
    fused_prologue: bool = False
    strided: bool = False


@dataclass(frozen=True)
class SchedulerConfig:
    """Noise schedule (SD-1.5 scheduler/scheduler_config.json)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    clip_sample: bool = False
    prediction_type: str = "epsilon"

    @classmethod
    def from_json(cls, path: str) -> "SchedulerConfig":
        return cls(**_filter_kwargs(cls, _read_json(path)))


# TrainConfig's pretrained_model_path default, the JAX package's
DEFAULT_MODEL_PATH = "./ckpt/stable-diffusion-v1-5/"


@dataclass(frozen=True)
class TrainConfig:
    """The training fields of the reference's config/*.yml that the port's
    trainer reads (names and defaults as in the JAX package)."""
    # a diffusers folder; build_models loads it when it holds unet/ and
    # was named (this default counts as unnamed)
    pretrained_model_path: str = DEFAULT_MODEL_PATH
    logdir: str = "./logs/"
    # the StorySalon (or COCO) root that the train entry point reads
    dataset_path: str = "./StorySalon/"
    # a folder of precomputed VAE posterior moments (.npz); when set, the
    # trainer trains on those instead of images
    latents_path: Optional[str] = None
    train_steps: int = 50000
    train_batch_size: int = 12
    gradient_accumulation_steps: int = 8
    validation_steps: int = 500
    checkpointing_steps: int = 5000
    # diffusers-folder export cadence; None: every checkpointing_steps
    export_steps: Optional[int] = None
    seed: int = 6666
    mixed_precision: str = "bf16"  # "fp16" is read as bf16
    learning_rate: float = 1e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    use_8bit_adam: bool = False  # block-quantized moments (optim8bit.py)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    num_ref_frames: int = 3
    # the JAX package's data-parallel mesh, capped there at the devices it
    # has; the port's trainer runs on the ranks of its process group and
    # says so when the mesh asks for more
    mesh_shape: Tuple[int, ...] = (1,)
    # gradient checkpointing per UNet block
    remat: bool = True
    loader_threads: int = 8
    # SampleLogger keyword arguments; renders need a tokenizer
    validation_sample_logger: Optional[dict] = None
    # the tokenizer folder (vocab.json, merges.txt); None:
    # <pretrained_model_path>/tokenizer
    tokenizer_path: Optional[str] = None

    def __post_init__(self):
        if self.mixed_precision not in ("bf16", "fp16", "fp32", "no"):
            raise ValueError(
                f"mixed_precision={self.mixed_precision!r}; expected "
                "'bf16', 'fp16' (read as bf16), 'fp32' or 'no'")
        if self.lr_scheduler not in ("constant", "linear", "cosine"):
            raise ValueError(f"lr_scheduler={self.lr_scheduler!r}")
        if self.mesh_devices < 1:
            raise ValueError(f"mesh_shape={self.mesh_shape!r}: no devices")

    @property
    def mesh_devices(self) -> int:
        """The devices the mesh asks for (the product of its shape)."""
        return math.prod(self.mesh_shape)

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        """The fields of a YAML file (configs/*.yml); other keys are
        dropped. Needs PyYAML."""
        import yaml
        with open(path) as f:
            d = yaml.safe_load(f)
        return cls(**_filter_kwargs(cls, _tuples(d, "mesh_shape")))


def load_pretrained_configs(root: str):
    """(unet, vae, clip, scheduler) configs of a diffusers-layout folder;
    the text encoder's from text_encoder/ or else CLIP/."""
    unet = UNetConfig.from_json(os.path.join(root, "unet", "config.json"))
    vae = VAEConfig.from_json(os.path.join(root, "vae", "config.json"))
    sched = SchedulerConfig.from_json(
        os.path.join(root, "scheduler", "scheduler_config.json"))
    clip_path = os.path.join(root, "text_encoder", "config.json")
    if not os.path.exists(clip_path):
        clip_path = os.path.join(root, "CLIP", "config.json")
    return unet, vae, CLIPTextConfig.from_json(clip_path), sched
