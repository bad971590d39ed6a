"""Noise schedule and the DDIM update (eta = 0).

Counterpart of storygen_tpu/diffusion/schedule.py for the sampling path:
scaled-linear betas (tables built in float64, kept in fp32), `add_noise`,
"leading" DDIM timesteps with steps_offset, and `ddim_step` with
set_alpha_to_one=False semantics. The other samplers are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig


@dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor            # (T,) fp32
    alphas_cumprod: torch.Tensor   # (T,) fp32
    final_alpha_cumprod: torch.Tensor  # () fp32
    num_train_timesteps: int
    prediction_type: str
    init_noise_sigma: float = 1.0


def make_schedule(cfg: SchedulerConfig = SchedulerConfig(),
                  device=None) -> NoiseSchedule:
    if cfg.beta_schedule != "scaled_linear":
        raise ValueError(f"unsupported beta_schedule {cfg.beta_schedule}")
    if cfg.clip_sample:
        raise ValueError("clip_sample is not supported")
    if cfg.prediction_type != "epsilon":
        raise ValueError(f"unsupported prediction_type {cfg.prediction_type}")
    n = cfg.num_train_timesteps
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                        dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    final = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    f32 = dict(dtype=torch.float32, device=device)
    return NoiseSchedule(torch.tensor(betas, **f32), torch.tensor(acp, **f32),
                         torch.tensor(final, **f32), n, cfg.prediction_type)


def _bcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _gather(table: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, device=table.device).long()
    return table[t.clamp(0, table.shape[0] - 1)]


def add_noise(sched: NoiseSchedule, samples: torch.Tensor,
              noise: torch.Tensor, timesteps) -> torch.Tensor:
    """sqrt(acp_t) x0 + sqrt(1 - acp_t) eps in fp32, cast to samples'
    dtype; `timesteps` is () or (B,)."""
    acp = _bcast(_gather(sched.alphas_cumprod, timesteps), samples.dim())
    out = acp.sqrt() * samples.float() + (1.0 - acp).sqrt() * noise.float()
    return out.to(samples.dtype)


def ddim_timesteps(cfg: SchedulerConfig, num_inference_steps: int
                   ) -> np.ndarray:
    """Descending "leading" timesteps plus steps_offset."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
    return ts.astype(np.int64) + cfg.steps_offset


def ddim_step(sched: NoiseSchedule, eps: torch.Tensor, t: int, prev_t: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update x_t -> x_{prev_t}; prev_t < 0
    selects final_alpha_cumprod."""
    acp_t = _gather(sched.alphas_cumprod, t)
    acp_prev = (_gather(sched.alphas_cumprod, prev_t) if prev_t >= 0
                else sched.final_alpha_cumprod)
    x = sample.float()
    e = eps.float()
    x0 = (x - torch.sqrt(1.0 - acp_t) * e) / torch.sqrt(acp_t)
    prev = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * e
    return prev.to(sample.dtype)
