"""Noise schedules, the DDIM and DDPM updates and the prediction-type
conversions.

Counterpart of storygen_tpu/diffusion/schedule.py: scaled-linear, linear
and squaredcos_cap_v2 betas (built in float64, kept in fp32), `add_noise`,
`velocity`, "leading" DDIM timesteps with steps_offset, `ddim_step` with
set_alpha_to_one=False semantics and eta, and the ancestral `ddpm_step`
(variance fixed_small). Timesteps are Python or numpy scalars or tensors;
the update math runs in fp32 and casts back to the sample's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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
    clip_sample: bool = False
    init_noise_sigma: float = 1.0


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    """The (T,) float64 betas of `cfg.beta_schedule`."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                           dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(n, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n),
                          0.999)
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule}")


def make_schedule(cfg: SchedulerConfig = SchedulerConfig(),
                  device=None) -> NoiseSchedule:
    betas = make_betas(cfg)
    acp = np.cumprod(1.0 - betas)
    final = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    f32 = dict(dtype=torch.float32, device=device)
    return NoiseSchedule(torch.tensor(betas, **f32), torch.tensor(acp, **f32),
                         torch.tensor(final, **f32), cfg.num_train_timesteps,
                         cfg.prediction_type, cfg.clip_sample)


def _bcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _gather(table: torch.Tensor, t) -> torch.Tensor:
    """Per-timestep values; t is clamped to the table and truncated to an
    integer, as the JAX package's astype(int32) does for float t."""
    t = torch.as_tensor(t, device=table.device).long()
    return table[t.clamp(0, table.shape[0] - 1)]


def _acp_prev(sched: NoiseSchedule, prev_t) -> torch.Tensor:
    """alphas_cumprod at prev_t; prev_t < 0 selects final_alpha_cumprod."""
    prev_t = torch.as_tensor(prev_t, device=sched.alphas_cumprod.device)
    return torch.where(prev_t >= 0, _gather(sched.alphas_cumprod, prev_t),
                       sched.final_alpha_cumprod)


def add_noise(sched: NoiseSchedule, samples: torch.Tensor,
              noise: torch.Tensor, timesteps) -> torch.Tensor:
    """sqrt(acp_t) x0 + sqrt(1 - acp_t) eps in fp32, cast to samples'
    dtype; `timesteps` is () or (B,)."""
    acp = _bcast(_gather(sched.alphas_cumprod, timesteps), samples.dim())
    out = acp.sqrt() * samples.float() + (1.0 - acp).sqrt() * noise.float()
    return out.to(samples.dtype)


def velocity(sched: NoiseSchedule, samples: torch.Tensor,
             noise: torch.Tensor, timesteps) -> torch.Tensor:
    """The v-prediction target sqrt(acp) eps - sqrt(1 - acp) x0."""
    acp = _bcast(_gather(sched.alphas_cumprod, timesteps), samples.dim())
    out = acp.sqrt() * noise.float() - (1.0 - acp).sqrt() * samples.float()
    return out.to(samples.dtype)


def ddim_timesteps(cfg: SchedulerConfig, num_inference_steps: int
                   ) -> np.ndarray:
    """Descending "leading" timesteps plus steps_offset."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
    return ts.astype(np.int64) + cfg.steps_offset


def pred_original_sample(sched: NoiseSchedule, model_output: torch.Tensor,
                         t, sample: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_eps) in fp32 from the model output at timestep t, for
    the schedule's prediction type; clip_sample clips x0 to [-1, 1] and
    recomputes eps from it."""
    acp_t = _bcast(_gather(sched.alphas_cumprod, t), sample.dim())
    x = sample.float()
    out = model_output.float()
    if sched.prediction_type == "epsilon":
        x0 = (x - (1.0 - acp_t).sqrt() * out) / acp_t.sqrt()
        eps = out
    elif sched.prediction_type == "v_prediction":
        x0 = acp_t.sqrt() * x - (1.0 - acp_t).sqrt() * out
        eps = acp_t.sqrt() * out + (1.0 - acp_t).sqrt() * x
    elif sched.prediction_type == "sample":
        x0 = out
        eps = (x - acp_t.sqrt() * x0) / (1.0 - acp_t).sqrt()
    else:
        raise ValueError(f"unknown prediction_type {sched.prediction_type}")
    if sched.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
        eps = (x - acp_t.sqrt() * x0) / (1.0 - acp_t).sqrt()
    return x0, eps


def ddim_step(sched: NoiseSchedule, model_output: torch.Tensor, t, prev_t,
              sample: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t -> x_{prev_t}; prev_t < 0 selects
    final_alpha_cumprod. eta > 0 adds eta * sigma_t of fresh `noise`, which
    it then requires."""
    if eta > 0.0 and noise is None:
        raise ValueError("eta > 0 requires noise")
    nd = sample.dim()
    x0, eps = pred_original_sample(sched, model_output, t, sample)
    acp_prev = _bcast(_acp_prev(sched, prev_t).reshape(-1), nd)
    if eta > 0.0:
        acp_t = _bcast(_gather(sched.alphas_cumprod, t), nd)
        var = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
        std = eta * var.sqrt()
    else:
        std = torch.zeros_like(acp_prev)
    prev = acp_prev.sqrt() * x0 + (1.0 - acp_prev - std ** 2).sqrt() * eps
    if eta > 0.0:
        prev = prev + std * noise.float()
    return prev.to(sample.dtype)


def ddpm_step(sched: NoiseSchedule, model_output: torch.Tensor, t,
              sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One ancestral DDPM update x_t -> x_{t-1} (variance fixed_small); no
    noise is added at t = 0."""
    nd = sample.dim()
    t = torch.as_tensor(t, device=sched.alphas_cumprod.device)
    x0, _ = pred_original_sample(sched, model_output, t, sample)
    acp_t = _bcast(_gather(sched.alphas_cumprod, t), nd)
    acp_prev = _bcast(torch.where(t - 1 >= 0,
                                  _gather(sched.alphas_cumprod, t - 1),
                                  torch.ones_like(sched.final_alpha_cumprod)),
                      nd)
    beta_t = _bcast(_gather(sched.betas, t), nd)
    # posterior mean coefficients (Ho et al. eq. 7)
    coef_x0 = acp_prev.sqrt() * beta_t / (1.0 - acp_t)
    coef_xt = (1.0 - beta_t).sqrt() * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * sample.float()
    var = ((1.0 - acp_prev) / (1.0 - acp_t) * beta_t).clamp(min=1e-20)
    t_b = _bcast(t.reshape(-1), nd)
    prev = mean + torch.where(t_b > 0, var.sqrt() * noise.float(),
                              torch.zeros_like(mean))
    return prev.to(sample.dtype)
