"""PNDM (PLMS) sampler with skip_prk_steps, the scheduler class the SD-1.5
checkpoint names.

Counterpart of storygen_tpu/diffusion/pndm.py: a 4th-order
Adams-Bashforth multistep over eps predictions (Liu et al. 2022,
arXiv:2202.09778), its first two steps bootstrapped by a plain transfer
and by a trapezoid average re-evaluated at the same sample, which is why
the timestep list has n+1 entries with the second visited twice. The
history is a (4, ...) ring, newest last; the step counter is the loop
index, and the counter-1 timestep juggling lives in the host tables of
`plms_timesteps`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig
from storygen_tpu_torch.diffusion.schedule import (NoiseSchedule, _acp_prev,
                                                   _bcast, _gather)


class PNDMState(NamedTuple):
    ets: torch.Tensor         # (4, B, ...) fp32 eps history, newest at [3]
    cur_sample: torch.Tensor  # the sample counter 1 re-evaluates


def init_state(sample: torch.Tensor) -> PNDMState:
    z = torch.zeros((4,) + tuple(sample.shape), dtype=torch.float32,
                    device=sample.device)
    return PNDMState(z, torch.zeros_like(sample, dtype=torch.float32))


def plms_timesteps(cfg: SchedulerConfig, num_inference_steps: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t_eval, t_coeff, prev_coeff), each of n+1 descending entries.

    PNDMScheduler.set_timesteps with skip_prk_steps: ascending arange(n) *
    ratio + steps_offset, then [:-1] + [-2:-1] + [-1:], reversed. t_eval
    is what the UNet and ref_t see; (t_coeff, prev_coeff) feed the
    transfer formula, with counter 1's (prev = t, t = t + ratio)."""
    n = num_inference_steps
    ratio = cfg.num_train_timesteps // n
    ts = (np.arange(0, n) * ratio).round().astype(np.int64) + cfg.steps_offset
    plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    t_eval = plms.copy()
    t_coeff = plms.copy()
    prev_coeff = plms - ratio
    if len(t_eval) > 1:
        prev_coeff[1] = t_eval[1]
        t_coeff[1] = t_eval[1] + ratio
    return t_eval, t_coeff, prev_coeff


def _transfer(sched: NoiseSchedule, sample: torch.Tensor, t, prev_t,
              eps: torch.Tensor) -> torch.Tensor:
    """The PNDM transfer (paper eq. 11; diffusers _get_prev_sample):
    sqrt(acp_prev / acp_t) x - (acp_prev - acp_t) eps / denom, with denom =
    acp_t sqrt(1 - acp_prev) + sqrt(acp_t (1 - acp_t) acp_prev)."""
    nd = sample.dim()
    acp_t = _bcast(_gather(sched.alphas_cumprod, t), nd)
    acp_prev = _bcast(_acp_prev(sched, prev_t).reshape(-1), nd)
    coeff = (acp_prev / acp_t).sqrt()
    denom = (acp_t * (1.0 - acp_prev).sqrt()
             + (acp_t * (1.0 - acp_t) * acp_prev).sqrt())
    return coeff * sample - (acp_prev - acp_t) * eps / denom


def plms_step(sched: NoiseSchedule, eps: torch.Tensor, i: int, t_coeff,
              prev_coeff, sample: torch.Tensor, state: PNDMState
              ) -> Tuple[torch.Tensor, PNDMState]:
    """One PLMS update at loop counter `i` (0-based, diffusers' counter);
    `eps` is the model output at t_eval[i]."""
    x = sample.float()
    e = eps.float()
    ets = state.ets
    # every counter but 1 appends to the history (diffusers step_plms)
    appended = torch.cat([ets[1:], e[None]])
    if i == 0:    # plain transfer; remember the sample
        model_out, x_used = e, x
    elif i == 1:  # trapezoid of (new, last) at the same sample
        model_out, x_used = (e + ets[3]) / 2.0, state.cur_sample
    elif i == 2:  # 2-step Adams-Bashforth
        model_out, x_used = (3.0 * appended[3] - appended[2]) / 2.0, x
    elif i == 3:
        model_out = (23.0 * appended[3] - 16.0 * appended[2]
                     + 5.0 * appended[1]) / 12.0
        x_used = x
    else:         # 4-step, the steady state
        model_out = (55.0 * appended[3] - 59.0 * appended[2]
                     + 37.0 * appended[1] - 9.0 * appended[0]) / 24.0
        x_used = x
    prev = _transfer(sched, x_used, t_coeff, prev_coeff, model_out)
    new_state = PNDMState(ets if i == 1 else appended,
                          x if i == 0 else state.cur_sample)
    return prev.to(sample.dtype), new_state
