"""Data-parallel batched serving: each rank samples its rows of the batch.

Counterpart of storygen_tpu/parallel/serving.py. There one program holds
the whole batch, sharded over the mesh, and returns it whole. Here every
rank runs `StoryGenSampler.sample` on its own rows, with its own replica of
the models, and the rows come back together on every rank: each rank
writes its block into a zeroed buffer of the full batch, and one fp32
all-reduce over the batch axes sums the blocks (gloo has no all-gather of
CUDA tensors). Sampling itself needs no collective.

Usage, in every rank:
    mesh = make_mesh()
    latents = sample_data_parallel(sampler, mesh, latents, ...same args...)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from storygen_tpu_torch.parallel.mesh import Mesh, batch_rows


def place_sample_args(mesh: Mesh, latents, text_u, text_c, ref_latents,
                      zero_latents, prev_u, prev_c, noise,
                      step_noise=None) -> Tuple[Optional[torch.Tensor], ...]:
    """This rank's rows of the sampler's batch-major arguments: axis 0 of
    the (B, ...) ones, axis 1 of the ref-major (N, B, ...) ones and of
    step_noise (n_iters, B, ...)."""
    rows = batch_rows(mesh, latents.shape[0])

    def axis0(x):
        return None if x is None else x[rows]

    def axis1(x):
        return None if x is None else x[:, rows]

    return (axis0(latents), axis0(text_u), axis0(text_c), axis1(ref_latents),
            axis0(zero_latents), axis1(prev_u), axis1(prev_c), axis0(noise),
            axis1(step_noise))


def sample_data_parallel(sampler, mesh: Mesh, latents, text_u, text_c,
                         ref_latents, zero_latents, prev_u, prev_c, noise,
                         guidance_scale, image_guidance_scale, *, stage,
                         num_inference_steps, step_noise=None,
                         **kw) -> torch.Tensor:
    """StoryGenSampler.sample with the batch split over the mesh's batch
    axes; returns the full batch's final latents (B, h, w, 4) on every
    rank. The batch must split evenly; the other keyword arguments go to
    `sample` (a `generator` for stochastic samplers would draw per rank:
    pass `step_noise` to keep the single-process draws)."""
    placed = place_sample_args(mesh, latents, text_u, text_c, ref_latents,
                               zero_latents, prev_u, prev_c, noise,
                               step_noise)
    mine = sampler.sample(*placed[:8], guidance_scale, image_guidance_scale,
                          stage=stage, num_inference_steps=num_inference_steps,
                          step_noise=placed[8], **kw)
    if not dist.is_initialized():
        return mine
    full = torch.zeros((latents.shape[0],) + tuple(mine.shape[1:]),
                       dtype=torch.float32, device=mine.device)
    full[batch_rows(mesh, latents.shape[0])] = mine
    dist.all_reduce(full, op=dist.ReduceOp.SUM,
                    group=mesh.group(*mesh.batch_axes))
    return full
