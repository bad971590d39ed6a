"""Masked-region inpainting on the port's UNet and VAE. Counterpart of
storygen_tpu/data_process/inpaint.py (TPUInpainter).

RePaint-style masked DDIM: the masked latents are denoised from noise
while, at every step, the known region is put back at the step's new
noise level, so only the masked pixels are made anew; the image is then
composited in pixels, (1 - mask) * image + mask * decoded. The UNet and
the VAE run on their own kernel routes (F, G and C; P and D in the fused
conv configuration); the schedule and the DDIM update run in fp32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from storygen_tpu_torch.configs import SchedulerConfig
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.utils.device import require_on, resolve_device


def latent_mask(mask: torch.Tensor, size) -> torch.Tensor:
    """(H, W) pixel mask -> (1, h, w, 1) {0, 1} fp32 latent mask: a
    bilinear resize with half-pixel centres and no antialias (the JAX
    package's jax.image.resize(..., "linear", antialias=False)), then > 0."""
    small = F.interpolate(mask.float()[None, None], size=tuple(size),
                          mode="bilinear", align_corners=False,
                          antialias=False)
    return (small > 0).float().permute(0, 2, 3, 1)


class Inpainter:
    """The port of the JAX package's TPUInpainter. `device=None` means the
    card (a RuntimeError without one); the UNet and the VAE must already
    lie on the device it runs on."""

    def __init__(self, unet, vae, sched_cfg: SchedulerConfig = SchedulerConfig(),
                 device=None):
        self.device = resolve_device(device)
        require_on(self.device, unet=unet, vae=vae)
        self.unet, self.vae = unet, vae
        self.sched_cfg = sched_cfg
        self.schedule = S.make_schedule(sched_cfg, device=self.device)

    @torch.no_grad()
    def inpaint_latents(self, latents0: torch.Tensor,
                        latent_mask: torch.Tensor, text_emb: torch.Tensor,
                        noise: torch.Tensor,
                        num_inference_steps: int = 25) -> torch.Tensor:
        """latents0 (B, h, w, 4): the clean latents of the image;
        latent_mask (B, h, w, 1), 1 = the region to make anew; text_emb
        (B, 77, D); noise (B, h, w, 4) N(0, 1), the start's draw (also the
        noise of every re-injection). Returns the inpainted latents in
        fp32, equal to latents0 outside the mask."""
        sched, cfg = self.schedule, self.sched_cfg
        ts = S.ddim_timesteps(cfg, num_inference_steps)
        ratio = cfg.num_train_timesteps // num_inference_steps
        prevs = np.append(ts[1:], ts[-1] - ratio)
        latents0 = latents0.float()
        m = latent_mask.float()
        x = S.add_noise(sched, latents0, noise, int(ts[0]))
        for t, prev_t in zip(ts.tolist(), prevs.tolist()):
            eps, _ = self.unet(x, t, text_emb)
            x_prev = S.ddim_step(sched, eps.float(), t, prev_t, x)
            # the known region, at the noise level of the step's target
            known = (S.add_noise(sched, latents0, noise, prev_t)
                     if prev_t >= 0 else latents0)
            x = known * (1.0 - m) + x_prev * m
        return latents0 * (1.0 - m) + x * m

    @torch.no_grad()
    def inpaint_image(self, text_encoder, tokenizer, image: np.ndarray,
                      mask: np.ndarray, prompt: str = "",
                      generator: Optional[torch.Generator] = None,
                      num_inference_steps: int = 25,
                      posterior_noise: Optional[torch.Tensor] = None,
                      latent_noise: Optional[torch.Tensor] = None
                      ) -> np.ndarray:
        """image (H, W, 3) in [0, 1]; mask (H, W), nonzero = the region to
        make anew. Returns (H, W, 3) float32: the image outside the mask,
        the decoded inpainting inside it.

        The two N(0, 1) draws, the posterior's (1, H/8, W/8, 4) and then
        the start's (1, H/8, W/8, 4), are `posterior_noise` and
        `latent_noise` where given, else drawn in that order from
        `generator` (None: a generator on the device seeded 0, the JAX
        package's default key)."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=dev)[None] * 2.0 - 1.0
        dist = self.vae.encode(img)
        if posterior_noise is None:
            posterior_noise = torch.randn(dist.mean.shape,
                                          generator=generator, device=dev)
        sf = self.vae.config.scaling_factor
        lat0 = dist.sample(posterior_noise.to(dev)) * sf
        lat_mask = latent_mask(torch.as_tensor(
            np.asarray(mask, np.float32), device=dev), lat0.shape[1:3])
        ids = torch.as_tensor(np.asarray(tokenizer([prompt])),
                              dtype=torch.long, device=dev)
        text = text_encoder(ids)
        if latent_noise is None:
            latent_noise = torch.randn(lat0.shape, generator=generator,
                                       device=dev)
        lat = self.inpaint_latents(lat0, lat_mask, text, latent_noise.to(dev),
                                   num_inference_steps=num_inference_steps)
        dec = self.vae.decode(lat / sf)
        out = (dec[0].float() / 2 + 0.5).clamp(0.0, 1.0).cpu().numpy()
        m3 = np.asarray(mask, np.float32)[:, :, None]
        return image * (1 - m3) + out * m3
