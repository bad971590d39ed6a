"""StoryGen inference: the per-frame auto-regressive story path.

Counterpart of storygen_tpu/pipeline.py for stage "no" and
"auto-regressive" with DDIM (eta = 0) and `ref_feature_interval=1`:
3-way classifier-free guidance, one batched reference-cycle UNet pass per
step with the exact CFG-row dedup, the image-cycle pass, the DDIM update,
VAE encode of the history frames and VAE decode. The UNet, VAE and CLIP run
in their parameters' dtype; the schedule, the CFG combine and the DDIM
update run in fp32. `device=None` means the card (a RuntimeError without
one); the models must already lie on the device the sampler and the
pipeline run on.

Not ported yet: stage "multi-image-condition", the other samplers, eta > 0,
`ref_feature_interval > 1`, negative prompts, `normalize_refs`,
`story_rollout` and `reuse_latents`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.utils.device import require_on, resolve_device

STAGES = ("no", "auto-regressive")


def _ref_timesteps(ref_t: int, num_refs: int) -> torch.Tensor:
    """Noise level per reference frame in the auto-regressive stage: older
    frames are noised harder, ref_t * (N - i)."""
    return ref_t * torch.arange(num_refs, 0, -1)


def frame_generator(device, seed: int, frame: int) -> torch.Generator:
    """The generator of one story frame: distinct per (seed, frame), as
    fold_in(rng, k) is in the JAX package."""
    state = np.random.SeedSequence([seed, frame]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class StoryGenSampler:
    def __init__(self, unet, vae, sched_cfg: SchedulerConfig = SchedulerConfig(),
                 device=None):
        self.device = resolve_device(device)
        require_on(self.device, unet=unet, vae=vae)
        self.unet = unet
        self.vae = vae
        self.sched_cfg = sched_cfg
        self.schedule = S.make_schedule(sched_cfg, device=self.device)

    def encode_ref_latents(self, images: torch.Tensor,
                           noise: torch.Tensor) -> torch.Tensor:
        """(N, B, H, W, 3) -> (N, B, h, w, 4) posterior draws scaled by
        0.18215, with `noise` (N*B, h, w, 4) the posterior's N(0, 1) draw."""
        n, b = images.shape[:2]
        dist = self.vae.encode(images.reshape((n * b,) + images.shape[2:]))
        z = dist.sample(noise) * self.vae.config.scaling_factor
        return z.reshape((n, b) + z.shape[1:])

    @torch.no_grad()
    def sample(self, latents: torch.Tensor, text_emb_uncond: torch.Tensor,
               text_emb_cond: torch.Tensor,
               ref_latents: Optional[torch.Tensor],
               zero_latents: Optional[torch.Tensor],
               prev_text_uncond: Optional[torch.Tensor],
               prev_text_cond: Optional[torch.Tensor],
               noise: torch.Tensor, guidance_scale: float,
               image_guidance_scale: float, *, stage: str,
               num_inference_steps: int) -> torch.Tensor:
        """The DDIM (eta = 0) denoising loop, recomputing the reference
        features at every step; arguments as in the JAX sampler:
        latents (B, h, w, 4); text (B, 77, D); ref_latents (N, B, h, w, 4);
        zero_latents (B, h, w, 4); prev_text_* (N, B, 77, D); noise
        (B, h, w, 4), the one draw reused for ref noising at every step.
        Returns the final latents (B, h, w, 4) in fp32."""
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        sched = self.schedule
        ts = S.ddim_timesteps(self.sched_cfg, num_inference_steps)
        ratio = self.sched_cfg.num_train_timesteps // num_inference_steps
        prev_ts = list(ts[1:]) + [int(ts[-1]) - ratio]
        b = latents.shape[0]
        use_refs = stage == "auto-regressive"
        latents = latents.float()
        if use_refs:
            num_refs = ref_latents.shape[0]
            text3 = torch.cat([text_emb_uncond, text_emb_uncond,
                               text_emb_cond])
            # reference-pass rows per ref: [zero | uncond], [ref | cond];
            # the reference's third row (ref | cond) duplicates the second
            prev2 = torch.cat([prev_text_uncond, prev_text_cond], dim=1)
            prev2_flat = prev2.reshape((num_refs * 2 * b,) + prev2.shape[2:])
            zero_b = zero_latents[None].expand(ref_latents.shape)
        else:
            text2 = torch.cat([text_emb_uncond, text_emb_cond])

        for t, prev_t in zip(ts.tolist(), prev_ts):
            t = int(t)
            if use_refs:
                ref_ts = _ref_timesteps(t // 10, num_refs)
                noisy_refs = S.add_noise(sched, ref_latents, noise[None],
                                         ref_ts)
                noisy_zero = S.add_noise(sched, zero_b, noise[None], ref_ts)
                pair = torch.cat([noisy_zero, noisy_refs], dim=1)
                pair_flat = pair.reshape((num_refs * 2 * b,) + pair.shape[2:])
                t_flat = ref_ts.repeat_interleave(2 * b).to(latents.device)
                _, raw = self.unet(pair_flat, t_flat, prev2_flat)
                ctx = {k: self._expand(v, num_refs, b) for k, v in raw.items()}
                lat_in = torch.cat([latents] * 3)
                t_in = torch.full((3 * b,), t, device=latents.device)
                eps3, _ = self.unet(lat_in, t_in, text3, ctx)
                eps_u, eps_i, eps_a = eps3.float().chunk(3)
                eps = (eps_u + image_guidance_scale * (eps_i - eps_u)
                       + guidance_scale * (eps_a - eps_i))
            else:
                t_in = torch.full((2 * b,), t, device=latents.device)
                eps2, _ = self.unet(torch.cat([latents] * 2), t_in, text2)
                eps_u, eps_c = eps2.float().chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            latents = S.ddim_step(sched, eps, t, int(prev_t), latents)
        return latents

    @staticmethod
    def _expand(v: torch.Tensor, num_refs: int, b: int) -> torch.Tensor:
        """(N*2B, S, C) -> (2B, N*S, C) -> the 3-row CFG layout
        [zero, ref, ref] as (3B, N*S, C)."""
        v = (v.reshape((num_refs, 2 * b) + v.shape[1:]).transpose(0, 1)
             .reshape(2 * b, num_refs * v.shape[1], v.shape[2]))
        return torch.cat([v, v[b:]])

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images in [0, 1], fp32."""
        img = self.vae.decode(latents / self.vae.config.scaling_factor)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0)


class StoryGenPipeline:
    """Tokenize -> encode text -> sample -> decode.

    `tokenizer` maps a list of B strings to (B, 77) token ids (an array, a
    tensor, or a dict / object with "input_ids")."""

    def __init__(self, unet, vae, text_encoder,
                 tokenizer: Callable[[List[str]], object],
                 sched_cfg: SchedulerConfig = SchedulerConfig(),
                 device=None):
        self.device = resolve_device(device)
        require_on(self.device, text_encoder=text_encoder)
        self.sampler = StoryGenSampler(unet, vae, sched_cfg, self.device)
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.tokenizer(list(prompts))
        if isinstance(ids, dict) or hasattr(ids, "input_ids"):
            ids = ids["input_ids"]
        return torch.as_tensor(np.asarray(ids), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.text_encoder(self.tokenize(prompts))

    def __call__(self, stage: str, prompt: Sequence[str],
                 image_prompt=None, prev_prompt=None, **kw) -> np.ndarray:
        """Generate (B, H, W, 3) images in [0, 1]; see `_generate`."""
        images, _ = self._generate(stage, prompt, image_prompt=image_prompt,
                                   prev_prompt=prev_prompt, **kw)
        return images

    @torch.no_grad()
    def _generate(self, stage: str, prompt: Sequence[str],
                  image_prompt=None,
                  prev_prompt: Optional[Sequence[Sequence[str]]] = None,
                  height: int = 512, width: int = 512,
                  num_inference_steps: int = 50,
                  guidance_scale: float = 7.5,
                  image_guidance_scale: float = 3.5,
                  generator: Optional[torch.Generator] = None,
                  latents: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  ref_posterior_noise: Optional[torch.Tensor] = None,
                  zero_posterior_noise: Optional[torch.Tensor] = None
                  ) -> Tuple[np.ndarray, torch.Tensor]:
        """Returns (images (B, H, W, 3) in [0, 1], final latents).

        image_prompt: (N, B, H, W, 3) reference frames, fed to the VAE as
          they are (the reference-checkpoint convention is [0, 1]).
        prev_prompt: N lists of B captions for the reference frames.
        latents, noise (B, h, w, 4), ref_posterior_noise (N*B, h, w, 4) and
          zero_posterior_noise (B, h, w, 4) replace the draws from
          `generator` when given, so that two implementations can be fed
          the same random numbers.
        """
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        dev = self.device
        b = len(prompt)
        shape = (b, height // 8, width // 8, 4)

        def draw(given, shp):
            if given is not None:
                return torch.as_tensor(given, dtype=torch.float32, device=dev)
            return torch.randn(shp, generator=generator, device=dev)

        latents = draw(latents, shape) * self.sampler.schedule.init_noise_sigma
        text_cond = self.encode_prompt(prompt)
        text_uncond = self.encode_prompt([""] * b)
        ref_latents = zero_latents = prev_u = prev_c = None
        if stage == "auto-regressive":
            if prev_prompt is None or image_prompt is None:
                raise ValueError(f"stage {stage} needs prev_prompt and "
                                 "image_prompt")
            imgs = torch.as_tensor(image_prompt, dtype=torch.float32,
                                   device=dev)
            n = imgs.shape[0]
            ref_latents = self.sampler.encode_ref_latents(
                imgs, draw(ref_posterior_noise, (n * b,) + shape[1:]))
            zdist = self.vae.encode(torch.zeros((b, height, width, 3),
                                                device=dev))
            zero_latents = (zdist.sample(draw(zero_posterior_noise, shape))
                            * self.vae.config.scaling_factor)
            prev_c = torch.stack([self.encode_prompt(p) for p in prev_prompt])
            prev_u = torch.stack([self.encode_prompt([""] * b)
                                  for _ in prev_prompt])
        noise = draw(noise, shape)
        final = self.sampler.sample(
            latents, text_uncond, text_cond, ref_latents, zero_latents,
            prev_u, prev_c, noise, guidance_scale, image_guidance_scale,
            stage=stage, num_inference_steps=num_inference_steps)
        images = self.sampler.decode(final)
        return images.cpu().numpy(), final

    def generate_story(self, prompts: Sequence[str],
                       first_frame: Optional[np.ndarray] = None,
                       first_caption: Optional[str] = None,
                       max_refs: int = 3, seed: int = 0, **kw) -> List[np.ndarray]:
        """Frame k is conditioned on up to `max_refs` previous frames and
        their captions; frame 1 (without a `first_frame`) runs stage "no".
        Each frame draws from its own generator (`frame_generator`).
        Returns the frames, each (H, W, 3) in [0, 1]."""
        history: List[Tuple[np.ndarray, str]] = []
        if first_frame is not None:
            history.append((np.asarray(first_frame),
                            first_caption or prompts[0]))
        frames: List[np.ndarray] = []
        for k, prompt in enumerate(prompts):
            gen = frame_generator(self.device, seed, k)
            if not history:
                img = self(stage="no", prompt=[prompt], generator=gen, **kw)
            else:
                hist = history[-max_refs:]
                refs = np.stack([f for f, _ in hist])[:, None]
                img = self(stage="auto-regressive", prompt=[prompt],
                           image_prompt=refs, generator=gen,
                           prev_prompt=[[c] for _, c in hist], **kw)
            frames.append(img[0])
            history.append((img[0], prompt))
        return frames
