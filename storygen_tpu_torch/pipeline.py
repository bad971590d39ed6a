"""StoryGen inference: the six samplers, the three stages and the story
paths.

Counterpart of storygen_tpu/pipeline.py: stages "no",
"multi-image-condition" and "auto-regressive"; samplers ddim (with eta),
dpm++, pndm, lms, euler and euler_a; 3-way classifier-free guidance; one
batched reference-cycle UNet pass per step (the exact CFG-row dedup; in
"multi-image-condition" one shared zero-row group), reused for
`ref_feature_interval` steps; negative prompts and several images per
prompt; VAE encode of the history frames and VAE decode; and the story as
per-frame calls, as a rollout on cached posterior moments
(`story_rollout`, fused=True) or on fed-back latents (reuse_latents). The
UNet, VAE and CLIP run in their parameters' dtype; the schedule, the CFG
combine and the sampler updates run in fp32. `device=None` means the card
(a RuntimeError without one); the models must already lie on the device
the sampler and the pipeline run on.

Random draws come from a draw provider, `draw(frame, name, shape)`, with
`name` one of DRAWS; both story paths ask for them in that order, so they
take the same draws. The default provider (`seeded_draws`) draws frame k
from `frame_generator(device, seed, k)`.

`StoryGenPipeline.save_pretrained` writes the diffusers folder that
checkpoint/hf_import.py loads. `numpy_to_pil` (also a method) needs PIL,
imported there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig
from storygen_tpu_torch.diffusion import dpm_solver as D
from storygen_tpu_torch.diffusion import euler as E
from storygen_tpu_torch.diffusion import lms as L
from storygen_tpu_torch.diffusion import pndm as P
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.models.vae import DiagonalGaussian
from storygen_tpu_torch.utils.device import require_on, resolve_device

STAGES = ("no", "multi-image-condition", "auto-regressive")
SAMPLERS = ("ddim", "dpm++", "pndm", "lms", "euler", "euler_a")
# the draws of one frame, in the order both story paths ask for them
DRAWS = ("latents", "ref_posterior", "zero_posterior", "noise", "step")

Draw = Callable[[int, str, Tuple[int, ...]], torch.Tensor]


def frame_generator(device, seed: int, frame: int) -> torch.Generator:
    """The generator of one story frame: distinct per (seed, frame), as
    fold_in(rng, k) is in the JAX package."""
    state = np.random.SeedSequence([seed, frame]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def seeded_draws(device, seed: int) -> Draw:
    """The default draw provider: frame k's draws, N(0, 1) in fp32, come
    from frame_generator(device, seed, k) in the order they are asked for."""
    gens: Dict[int, torch.Generator] = {}

    def draw(frame: int, name: str, shape) -> torch.Tensor:
        if frame not in gens:
            gens[frame] = frame_generator(device, seed, frame)
        return torch.randn(tuple(shape), generator=gens[frame], device=device)
    return draw


class Timesteps(NamedTuple):
    """A sampler's host tables, one entry per UNet step."""
    t: np.ndarray                     # the UNet's timesteps (lms: float32)
    prev: Optional[np.ndarray]        # the update's target timesteps
    t_coeff: Optional[np.ndarray]     # pndm: the transfer's timesteps
    sigmas: Optional[np.ndarray]      # lms: (n+1,) sigmas
    coeffs: Optional[np.ndarray]      # lms: (n, 4) multistep weights, fp64


def timesteps(cfg: SchedulerConfig, sampler: str,
              num_inference_steps: int) -> Timesteps:
    """The tables of `sampler` at `num_inference_steps` (pndm runs n+1
    UNet steps)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; one of {SAMPLERS}")
    if sampler == "pndm":
        t_eval, t_coeff, prev = P.plms_timesteps(cfg, num_inference_steps)
        return Timesteps(t_eval, prev, t_coeff, None, None)
    if sampler == "lms":
        t_eval, sigmas, coeffs = L.lms_tables(cfg, num_inference_steps)
        return Timesteps(t_eval, None, None, sigmas, coeffs)
    ts = S.ddim_timesteps(cfg, num_inference_steps)
    ratio = cfg.num_train_timesteps // num_inference_steps
    return Timesteps(ts, np.append(ts[1:], ts[-1] - ratio), None, None, None)


def stochastic(sampler: str, eta: float) -> bool:
    """Whether a sampler takes fresh noise at every step."""
    return sampler == "euler_a" or (sampler == "ddim" and eta > 0.0)


def _ref_timesteps(stage: str, ref_t, num_refs: int) -> np.ndarray:
    """Noise level per reference frame: "auto-regressive" noises older
    frames harder, ref_t * (N - i); "multi-image-condition" noises all
    alike. In the dtype of ref_t (lms: float)."""
    if stage == "auto-regressive":
        return ref_t * np.arange(num_refs, 0, -1).astype(ref_t.dtype)
    return np.full(num_refs, ref_t)


class StoryGenSampler:
    def __init__(self, unet, vae, sched_cfg: SchedulerConfig = SchedulerConfig(),
                 device=None):
        self.device = resolve_device(device)
        require_on(self.device, unet=unet, vae=vae)
        self.unet = unet
        self.vae = vae
        self.sched_cfg = sched_cfg
        self.schedule = S.make_schedule(sched_cfg, device=self.device)

    @torch.no_grad()
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
               num_inference_steps: int, sampler: str = "ddim",
               eta: float = 0.0, step_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               ref_feature_interval: int = 1) -> torch.Tensor:
        """The denoising loop; arguments as in the JAX sampler:
        latents (B, h, w, 4) unit-variance; text (B, 77, D); ref_latents
        (N, B, h, w, 4); zero_latents (B, h, w, 4); prev_text_* (N, B, 77,
        D); noise (B, h, w, 4), the one draw reused for ref noising at every
        step. `sampler` is one of SAMPLERS (pndm runs n+1 UNet steps).
        eta > 0 (ddim) and euler_a take fresh noise at every step: row i of
        `step_noise` (n_iters, B, h, w, 4), else a draw from `generator`.
        The reference pass runs at the steps i with i % ref_feature_interval
        == 0 and its context is reused in between.
        Returns the final latents (B, h, w, 4) in fp32."""
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        tab = timesteps(self.sched_cfg, sampler, num_inference_steps)
        if (stochastic(sampler, eta) and step_noise is None
                and generator is None):
            raise ValueError("eta > 0 and euler_a need step_noise or a "
                             "generator")
        sched = self.schedule
        dev = latents.device
        use_refs = stage != "no"
        latents = latents.float()
        if sampler in ("euler", "euler_a"):
            # lift the unit-variance latents into sigma space
            latents = (latents / sched.init_noise_sigma
                       * E.sigma_of(sched, tab.t[0]))
        elif sampler == "lms":
            latents = latents / sched.init_noise_sigma * float(tab.sigmas[0])
        state = None  # the multistep samplers' history
        if sampler == "dpm++":
            state = D.init_state(latents)
        elif sampler == "pndm":
            state = P.init_state(latents)
        elif sampler == "lms":
            state = L.init_state(latents)
        if use_refs:
            text3 = torch.cat([text_emb_uncond, text_emb_uncond,
                               text_emb_cond])
            refs = (ref_latents, zero_latents, prev_text_uncond,
                    prev_text_cond, noise)
        else:
            text2 = torch.cat([text_emb_uncond, text_emb_cond])

        ctx = None
        for i, t in enumerate(tab.t):
            if sampler in ("euler", "euler_a"):
                model_lat = E.scale_model_input(sched, latents, t)
            elif sampler == "lms":
                model_lat = L.scale_model_input(latents, tab.sigmas[i])
            else:
                model_lat = latents
            t_in = torch.as_tensor(t, device=dev)
            if use_refs:
                if i % ref_feature_interval == 0:
                    ctx = self._reference_context(stage, t, *refs)
                eps3, _ = self.unet(torch.cat([model_lat] * 3), t_in, text3,
                                    ctx)
                eps_u, eps_i, eps_a = eps3.float().chunk(3)
                eps = (eps_u + image_guidance_scale * (eps_i - eps_u)
                       + guidance_scale * (eps_a - eps_i))
            else:
                eps2, _ = self.unet(torch.cat([model_lat] * 2), t_in, text2)
                eps_u, eps_c = eps2.float().chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)

            z = None
            if stochastic(sampler, eta):
                z = (step_noise[i] if step_noise is not None else
                     torch.randn(latents.shape, generator=generator,
                                 device=dev))
            if sampler == "dpm++":
                latents, state = D.dpmpp_2m_step(sched, eps, int(t),
                                                 int(tab.prev[i]), latents,
                                                 state)
            elif sampler == "pndm":
                latents, state = P.plms_step(sched, eps, i, tab.t_coeff[i],
                                             tab.prev[i], latents, state)
            elif sampler == "lms":
                latents, state = L.lms_step(eps, tab.coeffs[i], latents,
                                            state)
            elif sampler == "euler":
                latents = E.euler_step(sched, eps, t, tab.prev[i], latents)
            elif sampler == "euler_a":
                latents = E.euler_ancestral_step(sched, eps, t, tab.prev[i],
                                                 latents, z)
            else:
                latents = S.ddim_step(sched, eps, t, tab.prev[i], latents,
                                      eta=eta, noise=z)
        return latents

    def _reference_context(self, stage: str, t, ref_latents, zero_latents,
                           prev_text_uncond, prev_text_cond, noise
                           ) -> Dict[str, torch.Tensor]:
        """One batched reference-cycle UNet pass at ref_t = t // 10 (float
        division floored for lms's float t); returns the context in the
        3-row CFG layout [zero, ref, ref] as (3B, N*S, C) per key."""
        sched = self.schedule
        num_refs, b = ref_latents.shape[:2]
        dev = ref_latents.device
        ref_t = t // 10
        ref_ts = torch.as_tensor(_ref_timesteps(stage, ref_t, num_refs),
                                 device=dev)
        noisy_refs = S.add_noise(sched, ref_latents, noise[None], ref_ts)
        if stage == "multi-image-condition":
            # all refs share ref_t, so the N zero-image rows would be equal:
            # one zero-row group and N ref groups, (N+1)B rows
            noisy_zero = S.add_noise(sched, zero_latents, noise, ref_ts[0])
            stack = torch.cat([noisy_zero[None], noisy_refs])
            text = torch.cat([prev_text_uncond[:1], prev_text_cond])
            rows = (num_refs + 1) * b
            _, raw = self.unet(stack.reshape((rows,) + stack.shape[2:]),
                               ref_ts[:1].expand(rows),
                               text.reshape((rows,) + text.shape[2:]))
            return {k: self._expand_shared(v, num_refs, b)
                    for k, v in raw.items()}
        # auto-regressive: the zero rows differ per ref; reference-pass
        # rows per ref [zero | uncond], [ref | cond] (the reference's third
        # row, ref | cond, duplicates the second)
        noisy_zero = S.add_noise(sched, zero_latents[None].expand(
            ref_latents.shape), noise[None], ref_ts)
        pair = torch.cat([noisy_zero, noisy_refs], dim=1)
        prev2 = torch.cat([prev_text_uncond, prev_text_cond], dim=1)
        rows = num_refs * 2 * b
        _, raw = self.unet(pair.reshape((rows,) + pair.shape[2:]),
                           ref_ts.repeat_interleave(2 * b),
                           prev2.reshape((rows,) + prev2.shape[2:]))
        return {k: self._expand(v, num_refs, b) for k, v in raw.items()}

    @staticmethod
    def _expand(v: torch.Tensor, num_refs: int, b: int) -> torch.Tensor:
        """(N*2B, S, C) -> (2B, N*S, C) -> the 3-row CFG layout
        [zero, ref, ref] as (3B, N*S, C)."""
        v = (v.reshape((num_refs, 2 * b) + v.shape[1:]).transpose(0, 1)
             .reshape(2 * b, num_refs * v.shape[1], v.shape[2]))
        return torch.cat([v, v[b:]])

    @staticmethod
    def _expand_shared(v: torch.Tensor, num_refs: int, b: int
                       ) -> torch.Tensor:
        """((N+1)*B, S, C), the zero group first -> [zero tiled N times
        along kv, ref, ref] as (3B, N*S, C)."""
        g = v.reshape((num_refs + 1, b) + v.shape[1:])
        ref = g[1:].transpose(0, 1).reshape(b, num_refs * v.shape[1],
                                             v.shape[2])
        return torch.cat([g[0].repeat(1, num_refs, 1), ref, ref])

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images in [0, 1], fp32."""
        img = self.vae.decode(latents / self.vae.config.scaling_factor)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0)

    def step_noise(self, draw: Callable, sampler: str, eta: float,
                   num_inference_steps: int, shape) -> Optional[torch.Tensor]:
        """The per-step noise (n_iters, *shape) from `draw("step", ...)`, or
        None when the sampler takes none (nothing is drawn then)."""
        if not stochastic(sampler, eta):
            return None
        n = len(timesteps(self.sched_cfg, sampler, num_inference_steps).t)
        return draw("step", (n,) + tuple(shape))

    @torch.no_grad()
    def story_rollout(self, text_uncond: torch.Tensor,
                      text_conds: torch.Tensor, draw: Draw,
                      guidance_scale: float, image_guidance_scale: float,
                      first_frame: Optional[torch.Tensor] = None,
                      first_caption_emb: Optional[torch.Tensor] = None, *,
                      num_inference_steps: int = 50, max_refs: int = 3,
                      sampler: str = "ddim", eta: float = 0.0,
                      ref_feature_interval: int = 1,
                      normalize_refs: bool = False, height: int = 512,
                      width: int = 512) -> torch.Tensor:
        """The whole story, frame by frame, in one call: frame 1 (without a
        first frame) in stage "no", frame k conditioned on up to `max_refs`
        earlier frames in stage "auto-regressive", as the per-frame
        generate_story does, with the same draws, but

        - the zero image is VAE-encoded once;
        - each frame's pixels pass through the VAE encoder once: its
          posterior moments are kept and re-sampled with the draw of every
          frame that it serves as a reference to;
        - the captions' embeddings are kept, not re-encoded.

        Frames are dispatched one denoise step at a time, as in the
        per-frame path; the story is not captured as one CUDA graph.

        text_uncond (B, 77, D); text_conds (F, B, 77, D), one caption per
        frame; draw(frame, name, shape), see DRAWS; first_frame (B, H, W,
        3) in [0, 1] with first_caption_emb (B, 77, D); normalize_refs
        feeds history frames to the VAE in [-1, 1].
        Returns (F, B, H, W, 3) frames in [0, 1], fp32."""
        b = text_uncond.shape[0]
        shape = (b, height // 8, width // 8, 4)
        sf = self.vae.config.scaling_factor
        dev = self.device

        def encode(img):
            return self.vae.encode(img * 2.0 - 1.0 if normalize_refs
                                   else img)

        zero_dist = self.vae.encode(torch.zeros((b, height, width, 3),
                                                device=dev))
        hist_m: List[DiagonalGaussian] = []
        hist_c: List[torch.Tensor] = []
        if first_frame is not None:
            hist_m.append(encode(first_frame.float()))
            hist_c.append(first_caption_emb)
        frames = []
        for k in range(text_conds.shape[0]):
            d = functools.partial(draw, k)
            lat0 = d("latents", shape) * self.schedule.init_noise_sigma
            n = min(len(hist_m), max_refs)
            refs = zero = prev_u = prev_c = None
            if n:
                flat = DiagonalGaussian(
                    torch.cat([m.mean for m in hist_m[-n:]]),
                    torch.cat([m.logvar for m in hist_m[-n:]]))
                refs = (flat.sample(d("ref_posterior", (n * b,) + shape[1:]))
                        * sf).reshape((n,) + shape)
                zero = zero_dist.sample(d("zero_posterior", shape)) * sf
                prev_c = torch.stack(hist_c[-n:])
                prev_u = text_uncond[None].expand((n,) + text_uncond.shape)
            noise = d("noise", shape)
            lat = self.sample(
                lat0, text_uncond, text_conds[k], refs, zero, prev_u, prev_c,
                noise, guidance_scale, image_guidance_scale,
                stage="auto-regressive" if n else "no",
                num_inference_steps=num_inference_steps, sampler=sampler,
                eta=eta, step_noise=self.step_noise(
                    d, sampler, eta, num_inference_steps, shape),
                ref_feature_interval=ref_feature_interval)
            img = self.decode(lat)
            frames.append(img)
            if k + 1 < text_conds.shape[0]:  # the last frame is no ref
                hist_m.append(encode(img))
                hist_c.append(text_conds[k])
        return torch.stack(frames)


class StoryGenPipeline:
    """Tokenize -> encode text -> sample -> decode.

    `tokenizer` maps a list of B strings to (B, 77) token ids (an array, a
    tensor, or a dict / object with "input_ids"); a raw HF tokenizer, which
    raises TypeError without its padding arguments, is called with them."""

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

    def save_pretrained(self, root: str) -> None:
        """Write unet/, vae/, text_encoder/, scheduler/ and
        model_index.json (checkpoint/hf_export.py), and tokenizer/ when
        the tokenizer has a save_pretrained of its own."""
        from storygen_tpu_torch.checkpoint.hf_export import save_pretrained
        save_pretrained(root, unet=self.sampler.unet, vae=self.vae,
                        text_encoder=self.text_encoder,
                        scheduler_config=self.sampler.sched_cfg,
                        tokenizer=self.tokenizer)

    @staticmethod
    def numpy_to_pil(images: np.ndarray):
        return numpy_to_pil(images)

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        try:
            ids = self.tokenizer(list(prompts))
            if isinstance(ids, dict) or hasattr(ids, "input_ids"):
                ids = ids["input_ids"]
        except TypeError:
            ids = self.tokenizer(list(prompts), padding="max_length",
                                 max_length=77, truncation=True,
                                 return_tensors="np")["input_ids"]
        return torch.as_tensor(np.asarray(ids), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.text_encoder(self.tokenize(prompts))

    def __call__(self, stage: str, prompt: Sequence[str],
                 image_prompt=None, prev_prompt=None, **kw) -> np.ndarray:
        """Generate (B * num_images_per_prompt, H, W, 3) images in [0, 1];
        see `_generate`."""
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
                  negative_prompt: Optional[Sequence[str]] = None,
                  generator: Optional[torch.Generator] = None,
                  latents: Optional[torch.Tensor] = None,
                  sampler: str = "ddim", eta: float = 0.0,
                  ref_feature_interval: int = 1,
                  num_images_per_prompt: int = 1,
                  ref_latents: Optional[torch.Tensor] = None,
                  draw: Optional[Callable] = None
                  ) -> Tuple[np.ndarray, torch.Tensor]:
        """Returns (images (B*n, H, W, 3) in [0, 1], final latents).

        image_prompt: (N, B, H, W, 3) reference frames, fed to the VAE as
          they are (the reference-checkpoint convention is [0, 1]).
        prev_prompt: N lists of B captions for the reference frames.
        negative_prompt: B captions in place of the main pass's empty one;
          the reference pass keeps the empty caption.
        num_images_per_prompt n: rows [i*n, (i+1)*n) of the output are
          prompt i's.
        ref_latents: (N, B, h, w, 4) scaled reference latents, in place of
          encoding `image_prompt`.
        draw(name, shape): the random draws (DRAWS), else N(0, 1) from
          `generator`; `latents` (B*n, h, w, 4) replaces the first.
        """
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        dev = self.device
        b = len(prompt)
        n = int(num_images_per_prompt)
        shape = (b * n, height // 8, width // 8, 4)
        if draw is None:
            def draw(name, shp):
                return torch.randn(shp, generator=generator, device=dev)

        def dup(x, dim=0):
            """Prompt-major duplication of the batch axis."""
            return x if n == 1 else x.repeat_interleave(n, dim=dim)

        latents = (draw("latents", shape) if latents is None else
                   torch.as_tensor(latents, dtype=torch.float32, device=dev))
        latents = latents * self.sampler.schedule.init_noise_sigma
        uncond = [""] * b if negative_prompt is None else list(negative_prompt)
        text_cond = dup(self.encode_prompt(prompt))
        text_uncond = dup(self.encode_prompt(uncond))
        zero_latents = prev_u = prev_c = None
        if stage == "no":
            ref_latents = None
        else:
            if prev_prompt is None or (image_prompt is None
                                       and ref_latents is None):
                raise ValueError(f"stage {stage} needs prev_prompt and "
                                 "image_prompt (or ref_latents)")
            if ref_latents is None:
                imgs = torch.as_tensor(image_prompt, dtype=torch.float32,
                                       device=dev)
                ref_latents = self.sampler.encode_ref_latents(
                    imgs, draw("ref_posterior",
                               (imgs.shape[0] * b,) + shape[1:]))
            ref_latents = dup(torch.as_tensor(ref_latents,
                                              dtype=torch.float32,
                                              device=dev), dim=1)
            zdist = self.vae.encode(torch.zeros((b, height, width, 3),
                                                device=dev))
            zero_latents = dup(zdist.sample(draw("zero_posterior",
                                                 (b,) + shape[1:]))
                               * self.vae.config.scaling_factor)
            prev_c = dup(torch.stack([self.encode_prompt(p)
                                      for p in prev_prompt]), dim=1)
            prev_u = dup(torch.stack([self.encode_prompt([""] * b)
                                      for _ in prev_prompt]), dim=1)
        noise = draw("noise", shape)
        final = self.sampler.sample(
            latents, text_uncond, text_cond, ref_latents, zero_latents,
            prev_u, prev_c, noise, guidance_scale, image_guidance_scale,
            stage=stage, num_inference_steps=num_inference_steps,
            sampler=sampler, eta=float(eta),
            step_noise=self.sampler.step_noise(draw, sampler, eta,
                                               num_inference_steps, shape),
            ref_feature_interval=int(ref_feature_interval))
        images = self.sampler.decode(final)
        return images.cpu().numpy(), final

    def generate_story(self, prompts: Sequence[str],
                       first_frame: Optional[np.ndarray] = None,
                       first_caption: Optional[str] = None,
                       max_refs: int = 3, normalize_refs: bool = False,
                       reuse_latents: bool = False, fused: bool = False,
                       seed: int = 0, draw: Optional[Draw] = None,
                       **kw) -> List[np.ndarray]:
        """Frame k is conditioned on up to `max_refs` previous frames and
        their captions; frame 1 (without a `first_frame`) runs stage "no".

        normalize_refs: feed history frames to the VAE in [-1, 1] (for
          checkpoints trained so) instead of the reference's [0, 1].
        reuse_latents: condition on the earlier frames' final latents, not
          on their decoded and re-encoded pixels (a different
          conditioning, not reference parity); a given first frame is
          encoded with the draw of frame len(prompts).
        fused: run `StoryGenSampler.story_rollout`, which takes the same
          draws and encodes each frame once.
        draw(frame, name, shape) gives the random draws, by default
        `seeded_draws(device, seed)`. Other keyword arguments go to
        `_generate`. Returns the frames, each (H, W, 3) in [0, 1]."""
        if reuse_latents and fused:
            raise ValueError("fused=True keeps the decode -> encode feedback "
                             "chain; reuse_latents is a different "
                             "conditioning: pick one")
        draw = draw or seeded_draws(self.device, seed)
        if reuse_latents:
            return self._generate_story_latents(
                prompts, first_frame, first_caption, max_refs,
                normalize_refs, draw, **kw)
        if fused:
            return self._generate_story_fused(
                prompts, first_frame, first_caption, max_refs,
                normalize_refs, draw, **kw)
        history: List[Tuple[np.ndarray, str]] = []
        if first_frame is not None:
            history.append((np.asarray(first_frame),
                            first_caption or prompts[0]))
        frames: List[np.ndarray] = []
        for k, prompt in enumerate(prompts):
            d = functools.partial(draw, k)
            if not history:
                img = self(stage="no", prompt=[prompt], draw=d, **kw)
            else:
                hist = history[-max_refs:]
                refs = np.stack([f for f, _ in hist])[:, None]
                if normalize_refs:
                    refs = refs * 2.0 - 1.0
                img = self(stage="auto-regressive", prompt=[prompt],
                           image_prompt=refs, draw=d,
                           prev_prompt=[[c] for _, c in hist], **kw)
            frames.append(img[0])
            history.append((img[0], prompt))
        return frames

    def _generate_story_latents(self, prompts, first_frame, first_caption,
                                max_refs, normalize_refs, draw: Draw,
                                **kw) -> List[np.ndarray]:
        """generate_story(reuse_latents=True): the history holds scaled
        final latents, fed back through _generate(ref_latents=...)."""
        history: List[Tuple[torch.Tensor, str]] = []
        if first_frame is not None:
            frame = np.asarray(first_frame, dtype=np.float32)
            if normalize_refs:
                frame = frame * 2.0 - 1.0
            h, w = frame.shape[:2]
            lat0 = self.sampler.encode_ref_latents(
                torch.as_tensor(frame, device=self.device)[None, None],
                draw(len(prompts), "ref_posterior", (1, h // 8, w // 8, 4)))
            history.append((lat0[0, 0], first_caption or prompts[0]))
        frames: List[np.ndarray] = []
        for k, prompt in enumerate(prompts):
            d = functools.partial(draw, k)
            if not history:
                img, fin = self._generate(stage="no", prompt=[prompt],
                                          draw=d, **kw)
            else:
                hist = history[-max_refs:]
                img, fin = self._generate(
                    stage="auto-regressive", prompt=[prompt],
                    ref_latents=torch.stack([z for z, _ in hist])[:, None],
                    prev_prompt=[[c] for _, c in hist], draw=d, **kw)
            frames.append(img[0])
            history.append((fin[0], prompt))
        return frames

    def _generate_story_fused(self, prompts, first_frame, first_caption,
                              max_refs, normalize_refs, draw: Draw,
                              height: int = 512, width: int = 512,
                              num_inference_steps: int = 50,
                              guidance_scale: float = 7.5,
                              image_guidance_scale: float = 3.5,
                              sampler: str = "ddim", eta: float = 0.0,
                              ref_feature_interval: int = 1
                              ) -> List[np.ndarray]:
        """generate_story(fused=True): every caption encoded up front, then
        one story_rollout."""
        text_conds = torch.stack([self.encode_prompt([p]) for p in prompts])
        ff = fc = None
        if first_frame is not None:
            ff = torch.as_tensor(np.asarray(first_frame), dtype=torch.float32,
                                 device=self.device)[None]
            fc = self.encode_prompt([first_caption or prompts[0]])
        out = self.sampler.story_rollout(
            self.encode_prompt([""]), text_conds, draw, guidance_scale,
            image_guidance_scale, ff, fc,
            num_inference_steps=num_inference_steps, max_refs=max_refs,
            sampler=sampler, eta=float(eta),
            ref_feature_interval=int(ref_feature_interval),
            normalize_refs=normalize_refs, height=height, width=width)
        return list(out[:, 0].cpu().numpy())


def numpy_to_pil(images: np.ndarray):
    """(B, H, W, 3) float [0, 1] -> list of PIL images (rounded to uint8)."""
    from PIL import Image
    arr = (np.asarray(images) * 255).round().astype("uint8")
    return [Image.fromarray(a) for a in arr]
