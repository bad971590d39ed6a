"""Training steps for the three StoryGen regimes.

Counterpart of storygen_tpu/training/steps.py:
- stage1 (style pretrain): single-frame denoising, trainable attn1, masked
  MSE;
- stage2 (VLCM): reference-cycle features of 3 earlier frames, a random
  1-3 of them used, trainable attn3, masked MSE;
- COCO: 3 entity-segment refs, equal ref noise (no decay), unmasked MSE.

As in the JAX step, the frozen encoders and the reference cycle run once,
batched over the N refs, without a graph (`torch.no_grad`, the JAX
`stop_gradient`): every parameter they use is frozen, so no gradient flows
there. Only the main UNet pass is differentiated. The "random number of
refs" is a per-sample (B, N) keep mask over attn3's fixed (B, N*S) kv.

Precomputed-latent mode (the JAX step's): a batch with `latent_moments`
(B, h, w, 8) and `ref_latent_moments` (N, B, h, w, 8), the stored VAE
posterior means and logvars, in place of image and ref_images. Each
posterior is sampled in fp32 (logvar clipped to [-30, 20]), scaled and cast
to the VAE's dtype; no encoder runs. Unlike the JAX package, this mode
applies the CFG dropout that the image datasets apply per sample (the
files are written without it): 5% of rows take the empty prompt's ids, and
10% take the empty ref prompts and the moments of an all-zero reference
image, which the frozen VAE encodes once, as zeroed refs are in the image
mode. The empty prompt's ids come from the caller's tokenizer
(`empty_ids`); without them the mode raises.

Random draws come from one `torch.Generator`, in a fixed order: the latent
posterior noise, the noise, t, the ref posterior noise, the ref noise, the
ref mask and, in the precomputed mode, the prompt and ref dropout rows.
Each can be injected instead (`draws`, keys DRAW_KEYS), so that two
implementations can be fed the same random numbers.

Data parallelism (`mesh`, parallel/mesh.py): each rank holds its rows of
the global batch. Every rank draws (or is given) the draws of the global
batch, from generators seeded alike, and keeps its own rows, as one JAX key
over a sharded batch does; so a run draws the same numbers at any world
size. Between the gradients and the optimizer the gradients (and the
loss) are averaged over the batch axes in one fp32 all-reduce. Under
tensor parallelism (parallel/tensor.py) the UNet holds shards; the
gradient of a shard is its own, and the optimizer's norm sums the shards'
squares over the tensor group (`optim.AdamW.norm`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.models.vae import DiagonalGaussian
from storygen_tpu_torch.parallel.mesh import Mesh, allreduce_mean_
from storygen_tpu_torch.training.losses import downsample_mask, masked_mse
from storygen_tpu_torch.training.optim import AdamW

DRAW_KEYS = ("posterior_noise", "noise", "t", "ref_posterior_noise",
             "ref_noise", "ref_mask", "prompt_dropout", "ref_dropout")
# the CFG dropout rates of the reference's StorySalon and COCO datasets
PROMPT_DROPOUT = 0.05
REF_DROPOUT = 0.1


def sample_ref_mask(generator: torch.Generator, batch: int, num_refs: int,
                    probs=(0.3, 0.3, 0.4)) -> torch.Tensor:
    """Per-sample (B, N) bool mask keeping the newest k refs: ref i is kept
    when i >= k0, with k0 drawn from {0, .., N-1} with `probs` (3 refs with
    p 0.3, 2 with 0.3, 1 with 0.4 for N = 3). The newest ref (index N-1)
    is always kept."""
    dev = generator.device
    p = torch.tensor(probs, dtype=torch.float32, device=dev)
    if p.shape[0] != num_refs:
        raise ValueError(f"{num_refs} refs need {num_refs} probabilities")
    k0 = torch.multinomial(p, batch, replacement=True, generator=generator)
    return torch.arange(num_refs, device=dev)[None, :] >= k0[:, None]


def make_train_step(unet, vae, text_encoder, sched: S.NoiseSchedule,
                    optimizer: AdamW, *, stage: str = "stage2",
                    num_refs: int = 3, ref_noise_decay: bool = True,
                    use_mask: bool = True,
                    num_train_timesteps: int = 1000,
                    empty_ids: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Build the train step of a stage.

    stage: 'stage1' (no refs) | 'stage2' | 'coco'.
    ref_noise_decay: noise ref i at ref_t * (N - i) (stage2) instead of a
      flat ref_t (COCO).
    use_mask: masked MSE over the inpainting mask.
    empty_ids: (77,) token ids of the empty prompt, which the precomputed
      mode's CFG dropout needs.
    mesh: the data-parallel (or data and tensor) mesh: the batch is this
      rank's rows, `draws` are the global batch's.

    The step takes a batch of tensors on the models' device:
      image (B, H, W, 3) in [-1, 1] or latent_moments (B, h, w, 8); mask
      (B, H, W, 1) in [0, 1] (if use_mask); input_ids (B, 77); ref_images
      (N, B, H, W, 3) or ref_latent_moments (N, B, h, w, 8), and
      ref_input_ids (N, B, 77) (stages with refs);
    a generator on that device, and optionally `draws`, a dict of tensors
    under DRAW_KEYS that replace the generator's draws. It differentiates
    the loss, hands the gradients to the optimizer and returns
    {"loss", "grad_norm"} (fp32 scalars over the global batch; grad_norm
    is the micro-step gradient's global norm before clipping).
    """
    if stage not in ("stage1", "stage2", "coco"):
        raise ValueError(f"unknown stage {stage!r}")
    use_refs = stage != "stage1"
    sf = vae.config.scaling_factor
    down = vae.config.downscale_factor
    lat_ch = vae.config.latent_channels
    # the batch axes: how many ranks split the global batch, and which
    # block of its rows is this rank's
    n_data = 1 if mesh is None else mesh.size(*mesh.batch_axes)
    data_index = 0 if mesh is None else mesh.index(*mesh.batch_axes)
    data_group = None if mesh is None else mesh.group(*mesh.batch_axes)

    zero_moments = {}  # (h, w) -> the all-zero image's moments

    def zero_image_moments(h: int, w: int, dev) -> torch.Tensor:
        """(h, w, 8) posterior moments of an all-zero image, fp32."""
        if (h, w) not in zero_moments:
            dist = vae.encode(torch.zeros((1, h * down, w * down, 3),
                                          device=dev))
            zero_moments[(h, w)] = torch.cat([dist.mean, dist.logvar],
                                             dim=-1)[0]
        return zero_moments[(h, w)]

    def sample_moments(moments, noise):
        mean, logvar = moments.float().chunk(2, dim=-1)
        z = DiagonalGaussian(mean, logvar.clamp(-30.0, 20.0)).sample(noise)
        return (z * sf).to(vae.dtype)

    def draw(batch, generator, given, precomputed):
        """The global batch's draws, in the fixed order; this rank keeps
        its rows (axis 1 of the ref-major ref posterior noise)."""
        if precomputed:
            b, h, w = batch["latent_moments"].shape[:3]
            dev = batch["latent_moments"].device
        else:
            b, hh, ww = batch["image"].shape[:3]
            h, w = hh // down, ww // down
            dev = batch["image"].device
        gb = b * n_data  # the global batch
        rows = slice(data_index * b, (data_index + 1) * b)
        lat = (gb, h, w, lat_ch)
        out = {}

        def put(key, fn, ref_major=False):
            x = given[key].to(dev) if key in given else fn()
            if ref_major:  # (N*B, ...) -> this rank's (N*b, ...)
                x = x.reshape((num_refs, gb) + x.shape[1:])[:, rows]
                out[key] = x.reshape((num_refs * b,) + x.shape[2:])
            else:
                out[key] = x[rows]

        def normal(shape):
            return lambda: torch.randn(shape, generator=generator,
                                       device=dev)

        def dropped(rate):
            return lambda: torch.rand((gb,), generator=generator,
                                      device=dev) < rate

        put("posterior_noise", normal(lat))
        put("noise", normal(lat))
        put("t", lambda: torch.randint(0, num_train_timesteps, (gb,),
                                       generator=generator, device=dev))
        if use_refs:
            put("ref_posterior_noise", normal((num_refs * gb,) + lat[1:]),
                ref_major=True)
            put("ref_noise", normal(lat))
            if stage == "stage2":
                put("ref_mask", lambda: sample_ref_mask(generator, gb,
                                                        num_refs))
        if precomputed:
            put("prompt_dropout", dropped(PROMPT_DROPOUT))
            if use_refs:
                put("ref_dropout", dropped(REF_DROPOUT))
        return out

    def cfg_dropout(batch, d):
        """The precomputed batch's ids and ref moments after CFG
        dropout."""
        if empty_ids is None:
            raise ValueError(
                "the precomputed-latent mode's CFG dropout needs the empty "
                "prompt's ids: pass the tokenizer to train() (empty_ids)")
        empty = empty_ids.to(batch["input_ids"])
        drop = d["prompt_dropout"].bool()
        ids = torch.where(drop[:, None], empty, batch["input_ids"])
        if not use_refs:
            return ids, None, None  # stage 1 takes no refs
        drop = d["ref_dropout"].bool()
        moments = batch["ref_latent_moments"]
        zero = zero_image_moments(moments.shape[2], moments.shape[3],
                                  moments.device)
        ref_moments = torch.where(drop[None, :, None, None, None],
                                  zero.to(moments.dtype), moments)
        ref_ids = torch.where(drop[None, :, None], empty,
                              batch["ref_input_ids"])
        return ids, ref_moments, ref_ids

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        unknown = set(draws or {}) - set(DRAW_KEYS)
        if unknown:
            raise ValueError(f"unknown draws {sorted(unknown)}; expected "
                             f"some of {DRAW_KEYS}")
        precomputed = "latent_moments" in batch
        d = draw(batch, generator, draws or {}, precomputed)
        t = d["t"].long()
        with torch.no_grad():
            if precomputed:
                ids, ref_moments, ref_ids = cfg_dropout(batch, d)
                latents = sample_moments(batch["latent_moments"],
                                         d["posterior_noise"].float())
            else:
                ids, ref_ids = batch["input_ids"], batch.get("ref_input_ids")
                latents = vae.encode(batch["image"]).sample(
                    d["posterior_noise"].float()) * sf
            b = latents.shape[0]
            text = text_encoder(ids)
            noisy = S.add_noise(sched, latents, d["noise"].float(), t)
            ctx = ref_mask = None
            if use_refs:
                n = num_refs
                if precomputed:
                    noise = d["ref_posterior_noise"].float()
                    ref_lat = sample_moments(
                        ref_moments, noise.reshape((n, b) + noise.shape[1:]))
                else:
                    refs = batch["ref_images"]
                    dist = vae.encode(refs.reshape((n * b,)
                                                   + refs.shape[2:]))
                    z = dist.sample(d["ref_posterior_noise"].float()) * sf
                    ref_lat = z.reshape((n, b) + z.shape[1:])
                ref_t = t // 10
                if ref_noise_decay:
                    factors = torch.arange(n, 0, -1, device=t.device)
                    ref_ts = ref_t[None, :] * factors[:, None]  # (N, B)
                else:
                    ref_ts = ref_t[None, :].expand(n, b)
                noisy_refs = S.add_noise(sched, ref_lat,
                                         d["ref_noise"].float()[None],
                                         ref_ts)
                prev_text = text_encoder(ref_ids.reshape(n * b, -1))
                _, raw = unet(noisy_refs.reshape((n * b,)
                                                 + ref_lat.shape[2:]),
                              ref_ts.reshape(-1), prev_text)
                # (N*B, S, C) -> (B, N*S, C): refs concatenated along kv
                ctx = {k: v.reshape((n, b) + v.shape[1:]).transpose(0, 1)
                       .reshape(b, n * v.shape[1], v.shape[2])
                       for k, v in raw.items()}
                if stage == "stage2":
                    ref_mask = d["ref_mask"].bool()
            latent_mask = (downsample_mask(batch["mask"], down) if use_mask
                           else None)

        # the differentiated main pass
        pred, _ = unet(noisy, t, text, ctx, ref_mask)
        loss = masked_mse(pred, d["noise"], latent_mask)
        params = optimizer.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        loss = loss.detach()
        if mesh is not None:
            # the global batch's mean gradient and loss
            allreduce_mean_(list(grads.values()) + [loss], data_group)
        norm = optimizer.norm(grads)
        optimizer.update(grads)
        return {"loss": loss, "grad_norm": norm}

    return step
