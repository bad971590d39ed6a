"""What the opt-in speed knobs cost in drift and buy in speed: one
auto-regressive frame (3 refs, 512 px, the full-width SD-1.5 + VLCM UNet
and VAE in bf16, seeded random weights) on the same inputs and draws with
the exact sampler and with each knob.

  python -m storygen_tpu_torch.scripts.study_knobs [--device cuda]

Knobs: ref_feature_interval 2 (the reference features refreshed every
second step), dpm++ at 25 steps (against DDIM-50) and both. For each:
  - latent_rel_rmse_vs_exact: the RMS of the final latents' difference
    from the exact path's over the exact latents' RMS (scale-free),
  - pixel_mad_vs_exact: the decoded pixels' mean absolute difference in
    [0, 1] units,
  - frames_per_s: 1 / the time of a second call, made on a distinct input
    chained to the first call's output (the latents plus 1e-6 of the first
    output's mean), after the first call warmed the path.
Prints one line per knob and the JSON of all.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from storygen_tpu_torch.scripts.common import add_device_flag

# (name, DDIM/dpm++ steps, sampler, ref_feature_interval); the first is the
# exact path the others are held against
CONFIGS = [("exact_ddim50", 50, "ddim", 1),
           ("interval2", 50, "ddim", 2),
           ("dpmpp25", 25, "dpm++", 1),
           ("dpmpp25_interval2", 25, "dpm++", 2)]
SIDE = 512
NUM_REFS = 3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_flag(ap)
    return ap.parse_args(argv)


def knob_models(dev: torch.device):
    """The full-width UNet and VAE, bf16, seeded random weights."""
    from storygen_tpu_torch.configs import UNetConfig, VAEConfig
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    with torch.device(dev):
        unet = UNet2DConditionModel(UNetConfig())
        vae = AutoencoderKL(VAEConfig())
    return (init_random_(unet.to(torch.bfloat16), 0).eval(),
            init_random_(vae.to(torch.bfloat16), 0).eval())


def run_knobs(unet, vae, dev: torch.device, side: int = SIDE,
              configs=CONFIGS) -> dict:
    """Each config's drift from the first and its frames/s."""
    from storygen_tpu_torch.pipeline import StoryGenSampler
    sampler = StoryGenSampler(unet, vae, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    hw, d = side // 8, unet.config.cross_attention_dim

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    latents = randn(1, hw, hw, 4)
    text_u = randn(1, 77, d, scale=0.02)
    text_c = randn(1, 77, d, scale=0.02)
    refs = randn(NUM_REFS, 1, hw, hw, 4)
    zero = randn(1, hw, hw, 4, scale=0.01)
    noise = randn(1, hw, hw, 4)
    prev_u = text_u[None].expand(NUM_REFS, -1, -1, -1)
    prev_c = text_c[None].expand(NUM_REFS, -1, -1, -1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def run(steps, smp, interval, lat0):
        return sampler.sample(lat0, text_u, text_c, refs, zero, prev_u,
                              prev_c, noise, 7.0, 3.5,
                              stage="auto-regressive",
                              num_inference_steps=steps, sampler=smp,
                              ref_feature_interval=interval)

    results, base_lat, base_px = {}, None, None
    for name, steps, smp, interval in configs:
        lat = run(steps, smp, interval, latents)
        salt = lat.mean() * 1e-6
        sync()
        t0 = time.perf_counter()
        run(steps, smp, interval, latents + salt)
        sync()
        dt = time.perf_counter() - t0
        with torch.no_grad():
            px = sampler.decode(lat).float()
        lat = lat.float()
        if base_lat is None:
            base_lat, base_px = lat, px
        rms = float(base_lat.pow(2).mean().sqrt())
        drift = float((lat - base_lat).pow(2).mean().sqrt()) / max(rms, 1e-9)
        results[name] = {
            "frames_per_s": 1.0 / dt,
            "latent_rel_rmse_vs_exact": drift,
            "pixel_mad_vs_exact": float((px - base_px).abs().mean()),
        }
        print(name, results[name], flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from storygen_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    results = run_knobs(*knob_models(dev), dev, SIDE, CONFIGS)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
