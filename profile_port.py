"""Times one story frame and one stage-2 training micro-step of the
PyTorch/CUDA port on the card, and profiles where their device time goes.

Run from the repository root on a machine with one NVIDIA H100:

    python3 profile_port.py

The frame is the headline's: 512 px, auto-regressive with 3 reference
frames, bf16, batch 1, guidance 7.5 / image guidance 3.5, with the
full-width SD-1.5 + VLCM UNet, VAE and CLIP text encoder of
`chip_smoke.py` (seeded random weights and token ids). The micro-step is
the training operating point of `chip_smoke.py`: stage 2, 512 px, batch
4, 3 refs, bf16, gradient checkpointing, 2 micro-steps per optimizer step,
on one seeded synthetic batch. It prints

  - the wall time of two DDIM-50 frames after a DDIM-2 warm-up, and
    frames/s from their median;
  - for a DDIM-4 frame: its wall time without and with `torch.profiler`,
    the device's busy time under the profiler (the union of the card's
    kernel and copy intervals), the device's idle share against each wall
    time, and device time by kernel, largest first;
  - the wall time of 4 micro-steps after 2 warm-ups, and the same profile
    of 2 micro-steps (one that accumulates, one that updates).

The full kernel tables go to chiprun_out/profile_port.txt and
chiprun_out/profile_train.txt. Every frame time includes the refs' VAE
encodes, the text encodes and the decode; every micro-step the VAE
encodes, text encodes, the reference UNet pass, the main pass, its
backward and the optimizer. Without a CUDA device the script exits
non-zero.
"""
from __future__ import annotations

import collections
import os
import statistics
import sys
import time

HEADLINE_STEPS = 50
PROFILE_STEPS = 4
TOP = 24


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from storygen_tpu_torch.pipeline import StoryGenPipeline, frame_generator

    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    unet, vae, clip = cs.full_width_models(dev)
    pipe = StoryGenPipeline(unet, vae, clip, cs.token_ids, device=dev)
    refs = np.random.RandomState(0).rand(3, 1, 512, 512, 3).astype(np.float32)
    prev = [[p] for p in cs.PROMPTS[:3]]

    def frame(steps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe(stage="auto-regressive", prompt=[cs.PROMPTS[3]],
                   image_prompt=refs, prev_prompt=prev,
                   num_inference_steps=steps, guidance_scale=7.5,
                   image_guidance_scale=3.5,
                   generator=frame_generator(dev, 0, 3))
        torch.cuda.synchronize()
        assert img.shape == (1, 512, 512, 3) and np.isfinite(img).all()
        return time.perf_counter() - t0

    frame(2)
    times = [frame(HEADLINE_STEPS) for _ in range(2)]
    med = statistics.median(times)
    print(f"DDIM-{HEADLINE_STEPS} auto-regressive frame, 3 refs, 512 px, "
          f"bf16: {', '.join(f'{t:.3f}' for t in times)} s; median "
          f"{med:.3f} s = {1 / med:.4f} frames/s [{card}]", flush=True)

    # The profiler's host-side tracing slows the host, not the card: the
    # idle share is taken against the same frame's wall time unprofiled.
    wall = frame(PROFILE_STEPS)
    if not report(f"DDIM-{PROFILE_STEPS} frame", lambda: frame(PROFILE_STEPS),
                  wall, card, "profile_port.txt"):
        return 1
    del pipe, unet, vae, clip
    torch.cuda.empty_cache()
    return 0 if train_micro_steps(dev, card) else 1


def report(label: str, run, wall: float, card: str, out_name: str) -> bool:
    """Profile `run` (which returns its wall seconds) and print the
    device's busy time, idle share and time by kernel."""
    import torch
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        wall_profiled = run()
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_kernel[e.name][0] += (end - start) / 1e3
        by_kernel[e.name][1] += 1
    if not spans:
        print("profile_port: the profiler recorded no device events",
              file=sys.stderr)
        return False
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy = busy_us / 1e3
    print(f"{label}: wall {1e3 * wall:.1f} ms unprofiled, "
          f"{1e3 * wall_profiled:.1f} ms profiled; device busy {busy:.1f} "
          f"ms; device idle share {1 - busy / (1e3 * wall):.3f} unprofiled, "
          f"{1 - busy / (1e3 * wall_profiled):.3f} profiled [{card}]")
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    lines = [f"{ms:10.2f} ms {100 * ms / busy:6.1f}%  n={n:6d}  {name}"
             for name, (ms, n) in rows]
    print("\n".join(line[:140] for line in lines[:TOP]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_name), "w") as f:
        f.write(f"{card}\n" + "\n".join(lines) + "\n")
    return True


def train_micro_steps(dev, card: str) -> bool:
    import torch
    import chip_smoke as cs
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
    from storygen_tpu_torch.training import trainer
    cfg = TrainConfig(train_batch_size=cs.TRAIN_BATCH,
                      gradient_accumulation_steps=cs.TRAIN_GA, seed=0)
    bundle = trainer.build_models(cfg, dev)
    step, _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
    ds = SyntheticStoryDataset(cs.TRAIN_BATCH, size=512, seed=5)
    batch = trainer.to_device(collate([ds[i] for i in range(len(ds))]), dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def micro(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step(batch, gen)["loss"]
        torch.cuda.synchronize()
        assert torch.isfinite(loss).item()
        return time.perf_counter() - t0

    micro(2)
    torch.cuda.reset_peak_memory_stats()
    times = [micro(1) for _ in range(4)]
    print(f"stage-2 micro-step, batch {cs.TRAIN_BATCH}, 512 px, 3 refs, "
          f"bf16, gradient checkpointing: "
          f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms; median "
          f"{1e3 * statistics.median(times):.1f} ms = "
          f"{cs.TRAIN_BATCH / statistics.median(times):.3f} samples/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"[{card}]", flush=True)
    wall = micro(2)
    return report("2 stage-2 micro-steps", lambda: micro(2), wall, card,
                  "profile_train.txt")


if __name__ == "__main__":
    sys.exit(main())
