"""On-card smoke test of the PyTorch/CUDA port (`storygen_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It takes no arguments and runs three phases, all of which must pass:
  kernels  builds the three CUDA kernels from storygen_tpu_torch/csrc/ and
           holds each against its plain PyTorch version at the 512 px
           shapes of the main path, with CUDA-event times for both;
  models   one full-width UNet image-cycle pass (512 px, 3 refs) and one
           512 px VAE encode and decode, kernel path against the plain
           path on the card, compared before any clamp;
  story    a 4-prompt auto-regressive `generate_story` at 512x512 with the
           full-width SD-1.5 + VLCM UNet, VAE and CLIP text encoder (seeded
           random weights and token ids), checking the frames and that
           every kernel ran on the main path.

There is no CPU branch: without a CUDA device the script exits non-zero
before printing any result. The last line is the JSON status object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# DDIM steps per story frame: a fifth of the product's 50. Every step runs
# the same kernels at the same shapes, so fewer steps cut time, not coverage.
STORY_STEPS = 10

# Kernel outputs are bf16; the oracle is the plain version in fp32 on the
# same bf16 inputs. Output rounding alone is 2^-9 relative, and each kernel
# rounds one operand to bf16 inside (P in attention, the gated product in
# GEGLU); 1e-2 of the largest reference magnitude leaves a 4-5x margin.
KERNEL_RTOL = 1e-2
# Whole-model kernel path vs plain path, both bf16 end to end: the two
# differ by bf16 rounding at every site of ~70 UNet (~30 VAE) layers; a
# wrong kernel gives O(1). Bound on the relative L2 error of the output.
MODEL_REL_L2 = 5e-2


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(dev):
    """(kernel name, case label, kernel call, plain call on bf16, fp32
    oracle) at the main path's 512 px shapes."""
    import torch
    from storygen_tpu_torch.ops import conv, flash_attention as fa, geglu

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(
            torch.bfloat16)

    cases = []
    attn = [("attn1 L1", 6, 4096, 4096, 40), ("attn3 L1", 3, 4096, 12288, 40),
            ("attn3 L2", 3, 1024, 3072, 80), ("attn3 L3", 3, 256, 768, 160),
            ("attn1 mid", 6, 64, 64, 160), ("attn2 L1", 3, 4096, 77, 40),
            ("ragged", 2, 1000, 333, 40)]
    for label, b, sq, skv, d in attn:
        q, k, v = rnd(b, sq, 8 * d), rnd(b, skv, 8 * d), rnd(b, skv, 8 * d)
        sc = d ** -0.5
        cases.append(("flash_attention", f"{label} B{b} {sq}x{skv} d{d}",
                      lambda q=q, k=k, v=v, sc=sc: fa.flash_attention(
                          q, k, v, 8, sc),
                      lambda q=q, k=k, v=v, sc=sc: fa.flash_attention_plain(
                          q, k, v, 8, sc),
                      lambda q=q, k=k, v=v, sc=sc: fa.flash_attention_plain(
                          q.float(), k.float(), v.float(), 8, sc)))
    for label, m, n, e in [("L1 ff", 3 * 4096, 1280, 320),
                           ("L2 ref ff", 6 * 1024, 2560, 640),
                           ("mid ff", 192, 5120, 1280)]:
        p, w, bias = rnd(m, 2 * n), rnd(e, n, s=n ** -0.5), rnd(e)
        cases.append(("geglu_matmul", f"{label} ({m}, 2x{n})->{e}",
                      lambda p=p, w=w, bias=bias: geglu.geglu_matmul(
                          p, w, bias),
                      lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(
                          p, w, bias),
                      lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(
                          p.float(), w.float(), bias.float())))
    for label, b, hw, cin, cout, bias_b, res in [
            ("UNet up L1 (B,C) bias", 3, 64, 960, 320, True, False),
            ("UNet L1 residual", 3, 64, 320, 320, False, True),
            ("VAE dec 512px", 1, 512, 256, 128, False, False),
            ("VAE enc conv_in", 1, 512, 3, 128, False, False),
            ("VAE dec conv_out", 1, 512, 128, 3, False, False),
            ("UNet conv_in", 3, 64, 4, 320, False, False)]:
        x = rnd(b, hw, hw, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        r = rnd(b, hw, hw, cout) if res else None
        cases.append(("conv3x3",
                      f"{label} B{b} {hw}x{hw} {cin}->{cout}",
                      lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3(
                          x, w9, bias, r),
                      lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                          x, w9, bias, r),
                      lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                          x.float(), w9.float(), bias,
                          None if r is None else r.float())))
    return cases


KERNEL_META = {
    "flash_attention": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:124"},
    "geglu_matmul": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/geglu_matmul.cu",
        "replaces": "storygen_tpu/ops/pallas_geglu.py:50"},
    "conv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/conv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:61"},
}


def phase_kernels(dev, card: str, results: dict) -> bool:
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for name, label, kern, plain, oracle in kernel_cases(dev):
        out = kern().float()
        ref = oracle().float()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = KERNEL_RTOL * ref.abs().max().item()
        finite = bool(torch.isfinite(out).all().item())
        good = finite and err <= bound
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        ok &= good
        print(f"kernel {name:16s} {label:40s} max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]",
              flush=True)
        r = results.setdefault(name, {"name": name, **KERNEL_META[name],
                                      "launches": 0, "max_abs_err": 0.0,
                                      "ms": 0.0, "plain_ms": 0.0,
                                      "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["cases"].append({"case": label, "max_abs_err": err, "bound": bound,
                           "ms": ms, "plain_ms": plain_ms})
        del out, ref
    return ok


def full_width_models(dev):
    """SD-1.5 + VLCM UNet, VAE and CLIP ViT-L/14 text encoder at their
    published widths, bf16, seeded random weights."""
    import torch
    from storygen_tpu.configs import CLIPTextConfig, UNetConfig, VAEConfig
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL

    def make(cls, cfg, seed):
        with torch.device(dev):  # allocate on the card, skip CPU init
            module = cls(cfg)
        return init_random_(module.to(torch.bfloat16), seed).eval()

    return (make(UNet2DConditionModel, UNetConfig(), 1),
            make(AutoencoderKL, VAEConfig(), 2),
            make(CLIPTextModel, CLIPTextConfig(), 3))


def token_ids(prompts):
    """Deterministic stand-in for the CLIP tokenizer (no tokenizer files
    ship with the repository): BOS, ids seeded by the prompt, EOS padding."""
    import zlib

    import numpy as np
    ids = np.full((len(prompts), 77), 49407, dtype=np.int64)
    for i, p in enumerate(prompts):
        n = min(len(p.split()) + 1, 75)
        rs = np.random.RandomState(zlib.crc32(p.encode()))
        ids[i, 0] = 49406
        ids[i, 1:1 + n] = rs.randint(0, 49406, n)
    return ids


def kernel_vs_plain(label: str, fn, shape, card: str) -> bool:
    """Runs `fn` on the kernel path and on the plain path, and holds the
    relative L2 error of the (unclamped) outputs under MODEL_REL_L2."""
    import torch
    from storygen_tpu_torch import ops
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = fn().float()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with ops.plain_path():
            out_p = fn().float()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    finite = bool(torch.isfinite(out_k).all().item())
    ok = finite and rel <= MODEL_REL_L2 and tuple(out_k.shape) == shape
    print(f"{label}: rel L2 kernel vs plain {rel:.3e} (bound "
          f"{MODEL_REL_L2:.0e}) {'ok' if ok else 'FAIL'}; kernel path "
          f"{1e3 * (t1 - t0):.1f} ms, plain path {1e3 * (t2 - t1):.1f} ms "
          f"(first calls) [{card}]", flush=True)
    return ok


def phase_models(dev, card: str) -> bool:
    """One image-cycle UNet pass (3-row CFG batch, 3 refs at 64x64
    latents), one 512 px VAE encode and one decode, each on the kernel path
    against the plain path on the same inputs."""
    import torch
    from storygen_tpu_torch.pipeline import StoryGenSampler
    unet, vae, _ = full_width_models(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    n, b = 3, 1
    refs = torch.randn((n * 2 * b, 64, 64, 4), generator=g, device=dev)
    rtext = torch.randn((n * 2 * b, 77, 768), generator=g, device=dev)
    x = torch.randn((3 * b, 64, 64, 4), generator=g, device=dev)
    text = torch.randn((3 * b, 77, 768), generator=g, device=dev)
    t_ref = torch.tensor([48, 48, 32, 32, 16, 16], device=dev)
    image = torch.rand((1, 512, 512, 3), generator=g, device=dev)
    z = torch.randn((1, 64, 64, 4), generator=g, device=dev)
    with torch.no_grad():
        _, raw = unet(refs, t_ref, rtext)
        ctx = {k: StoryGenSampler._expand(v, n, b) for k, v in raw.items()}
    ok = kernel_vs_plain("unet image cycle B3 64x64 3 refs",
                         lambda: unet(x, 481, text, ctx)[0], (3, 64, 64, 4),
                         card)
    ok &= kernel_vs_plain("vae encode B1 512x512 (posterior mean)",
                          lambda: vae.encode(image).mean, (1, 64, 64, 4),
                          card)
    ok &= kernel_vs_plain("vae decode B1 64x64 latents (before the clamp)",
                          lambda: vae.decode(z), (1, 512, 512, 3), card)
    del unet, vae, raw, ctx
    torch.cuda.empty_cache()
    return ok


PROMPTS = ("A little fox finds a glowing lantern in the snowy forest.",
           "The fox carries the lantern along a frozen river at dusk.",
           "An owl watches the fox from a pine branch under the stars.",
           "The fox and the owl share the lantern light in a warm den.")


def phase_story(dev, card: str, results: dict) -> bool:
    """The main path: a 4-prompt generate_story at 512x512, DDIM, guidance
    7.5 / image guidance 3.5, frames 2-4 conditioned on up to 3 refs."""
    import numpy as np
    import torch
    from storygen_tpu_torch.ops import conv, flash_attention as fa, geglu
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    unet, vae, clip = full_width_models(dev)
    pipe = StoryGenPipeline(unet, vae, clip, token_ids, device=dev)
    marks = []
    decode = pipe.sampler.decode

    def timed_decode(latents):
        img = decode(latents)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return img

    pipe.sampler.decode = timed_decode
    wrappers = {"flash_attention": fa.flash_attention,
                "geglu_matmul": geglu.geglu_matmul, "conv3x3": conv.conv3x3}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = pipe.generate_story(list(PROMPTS),
                                 num_inference_steps=STORY_STEPS,
                                 height=512, width=512, guidance_scale=7.5,
                                 image_guidance_scale=3.5, seed=0)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    per_frame = np.diff([t0] + marks)
    ok = len(frames) == len(PROMPTS)
    for i, f in enumerate(frames):
        good = (f.shape == (512, 512, 3) and bool(np.isfinite(f).all())
                and f.min() >= 0.0 and f.max() <= 1.0)
        ok &= good
        print(f"frame {i + 1}: shape {f.shape} range [{f.min():.3f}, "
              f"{f.max():.3f}] mean {f.mean():.3f} "
              f"{'ok' if good else 'FAIL'}")
    for k, n in launches.items():
        ok &= n > 0
        if k in results:
            results[k]["launches"] = n
        else:
            results[k] = {"name": k, **KERNEL_META[k], "launches": n}
    print(f"story: {len(frames)} frames 512x512, DDIM-{STORY_STEPS}, "
          f"refs up to 3, "
          f"bf16: total {total:.2f} s, per frame "
          f"{', '.join(f'{s:.2f}' for s in per_frame)} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from storygen_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)

    results: dict = {}
    failed = []
    if not phase_kernels(dev, card, results):
        failed.append("kernels")
    if not phase_models(dev, card):
        failed.append("models")
    if not phase_story(dev, card, results):
        failed.append("story")
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
