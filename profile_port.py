"""Times one story frame and one stage-2 training micro-step of the
PyTorch/CUDA port on the card, in the default and in the fused-conv
configuration (`ConvKernels(fused_prologue=True, strided=True)`: resnet
convs on kernel P, stride-2 convs on kernel D), and profiles where their
device time goes.

Run from the repository root on a machine with one NVIDIA H100:

    python3 profile_port.py            # frames and micro-steps
    python3 profile_port.py options    # serving's samplers and options
    python3 profile_port.py timers     # the three timers, a process a run

The frame is the headline's: 512 px, auto-regressive with 3 reference
frames, bf16, batch 1, guidance 7.5 / image guidance 3.5, with the
full-width SD-1.5 + VLCM UNet, VAE and CLIP text encoder of
`chip_smoke.py` (seeded random weights and token ids). The micro-step is
the training operating point of `chip_smoke.py`: stage 2, 512 px, batch
4, 3 refs, bf16, gradient checkpointing, 2 micro-steps per optimizer step,
on one seeded synthetic batch. Both configurations are built side by
side (the same seeded weights) and timed in turns, default, fused, fused,
default, so that a drift of the card's clock or of its host falls on both.
It prints

  - for each configuration, the wall time of two DDIM-50 frames after a
    DDIM-2 warm-up, and frames/s from their median;
  - for a DDIM-4 frame of each: its wall time without and with
    `torch.profiler`, the device's busy time under the profiler (the union
    of the card's kernel and copy intervals), the device's idle share
    against each wall time, device time by port kernel (F / M, L, DQ /
    DKV, G, C, P, D, U, UB (U's input gradient), each conv's split sums
    with it; the rest is plain torch) and by kernel, largest first;
  - for each, the wall time of 4 micro-steps after 2 warm-ups, and the
    same profile of 2 micro-steps (one that accumulates, one that updates).

The full kernel tables go to chiprun_out/profile_port.txt,
profile_train.txt (default) and profile_port_fused.txt,
profile_train_fused.txt. Every frame time includes the refs' VAE
encodes, the text encodes and the decode; every micro-step the VAE
encodes, text encodes, the reference UNet pass, the main pass, its
backward and the optimizer.

With `host [TREE]` it times instead the host's cost of one call of
kernels F, C and G (microseconds, the device's queue not full): through
the wrapper (`flash_fwd`, `conv3x3`, `geglu_matmul`) and of the C launcher
alone on operands and buffers made once, at serving shapes (F: attn1 L1
B6 4096² d40, attn2 L1 B3 4096x77 d40, mid B6 64² d160; C: UNet L1 B3 64²
320->320, mid B3 8² 1280->1280 with its split workspace; G: L1 ff (12288,
2x1280)->320, mid ff (192, 2x5120)->1280, each launcher call encoding its
two tensor maps), and the first call of each launcher in the process (its
one-time lookups included). TREE (default:
this checkout) is the root of a checkout whose `storygen_tpu_torch` is
imported and built, so that two commits are timed by one script, each in
its own process, in turns.

With `options` it times instead, in the default configuration and in
turns (each variant three times, forward and backward order in turn;
the stories twice), the wall time of
  - one auto-regressive frame (3 refs, 512 px) at DDIM-50, DPM++-25 and
    PNDM-50 (51 UNet steps);
  - the DDIM-50 frame with ref_feature_interval 1 and 2;
  - a 4-frame DDIM-50 story, per-frame and fused (generate_story(fused=
    True)),
and prints each one's times, median and factor over the first variant.

With `timers` it runs the port's three timers
(storygen_tpu_torch/scripts/bench{,_story,_train}.py) through their
main() at the JAX scripts' settings, each run in a process of its own
(`TIMER_RUNS`, each variant in both conv configurations, in turns:
default, fused, fused, default): `bench` (3 DDIM-50 frames after a
warm-up), `bench_story` per-frame, --reuse-latents and --fused (3
stories after a warm-up each), and `bench_train` at stage2 with AdamW,
stage2 with AdamW8bit, stage2 from precomputed moments and full with
AdamW8bit (batch 4, 5 steps after one). Each run's line, with its
per-iteration, per-frame or per-step times on the card's timeline and on
the host's clock and the card's name, power limit and SM clock, goes to
chiprun_out/timers.jsonl, beside the time of a fixed Python loop on the
host just before and after the run (`host_probe_ms`). About 30 min.
Without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import collections
import json
import os
import re
import statistics
import sys
import time

HEADLINE_STEPS = 50
PROFILE_STEPS = 4
TOP = 24
CONFIGS = ("default", "fused")
SUFFIX = {"default": "", "fused": "_fused"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if sys.argv[1:2] == ["host"]:
        tree = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else
                               os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, tree)
        return 0 if host_costs(dev, card, tree) else 1
    if sys.argv[1:] == ["options"]:
        return 0 if serving_options(dev, card) else 1
    if sys.argv[1:] == ["timers"]:
        return 0 if timers(dev, card) else 1
    return 0 if story_frames(dev, card) and train_micro_steps(dev, card) \
        else 1


def in_turns(run, label: str, card: str, unit: str, scale: float,
             keys=CONFIGS, rounds: int = 2) -> dict:
    """Times run(key) `rounds` times per key, the keys in order and in
    reverse order by turns (default, fused, fused, default for two
    configurations), and prints each key's times."""
    times = {k: [] for k in keys}
    for r in range(rounds):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            times[key].append(run(key))
    for key in keys:
        med = statistics.median(times[key])
        print(f"[{key}] {label}: "
              f"{', '.join(f'{scale * t:.3f}' for t in times[key])} "
              f"{unit}; median {scale * med:.3f} {unit}; "
              f"{med / statistics.median(times[keys[0]]):.3f}x [{keys[0]}]"
              f" [{card}]", flush=True)
    return times


HOST_CALLS = 200


def host_costs(dev, card: str, tree: str) -> bool:
    """Host microseconds per call of F, C and G through their wrappers and
    of their C launchers alone, with `tree`'s package (first on
    sys.path)."""
    import torch
    from storygen_tpu_torch.ops import _build, conv, flash_attention as fa
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
    assert os.path.dirname(pkg) == tree, fa.__file__
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def us(fn, n=HOST_CALLS) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * t / n

    rows = []
    for label, b, sq, skv, d in (("attn1 L1 B6 4096x4096 d40", 6, 4096,
                                  4096, 40),
                                 ("attn2 L1 B3 4096x77 d40", 3, 4096, 77,
                                  40),
                                 ("attn1 mid B6 64x64 d160", 6, 64, 64,
                                  160)):
        q, k, v = rnd(b, sq, 8 * d), rnd(b, skv, 8 * d), rnd(b, skv, 8 * d)
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                8, sq, skv, d, q.stride(0), q.stride(1), k.stride(0),
                k.stride(1), v.stride(0), v.stride(1), None, 1, 1,
                d ** -0.5, stream)
        rows.append(("F " + label, lambda a=args: lib.sg_flash_fwd(*a),
                     lambda q=q, k=k, v=v, d=d: fa.flash_fwd(q, k, v, 8,
                                                             d ** -0.5)))
    for label, b, hw, c in (("C UNet L1 B3 64x64 320->320", 3, 64, 320),
                            ("C mid B3 8x8 1280->1280", 3, 8, 1280)):
        x, w9 = rnd(b, hw, hw, c), rnd(9, c, c)
        bias = torch.randn((c,), generator=g, device=dev)
        out = torch.empty_like(x)
        shape = conv.workspace_shape(False, b, hw, hw, c, c)
        ws = (None if shape is None else
              torch.empty(shape, dtype=torch.float32, device=dev))
        args = (x.data_ptr(), w9.data_ptr(), bias.data_ptr(), 0, None,
                out.data_ptr(), None if ws is None else ws.data_ptr(),
                1 if shape is None else shape[0], b, hw, hw, c, c, stream)
        rows.append((label, lambda a=args, keep=(out, ws):
                     lib.sg_conv3x3(*a),
                     lambda x=x, w9=w9, bias=bias: conv.conv3x3(x, w9,
                                                                bias)))
    rows += geglu_host_rows(dev, rnd, lib, stream)
    ok = True
    with torch.no_grad():
        for label, alone, wrapper in rows:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            err = alone()  # the launcher's first call in this process
            first = 1e6 * (time.perf_counter() - t0)
            ok &= err == 0
            wrapper()
            a_us, w_us = us(alone), us(wrapper)
            a2_us, w2_us = us(alone), us(wrapper)
            print(f"host {label}: launcher alone {a_us:.2f} / {a2_us:.2f} "
                  f"us a call (first call {first:.1f} us), wrapper "
                  f"{w_us:.2f} / {w2_us:.2f} us a call; tree {tree} "
                  f"[{card}]", flush=True)
    return ok


def geglu_host_rows(dev, rnd, lib, stream):
    """Kernel G's (label, launcher alone, wrapper) at the first level and
    the mid block (its split line) of serving. The launcher's arguments
    follow the tree's signature: rows per image (this design, two tensor
    maps a call), or split-K partials and counters picked by M (the
    mma.sync design before it)."""
    import torch
    from storygen_tpu_torch.ops import _build, geglu
    rows = []
    for label, m, n, e, tokens in (("G L1 ff (12288, 2x1280)->320", 12288,
                                    1280, 320, 4096),
                                   ("G mid ff (192, 2x5120)->1280", 192,
                                    5120, 1280, 64)):
        p, w, bias = rnd(m, 2 * n), rnd(e, n), rnd(e)
        out = torch.empty((m, e), dtype=p.dtype, device=dev)
        keep = [p, w, bias, out]
        if len(_build.SIGNATURES["sg_geglu_matmul"]) == 10:
            args = (p.data_ptr(), w.data_ptr(), bias.data_ptr(), 0,
                    out.data_ptr(), m, n, e, tokens, stream)
            wrapper = (lambda p=p, w=w, bias=bias, t=tokens:
                       geglu.geglu_matmul(p, w, bias, t))
        else:
            tile = geglu.geglu_tile(m, n, e)
            split = tile[6]
            part = count = None
            if split > 1:
                part = torch.empty((split, m, e), dtype=torch.float32,
                                   device=dev)
                count = geglu._tile_counters(dev, stream, -(-m // tile[0])
                                             * -(-e // tile[1]))
                keep += [part, count]
            args = (p.data_ptr(), w.data_ptr(), bias.data_ptr(), 0,
                    out.data_ptr(), None if part is None else part.data_ptr(),
                    None if count is None else count.data_ptr(), m, n, e,
                    stream)
            wrapper = (lambda p=p, w=w, bias=bias:
                       geglu.geglu_matmul(p, w, bias))
        rows.append((label, lambda a=args, keep=keep:
                     lib.sg_geglu_matmul(*a), wrapper))
    return rows


def story_frames(dev, card: str) -> bool:
    import numpy as np
    import torch
    import chip_smoke as cs
    from storygen_tpu_torch.pipeline import StoryGenPipeline, frame_generator
    pipes = {}
    for config in CONFIGS:
        unet, vae, clip = cs.full_width_models(dev, config)
        pipes[config] = StoryGenPipeline(unet, vae, clip, cs.token_ids,
                                         device=dev)
    refs = np.random.RandomState(0).rand(3, 1, 512, 512, 3).astype(np.float32)
    prev = [[p] for p in cs.PROMPTS[:3]]

    def frame(config: str, steps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipes[config](stage="auto-regressive", prompt=[cs.PROMPTS[3]],
                            image_prompt=refs, prev_prompt=prev,
                            num_inference_steps=steps, guidance_scale=7.5,
                            image_guidance_scale=3.5,
                            generator=frame_generator(dev, 0, 3))
        torch.cuda.synchronize()
        assert img.shape == (1, 512, 512, 3) and np.isfinite(img).all()
        return time.perf_counter() - t0

    for config in CONFIGS:
        frame(config, 2)
    times = in_turns(lambda c: frame(c, HEADLINE_STEPS),
                     f"DDIM-{HEADLINE_STEPS} auto-regressive frame, 3 refs, "
                     "512 px, bf16", card, "s", 1.0)
    for config in CONFIGS:
        print(f"[{config}] {1 / statistics.median(times[config]):.4f} "
              f"frames/s [{card}]")

    # The profiler's host-side tracing slows the host, not the card: the
    # idle share is taken against the same frame's wall time unprofiled.
    ok = True
    for config in CONFIGS:
        wall = frame(config, PROFILE_STEPS)
        ok &= report(f"[{config}] DDIM-{PROFILE_STEPS} frame",
                     lambda: frame(config, PROFILE_STEPS), wall, card,
                     f"profile_port{SUFFIX[config]}.txt")
    del pipes
    torch.cuda.empty_cache()
    return ok


def serving_options(dev, card: str) -> bool:
    """`profile_port.py options`: the samplers, ref_feature_interval and
    the fused story against the per-frame one, in turns."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from storygen_tpu_torch.pipeline import StoryGenPipeline, frame_generator
    unet, vae, clip = cs.full_width_models(dev)
    pipe = StoryGenPipeline(unet, vae, clip, cs.token_ids, device=dev)
    refs = np.random.RandomState(0).rand(3, 1, 512, 512, 3).astype(np.float32)
    prev = [[p] for p in cs.PROMPTS[:3]]

    def frame(sampler: str, steps: int, interval: int = 1) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe(stage="auto-regressive", prompt=[cs.PROMPTS[3]],
                   image_prompt=refs, prev_prompt=prev,
                   num_inference_steps=steps, guidance_scale=7.5,
                   image_guidance_scale=3.5, sampler=sampler,
                   ref_feature_interval=interval,
                   generator=frame_generator(dev, 0, 3))
        torch.cuda.synchronize()
        assert img.shape == (1, 512, 512, 3) and np.isfinite(img).all()
        return time.perf_counter() - t0

    def story(fused: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = pipe.generate_story(list(cs.PROMPTS), fused=fused,
                                     num_inference_steps=HEADLINE_STEPS,
                                     guidance_scale=7.5,
                                     image_guidance_scale=3.5, seed=0)
        torch.cuda.synchronize()
        assert len(frames) == 4 and all(np.isfinite(f).all() for f in frames)
        return time.perf_counter() - t0

    variants = {"DDIM-50": ("ddim", 50), "DPM++-25": ("dpm++", 25),
                "PNDM-50": ("pndm", 50)}
    for sampler, _ in variants.values():
        frame(sampler, 2)
    in_turns(lambda k: frame(*variants[k]), "auto-regressive frame, 3 refs, "
             "512 px, bf16", card, "s", 1.0, keys=tuple(variants), rounds=3)
    frame("ddim", 4, 2)
    in_turns(lambda k: frame("ddim", 50, int(k[-1])), "DDIM-50 "
             "auto-regressive frame, 3 refs, 512 px, bf16", card, "s", 1.0,
             keys=("ref_feature_interval 1", "ref_feature_interval 2"),
             rounds=3)
    in_turns(lambda k: story(k == "fused"), "4-frame DDIM-50 story, refs up "
             "to 3, 512 px, bf16", card, "s", 1.0,
             keys=("per-frame", "fused"), rounds=2)
    return True


# the timers mode's runs: (label, module, flags beside --conv)
TIMER_RUNS = (
    ("bench: s per DDIM-50 frame (3 refs, 512 px)", "bench", ()),
    ("bench_story per-frame: p50 s per 4-frame DDIM-50 story",
     "bench_story", ()),
    ("bench_story reuse-latents: p50 s per 4-frame DDIM-50 story",
     "bench_story", ("--reuse-latents",)),
    ("bench_story fused: p50 s per 4-frame DDIM-50 story", "bench_story",
     ("--fused",)),
    ("bench_train stage2 fp32: ms per step, batch 4", "bench_train", ()),
    ("bench_train stage2 8bit: ms per step, batch 4", "bench_train",
     ("--opt", "8bit")),
    ("bench_train stage2 fp32 precomputed: ms per step, batch 4",
     "bench_train", ("--precomputed",)),
    ("bench_train full 8bit: ms per step, batch 4", "bench_train",
     ("--stage", "full", "--opt", "8bit")))

# a timer's main() in a child process; its returned line after "TIMER "
TIMER_CALL = ("import json, sys; from storygen_tpu_torch.scripts import {} "
              "as m; print('TIMER ' + json.dumps(m.main(sys.argv[1:])), "
              "flush=True)")


def timer_process(module: str, flags, conv: str) -> dict:
    """Runs `module`'s main(flags + --conv conv) in a process of its own
    and returns its line; raises if the process fails."""
    import subprocess
    proc = subprocess.run([sys.executable, "-c", TIMER_CALL.format(module),
                           *flags, "--conv", conv],
                          capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"{module} {flags} --conv {conv}: exit "
                           f"{proc.returncode}")
    last = [x for x in proc.stdout.splitlines() if x.startswith("TIMER ")]
    return json.loads(last[-1][len("TIMER "):])


def host_probe_ms(n: int = 2_000_000) -> float:
    """Milliseconds of a fixed pure-Python loop: the host's own pace, read
    beside each timer run."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return 1e3 * (time.perf_counter() - t0)


def timers(dev, card: str) -> bool:
    """`profile_port.py timers`: each of TIMER_RUNS in turns, a process a
    run; each line goes to chiprun_out/timers.jsonl with its label and
    `host_probe_ms` just before and just after the run."""
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "timers.jsonl"), "w") as out:
        for label, module, flags in TIMER_RUNS:
            def run(conv: str) -> float:
                before = host_probe_ms()
                line = timer_process(module, flags, conv)
                probe = [before, host_probe_ms()]
                print(f"host probe {probe[0]:.1f}, {probe[1]:.1f} ms",
                      flush=True)
                out.write(json.dumps({"label": label, "host_probe_ms": probe,
                                      **line}) + "\n")
                out.flush()
                if module == "bench":
                    return 1 / line["value"]
                if module == "bench_story":
                    return line["value"]
                return line["ms_per_step"]

            in_turns(run, label, card, "s" if module != "bench_train"
                     else "ms", 1.0)
    return True


# the conv template's kernels by (stride, mode): csrc/conv_wgmma.cuh's
# wg_conv_kernel and its split sum wg_splitk_reduce (a tree before kernel
# U names C's, P's and D's mode as a bool, and their split sums alike)
CONV_MODES = {("1", "0"): "C", ("1", "1"): "P", ("2", "0"): "D",
              ("1", "2"): "U", ("2", "3"): "UB", ("1", "false"): "C",
              ("1", "true"): "P", ("2", "false"): "D"}
ENTRIES = (("flash_bwd_wg_kernel", "DQ / DKV"), ("lse_wg_kernel", "L"),
           ("flash_wg_kernel", "F / M"), ("geglu_wg_kernel", "G"),
           ("conv_mma_kernel", "C"))


def port_kernel(name: str) -> str:
    """The port kernel that a trace's kernel name belongs to, or "plain
    torch"."""
    m = re.search(r"wg_conv_kernel<(\d+), (\w+)", name)
    if m:
        return CONV_MODES.get(m.groups(), "plain torch")
    m = re.search(r"wg_splitk_reduce<(\d+), (\d+)>", name)
    if m:
        return CONV_MODES.get(m.groups(), "plain torch")
    if "wg_splitk_reduce" in name:
        return "C"  # a tree before U: C's, P's and D's split sums
    return next((k for entry, k in ENTRIES if entry in name), "plain torch")


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
    by_port = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in rows:
        by_port[port_kernel(name)][0] += ms
        by_port[port_kernel(name)][1] += n
    port = (f"{label} by port kernel: " + ", ".join(
        f"{k} {ms:.2f} ms ({100 * ms / busy:.1f}%, n={n})"
        for k, (ms, n) in sorted(by_port.items(), key=lambda kv: -kv[1][0]))
        + f" [{card}]")
    print(port)
    lines = [f"{ms:10.2f} ms {100 * ms / busy:6.1f}%  n={n:6d}  {name}"
             for name, (ms, n) in rows]
    print("\n".join(line[:140] for line in lines[:TOP]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_name), "w") as f:
        f.write(f"{card}\n{port}\n" + "\n".join(lines) + "\n")
    return True


def train_micro_steps(dev, card: str) -> bool:
    import torch
    import chip_smoke as cs
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
    from storygen_tpu_torch.training import trainer
    cfg = TrainConfig(train_batch_size=cs.TRAIN_BATCH,
                      gradient_accumulation_steps=cs.TRAIN_GA, seed=0)
    step = {}
    for config in CONFIGS:
        bundle = trainer.build_models(cfg, dev, conv=cs.conv_kernels(config))
        step[config], _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
    ds = SyntheticStoryDataset(cs.TRAIN_BATCH, size=512, seed=5)
    batch = trainer.to_device(collate([ds[i] for i in range(len(ds))]), dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def micro(config: str, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step[config](batch, gen)["loss"]
        torch.cuda.synchronize()
        assert torch.isfinite(loss).item()
        return time.perf_counter() - t0

    for config in CONFIGS:
        micro(config, 2)
    torch.cuda.reset_peak_memory_stats()
    times = in_turns(lambda c: micro(c, 1),
                     f"stage-2 micro-step, batch {cs.TRAIN_BATCH}, 512 px, "
                     "3 refs, bf16, gradient checkpointing", card, "ms", 1e3)
    for config in CONFIGS:
        print(f"[{config}] {cs.TRAIN_BATCH / statistics.median(times[config]):.3f}"
              f" samples/s [{card}]")
    print(f"peak memory of both configurations' models and steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]",
          flush=True)
    ok = True
    for config in CONFIGS:
        wall = micro(config, 2)
        ok &= report(f"[{config}] 2 stage-2 micro-steps",
                     lambda: micro(config, 2), wall, card,
                     f"profile_train{SUFFIX[config]}.txt")
    return ok


if __name__ == "__main__":
    sys.exit(main())
