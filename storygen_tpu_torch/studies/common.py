"""What the ported attention studies share: the UNet's attention shapes by
the studies' names, seeded inputs, the fp32 reference, the port's kernel F
as the "repo" baseline, the SDPA yardstick, CUDA-event timing, the
report line, and the tile studies' parallel build of one library per
candidate with its ptxas registers and spills.

Every study runs on the card unless the caller asks for the CPU
(`device="cpu"` or `--device cpu`); without a card it raises. On the CPU
the wrappers run their plain versions and times are host-clock times of
those, printed with "[cpu host clock]" instead of the card's name: they
say nothing about the card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import time
from pathlib import Path
from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.utils.device import resolve_device

# (batch, heads, Sq, Skv, head dim) of the UNet's attention sites at
# 512 px; "ref" has the image cycle's 6-row batch, "main" the 3-row one
SHAPES = {
    "attn3_L1": (3, 8, 4096, 12288, 40),
    "attn1_L1": (6, 8, 4096, 4096, 40),
    "attn1_L1_ref": (6, 8, 4096, 4096, 40),
    "attn1_L1_main": (3, 8, 4096, 4096, 40),
    "attn3_L2": (3, 8, 1024, 3072, 80),
    "attn1_L2_ref": (6, 8, 1024, 1024, 80),
    "attn1_L2_main": (3, 8, 1024, 1024, 80),
    "attn3_L3": (3, 8, 256, 768, 160),
    "attn2_L1": (3, 8, 4096, 77, 40),
}

Shape = Tuple[str, int, int, int, int, int]


def shapes(names: Iterable) -> List[Shape]:
    """Names of SHAPES, or (name, b, h, sq, skv, d) tuples as they are."""
    return [(s, *SHAPES[s]) if isinstance(s, str) else tuple(s)
            for s in names]


def arg_parser(doc: str, modes: Sequence[str] = ()) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    if modes:
        p.add_argument("mode", nargs="?", default=modes[0], choices=modes)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--shapes", default=None,
                   help="comma-separated names of common.SHAPES")
    p.add_argument("--iters", type=int, default=10)
    return p


def cli_kwargs(args: argparse.Namespace) -> dict:
    """The keyword arguments of a study function from its command line."""
    kw = {"device": args.device, "iters": args.iters}
    if args.shapes is not None:
        kw["shapes"] = args.shapes.split(",")
    return kw


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu host clock"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def qkv(dev: torch.device, b, h, sq, skv, d, seed: int = 0):
    """Seeded N(0, 1) q (B, H, Sq, D) and k, v (B, H, Skv, D) in bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    return rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)


def xla_attn(q, k, v, scale: float) -> torch.Tensor:
    """The plain attention (fp32 softmax, probabilities rounded to the
    input dtype): with fp32 inputs, the studies' fp32 reference."""
    return fa.plain_attention(q, k, v, scale)


# the label of the "repo" baseline: kernel F on wgmma fed by TMA
# (csrc/flash_wgmma.cuh; the "repo (F, mma.sync)" rows of earlier tables
# timed its mma.sync design, and "repo (F)" rows the WMMA kernel before it)
REPO = "repo (F, wgmma)"


def repo_attn(q, k, v, scale: float) -> torch.Tensor:
    """The port's kernel F on (B, H, S, D) tensors (its plain version on
    the CPU): the studies' "repo" baseline."""
    h = q.shape[1]
    return fa.split_heads(fa.flash_fwd(fa.merge_heads(q), fa.merge_heads(k),
                                       fa.merge_heads(v), h, scale), h)


def sdpa(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """PyTorch's fused attention (`mask`: boolean, True = keep): timed as a
    yardstick only; no kernel path of the port calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def time_ms(fn: Callable, dev: torch.device, iters: int) -> float:
    """Mean ms per call after two warm-up calls: CUDA events around `iters`
    calls on the card, the host clock on the CPU."""
    fn()
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, iters: int = 20, replays: int = 3) -> float:
    """Device ms per call of `fn` (which launches on the current stream)
    replayed from a CUDA graph of `iters` calls: the kernels back to back,
    without the host work that sets the pace of a small kernel's mean."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def line(name: str, label: str, ms: float, ops: float, card: str,
         err: Optional[float] = None, unit: str = "TFLOP/s") -> str:
    errs = "" if err is None else f"  maxerr {err:.2e}"
    return (f"{name:14s} {label:24s} {ms:9.4f} ms {ops / ms / 1e9:7.1f} "
            f"{unit}{errs}  [{card}]")


def run_candidates(name: str, cands, ref, ops: float, dev, card: str,
                   iters: int, unit: str = "TFLOP/s",
                   graph: bool = False) -> None:
    """One line per candidate (label, fn, check_err): its time, rate and,
    where check_err, its max error against `ref`; on the card, with
    `graph`, also its device time from a CUDA graph of its calls
    (graph_ms). An instantiation that is not built (ValueError) prints a
    FAILED line, as the JAX studies did."""
    for label, fn, check in cands:
        try:
            with torch.no_grad():
                err = max_err(fn(), ref) if check else None
                ms = time_ms(fn, dev, iters)
                alone = (graph_ms(fn) if graph and dev.type == "cuda"
                         else None)
        except ValueError as e:
            print(f"{name:14s} {label:24s} FAILED ValueError: {e}  [{card}]",
                  flush=True)
            continue
        extra = "" if alone is None else f"  graph {alone:.4f} ms"
        print(line(name, label, ms, ops, card, err, unit) + extra,
              flush=True)


def refused_as_value_error(fn: Callable) -> Callable:
    """A candidate whose launch the card refuses (a cudaError_t that the
    wrapper raises as RuntimeError) prints a FAILED line."""
    def call():
        try:
            return fn()
        except RuntimeError as e:
            raise ValueError(str(e)) from e
    return call


def setup(device) -> Tuple[torch.device, str]:
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev, card_line(dev)


def ptxas_summary(out: str) -> List[Tuple[str, int, int, int, int]]:
    """(kernel entry, registers, stack bytes, spill stores, spill loads)
    of every entry in `nvcc -Xptxas -v` output."""
    rows, entry, frame = [], "?", (0, 0, 0)
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, frame = m.group(1), (0, 0, 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((entry, int(m.group(1)), *frame))
    return rows


def build_candidates(root: Path, cands: Dict[Hashable, Tuple[str, str]],
                     kernel: str) -> Dict[Hashable, Path]:
    """One shared library per candidate under `root`: `cands` maps a key
    to (file stem, CUDA source). One nvcc with `-Xptxas -v` per candidate,
    all started together. Prints each candidate's registers and (stack,
    spill stores, spill loads) per kernel entry whose name holds `kernel`,
    or FAILED with the compiler's output, and then leaves it out."""
    root.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for key, (stem, text) in cands.items():
        src, lib = root / f"{stem}.cu", root / f"lib{stem}.so"
        src.write_text(text)
        procs.append((key, stem, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, stem, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"candidate {stem} FAILED to build:\n{out[-3000:]}",
                  flush=True)
            continue
        ents = [e for e in ptxas_summary(out) if kernel in e[0]]
        print(f"candidate {stem}: registers {[e[1] for e in ents]}, "
              f"stack/spill stores/loads {[e[2:] for e in ents]}",
              flush=True)
        for text in out.splitlines():
            if "serializ" in text:
                print(f"candidate {stem}: {text.strip()}", flush=True)
        libs[key] = lib
    return libs
